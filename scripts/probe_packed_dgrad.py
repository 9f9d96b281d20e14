"""The packed engine's conv input gradients on the card: which library call
the default training step spends its backward in, and the input gradient as
a forward conv (``ops/packed_conv.py::PackedConv``) against the library's.

    python3 scripts/probe_packed_dgrad.py [--phases culprit,shapes,step,crossover]
        [--out build/probe_packed_dgrad.jsonl]

Phases (each prints one JSON line, appended to ``--out``, with the card's
name and power limit):

- ``culprit``: the packed baseline's step at ``TrainConfig()`` (batch 32,
  patch 33), profiled over ``--steps`` steps with ``record_shapes``: every
  kernel over 1% of the stretch's device time, with the op that launched it
  and that op's ``aten::convolution_backward`` ancestor (input shapes); and,
  from the autograd graph of one step's loss, each
  ``ConvolutionBackward0``'s saved input and weight and its output gradient
  (shape, strides, channels-last or not).  Runs on any tree of the port.
- ``shapes``: each conv ``packed_conv._conv`` makes in one
  ``forward_train`` of the packed baseline, ``vgg_like`` and the packed U-Net
  at ``TrainConfig()`` (recorded from the calls), whose input needs a
  gradient: the library's input gradient (``aten.convolution_backward``,
  input only) and its weight gradient alone, against ``PackedConv``'s input
  gradient (a forward conv), bf16, ms by CUDA events (median of
  ``--reps``), with the two input gradients' gap (``chip_smoke.conv_check``
  against an f32 ``conv3d_input``).
- ``step``: the packed baseline's and U-Net's b32 steps with ``_conv`` as it
  is ("new"), the previous ``_conv`` (the library's gradients, "old") and
  every conv under grad through ``PackedConv`` ("all"), in turns in one
  process, ms a step (synchronised host clock over ``--steps``); the
  profiled breakdown of the step as it is, and its tracer counters a step.
- ``crossover``: the baseline's step at batch 32, 64 and 96 on the packed
  and the plain engine: patch Mvox/s (batch x 33^3 a step), as the
  benchmark's ``train_mvox_s`` counts them.

It needs a CUDA card.  Only ``culprit`` runs on a tree without
``PackedConv``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from flypylib_tpu_torch import FplNetwork  # noqa: E402
from flypylib_tpu_torch.ops import packed_conv as tpc  # noqa: E402
from flypylib_tpu_torch.ops.conv import conv3d_f32, no_tf32  # noqa: E402
from flypylib_tpu_torch.train.trainer import (TrainConfig, TrainData,  # noqa: E402
                                              make_loss_fn, make_train_step)
from flypylib_tpu_torch.utils import metrics as tm  # noqa: E402

PATCH = 33
DEV = torch.device("cuda")


def card() -> dict:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": q}


def old_conv(x, w):
    """``packed_conv._conv`` before ``PackedConv``: the library's conv
    gradients through autograd."""
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                     w.to(x.dtype).permute(4, 3, 0, 1, 2))
        return y.permute(0, 2, 3, 4, 1)
    return conv3d_f32(x, w.to(x.dtype)).to(x.dtype)


def all_conv(x, w):
    """``_conv`` with every conv under grad through ``PackedConv`` (no rule
    by kernel extent)."""
    w = w.to(x.dtype)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return tpc.PackedConv.apply(x, w)
    return tpc._fprop(x, w)


@contextlib.contextmanager
def conv_as(conv):
    """``_conv`` replaced by ``conv`` in both packed engines for the block."""
    from flypylib_tpu_torch.ops import packed_unet as tpu
    real = tpc._conv, tpu._conv
    tpc._conv = tpu._conv = conv
    try:
        yield
    finally:
        tpc._conv, tpu._conv = real


def train_setup(model: str, batch: int, engine: str = "auto", seed: int = 0):
    """``(step, state, gen, data, loss_fn, sample_fn)`` of ``model`` at
    ``TrainConfig(batch_size=batch, engine=engine)`` on a random labelled
    128^3 volume on ``DEV``."""
    dev = DEV
    cfg = TrainConfig(batch_size=batch, engine=engine)
    net = FplNetwork(model, seed=seed, device=dev, train_config=cfg)
    step, _, patch = make_train_step(net.spec, net.trainer.cfg)
    loss_fn, sample_fn, _ = make_loss_fn(net.spec, net.trainer.cfg)
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (128,) * 3, dtype=np.uint8)
    labels = (rng.random((128,) * 3) > 0.999).astype(np.float32)
    data = TrainData.build(image, labels, np.ones_like(labels), patch,
                           device=dev)
    state = net.trainer.init_state()
    return step, state, net.trainer.generator, data, loss_fn, sample_fn


def sync():
    if DEV.type == "cuda":
        torch.cuda.synchronize()


def steps_ms(step, state, gen, data, n: int) -> float:
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, gen, data)
    sync()
    return (time.perf_counter() - t0) / n * 1e3


def profile_steps(step, state, gen, data, n: int, shapes: bool = False):
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        for _ in range(n):
            step(state, gen, data)
        sync()
    return prof


def kernels(prof, n: int, min_share: float = 0.01) -> dict:
    """Device ms a step by kernel name, the launching op and its
    ``aten::convolution_backward`` ancestor's input shapes."""
    rows, total = {}, 0.0
    for e in prof.events():
        for k in e.kernels:
            total += k.duration
            conv = e
            while conv is not None and conv.name != "aten::convolution_backward":
                conv = conv.cpu_parent
            key = (k.name[:120], e.name,
                   json.dumps(conv.input_shapes) if conv is not None else None)
            rows[key] = rows.get(key, 0.0) + k.duration
    out = [{"kernel": a, "op": b, "conv_backward_inputs": c,
            "ms_a_step": v / 1e3 / n} for (a, b, c), v in rows.items()
           if v >= min_share * total]
    out.sort(key=lambda r: -r["ms_a_step"])
    table = prof.key_averages(group_by_input_shape=True).table(
        sort_by="self_device_time_total", row_limit=12, max_name_column_width=60,
        max_shapes_column_width=120)
    return {"device_ms_a_step": total / 1e3 / n, "kernels": out,
            "ops_by_shape": table}


def _layout(t: torch.Tensor) -> dict:
    return {"shape": list(t.shape), "stride": list(t.stride()),
            "dtype": str(t.dtype).replace("torch.", ""),
            "channels_last_3d": t.is_contiguous(
                memory_format=torch.channels_last_3d) if t.dim() == 5 else None,
            "contiguous": t.is_contiguous()}


def culprit(args) -> dict:
    step, state, gen, data, loss_fn, sample_fn = train_setup("baseline", 32)
    for _ in range(5):
        step(state, gen, data)
    # the graph of one step's loss: each conv backward node's operands
    loss, _ = loss_fn(*sample_fn(gen, data))
    nodes, seen, todo = [], set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == "ConvolutionBackward0":
            rec = {"input": _layout(fn._saved_input),
                   "weight": _layout(fn._saved_weight),
                   "padding": list(fn._saved_padding),
                   "groups": fn._saved_groups}
            fn.register_prehook(
                lambda g, rec=rec: rec.__setitem__("grad_output", _layout(g[0])))
            nodes.append(rec)
        todo += [f for f, _ in fn.next_functions]
    loss.backward()
    sync()
    prof = profile_steps(step, state, gen, data, args.steps, shapes=True)
    return {"phase": "culprit", "conv_backward_nodes": nodes,
            **kernels(prof, args.steps)}


def _record_convs(model: str) -> list:
    """The ``_conv`` calls of one ``forward_train`` of ``model``'s packed
    engine at ``TrainConfig()``: (x shape, w shape, x needs a gradient)."""
    _, state, gen, data, loss_fn, sample_fn = train_setup(model, 32, "packed")
    seen, real = [], tpc._conv

    def spy(x, w):
        seen.append((tuple(x.shape), tuple(w.shape), bool(x.requires_grad)))
        return real(x, w)

    with conv_as(spy):
        loss_fn(*sample_fn(gen, data))
    return seen


def time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    ts = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def shapes(args) -> dict:
    dev = DEV
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for model in ("baseline", "vgg_like", "unet"):
        calls = _record_convs(model)
        for xs, ws, needs in dict.fromkeys(calls):
            if not needs:
                continue
            x = torch.randn(xs, generator=gen, device=dev).bfloat16()
            w = (torch.randn(ws, generator=gen, device=dev)
                 / np.sqrt(np.prod(ws[:4]))).bfloat16()
            ys = (xs[0], *(xs[i] - ws[i - 1] + 1 for i in (1, 2, 3)), ws[4])
            g = torch.randn(ys, generator=gen, device=dev).bfloat16()
            xn, gn = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
            wn = w.permute(4, 3, 0, 1, 2)

            def lib(mask):
                return torch.ops.aten.convolution_backward(
                    gn, xn, wn, None, [1] * 3, [0] * 3, [1] * 3, False,
                    [0] * 3, 1, mask)

            def fprop():
                return tpc.PackedConv.backward(_Ctx(x, w), g)[0]

            with no_tf32(dev):
                ref = torch.nn.grad.conv3d_input(xn.shape, wn.float(),
                                                 gn.float())
                ref = ref.permute(0, 2, 3, 4, 1)
                lib_dx = lib([True, False, False])[0].permute(0, 2, 3, 4, 1)
                row = {"model": model, "x": list(xs), "w": list(ws),
                       "lib_dgrad_ms": time_ms(lambda: lib([True, False, False]),
                                               args.reps),
                       "lib_wgrad_ms": time_ms(lambda: lib([False, True, False]),
                                               args.reps),
                       "fprop_dgrad_ms": time_ms(fprop, args.reps),
                       "fprop_err_ok": chip_smoke.conv_check(fprop(), ref),
                       "lib_err_ok": chip_smoke.conv_check(lib_dx, ref)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return {"phase": "shapes", "rows": rows}


class _Ctx:
    """What ``PackedConv.backward`` reads of its context: the saved operands
    and which gradients are needed (the input's only)."""

    def __init__(self, x, w):
        self.saved_tensors = (x, w)
        self.needs_input_grad = (True, False)


def step(args) -> dict:
    out = {"phase": "step"}
    for model in ("baseline", "unet"):
        st = train_setup(model, 32)[:4]
        convs = {"new": tpc._conv, "old": old_conv, "all": all_conv}
        times = {side: [] for side in convs}
        order = list(convs)
        for r in range(args.rounds):
            for side in order[r % 3:] + order[:r % 3]:
                with conv_as(convs[side]):
                    steps_ms(*st, 3)
                    times[side].append(steps_ms(*st, args.steps))
        prof = profile_steps(*st, args.steps)
        tm.take()  # what the profiled steps recorded
        tm.enable()
        steps_ms(*st, 2)
        rec = tm.disable()
        out[model] = {"ms_a_step": times, **kernels(prof, args.steps),
                      "grouped_direct": any("grouped_direct" in k.name
                                            for e in prof.events()
                                            for k in e.kernels),
                      "counters": list(rec["counters"].values())}
        print(json.dumps({model: out[model]["ms_a_step"]}), flush=True)
    return out


def crossover(args) -> dict:
    rows = []
    for batch in (32, 64, 96):
        for engine in ("packed", "plain"):
            st = train_setup("baseline", batch, engine)[:4]
            steps_ms(*st, 5)
            ms = [steps_ms(*st, args.steps) for _ in range(args.rounds)]
            med = statistics.median(ms)
            rows.append({"batch": batch, "engine": engine, "ms_a_step": ms,
                         "patch_mvox_s": batch * PATCH ** 3 / med / 1e3})
            print(json.dumps(rows[-1]), flush=True)
            del st
            torch.cuda.empty_cache()
    return {"phase": "crossover", "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="culprit,shapes,step,crossover")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="build/probe_packed_dgrad.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_packed_dgrad: needs a CUDA card", file=sys.stderr)
        return 1
    from flypylib_tpu_torch.ops import _build
    _build.build()
    head = card()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    phases = {"culprit": culprit, "shapes": shapes, "step": step,
              "crossover": crossover}
    for name in args.phases.split(","):
        t0 = time.perf_counter()
        line = {**phases[name](args), **head,
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
