#!/usr/bin/env python3
"""The BatchNorm baseline's f32 train-step gradient on one GPU, against an
f64 truth, parameter by parameter and op by op.

    python3 scripts/probe_bn_grad.py

Runs ``chip_smoke.py`` phase 13(c)'s f32 case (the full-width BatchNorm
baseline of ``chip_smoke.bn_state``, batch seed 1, batch 8, patch 34) and
prints:

- every parameter's gradient error, max |g - g64| / max |g64|, for the
  port's step on the card, the port's step on the CPU taking the card's
  ReLU masks (``chip_smoke.grad_decisions``), and between the two, against
  an f64 autograd of the same model on the CPU on the same masks
  (``chip_smoke.bn_f64_grads``); beside
  each, max |g64|, whose fall from layer to layer (BatchNorm's backward
  projects out each channel's mean and its normalised input) scales an
  upstream error up below it;
- each body conv's weight and input gradients at the shapes and values of
  the card's own step (``torch.nn.grad``, as
  ``ops.conv.Conv3dBiasReLU.backward`` calls them), f32 under ``no_tf32``
  against f64, with cuDNN as configured, deterministic, and off; and the
  gradient arriving at each conv's output, card against f64.
"""

import contextlib
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def main() -> int:
    cs.require(torch.cuda.is_available(), "needs an NVIDIA GPU")
    port = cs.import_port()
    card_str = cs.card()
    from flypylib_tpu_torch.models.zoo import Conv3BiasReLU
    from flypylib_tpu_torch.ops import _build
    from flypylib_tpu_torch.ops.conv import no_tf32

    _build.build()
    _build.load_library()
    print(f"torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}")
    state = cs.bn_state(port)
    batch = cs.grad_batch(cs.GRAD_SEEDS[0], cs.GRAD_BATCH, cs.GRAD_PATCH, 6)
    cpu = cs.bn_spec(port, state, torch.float32)
    gpu = cs.bn_spec(port, state, torch.float32)
    gpu.module.to("cuda")

    ops = []

    def hook(mod, inp, out):
        rec = {"mod": mod, "x": inp[0].detach(), "y": out.detach()}
        ops.append(rec)
        out.register_hook(lambda g: rec.__setitem__("dy", g.detach()))

    hs = [m.register_forward_hook(hook) for m in gpu.module.modules()
          if isinstance(m, Conv3BiasReLU)]
    try:
        with cs.grad_decisions(gpu.module) as card:
            _, g_card, _ = cs.train_grads(gpu, "plain", batch, "cuda")
    finally:
        for h in hs:
            h.remove()
    with cs.grad_decisions(cpu.module, ref=card):
        _, g_cpu, _ = cs.train_grads(cpu, "plain", batch, "cpu")
    g64 = cs.bn_f64_grads(state, batch, card["y"])
    print(f"BatchNorm baseline f32 (patch {cs.GRAD_PATCH}, batch "
          f"{cs.GRAD_BATCH}), max |g - g64| / max |g64| per parameter "
          f"[{card_str}]")
    print(f"{'parameter':16s}{'card':>12s}{'CPU':>12s}{'card vs CPU':>14s}"
          f"{'max|g64|':>12s}")
    for name, t in g64.items():
        print(f"{name:16s}{rel(g_card[name], t):12.3g}{rel(g_cpu[name], t):12.3g}"
              f"{rel(g_card[name], g_cpu[name]):14.3g}"
              f"{float(t.abs().max()):12.3g}", flush=True)

    modes = {
        "cuDNN as set": contextlib.nullcontext,
        "deterministic": lambda: torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True),
        "cuDNN off": lambda: torch.backends.cudnn.flags(enabled=False),
    }
    print(f"op by op on the card, f32 against f64, dw / dx [{card_str}]")
    print(f"{'conv':34s}" + "".join(f"{m:>24s}" for m in modes))
    for rec in ops:
        mod, d = rec["mod"], rec["mod"].dilation
        res = {}
        for dt in (torch.float64, torch.float32):
            x = rec["x"].to(dt).permute(0, 4, 1, 2, 3)
            g = rec["dy"].to(dt).permute(0, 4, 1, 2, 3)
            w = mod.weight.detach().to(dt).permute(4, 3, 0, 1, 2)
            for label, mode in modes.items():
                if dt == torch.float64 and label != "cuDNN as set":
                    continue
                with mode(), no_tf32(x.device):
                    res[(dt, label)] = (
                        torch.nn.grad.conv3d_weight(x, w.shape, g, dilation=d),
                        torch.nn.grad.conv3d_input(x.shape, w, g, dilation=d))
        w64, x64 = res[(torch.float64, "cuDNN as set")]
        line = [f"{rel(res[(torch.float32, m)][0], w64):10.3g} /"
                f"{rel(res[(torch.float32, m)][1], x64):10.3g}" for m in modes]
        label = f"conv {tuple(rec['x'].shape)}->{rec['y'].shape[-1]} d={d}"
        print(f"{label:34s}" + "".join(f"{s:>24s}" for s in line), flush=True)
    print(f"card: {cs.card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
