#!/usr/bin/env python3
"""Probe of the decoder tail's f32 stages (K2, K3) on one GPU.

    python3 scripts/probe_tail_f32.py [--quick | --timing-only | --widths]

Builds the kernels and prints the compiler's register/spill report of
``conv_f32_kernel`` (``csrc/conv3d_f32.cu``: K1's f32 route and the tail's
"simt" route).  Then:

- unless ``--timing-only``: ``chip_smoke``'s small K2 / K3 cases (bf16 and
  f32, each on the route it names), and a K3 stage at small widths, bit
  for bit in a second launch and on a sub-window of its operands;
- K1's f32 route at the baseline's layers 1-3 (a tile batch at 256^3,
  seeded operands): a hash of each output's bits, to compare across trees,
  and unless ``--quick`` its time;
- unless ``--quick``: at the operands ``chip_smoke.tail_inputs(float32)``
  captures (the packed U-Net's 256^3 covering tile, unit-scale
  activations), K2's and K3's whole f32 tails, stage 0 alone and the rest
  with the logits, on the route ``tail_route`` gives and on the first
  version ("fma", forced), in turns (rule, fma, fma, rule), then the plain
  version, the unfused f32 tail (cuDNN f32, TF32 off) and the bound at
  67 TFLOP/s.

``--timing-only`` runs on a tree whose ``chip_smoke.py`` predates the f32
route too, so the same script measures the parent.  ``--widths`` times,
instead, the whole f32 tails with the kernel's channel blocks 64, 48 and 32
wide (in turns: 64, 48, 32, 32, 48, 64) and the logits launch alone.
"""

import argparse
import hashlib
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from flypylib_tpu_torch.ops import _build, tail  # noqa: E402
from flypylib_tpu_torch.ops.conv import conv3d_bias_relu, k1_route  # noqa: E402

K1_LAYERS = (  # the baseline's layers 1-3 at 256^3: (input extent, Ci, Co, d)
    (74, 24, 32, 1), (72, 32, 48, 2), (68, 48, 64, 2))


def register_report(path: Path) -> None:
    lines = path.with_suffix(".log").read_text().splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "conv_f32_kernel" in ln:
            print("\n".join(lines[i:i + 4]), flush=True)


def small_checks(card_str: str) -> None:
    cs.check_tail_small(card_str)
    ops = cs.tail_operands((2, 20, 21, 30), 48, 16, 64, 0, 0, seed=3,
                           dtype=torch.float32)
    xa, xb, stage0, _, _ = ops
    assert tail.tail_route(xa, xb, stage0[0]) == "simt"
    got = cs.run_tail(*ops)
    cs.tail_simt_bitwise("K3 small", xa, xb, stage0, got, card_str)


def k1_control(card_str: str, timed: bool) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    total = 0.0
    for s, ci, co, d in K1_LAYERS:
        x = torch.relu(torch.randn((8, s, s, s, ci), generator=gen,
                                   device="cuda"))
        w = torch.randn((3, 3, 3, ci, co), generator=gen,
                        device="cuda") / (27 * ci) ** 0.5
        b = 0.1 * torch.randn((co,), generator=gen, device="cuda")
        route = k1_route(x, w, d)
        out = conv3d_bias_relu(x, w, b, d)
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        ms = cs.median_ms(lambda: conv3d_bias_relu(x, w, b, d)) if timed else None
        total += ms or 0.0
        print(f"K1 f32 (8,{s}^3,{ci}) -> {co} d={d} [{route}]: output sha256 "
              f"{digest}" + (f"; {ms:.4f} ms" if timed else "")
              + f" [{card_str}]", flush=True)
    if timed:
        print(f"K1 f32 baseline layers 1-3 summed {total:.4f} ms "
              f"[{card_str}]", flush=True)


def stage_routes() -> dict:
    """Stage launches so far by route, K2's and K3's together."""
    return {r: n + tail.packed_tail2.routes[r]
            for r, n in tail.packed_tail.routes.items()}


def tail_timing(card_str: str) -> None:
    _, seen, tin = cs.tail_inputs(torch.float32)
    xin, stages, lg = seen["packed_tail"]
    sc, xu, stage0, stages2, lg2 = seen["packed_tail2"]
    wa, wb = stage0[0], stage0[1]
    chains = {
        "K2": (xin, None, (stages[0][0], None, stages[0][1]),
               list(stages[1:]), lg),
        "K3": (sc, xu, stage0, list(stages2), lg2),
    }
    rule = tail.tail_route
    for kname, ops in chains.items():
        xa, xb, s0, rest, logit_ops = ops
        whole = lambda: cs.run_tail(*ops)  # noqa: E731
        first = lambda: cs.run_tail(xa, xb, s0, [], None)  # noqa: E731
        mid = first()
        tail_rest = lambda: tail.packed_tail(mid, rest, logit_ops)  # noqa: E731
        ref = cs.run_tail(*ops, plain=True)
        for turn in ("rule", "fma", "fma", "rule"):
            if turn == "fma":
                tail.tail_route = lambda *a: "fma"
            try:
                before = stage_routes()
                got = whole()
                torch.cuda.synchronize()
                ran = {r: n - before[r] for r, n in stage_routes().items()
                       if n != before[r]}
                err, ok = cs.tail_check(got, ref, torch.float32)
                assert ok, f"{kname} {turn}: max|err| {err}"
                del got
                t = (cs.median_ms(whole, warmup=1, iters=5),
                     cs.median_ms(first, warmup=1, iters=5),
                     cs.median_ms(tail_rest, warmup=1, iters=5))
            finally:
                tail.tail_route = rule
            print(f"{kname} f32 [{turn}: {ran}] whole {t[0]:.4f} ms = stage 0 "
                  f"{t[1]:.4f} + the rest with the logits {t[2]:.4f}; "
                  f"max|err| {err:.6g} [{card_str}]", flush=True)
        plain_ms = cs.median_ms(lambda: cs.run_tail(*ops, plain=True),
                                warmup=1, iters=3)
        loose_ms = cs.median_ms(lambda: cs.unfused_tail(*ops), warmup=1,
                                iters=5)
        if kname == "K2":
            bnd, by = cs.tail_bound((xin,), ref, [[w] for w, _ in stages], lg[0])
        else:
            bnd, by = cs.tail_bound((sc, xu), ref, [[wa, wb]] + [
                [w] for w, _ in stages2], lg2[0])
        print(f"{kname} f32 tail (tile in {tin}): plain {plain_ms:.4f} ms; "
              f"unfused tail (cuDNN f32, TF32 off) {loose_ms:.4f} ms; bound "
              f"{bnd:.4f} ms ({by}) [{card_str}]", flush=True)
        del mid, ref
        torch.cuda.empty_cache()


def width_sweep(card_str: str) -> None:
    """The whole f32 tails with channel blocks of 64, 48 and 32 (one to
    eight consumer warps a block; ``tail_simt_plan`` patched), and the
    logits launch alone on the stage-1 output."""
    _, seen, _ = cs.tail_inputs(torch.float32)
    xin, stages, lg = seen["packed_tail"]
    sc, xu, stage0, stages2, lg2 = seen["packed_tail2"]
    chains = {"K2": (xin, None, (stages[0][0], None, stages[0][1]),
                     list(stages[1:]), lg),
              "K3": (sc, xu, stage0, list(stages2), lg2)}
    plan = tail.tail_simt_plan
    for kname, ops in chains.items():
        ref = cs.run_tail(*ops, plain=True)
        for width in (64, 48, 32, 32, 48, 64):
            tail.tail_simt_plan = (lambda dhw, co, _w=width:
                                   (*plan(dhw, co)[:3], _w, 0))
            try:
                err, ok = cs.tail_check(cs.run_tail(*ops), ref, torch.float32)
                assert ok, f"{kname} width {width}: max|err| {err}"
                ms = cs.median_ms(lambda: cs.run_tail(*ops), warmup=1, iters=5)
            finally:
                tail.tail_simt_plan = plan
            print(f"{kname} f32 whole tail, channel blocks of {width}: "
                  f"{ms:.4f} ms [{card_str}]", flush=True)
        mid = cs.run_tail(*ops[:3], ops[3], None)
        ms = cs.median_ms(lambda: tail.packed_tail(mid, [], ops[4]), warmup=1,
                          iters=5)
        print(f"{kname} f32 logits launch alone on {tuple(mid.shape)}: "
              f"{ms:.4f} ms [{card_str}]", flush=True)
        del ref, mid
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--quick", action="store_true",
                      help="checks only, no timing")
    mode.add_argument("--timing-only", action="store_true",
                      help="no checks (runs on the parent tree too)")
    mode.add_argument("--widths", action="store_true",
                      help="channel-block widths and the logits launch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card_str = cs.card()
    path, seconds = _build.build()
    _build.load_library()
    print(f"card: {card_str}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; build {seconds:.2f} s", flush=True)
    register_report(path)
    if args.widths:
        width_sweep(card_str)
        return
    if not args.timing_only:
        small_checks(card_str)
    k1_control(card_str, timed=not args.quick)
    if not args.quick:
        tail_timing(card_str)


if __name__ == "__main__":
    main()
