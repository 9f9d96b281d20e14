#!/usr/bin/env python3
"""Probe of the decoder tail's wgmma stage kernel on one GPU.

    python3 scripts/probe_tail_wgmma.py [--quick]

Builds the kernels, prints the compiler's register/spill report of
``packed_tail_wgmma.cu``, counts the compiler's performance warnings
(serialised wgmma) per wgmma kernel, and holds K2 and K3 against their plain
versions at ``chip_smoke``'s small shapes (ragged boxes, odd extents, one
and two operands, a 16-channel rest, batch > 1, logits in the epilogue),
then, unless ``--quick``, times the main path's stages (132^3 cells, 240 or
192 + 48 channels into 192, then 192 into 192 with the logits) beside the
WMMA kernel of ``packed_tail.cu``.
"""

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from flypylib_tpu_torch.ops import _build, tail  # noqa: E402

run = chip_smoke.run_tail


def time_main(card):
    for ca, cb in ((240, 0), (192, 48)):
        ops = chip_smoke.tail_operands((1, 132, 132, 132), ca, cb, 192, 1, 8)
        xa, xb, stage0, stages, lg = ops
        got, ref = run(*ops), run(*ops, plain=True)
        err, ok = chip_smoke.tail_check(got, ref, torch.bfloat16)
        del ref
        s0 = chip_smoke.median_ms(lambda: run(xa, xb, stage0, [], None))
        mid = run(xa, xb, stage0, [], None)
        s1 = chip_smoke.median_ms(lambda: tail.packed_tail(mid, stages, lg))
        whole = chip_smoke.median_ms(lambda: run(*ops))
        print(f"  main path {ca}+{cb}: chain max|err| {err:.4g} "
              f"{'ok' if ok else 'FAIL'}; stage 0 {s0:.4f} ms, stage 1 + "
              f"logits {s1:.4f} ms, whole tail {whole:.4f} ms [{card}]",
              flush=True)
        assert ok
        del got, mid, ops, xa, xb
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the small shapes only, no timing")
    args = ap.parse_args()
    assert torch.cuda.is_available(), "needs an NVIDIA GPU"
    card = chip_smoke.card()
    path, seconds = _build.build()
    _build.load_library()
    log = path.with_suffix(".log").read_text().splitlines()
    for i, ln in enumerate(log):
        if "tail_wgmma_kernel" in ln and "Compiling" in ln:
            print(ln[-60:], "|", " ".join(log[i + 1:i + 4]))
    for fn in ("tail_wgmma_kernel", "conv_wgmma_kernel"):
        n = sum("Performance" in ln and fn in ln for ln in log)
        print(f"ptxas performance warnings naming {fn}: {n}")
    print(f"build {seconds:.1f} s [{card}]", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    print(f"rows per block {tail.TAIL_ROWS}, main-path boxes "
          f"{tail.tail_box((131, 131, 131))}, {tail.tail_box((130, 130, 130))}:",
          flush=True)
    chip_smoke.check_tail_small(card)
    if not args.quick:
        time_main(card)
        # the WMMA kernel of packed_tail.cu on the same operands
        ops = chip_smoke.tail_operands((1, 132, 132, 132), 240, 0, 192, 1, 8)
        wmma = tail.tail_route
        tail.tail_route = lambda *a: "wmma"
        try:
            t = chip_smoke.median_ms(lambda: run(*ops), warmup=1, iters=3)
        finally:
            tail.tail_route = wmma
        print(f"WMMA kernel, whole tail 240+0: {t:.4f} ms [{card}]")


if __name__ == "__main__":
    main()
