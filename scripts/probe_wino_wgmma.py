#!/usr/bin/env python3
"""Probe of K4's wgmma kernel (``csrc/wino_conv_wgmma.cu``) on one GPU.

    python3 scripts/probe_wino_wgmma.py [--quick]

Builds the kernels, prints the compiler's register/spill report of
``wino_wgmma_kernel`` and counts the compiler's performance warnings
(serialised wgmma) that name it, holds K4 against its plain version at
``chip_smoke``'s small shapes (ragged tiles, odd block counts, Ci = 24, a
16-channel rest, Ci and Co past 128, one case on the WMMA route), then,
unless ``--quick``, times the packed baseline's stage-B shapes ((64,36^3,32)
-> 48 and (64,34^3,48) -> 64 channels, unit-scale activations) beside the
WMMA kernel of ``wino_conv.cu``, K1's wgmma route at d = 1 and one cuDNN
call, with the dropped tap and the zeroed channel that must fail the check.
Asserts that the tile at the layer-3 shape fills the GEMM's 64 rows.
"""

import argparse
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from flypylib_tpu_torch.ops import _build  # noqa: E402
from flypylib_tpu_torch.ops import wino_conv as wino  # noqa: E402
from flypylib_tpu_torch.ops.conv import conv3d_bias_relu, k1_route  # noqa: E402

STAGE_B = (("layer 2", 64, 36, 32, 48), ("layer 3", 64, 34, 48, 64))


def time_stage_b(card):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, n, s, ci, co in STAGE_B:
        x = torch.relu(torch.randn((n, s, s, s, ci), generator=gen,
                                   device="cuda")).bfloat16()
        w = torch.randn((3, 3, 3, ci, co), generator=gen, device="cuda")
        w = w / math.sqrt(27 * ci)
        b = 0.1 * torch.randn((co,), generator=gen, device="cuda")
        u = wino.wino_transform_weights(w)
        blocks = ((s - 2) // 2,) * 3
        box = wino.wino_box(blocks)
        tiles = math.prod(-(-e // m) for e, m in zip(blocks, box))
        fill = math.prod(blocks) / (tiles * wino.WINO_ROWS)
        assert wino.wino_route(x, u) == "wgmma" and k1_route(x, w) == "wgmma"
        r = cs.wino_readings(x, u, b)
        ms = cs.median_ms(lambda: wino.wino_conv3d_bias_relu(x, u, b))
        rule, wino.wino_route = wino.wino_route, lambda *a: "wmma"
        try:
            wmma = cs.median_ms(lambda: wino.wino_conv3d_bias_relu(x, u, b),
                                warmup=1, iters=5)
        finally:
            wino.wino_route = rule
        k1 = cs.median_ms(lambda: conv3d_bias_relu(x, w, b, 1))
        lib = cs.median_ms(lambda: cs.cudnn_conv(x, w, b))
        out_numel = n * (s - 2) ** 3 * co
        bnd, by = cs.bound(2 * out_numel * ci * 8,
                           cs.nbytes(x, w.bfloat16(), b.bfloat16())
                           + 2 * out_numel)
        print(f"{label} x{tuple(x.shape)} -> Co {co} bf16, tile {box} of "
              f"2^3 blocks, {tiles} tiles a volume, rows filled {fill:.3f}: "
              + "; ".join(f"{k} {r[k][1]:.3g} ulps {'ok' if r[k][2] else 'FAIL'}"
                          for k in ("sound", "tap dropped", "channel zeroed"))
              + f"; kernel {ms:.4f} ms, WMMA kernel {wmma:.4f} ms, K1 wgmma "
              f"{k1:.4f} ms, cuDNN {lib:.4f} ms, bound {bnd:.4f} ms ({by}) "
              f"[{card}]", flush=True)
        assert r["sound"][2] and not r["tap dropped"][2]
        assert not r["channel zeroed"][2]
        if label == "layer 3":
            assert fill == 1.0, f"the layer-3 tile {box} leaves rows empty"
        del x
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the small shapes only, no timing")
    args = ap.parse_args()
    assert torch.cuda.is_available(), "needs an NVIDIA GPU"
    card = cs.card()
    path, seconds = _build.build()
    _build.load_library()
    log = path.with_suffix(".log").read_text().splitlines()
    for i, ln in enumerate(log):
        if "wino_" in ln and "_kernel" in ln and "Compiling" in ln:
            print(ln[-60:], "|", " ".join(log[i + 1:i + 4]))
    n = sum("Performance" in ln and "wino_wgmma_kernel" in ln for ln in log)
    print(f"ptxas performance warnings naming wino_wgmma_kernel: {n}")
    print(f"build {seconds:.1f} s [{card}]", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    cs.check_wino_small(card)
    if not args.quick:
        time_stage_b(card)


if __name__ == "__main__":
    main()
