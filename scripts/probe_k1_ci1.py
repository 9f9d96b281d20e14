#!/usr/bin/env python3
"""Probe of K1's Ci = 1 kernel on one GPU.

    python3 scripts/probe_k1_ci1.py [--quick]

Builds the kernels, prints the compiler's register/spill report of
``conv_ci1_kernel``, holds the kernel against its plain version at small
shapes (d = 1, 2, 3 and a dilation whose halo does not fit shared memory;
Co = 7, 24, 32, 129, 136, 192; f32 and bf16; ragged extents) and with one
tap zeroed (which must fail), then, unless ``--quick``, times it at the main
path's shapes (baseline L0, ``vgg_like`` L0, U-Net conv 0) beside one cuDNN
call and the bound.
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
from flypylib_tpu_torch.ops.conv import (ci1_plan, conv3d_bias_relu,  # noqa: E402
                                         conv3d_reference, k1_route)

SMALL = (  # (B, (D, H, W), Co, d)
    (2, (13, 17, 22), 24, 1), (2, (13, 17, 22), 7, 2), (1, (21, 21, 21), 192, 3),
    (2, (15, 16, 21), 129, 1), (1, (9, 40, 41), 32, 1), (1, (15, 16, 70), 136, 2),
    (1, (45, 46, 47), 24, 20),
)
MAIN = (("baseline L0", 8, 76, 24), ("vgg_like L0", 8, 94, 32),
        ("unet conv 0", 1, 296, 24))


def operands(B, dhw, co, dtype, gen):
    x = torch.randint(0, 256, (B, *dhw, 1), generator=gen, device="cuda").to(dtype)
    w = torch.randn((3, 3, 3, 1, co), generator=gen, device="cuda") / math.sqrt(27)
    b = 0.1 * torch.randn((co,), generator=gen, device="cuda")
    return x, w, b


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
        if "conv_ci1_kernel" in ln and "Compiling" in ln:
            print(ln[-70:], "|", " ".join(log[i + 1:i + 4]))
    print(f"build {seconds:.1f} s [{card}]", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, dhw, co, d in SMALL:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = operands(B, dhw, co, dtype, gen)
            assert k1_route(x, w) == "ci1"
            got = conv3d_bias_relu(x, w, b, d)
            torch.cuda.synchronize()
            ref = conv3d_reference(x, w, b, d)
            err, ok = cs.conv_check(got, ref)
            wz = w.clone()
            wz[1, 1, 1] = 0
            _, bad_ok = cs.conv_check(conv3d_bias_relu(x, wz, b, d), ref)
            plan = ci1_plan(tuple(ref.shape[1:4]), d)
            print(f"  {tuple(x.shape)} Co {co} d {d} {dtype} plan {plan}: "
                  f"max|err| {err:.4g} {'ok' if ok else 'FAIL'}; centre tap "
                  f"zeroed {'passes (FAULT)' if bad_ok else 'fails'}",
                  flush=True)
            assert ok and not bad_ok
    if args.quick:
        return
    for label, B, s, co in MAIN:
        x, w, b = operands(B, (s, s, s), co, torch.bfloat16, gen)
        got = conv3d_bias_relu(x, w, b, 1)
        err, ok = cs.conv_check(got, conv3d_reference(x, w, b, 1))
        ms = cs.median_ms(lambda: conv3d_bias_relu(x, w, b, 1))
        lib = cs.median_ms(lambda: cs.cudnn_conv(x, w, b))
        bnd, by = cs.bound(2 * 27 * got.numel(), cs.nbytes(x, w, b, got))
        print(f"{label} x{tuple(x.shape)} -> Co {co} bf16 plan "
              f"{ci1_plan(tuple(got.shape[1:4]), 1)}: max|err| {err:.4g} "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, cuDNN {lib:.4f} "
              f"ms, bound {bnd:.4f} ms ({by}) [{card}]", flush=True)
        assert ok
        del x, got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
