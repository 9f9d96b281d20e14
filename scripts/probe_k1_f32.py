#!/usr/bin/env python3
"""Probe of K1's f32 kernel ("simt", ``csrc/conv3d_f32.cu``) on one GPU.

    python3 scripts/probe_k1_f32.py [--quick]

Builds the kernels, prints the compiler's register/spill report of
``conv_f32_kernel``, holds the kernel against its plain version at small
shapes (d = 1-4 and 7, Co = 8 to 136 in one to three channel blocks,
ragged boxes, ``relu=False``) and with the centre tap zeroed (which must
fail), and checks that two launches give the same bits and that the
output of a sub-window of the input is bit for bit the overlap of the full
output.  Then, unless ``--quick``, at the main path's f32 shapes (phase 3's
K1 cases with Ci > 1: the baseline's layers 1-3, ``vgg_like``'s layer 6 and
the plain U-Net's convs 1-9 at ``default_tiling``'s tile and batch for a
256^3 volume) it times the kernel beside the first-version FMA kernel on
the same values (the input copied 4 bytes off a 16-byte boundary, which
``k1_route`` sends to "fma"), the plain version, one cuDNN f32 call (TF32
off) and the bound at 67 TFLOP/s.
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
from flypylib_tpu_torch.ops.conv import (conv3d_bias_relu,  # noqa: E402
                                         conv3d_reference, k1_route,
                                         simt_plan)

SMALL = (  # (B, (D, H, W), Ci, Co, d, relu)
    (2, (13, 17, 22), 24, 32, 1, True), (2, (15, 16, 21), 32, 48, 2, True),
    (1, (19, 18, 20), 48, 64, 3, True), (2, (17, 17, 26), 64, 96, 4, True),
    (1, (15, 15, 15), 8, 8, 1, False), (2, (13, 17, 22), 12, 136, 2, False),
    (1, (21, 20, 19), 4, 24, 7, True), (2, (11, 12, 30), 16, 20, 1, True),
)


def operands(B, dhw, ci, co, gen):
    x = torch.relu(torch.randn((B, *dhw, ci), generator=gen, device="cuda"))
    w = torch.randn((3, 3, 3, ci, co), generator=gen,
                    device="cuda") / math.sqrt(27 * ci)
    b = 0.1 * torch.randn((co,), generator=gen, device="cuda")
    return x, w, b


def off_boundary(x: torch.Tensor) -> torch.Tensor:
    """``x``'s values in a contiguous view 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.reshape(-1)
    return buf[1:].view(x.shape)


def bitwise_checks(gen) -> None:
    """Two launches give the same bits; a sub-window's output is the
    overlap of the full output, bit for bit (another box grid, another
    place in the box for every voxel)."""
    x, w, b = operands(2, (30, 29, 41), 32, 48, gen)
    d = 2
    full = conv3d_bias_relu(x, w, b, d)
    again = conv3d_bias_relu(x, w, b, d)
    sub = x[:, 3:25, 5:28, 7:38].contiguous()
    part = conv3d_bias_relu(sub, w, b, d)
    torch.cuda.synchronize()
    want = full[:, 3:3 + part.shape[1], 5:5 + part.shape[2], 7:7 + part.shape[3]]
    print(f"  repeat bitwise: {torch.equal(full, again)}; sub-window "
          f"{tuple(sub.shape)} plan {simt_plan(tuple(part.shape[1:4]), d, 48)} "
          f"against {simt_plan(tuple(full.shape[1:4]), d, 48)}: bitwise "
          f"{torch.equal(part, want)}", flush=True)
    assert torch.equal(full, again) and torch.equal(part, want)


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
        if "conv_f32_kernel" in ln and "Compiling" in ln:
            print(ln[-60:], "|", " ".join(log[i + 1:i + 4]))
    print(f"build {seconds:.1f} s [{card}]", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, dhw, ci, co, d, relu in SMALL:
        x, w, b = operands(B, dhw, ci, co, gen)
        assert k1_route(x, w, d) == "simt"
        got = conv3d_bias_relu(x, w, b, d, relu)
        torch.cuda.synchronize()
        ref = conv3d_reference(x, w, b, d, relu)
        err, ok = cs.conv_check(got, ref)
        wz = w.clone()
        wz[1, 1, 1] = 0
        _, bad_ok = cs.conv_check(conv3d_bias_relu(x, wz, b, d, relu), ref)
        plan = simt_plan(tuple(ref.shape[1:4]), d, co)
        print(f"  {tuple(x.shape)} Co {co} d {d} relu {relu} plan {plan}: "
              f"max|err| {err:.4g} {'ok' if ok else 'FAIL'}; centre tap "
              f"zeroed {'passes (FAULT)' if bad_ok else 'fails'}", flush=True)
        assert ok and not bad_ok
    bitwise_checks(gen)
    if args.quick:
        return
    sums = {}
    for label, B, s, ci, co, d in cs.conv_cases():
        if ci == 1 or label.startswith("wide"):
            continue
        x, w, b = operands(B, (s, s, s), ci, co, gen)
        xm = off_boundary(x)
        assert k1_route(x, w, d) == "simt" and k1_route(xm, w, d) == "fma"
        got = conv3d_bias_relu(x, w, b, d)
        ref = conv3d_reference(x, w, b, d)
        err, ok = cs.conv_check(got, ref)
        old_ok = torch.equal(conv3d_bias_relu(xm, w, b, d), got)
        ms = cs.median_ms(lambda: conv3d_bias_relu(x, w, b, d))
        old = cs.median_ms(lambda: conv3d_bias_relu(xm, w, b, d))
        plain = cs.median_ms(lambda: conv3d_reference(x, w, b, d))
        lib = cs.median_ms(lambda: cs.cudnn_conv(x, w, b, d))
        bnd, by = cs.bound(2 * 27 * ci * got.numel(),
                           cs.nbytes(x, w, b, got), torch.float32)
        print(f"{label} x{tuple(x.shape)} -> Co {co} d={d} f32 plan "
              f"{simt_plan(tuple(got.shape[1:4]), d, co)}: max|err| {err:.4g} "
              f"{'ok' if ok else 'FAIL'} (first version bitwise equal: "
              f"{old_ok}); simt {ms:.4f} ms, first version {old:.4f} ms, "
              f"plain {plain:.4f} ms, cuDNN {lib:.4f} ms, bound {bnd:.4f} ms "
              f"({by}); {bnd / ms:.1%} of the FMA rate [{card}]", flush=True)
        assert ok
        group = label.split(" ")[0]
        tot = sums.setdefault(group, [0.0] * 5)
        for i, v in enumerate((ms, old, plain, lib, bnd)):
            tot[i] += v
        del x, xm, got, ref
        torch.cuda.empty_cache()
    for group, (ms, old, plain, lib, bnd) in sums.items():
        print(f"{group} summed, f32: simt {ms:.4f} ms, first version "
              f"{old:.4f}, plain {plain:.4f}, cuDNN {lib:.4f}, bound {bnd:.4f} "
              f"({bnd / ms:.1%} of the FMA rate) [{card}]")


if __name__ == "__main__":
    main()
