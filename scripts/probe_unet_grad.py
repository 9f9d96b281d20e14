#!/usr/bin/env python3
"""The plain U-Net's f32 gradient on one GPU, against an f64 truth, op by op.

    python3 scripts/probe_unet_grad.py

Runs ``chip_smoke.py`` phase 12(a)'s plain U-Net f32 case (seed-0 weights,
batch seed 1) and prints:

- the f32 precision settings PyTorch reports inside ``ops.conv.no_tf32``;
- every parameter's gradient error, max |g - g64| / max |g64|, against an
  f64 autograd of the same model on the CPU, for the port on the CPU, the
  port on the card, and plain autograd (cuDNN and cuBLAS alone) on the card;
- each op's error at the shapes and values of the card's own step: the
  weight and input gradients of every 3^3 conv (``torch.nn.grad``, as
  ``ops.conv.Conv3dBiasReLU.backward`` calls them) and of every
  ConvTranspose (autograd through its matmul), f32 under ``no_tf32``
  against f64, with cuDNN as configured, deterministic, and off.

Every op is f32-accurate, yet the card's gradients below a few layers are
not: the gap is the odd ReLU input within rounding of 0 that the card's
and the CPU's sums put on opposite sides.  ``chip_smoke.py`` phase 12(a)
counts those voxels and reads the gap with the CPU on the card's masks.
"""

import contextlib
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def precision_flags() -> str:
    names = ("backends.fp32_precision", "backends.cuda.matmul.fp32_precision",
             "backends.cudnn.fp32_precision",
             "backends.cudnn.conv.fp32_precision",
             "backends.cuda.matmul.allow_tf32", "backends.cudnn.allow_tf32")
    out = []
    for name in names:
        obj = torch
        try:
            for part in name.split("."):
                obj = getattr(obj, part)
        except AttributeError:
            obj = "absent"
        out.append(f"{name}={obj}")
    out.append(f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    return ", ".join(out)


def conv(x, w, b, d):
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), dilation=d)
    return torch.relu(y.permute(0, 2, 3, 4, 1) + b)


def convt(x, w, b):
    from flypylib_tpu_torch.ops.packed_conv import (convT_packed_weight,
                                                    unpack_volume)
    return unpack_volume(x @ convT_packed_weight(w) + b.repeat(8))


def unet_forward(mod, P, x, taps=None):
    """``UNetValid.forward`` in plain autograd, in the dtype of ``P``; every
    op's output, its gradient retained, is appended to ``taps``."""
    from flypylib_tpu_torch.models.zoo import _max_pool2

    cps, i, skips = mod.convs_per_stage, iter(range(len(mod.convs))), []

    def tap(label, t):
        if taps is not None:
            t.retain_grad()
            taps.append((label, t))
        return t

    def c(x):
        k = next(i)
        return tap(f"conv {k}", conv(x, P[f"convs.{k}.weight"],
                                     P[f"convs.{k}.bias"], 1))

    for _ in range(mod.levels):
        for _ in range(cps):
            x = c(x)
        skips.append(x)
        x = tap(f"pool {len(skips) - 1}", _max_pool2(x))
    for _ in range(cps):
        x = c(x)
    for j, skip in enumerate(reversed(skips)):
        x = tap(f"convt {j}", convt(x, P[f"convts.{j}.weight"],
                                    P[f"convts.{j}.bias"]))
        o = [(skip.shape[a] - x.shape[a]) // 2 for a in (1, 2, 3)]
        skip = skip[:, o[0]:o[0] + x.shape[1], o[1]:o[1] + x.shape[2],
                    o[2]:o[2] + x.shape[3]]
        x = tap(f"cat {j}", torch.cat([skip, x], -1))
        for _ in range(cps):
            x = c(x)
    return tap("logits", x @ P["logits.weight"] + P["logits.bias"])


def autograd_grads(mod, batch, device, dt, taps=None):
    """Loss gradients of plain autograd through :func:`unet_forward`."""
    from flypylib_tpu_torch.ops.augment import augment_batch
    from flypylib_tpu_torch.ops.conv import no_tf32

    P = {n: p.detach().to(device, dt).requires_grad_()
         for n, p in mod.named_parameters()}
    x, y, m, codes = (torch.from_numpy(a).to(device) for a in batch)
    x, y, m = (augment_batch(v.to(dt), codes) for v in (x, y, m))
    with no_tf32(torch.device(device)):
        lg = unet_forward(mod, P, x[..., None], taps)[..., 0]
        bce = -y * F.logsigmoid(lg) - (1 - y) * F.logsigmoid(-lg)
        ((bce * m).sum() / m.sum().clamp(min=1)).backward()
    return {n: p.grad.detach().double().cpu() for n, p in P.items()}


def errors(got, want):
    return {n: float((got[n].double() - w).abs().max() / w.abs().max())
            for n, w in want.items()}


def capture_ops(spec, batch):
    """The card's plain U-Net step, with every conv's (x, w, y, dy) and
    every ConvTranspose's (x, w, b, dy) kept for the op readings."""
    from flypylib_tpu_torch.models.zoo import Conv3BiasReLU, ConvTranspose2

    ops = []

    def hook(mod, inp, out):
        rec = {"mod": mod, "x": inp[0].detach(), "y": out.detach()}
        ops.append(rec)
        out.register_hook(lambda g: rec.__setitem__("dy", g.detach()))

    hs = [m.register_forward_hook(hook) for m in spec.module.modules()
          if isinstance(m, (Conv3BiasReLU, ConvTranspose2))]
    try:
        cs.train_grads(spec, "plain", batch, "cuda")
    finally:
        for h in hs:
            h.remove()
    return ops


def op_grads(rec, dt):
    """(dw, dx) of one captured op in ``dt``, on the card, TF32 off."""
    from flypylib_tpu_torch.models.zoo import Conv3BiasReLU
    from flypylib_tpu_torch.ops.conv import no_tf32

    mod, x, dy = rec["mod"], rec["x"].to(dt), rec["dy"].to(dt)
    w = mod.weight.detach().to(dt)
    with no_tf32(x.device):
        if isinstance(mod, Conv3BiasReLU):
            g = (dy * (rec["y"] > 0)).permute(0, 4, 1, 2, 3)
            xn, wn = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)
            d = mod.dilation
            dw = torch.nn.grad.conv3d_weight(xn, wn.shape, g, dilation=d)
            dx = torch.nn.grad.conv3d_input(xn.shape, wn, g, dilation=d)
            return dw, dx
        x, w = x.requires_grad_(), w.requires_grad_()
        y = convt(x, w, mod.bias.detach().to(dt))
        dx, dw = torch.autograd.grad(y, (x, w), dy)
        return dw, dx


def rel(a, b):
    return float((a.double() - b).abs().max() / b.abs().max())


def main() -> int:
    cs.require(torch.cuda.is_available(), "needs an NVIDIA GPU")
    port = cs.import_port()
    card_str = cs.card()
    from flypylib_tpu_torch.ops import _build
    from flypylib_tpu_torch.ops.conv import no_tf32

    _build.build()
    _build.load_library()
    print(f"torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}")
    print(f"outside no_tf32: {precision_flags()}")
    with no_tf32(torch.device("cuda")):
        print(f"inside no_tf32: {precision_flags()}", flush=True)

    cpu, gpu = cs.grad_case_specs(port, "unet", torch.float32)
    patch, n = cs.grad_patch("unet", cpu)
    batch = cs.grad_batch(1, n, patch, cpu.context)
    g64 = autograd_grads(cpu.module, batch, "cpu", torch.float64)
    _, g_cpu, _ = cs.train_grads(cpu, "plain", batch, "cpu")
    _, g_card, _ = cs.train_grads(gpu, "plain", batch, "cuda")
    g_auto = autograd_grads(gpu.module, batch, "cuda", torch.float32)
    cols = {"port CPU": errors(g_cpu, g64), "port card": errors(g_card, g64),
            "autograd card": errors(g_auto, g64)}
    print(f"plain U-Net f32 (patch {patch}, batch {n}), max |g - g64| / "
          f"max |g64| per parameter [{card_str}]")
    print(f"{'parameter':18s}" + "".join(f"{c:>15s}" for c in cols))
    for name in g64:
        print(f"{name:18s}" + "".join(f"{cols[c][name]:15.3g}" for c in cols))
    print("worst" + " " * 13 + "".join(
        f"{max(cols[c].values()):15.3g}" for c in cols), flush=True)

    ops = capture_ops(gpu, batch)
    modes = {
        "cuDNN as set": contextlib.nullcontext,
        "deterministic": lambda: torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True),
        "cuDNN off": lambda: torch.backends.cudnn.flags(enabled=False),
    }
    print(f"op by op on the card, f32 against f64, dw / dx [{card_str}]")
    print(f"{'op':34s}" + "".join(f"{m:>24s}" for m in modes))
    for rec in ops:
        w64, x64 = op_grads(rec, torch.float64)
        line = []
        for mode in modes.values():
            with mode():
                w32, x32 = op_grads(rec, torch.float32)
            line.append(f"{rel(w32, w64):10.3g} /{rel(x32, x64):10.3g}")
        label = (f"{type(rec['mod']).__name__} {tuple(rec['x'].shape)}"
                 f"->{rec['y'].shape[-1]}")
        print(f"{label:34s}" + "".join(f"{s:>24s}" for s in line), flush=True)
    print(f"card: {cs.card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
