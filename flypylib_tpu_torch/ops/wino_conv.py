"""Winograd F(2x2x2, 3x3x3) conv3d + bias + ReLU — the port of K4.

Counterpart of ``flypylib_tpu/ops/wino_conv.py``: K1's valid dilation-1
3^3 conv computed with 64 transform-domain products per 2^3 output block
instead of 216 direct taps.  As in the reference, nothing on the
inference path calls it: it is a ported op, held against its plain version
and timed beside K1 at the packed baseline's stage-B shapes by
``chip_smoke.py``.

On a CUDA tensor :func:`wino_conv3d_bias_relu` launches the hand-written
kernel in ``csrc/wino_conv.cu`` (built by ``ops/_build.py`` on first use);
on a CPU tensor it runs the plain version, :func:`wino_reference`.  There
is no fallback between the two: a CUDA tensor the kernel cannot take
raises, and odd spatial extents raise on both devices (the reference's
"callers fall back to the direct conv" is the caller's business).

Rounding points, the reference kernel's (``wino_conv.py:105-178``): the
input transform runs per axis, z then y then x, each stage one signed sum
of two ``x.dtype`` values rounded to ``x.dtype``; ``U`` is rounded to
``x.dtype`` once; each tap's products are summed in f32 and folded into the
eight output phases with the inverse transform's +-1 in f32, tap by tap;
then the f32 of the dtype bias, ReLU and one rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from flypylib_tpu_torch.ops.conv import matmul_f32

# F(2, 3) transform matrices (exact in binary floating point)
BT = np.array(
    [[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]], np.float32
)
G = np.array(
    [[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]], np.float32
)
AT = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], np.float32)

# BT row -> ((position, sign) x2) of its two nonzeros
_BT_TERMS = [tuple((p, int(BT[r, p])) for p in range(4) if BT[r, p])
             for r in range(4)]
# AT column -> ((output phase, sign), ...)
_AT_TERMS = [tuple((g, int(AT[g, r])) for g in range(2) if AT[g, r])
             for r in range(4)]
_DTYPES = (torch.float32, torch.bfloat16)
MAX_C = 128  # the kernel's limit on Ci and Co


def wino_transform_weights(w: torch.Tensor) -> torch.Tensor:
    """(3,3,3,Ci,Co) valid-conv kernel -> (64, Ci, Co) transform-domain
    weights ``U = (G (x) G (x) G) w`` in f32 (cast to the compute dtype at
    call time).  G's entries are 0, +-1/2 and 1, so the sums are taken in
    f64, where they are exact, and rounded to f32 once."""
    g = torch.from_numpy(G).to(w.device, torch.float64)
    u = torch.einsum("az,by,cx,zyxio->abcio", g, g, g, w.to(torch.float64))
    return u.reshape(64, w.shape[3], w.shape[4]).float()


def _check(x: torch.Tensor, u: torch.Tensor, b: torch.Tensor) -> tuple[int, ...]:
    if x.dim() != 5:
        raise ValueError(f"x must be (N, D, H, W, Ci), got {tuple(x.shape)}")
    N, D, H, W, Ci = x.shape
    if D % 2 or H % 2 or W % 2:
        raise ValueError(f"winograd needs even spatial dims, got {tuple(x.shape)}")
    if min(D, H, W) < 4:
        raise ValueError(f"input {tuple(x.shape)} smaller than two 3^3 outputs")
    if u.dim() != 3 or tuple(u.shape[:2]) != (64, Ci):
        raise ValueError(f"u must be (64, {Ci}, Co), got {tuple(u.shape)}")
    Co = u.shape[2]
    if tuple(b.shape) != (Co,):
        raise ValueError(f"b must be ({Co},), got {tuple(b.shape)}")
    return N, D - 2, H - 2, W - 2, Co


def _bt(t: torch.Tensor, axis: int, m: int) -> list[torch.Tensor]:
    """The four rows of B^T along ``axis`` (extent 2m + 2) of ``t``: each a
    signed sum of two slices at stride 2, rounded to ``t.dtype`` once, as
    the reference's ``_bt_combine`` spells it."""
    def at(p):  # positions p, p + 2, ..., p + 2(m - 1)
        idx = [slice(None)] * t.dim()
        idx[axis] = slice(p, p + 2 * m - 1, 2)
        return t[tuple(idx)]

    rows = []
    for (p0, s0), (p1, s1) in _BT_TERMS:
        a, b = at(p0), at(p1)
        if s0 > 0 and s1 > 0:
            rows.append(a + b)
        elif s0 > 0:
            rows.append(a - b)
        elif s1 > 0:
            rows.append(b - a)
        else:
            rows.append(-(a + b))
    return rows


def wino_reference(x: torch.Tensor, u: torch.Tensor, b: torch.Tensor,
                   relu: bool = True) -> torch.Tensor:
    """Plain version of :func:`wino_conv3d_bias_relu`, with its rounding
    points: (N, D, H, W, Ci) -> (N, D-2, H-2, W-2, Co) in ``x.dtype``."""
    N, Do, Ho, Wo, Co = _check(x, u, b)
    dt = x.dtype
    md, mh, mw = Do // 2, Ho // 2, Wo // 2
    ud = u.to(dt)
    acc = [torch.zeros((N, md, mh, mw, Co), dtype=torch.float32,
                       device=x.device) for _ in range(8)]
    t1 = _bt(x, 1, md)
    for A in range(4):
        t2 = _bt(t1[A], 2, mh)
        for B in range(4):
            v = _bt(t2[B], 3, mw)
            for C in range(4):
                m = matmul_f32(v[C], ud[(A * 4 + B) * 4 + C])
                for gz, sz in _AT_TERMS[A]:
                    for gy, sy in _AT_TERMS[B]:
                        for gx, sx in _AT_TERMS[C]:
                            g = (gz * 2 + gy) * 2 + gx
                            if sz * sy * sx > 0:
                                acc[g] = acc[g] + m
                            else:
                                acc[g] = acc[g] - m
    bias = b.to(dt).float()
    y = torch.stack([a + bias for a in acc])
    if relu:
        y = torch.relu(y)
    # phase-major (gz, gy, gx, N, z, y, x, Co) -> interleaved NDHWC
    y = y.to(dt).reshape(2, 2, 2, N, md, mh, mw, Co)
    y = y.permute(3, 4, 0, 5, 1, 6, 2, 7)
    return y.reshape(N, Do, Ho, Wo, Co).contiguous()


def wino_conv3d_bias_relu(x: torch.Tensor, u: torch.Tensor, b: torch.Tensor,
                          relu: bool = True) -> torch.Tensor:
    """Fused valid 3^3 conv via Winograd F(2,3)^3 (+ bias + optional ReLU).

    x: (N, D, H, W, Ci) with D, H, W even, bf16 or f32; u: (64, Ci, Co)
    from :func:`wino_transform_weights`; b: (Co,).  Returns (N, D-2, H-2,
    W-2, Co) in ``x.dtype``.  A CPU tensor runs :func:`wino_reference`; a
    CUDA tensor launches the kernel (and adds one to
    ``wino_conv3d_bias_relu.launches``) or raises."""
    shape = _check(x, u, b)
    if x.device.type == "cpu":
        return wino_reference(x, u, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"no wino_conv3d_bias_relu for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if u.device != x.device or b.device != x.device:
        raise ValueError("x, u and b must be on the same device")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NDHWC)")
    ci, co = u.shape[1], u.shape[2]
    if ci > MAX_C or co > MAX_C:
        raise ValueError(f"Ci and Co must be <= {MAX_C}, got {ci} and {co}")
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:  # N == 0: a launch with an empty grid is refused
        return out

    from flypylib_tpu_torch.ops._build import load_library

    lib = load_library()
    # U in x's dtype, zero-padded to multiples of 16 for the tensor cores
    up = torch.zeros((64, -(-ci // 16) * 16, -(-co // 16) * 16),
                     dtype=x.dtype, device=x.device)
    up[:, :ci, :co] = u.to(x.dtype)
    bc = b.to(x.dtype).contiguous()
    N, D, H, W, _ = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fpl_wino_conv(x.data_ptr(), up.data_ptr(), bc.data_ptr(),
                                out.data_ptr(), N, D, H, W, ci, co, int(relu),
                                int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"wino_conv kernel launch failed: cudaError {err}")
    wino_conv3d_bias_relu.launches += 1
    return out


wino_conv3d_bias_relu.launches = 0
