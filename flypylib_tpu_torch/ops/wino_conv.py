"""Winograd F(2x2x2, 3x3x3) conv3d + bias + ReLU — the port of K4.

Counterpart of ``flypylib_tpu/ops/wino_conv.py``: K1's valid dilation-1
3^3 conv computed with 64 transform-domain products per 2^3 output block
instead of 216 direct taps.  As in the reference, nothing on the
inference path calls it: it is a ported op, held against its plain version
and timed beside K1 at the packed baseline's stage-B shapes by
``chip_smoke.py``.

On a CUDA tensor :func:`wino_conv3d_bias_relu` launches a hand-written
kernel (built by ``ops/_build.py`` on first use); on a CPU tensor it runs
the plain version, :func:`wino_reference`.  There is no fallback between
the two: a CUDA tensor the kernel cannot take raises, and odd spatial
extents raise on both devices (the reference's "callers fall back to the
direct conv" is the caller's business).

Which kernel takes a CUDA call is a rule on dtype, widths and alignment,
decided before the launch (:func:`wino_route`): bf16 with Ci and Co
multiples of 8 and a 16-byte-aligned ``x`` runs the wgmma/TMA kernel of
``csrc/wino_conv_wgmma.cu`` ("wgmma"); ``csrc/wino_conv.cu`` keeps the
other bf16 calls ("wmma") and f32 ("fma").  Every route takes any Ci and
Co, as the reference does: a layer wider than a kernel's widest block of
output channels runs as one launch per block (``ops/conv.py::
wgmma_chunks``: Co = 136 on the wgmma kernel as 48 + 48 + 40), and
the kernels loop over Ci themselves.

Rounding points, the reference kernel's (``wino_conv.py:105-178``): the
input transform runs per axis, z then y then x, each stage one signed sum
of two ``x.dtype`` values rounded to ``x.dtype``; ``U`` is rounded to
``x.dtype`` once; each tap's products are summed in f32 and folded into the
eight output phases with the inverse transform's +-1 in f32, tap by tap;
then the f32 of the dtype bias, ReLU and one rounding.  The wgmma kernel
rounds at the same points and takes the f32 sums in another order (the x
axis of the inverse transform inside the products' own accumulation, per
32-channel slice); ``tests/test_torch_wino_route.py`` holds a model of that
order against :func:`wino_reference`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from flypylib_tpu_torch.ops.conv import (matmul_f32, weight_images,
                                         wgmma_chunks)

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
WINO_ROUTES = ("wgmma", "wmma", "fma")
WINO_ROWS = 64  # 2^3 output blocks per tile of the wgmma kernel, at most
WINO_HALO_VOXELS = 1100  # input voxels of a tile's halo it has room for
WINO_N_TILES = (48, 64)  # the wgmma kernel's N tiles
WINO_CO_BLOCK = 128  # output channels per launch of the WMMA and FMA kernels


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


def wino_route(x: torch.Tensor, u: torch.Tensor) -> str:
    """Which of K4's CUDA kernels takes ``x`` (N, D, H, W, Ci) and ``u``
    (64, Ci, Co): "fma" for f32; "wgmma" for bf16 with Ci and Co multiples
    of 8 and ``x`` on a 16-byte boundary (the TMA tensor map's rules; U is
    repacked, so its alignment does not matter); "wmma" for every other
    bf16 call."""
    ci, co = u.shape[1], u.shape[2]
    if x.dtype != torch.bfloat16:
        return "fma"
    if ci % 8 == 0 and co % 8 == 0 and x.data_ptr() % 16 == 0:
        return "wgmma"
    return "wmma"


def wino_images(u: torch.Tensor,
                n_tile: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The images of ``u`` (64, Ci, Co) the wgmma kernel loads, one box per
    step (A, B) and K slice: ``weight_images(u, n_tile)`` with the four
    taps C of a step side by side, ``u32[4 A + B, s, C] = w32[16 A + 4 B +
    C, s]`` of shape (16, n_full, 4, n_tile, 32); ``u16`` (64, n_tile, 16)
    already keeps them so."""
    u32, u16 = weight_images(u, n_tile)
    u32 = u32.view(16, 4, *u32.shape[1:]).transpose(1, 2).contiguous()
    return u32, u16


@functools.lru_cache(maxsize=256)
def wino_box(blocks_dhw: tuple[int, int, int]) -> tuple[int, int, int]:
    """The tile (mz, my, mx) of 2^3 output blocks one block of the wgmma
    kernel owns, for a grid of ``blocks_dhw`` output blocks: no side past
    the grid's, mz*my*mx <= WINO_ROWS and the halo (2mz+2)(2my+2)(2mx+2)
    <= WINO_HALO_VOXELS; of those the tile that covers the grid in the
    fewest tiles (the GEMM rows best filled), then the one with the
    smallest halo."""
    MD, MH, MW = blocks_dhw
    best = None
    for mz in range(1, min(MD, WINO_ROWS) + 1):
        for my in range(1, min(MH, WINO_ROWS // mz) + 1):
            for mx in range(1, min(MW, WINO_ROWS // (mz * my)) + 1):
                halo = (2 * mz + 2) * (2 * my + 2) * (2 * mx + 2)
                if halo > WINO_HALO_VOXELS:
                    continue
                tiles = -(-MD // mz) * -(-MH // my) * -(-MW // mx)
                if best is None or (tiles, halo) < best[0]:
                    best = ((tiles, halo), (mz, my, mx))
    return best[1]


def wino_conv3d_bias_relu(x: torch.Tensor, u: torch.Tensor, b: torch.Tensor,
                          relu: bool = True) -> torch.Tensor:
    """Fused valid 3^3 conv via Winograd F(2,3)^3 (+ bias + optional ReLU).

    x: (N, D, H, W, Ci) with D, H, W even, bf16 or f32; u: (64, Ci, Co)
    from :func:`wino_transform_weights`; b: (Co,).  Returns (N, D-2, H-2,
    W-2, Co) in ``x.dtype``.  A CPU tensor runs :func:`wino_reference`; a
    CUDA tensor launches the kernel that :func:`wino_route` names (and adds
    one to ``wino_conv3d_bias_relu.launches`` and to that route's
    ``wino_conv3d_bias_relu.routes``) or raises."""
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
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:  # N == 0: a launch with an empty grid is refused
        return out

    from flypylib_tpu_torch.ops._build import load_library

    lib = load_library()
    route = wino_route(x, u)
    ud = u.to(x.dtype)
    bc = b.to(x.dtype).contiguous()
    N, D, H, W, _ = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "wgmma":
            mz, my, mx = wino_box((shape[1] // 2, shape[2] // 2, shape[3] // 2))
            for c0, cn in wgmma_chunks(co, WINO_N_TILES[-1]):
                n_tile = next(n for n in WINO_N_TILES if n >= cn)
                u32, u16 = wino_images(ud[:, :, c0:c0 + cn], n_tile)
                err = lib.fpl_wino_conv_wgmma(
                    x.data_ptr(), u32.data_ptr() if u32.numel() else None,
                    u16.data_ptr() if u16 is not None else None,
                    bc[c0:].data_ptr(), out[..., c0:].data_ptr(), N, D, H, W,
                    ci, cn, co, int(relu), n_tile, mz, my, mx, stream)
                if err != 0:
                    break
        else:
            for c0, cn in wgmma_chunks(co, WINO_CO_BLOCK, 16):
                # the block of U, zero-padded to multiples of 16
                up = torch.zeros((64, -(-ci // 16) * 16, -(-cn // 16) * 16),
                                 dtype=x.dtype, device=x.device)
                up[:, :ci, :cn] = ud[:, :, c0:c0 + cn]
                err = lib.fpl_wino_conv(
                    x.data_ptr(), up.data_ptr(), bc[c0:].data_ptr(),
                    out[..., c0:].data_ptr(), N, D, H, W, ci, cn, co,
                    int(relu), int(x.dtype == torch.bfloat16), stream)
                if err != 0:
                    break
    if err != 0:
        raise RuntimeError(f"wino_conv kernel launch failed ({route} route): "
                           f"cudaError {err}")
    wino_conv3d_bias_relu.launches += 1
    wino_conv3d_bias_relu.routes[route] += 1
    return out


wino_conv3d_bias_relu.launches = 0
wino_conv3d_bias_relu.routes = dict.fromkeys(WINO_ROUTES, 0)
