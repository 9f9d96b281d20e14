"""Space-to-depth packing, in PyTorch: the pieces the packed U-Net needs.

Counterpart of ``flypylib_tpu/ops/packed_conv.py`` (``pack_volume``,
``unpack_volume``, ``_tap_matrix``, ``pack_weight_d1``), plus
``convT_packed_weight`` of ``ops/packed_unet.py``.  A volume is
packed 2x2x2 -> 8 channels; a valid 3^3 conv on the full lattice is then a
valid 2^3 conv on the packed lattice with 8x the channels, whose kernel
embeds the 27 original taps exactly (the other slots are zeros).

The reference spells pack and unpack twice (one 8-D transpose, and the
per-axis ``_iv`` forms chosen for TPU layouts); both give the same values,
so the port has one of each.  The reference's custom VJPs belong to
training and are not ported.
"""

from __future__ import annotations

import functools
from itertools import product

import numpy as np
import torch

_PARITY = list(product(range(2), repeat=3))  # (pz, py, px), px fastest


def pack_volume(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, D/2, H/2, W/2, 8C); dims must be even.

    Packed channel index = ((pz*2 + py)*2 + px)*C + c: cell r and parity p
    encode the original position 2r + p on each axis."""
    b, d, h, w, c = x.shape
    if d % 2 or h % 2 or w % 2:
        raise ValueError(f"pack_volume needs even spatial dims, got {tuple(x.shape)}")
    x = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, d // 2, h // 2, w // 2, 8 * c)


def unpack_volume(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_volume`: (B, D, H, W, 8C) -> (B, 2D, 2H, 2W, C)."""
    b, d, h, w, c8 = x.shape
    c = c8 // 8
    x = x.reshape(b, d, h, w, 2, 2, 2, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, 2 * d, 2 * h, 2 * w, c)


@functools.cache
def _tap_matrix() -> np.ndarray:
    """A[t, u, s, k] = 1 iff 2t + u - s == k (per-axis packed-tap map)."""
    a = np.zeros((2, 2, 2, 3), np.float32)
    for t, u, s in product(range(2), repeat=3):
        k = 2 * t + u - s
        if 0 <= k <= 2:
            a[t, u, s, k] = 1.0
    return a


@functools.cache
def _tap_index() -> np.ndarray:
    """Over (tz,ty,tx, uz,uy,ux, sz,sy,sx): the flat index (kz*3+ky)*3+kx
    of the 3^3 tap each packed slot holds (per axis the k of
    :func:`_tap_matrix`), or 27 for a slot that holds no tap."""
    t, u, s, k = np.nonzero(_tap_matrix())
    k1 = np.full((2, 2, 2), -1)
    k1[t, u, s] = k
    idx = np.full((2,) * 9, 27, np.int64)
    for tz, ty, tx, uz, uy, ux, sz, sy, sx in product(range(2), repeat=9):
        kz, ky, kx = k1[tz, uz, sz], k1[ty, uy, sy], k1[tx, ux, sx]
        if min(kz, ky, kx) >= 0:
            idx[tz, ty, tx, uz, uy, ux, sz, sy, sx] = (kz * 3 + ky) * 3 + kx
    return idx


def pack_weight_d1(w: torch.Tensor) -> torch.Tensor:
    """(3,3,3,Ci,Co) valid-conv kernel -> (2,2,2,8Ci,8Co) packed kernel.

    y[2r+s] = sum_delta w[delta] x[2r+s+delta]; writing s+delta = 2t+u gives
    the packed tap (t) / input-parity (u) / output-parity (s) map of
    :func:`_tap_matrix`.  Every slot holds one original tap or zero, so the
    kernel is gathered, with no arithmetic: exact in any dtype."""
    kz, ky, kx, ci, co = w.shape
    if (kz, ky, kx) != (3, 3, 3):
        raise ValueError(f"pack_weight_d1 needs a 3^3 kernel, got {tuple(w.shape)}")
    taps = torch.cat([w.reshape(27, ci, co), w.new_zeros(1, ci, co)])
    wp = taps[torch.from_numpy(_tap_index()).to(w.device)]
    # (tz,ty,tx, uz,uy,ux, sz,sy,sx, ci, co) -> (..., uz,uy,ux, ci, sz,sy,sx, co)
    wp = wp.permute(0, 1, 2, 3, 4, 5, 9, 6, 7, 8, 10)
    return wp.reshape(2, 2, 2, 8 * ci, 8 * co)


def convT_packed_weight(k: torch.Tensor) -> torch.Tensor:
    """(2,2,2,Ci,Co) ConvTranspose kernel -> (Ci, 8Co) matrix whose output
    channels are parity-major packed.  Flax's ConvTranspose computes
    ``out[2r+p] = x[r] @ K[1-p]`` for kernel == stride == 2, so parity p
    reads the flipped tap.  (Re-exported by ``ops.packed_unet``, the
    reference's module for it.)"""
    return torch.cat([k[1 - pz, 1 - py, 1 - px] for pz, py, px in _PARITY],
                     dim=-1)
