"""Flip/rotation augmentation on the device.

Counterpart of ``flypylib_tpu/ops/augment.py``.  The group is the standard
16-element symmetry group for z-anisotropic EM volumes: (xy-transpose) x
(x-flip) x (y-flip) x (z-flip).  Code bit layout (code in [0, 16)):

- bit 0: flip z
- bit 1: flip y
- bit 2: flip x
- bit 3: transpose the (y, x) axes (applied after flips; requires Y == X)

All 16 codes enumerate the full group.  The same code must be applied to
the image patch, label patch, and mask patch.

:func:`augment_batch` applies a device tensor of per-patch codes as one
gather: each output voxel's source index is computed from its patch's code
on the device, so there is no host sync and no Python loop over patches.
The result is a copy of the input's values, exact for every code.
"""

from __future__ import annotations

import torch

AUGMENT_GROUP_SIZE = 16


def augment_batch(batch: torch.Tensor, codes) -> torch.Tensor:
    """Apply ``codes[b]`` to ``batch[b]`` for every patch.

    ``batch`` is (B, Z, Y, X) or (B, Z, Y, X, C); ``codes`` an int tensor
    (or sequence) of B codes in [0, 16), moved to the batch's device.
    The transpose bit requires Y == X: a non-square (y, x) patch raises,
    as the reference's trace-time check does, whatever the codes."""
    if batch.dim() not in (4, 5):
        raise ValueError(f"batch must be (B, Z, Y, X[, C]), got "
                         f"{tuple(batch.shape)}")
    b, z, y, x = batch.shape[:4]
    if y != x:
        raise ValueError(
            "xy-transpose augmentation requires square (y, x) patches; got "
            f"shape {tuple(batch.shape[1:])}"
        )
    dev = batch.device
    codes = torch.as_tensor(codes, device=dev).to(torch.int64).reshape(b)

    def flip(n, bit):
        """(B, n) source indices along one axis: reversed where ``bit``."""
        r = torch.arange(n, device=dev)
        on = ((codes >> bit) & 1).bool()[:, None]
        return torch.where(on, n - 1 - r, r)

    iz, iy, ix = flip(z, 0), flip(y, 1), flip(x, 2)
    # out[z, y, x] = flipped[z, x, y] where the transpose bit is set, and
    # flipped[z, y, x] = in[iz[z], iy[y], ix[x]]
    swap = ((codes >> 3) & 1).bool()[:, None, None]
    src_y = torch.where(swap, iy[:, None, :], iy[:, :, None])  # (B, y, x)
    src_x = torch.where(swap, ix[:, :, None], ix[:, None, :])
    bi = torch.arange(b, device=dev)[:, None, None, None]
    return batch[bi, iz[:, :, None, None], src_y[:, None], src_x[:, None]]


def augment_patch(patch: torch.Tensor, code) -> torch.Tensor:
    """Apply augmentation ``code`` (an int or a 0-d tensor in [0, 16)) to
    one (Z, Y, X) or (Z, Y, X, C) patch (Y == X)."""
    return augment_batch(patch[None], torch.as_tensor(code).reshape(1))[0]
