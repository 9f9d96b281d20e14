"""Small shared helpers: scalar->3-tuple broadcast and block-coordinate math.

Parity: flypylib fplutils (``to3d``-style scalar broadcast, block math).
Semantics are defined here and pinned by tests (see SURVEY.md section 0).

A copy of ``flypylib_tpu/utils/core.py`` (numpy only): importing the JAX
package would pull in jax.  tests/test_torch_detect.py checks the copy.
"""

from __future__ import annotations

import numpy as np


def to3d(x) -> tuple[int, int, int]:
    """Broadcast a scalar or length-3 sequence to an (z, y, x) int 3-tuple."""
    if np.isscalar(x):
        return (int(x),) * 3
    t = tuple(int(v) for v in x)
    if len(t) != 3:
        raise ValueError(f"expected scalar or length-3 sequence, got {x!r}")
    return t


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, multiple: int) -> int:
    return ceil_div(x, multiple) * multiple


def block_starts(total: int, block: int, stride: int | None = None) -> list[int]:
    """Start offsets covering ``[0, total)`` with windows of size ``block``.

    The final window is shifted left so it ends exactly at ``total`` (windows
    may overlap); all starts are valid (start + block <= total).
    """
    if block >= total:
        return [0]
    stride = block if stride is None else stride
    starts = list(range(0, total - block, stride))
    starts.append(total - block)
    return starts


def pad_to_multiple(vol: np.ndarray, multiple, mode: str = "constant", **kw):
    """Pad a 3D volume (z, y, x) on the high side so each dim is a multiple.

    Returns ``(padded, original_shape)``.
    """
    m = to3d(multiple)
    pads = [(0, round_up(s, mi) - s) for s, mi in zip(vol.shape, m)]
    return np.pad(vol, pads, mode=mode, **kw), vol.shape


def crop_center(vol: np.ndarray, context) -> np.ndarray:
    """Remove a ``context``-voxel border from each face of a 3D volume."""
    cz, cy, cx = to3d(context)
    sl = tuple(
        slice(c, s - c) if c > 0 else slice(None)
        for c, s in zip((cz, cy, cx), vol.shape[:3])
    )
    return vol[sl]
