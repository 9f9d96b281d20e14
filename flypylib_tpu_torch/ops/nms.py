"""Non-max suppression on the tensor's device, with a host list at the end.

Counterpart of ``flypylib_tpu/ops/nms.py``.  A voxel is a candidate iff it
equals the max of its neighbourhood (out-of-bounds neighbours are -inf, as
scipy ``maximum_filter(mode="constant", cval=-inf)``) and is >= threshold.
The probability map stays on its device; only the candidate list moves to
the host.

Canonical order (``ops/host_reference.py``): conf descending, ties by flat
index ascending, which is (z, y, x) ascending.  ``torch.topk`` promises no
order among ties, so the candidates (``nonzero`` gives them in ascending
index order) are stable-sorted on -conf instead.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from flypylib_tpu_torch.io.synapses import Tbars
from flypylib_tpu_torch.utils import to3d


def mask_valid_region(prob: torch.Tensor, valid_lo, valid_hi):
    """(masked prob, in-bounds mask): voxels outside ``[valid_lo,
    valid_hi)`` become -inf so they can neither be candidates nor suppress
    in-bounds ones — the monolithic boundary rule for regions that extend
    past the true volume."""
    inb = torch.ones(prob.shape, dtype=torch.bool, device=prob.device)
    for axis, (lo, hi) in enumerate(zip(to3d(valid_lo), to3d(valid_hi))):
        r = torch.arange(prob.shape[axis], device=prob.device)
        view = [1, 1, 1]
        view[axis] = -1
        inb &= ((r >= lo) & (r < hi)).view(view)
    return torch.where(inb, prob, -torch.inf), inb


def max_filter(prob: torch.Tensor, window=3) -> torch.Tensor:
    """Separable 3D max filter with -inf (out-of-bounds) padding.

    Three 1-D passes of shifted maxima; identical to a single 3-D box max
    (scipy ``maximum_filter`` with constant -inf)."""
    out = prob
    for axis, w in enumerate(to3d(window)):
        if w == 1:
            continue
        pads = [0] * 6  # F.pad order: (x_lo, x_hi, y_lo, y_hi, z_lo, z_hi)
        pads[2 * (2 - axis)] = w // 2
        pads[2 * (2 - axis) + 1] = w - 1 - w // 2
        padded = F.pad(out, pads, value=-torch.inf)
        n = out.shape[axis]
        res = padded.narrow(axis, 0, n)
        for s in range(1, w):
            res = torch.maximum(res, padded.narrow(axis, s, n))
        out = res
    return out


def candidate_mask(prob: torch.Tensor, window=3, threshold=0.5) -> torch.Tensor:
    """Boolean mask of NMS candidates."""
    return (prob == max_filter(prob, window)) & (prob >= threshold)


def _sorted_candidates(prob: torch.Tensor, window, threshold):
    """(flat indices, conf) of every candidate, in canonical order."""
    prob = prob.float()
    idx = torch.nonzero(candidate_mask(prob, window, threshold).reshape(-1))[:, 0]
    conf = prob.reshape(-1)[idx]
    conf, order = torch.sort(conf, descending=True, stable=True)
    return idx[order], conf


def _unflatten(idx: torch.Tensor, shape) -> torch.Tensor:
    yx = shape[1] * shape[2]
    return torch.stack([idx // yx, (idx % yx) // shape[2], idx % shape[2]], 1)


def nms_device(prob: torch.Tensor, window=3, threshold=0.5,
               max_detections: int | None = None):
    """NMS on ``prob``'s device: returns (locs (k,3) int64, conf (k,) f32,
    valid (k,) bool) in canonical order.

    ``k`` is the candidate count, or ``max_detections`` when given; slots
    past the true candidates have ``valid=False`` and conf -inf."""
    idx, conf = _sorted_candidates(prob, window, threshold)
    k = idx.numel() if max_detections is None else int(max_detections)
    idx, conf = idx[:k], conf[:k]
    valid = torch.ones(k, dtype=torch.bool, device=prob.device)
    pad = k - idx.numel()
    if pad:
        idx = F.pad(idx, (0, pad))
        conf = F.pad(conf, (0, pad), value=-torch.inf)
        valid[k - pad:] = False
    return _unflatten(idx, prob.shape), conf, valid


def nms(prob, window=3, threshold: float = 0.5,
        max_detections: int | None = None) -> Tbars:
    """Public ``nms`` verb: probability volume -> sorted detection list.

    Accepts a numpy array or a torch tensor (z, y, x) and computes on the
    tensor's device.  With the default ``max_detections=None`` every
    candidate is returned.  An explicit ``max_detections`` is a cap: the
    top ``max_detections`` candidates are returned, with a warning if more
    existed."""
    prob = torch.as_tensor(prob)
    idx, conf = _sorted_candidates(prob, window, float(threshold))
    if max_detections is not None and idx.numel() > max_detections:
        warnings.warn(
            f"nms: {idx.numel()} candidates, more than max_detections="
            f"{max_detections}; returning the top ones (pass "
            "max_detections=None for all)",
            stacklevel=2,
        )
        idx, conf = idx[:max_detections], conf[:max_detections]
    locs = _unflatten(idx, prob.shape)
    return Tbars(locs=locs.cpu().numpy().astype(np.float64),
                 conf=conf.cpu().numpy())
