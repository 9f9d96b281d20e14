"""Connected components on the tensor's device, with centroid extraction.

Counterpart of ``flypylib_tpu/ops/components.py`` (``components_device``
and ``label_components``).  Semantics are those of
``ops/host_reference.components_host``: 6-connectivity on
``prob >= threshold``; a detection sits at its component's mean voxel
coordinate, with the component's max probability as confidence; the list
is in canonical order (conf descending, then z, y, x ascending).

Labelling is an iterated fixed point, as in the reference: each voxel's
label starts as its own flat index and each sweep takes the min over the
6-neighbourhood within the mask.  Extraction works on the compacted
above-threshold voxels only.  Coordinate sums are integers, so the f64
centroids equal scipy's ``center_of_mass`` bit for bit.  PyTorch has no
static-shape limit, so there is no ``max_components`` cap to grow.
"""

from __future__ import annotations

import numpy as np
import torch

from flypylib_tpu_torch.io.synapses import Tbars
from flypylib_tpu_torch.ops.host_reference import sort_detections

# sweeps between convergence checks: each check (``torch.equal``) syncs the
# host with the device, so it is paid once per this many sweeps
_SWEEPS_PER_CHECK = 4


def _neighbor_min(lab: torch.Tensor, mask: torch.Tensor,
                  sentinel: int) -> torch.Tensor:
    """Min of label over the 6-neighbourhood (self included), masked."""
    out = lab.clone()
    for axis in range(3):
        n = lab.shape[axis]
        if n < 2:
            continue
        hi = out.narrow(axis, 1, n - 1)  # takes the neighbour below
        hi.copy_(torch.minimum(hi, lab.narrow(axis, 0, n - 1)))
        lo = out.narrow(axis, 0, n - 1)  # takes the neighbour above
        lo.copy_(torch.minimum(lo, lab.narrow(axis, 1, n - 1)))
    return torch.where(mask, out, sentinel)


def label_volume(mask: torch.Tensor) -> torch.Tensor:
    """Converged labels: each voxel in ``mask`` gets the smallest flat index
    of its 6-connected component; voxels outside get ``mask.numel()``."""
    n = mask.numel()
    dtype = torch.int32 if n < 2**31 - 1 else torch.int64
    idx = torch.arange(n, dtype=dtype, device=mask.device).reshape(mask.shape)
    lab = torch.where(mask, idx, n)
    while True:
        new = lab
        for _ in range(_SWEEPS_PER_CHECK):
            new = _neighbor_min(new, mask, n)
        if torch.equal(new, lab):
            return lab
        lab = new


def components_device(prob: torch.Tensor, threshold=0.5):
    """CC on ``prob``'s device: returns (centroids (K,3) f64, conf (K,) f32),
    one row per component, ordered by the component's smallest flat index."""
    prob = prob.float()
    mask = prob >= threshold
    cand = torch.nonzero(mask.reshape(-1))[:, 0]  # ascending
    if cand.numel() == 0:
        return (torch.zeros((0, 3), dtype=torch.float64, device=prob.device),
                torch.zeros((0,), dtype=torch.float32, device=prob.device))
    roots = label_volume(mask).reshape(-1)[cand]
    uniq, seg = torch.unique(roots, sorted=True, return_inverse=True)
    K = uniq.numel()
    Y, X = prob.shape[1], prob.shape[2]
    coords = torch.stack([cand // (Y * X), (cand // X) % Y, cand % X], 1)
    sums = torch.zeros((K, 3), dtype=torch.int64, device=prob.device)
    sums.index_add_(0, seg, coords)
    count = torch.bincount(seg, minlength=K)
    conf = torch.full((K,), -torch.inf, device=prob.device)
    conf.scatter_reduce_(0, seg, prob.reshape(-1)[cand], reduce="amax")
    return sums.double() / count.double()[:, None], conf


def label_components(prob, threshold: float = 0.5) -> Tbars:
    """Public CC verb: probability volume (numpy array or torch tensor,
    computed on the tensor's device) -> centroid detection list."""
    centroids, conf = components_device(torch.as_tensor(prob), float(threshold))
    return sort_detections(centroids.cpu().numpy(),
                           conf.cpu().numpy().astype(np.float64))
