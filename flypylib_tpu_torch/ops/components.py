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

For the staged and streaming whole-volume engine (``infer/large.py``) this
module also holds :func:`compact_true_indices` (the candidates of one
postprocess box, on its device), :func:`components_from_candidates` (the
host CC over the union of every box's candidates, ``cc_impl="sparse"``),
:func:`component_stats` (one labelled box's components, ``cc_impl="device"``)
and, copied from the reference, :class:`SeamUnionFind` and
:func:`merge_component_fragments` (the host merge of the boxes' fragments
across their seams).
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


def compact_true_indices(mask: torch.Tensor) -> torch.Tensor:
    """Flat indices of every True voxel of ``mask``, ascending, int64, on
    ``mask``'s device.

    Counterpart of the reference's ``compact_true_indices``, without its
    ``size`` cap: that cap, and the three-level compaction behind it, exist
    because XLA needs static shapes.  ``torch.nonzero`` returns the whole
    list in one pass (and waits for the device to count it)."""
    return torch.nonzero(mask.reshape(-1))[:, 0]


def components_device(prob: torch.Tensor, threshold=0.5):
    """CC on ``prob``'s device: returns (centroids (K,3) f64, conf (K,) f32),
    one row per component, ordered by the component's smallest flat index."""
    prob = prob.float()
    mask = prob >= threshold
    cand = compact_true_indices(mask)
    if cand.numel() == 0:
        return (torch.zeros((0, 3), dtype=torch.float64, device=prob.device),
                torch.zeros((0,), dtype=torch.float32, device=prob.device))
    _, sums, count, conf = component_stats(prob, label_volume(mask), cand)
    return sums.double() / count.double()[:, None], conf


def component_stats(prob: torch.Tensor, lab: torch.Tensor,
                    cand: torch.Tensor):
    """Per component of the labels ``lab`` (from :func:`label_volume`) over
    the candidate voxels ``cand`` (ascending flat indices of the mask):
    ``(uniq, sums, count, conf)``, the ascending local roots, int64
    coordinate sums (K, 3), int64 voxel counts and the f32 max of
    ``prob``."""
    uniq, seg = torch.unique(lab.reshape(-1)[cand], sorted=True,
                             return_inverse=True)
    K = uniq.numel()
    Y, X = prob.shape[1], prob.shape[2]
    coords = torch.stack([cand // (Y * X), (cand // X) % Y, cand % X], 1)
    sums = torch.zeros((K, 3), dtype=torch.int64, device=prob.device)
    sums.index_add_(0, seg, coords)
    count = torch.bincount(seg, minlength=K)
    conf = torch.full((K,), -torch.inf, device=prob.device)
    conf.scatter_reduce_(0, seg, prob.reshape(-1)[cand], reduce="amax")
    return uniq, sums, count, conf


def label_components(prob, threshold: float = 0.5) -> Tbars:
    """Public CC verb: probability volume (numpy array or torch tensor,
    computed on the tensor's device) -> centroid detection list."""
    centroids, conf = components_device(torch.as_tensor(prob), float(threshold))
    return sort_detections(centroids.cpu().numpy(),
                           conf.cpu().numpy().astype(np.float64))


def components_from_candidates(
    flat_idx: np.ndarray, prob: np.ndarray, shape
) -> Tbars:
    """Exact 6-connectivity CC from the sparse set of above-threshold
    voxels (ascending unique flat indices into a ``shape`` volume).

    Semantically identical to ``scipy.ndimage.label`` + centroid/max-conf
    extraction on the dense mask (the host reference): connectivity is
    evaluated on the candidate set itself, which IS the thresholded mask.
    Built for the sparse masks synapse detection produces (~0.01-1%
    occupancy): work scales with candidate count, not volume size —
    neighbor lookups are searchsorted into the sorted index list and the
    components come from one ``scipy.sparse.csgraph`` pass.  Used by the
    streaming detection path (infer/large.py cc_impl="sparse"), where
    each ROI ships only its compacted core candidates.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components as _cc

    a = np.asarray(flat_idx, np.int64)
    p = np.asarray(prob, np.float64)
    n = a.shape[0]
    if n == 0:
        return Tbars(locs=np.zeros((0, 3)), conf=np.zeros((0,)))
    vz, vy, vx = shape
    x = a % vx
    y = (a // vx) % vy
    z = a // (vy * vx)
    ri, ci = [], []
    for delta, guard in (
        (1, x != vx - 1),
        (vx, y != vy - 1),
        (vy * vx, z != vz - 1),
    ):
        b = a + delta
        pos = np.searchsorted(a, b)
        ok = guard & (pos < n)
        ok[ok] = a[pos[ok]] == b[ok]
        ri.append(np.nonzero(ok)[0])
        ci.append(pos[ok])
    ri = np.concatenate(ri + [np.arange(n)])
    ci = np.concatenate(ci + [np.arange(n)])
    g = sp.coo_matrix(
        (np.ones(ri.shape[0], np.int8), (ri, ci)), shape=(n, n)
    )
    ncomp, lab = _cc(g, directed=False)
    count = np.bincount(lab, minlength=ncomp).astype(np.float64)
    cents = np.stack(
        [
            np.bincount(lab, weights=c, minlength=ncomp) / count
            for c in (z, y, x)
        ],
        axis=1,
    )
    conf = np.full(ncomp, -np.inf)
    np.maximum.at(conf, lab, p)
    return sort_detections(cents, conf)


class SeamUnionFind:
    """Union-find over (block_key, slot) nodes for cross-block CC merging."""

    def __init__(self):
        self.parent: dict = {}

    def find(self, a):
        p = self.parent
        root = a
        while p.setdefault(root, root) != root:
            root = p[root]
        while p[a] != root:  # path compression
            p[a], a = root, p[a]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def merge_component_fragments(blocks: dict, sentinel: int) -> Tbars:
    """Merge per-block CC fragments into whole-volume components.

    ``blocks`` maps a 3-D grid key ``(iz, iy, ix)`` to a dict with:

    - ``uniq`` (K,) ascending local root ids,
    - ``sums`` (K, 3) GLOBAL coordinate sums, ``count`` (K,), ``conf`` (K,),
      ``valid`` (K,) — from :func:`component_stats`, sums globalized by the
      block's corner;
    - ``faces``: 6 boundary label planes in the order (z-lo, z-hi, y-lo,
      y-hi, x-lo, x-hi), values = local root ids or ``sentinel``
      (the block voxel count) where below threshold.

    Components whose boundary voxels are 6-adjacent across a block seam
    are unioned (exactly ``scipy.ndimage.label``'s connectivity — corner
    contact never links under 6-connectivity, so face adjacency is
    complete), then counts/coordinate-sums/max-conf reduce per root, so
    centroids and confidences equal a monolithic run's.  A copy of the
    reference's (``flypylib_tpu/ops/components.py``), used by the device-CC
    backend of ``infer/large.py``.
    """
    uf = SeamUnionFind()

    # face index pairs: (axis, this-block hi face, neighbor lo face)
    face_pairs = [(0, 1, 0), (1, 3, 2), (2, 5, 4)]
    for (iz, iy, ix), data in blocks.items():
        for axis, hi_f, lo_f in face_pairs:
            nb = (iz + (axis == 0), iy + (axis == 1), ix + (axis == 2))
            if nb not in blocks:
                continue
            a = data["faces"][hi_f]
            b = blocks[nb]["faces"][lo_f]
            pair = (a < sentinel) & (b < sentinel)
            if not pair.any():
                continue
            ka = np.searchsorted(data["uniq"], a[pair])
            kb = np.searchsorted(blocks[nb]["uniq"], b[pair])
            for sa, sb in set(zip(ka.tolist(), kb.tolist())):
                uf.union(((iz, iy, ix), sa), (nb, sb))

    roots: dict = {}
    for key, data in blocks.items():
        for slot in np.nonzero(data["valid"])[0]:
            r = uf.find((key, int(slot)))
            acc = roots.setdefault(r, [0.0, np.zeros(3), -np.inf])
            acc[0] += data["count"][slot]
            acc[1] = acc[1] + data["sums"][slot]
            acc[2] = max(acc[2], float(data["conf"][slot]))

    if not roots:
        return Tbars(locs=np.zeros((0, 3)), conf=np.zeros((0,)))
    locs = np.stack([v[1] / v[0] for v in roots.values()])
    confs = np.asarray([v[2] for v in roots.values()])
    return sort_detections(locs, confs)
