"""Precision-recall point matching and evaluation.

Counterpart of ``flypylib_tpu/ops/matching.py``: greedy confidence-ordered
one-to-one matching of predicted points to ground-truth points within a
Euclidean distance threshold, swept over confidence to produce a PR curve;
plus voxel-wise PR.

The host half (the matchers, ``obj_pr_curve``, ``obj_pr``, ``voxel_pr``) is
a copy of the reference's (numpy and scipy only): importing the JAX package
would pull in jax.  tests/test_torch_matching.py checks it against the
original.

Pinned matching rule: iterate predictions in canonical order (conf desc,
z/y/x asc); each prediction matches the nearest not-yet-matched ground
truth within ``dist_thresh`` (ties -> lowest ground-truth index); matched
predictions are true positives.  The PR curve is the cumulative
precision/recall over this single matching as the confidence cutoff sweeps
down the sorted predictions (matching once, then cumsum).

Voxel PR on the device (:func:`voxel_pr_device`, :func:`voxel_pr_streaming`)
counts in torch on the map's device, in int64, so the counts are exact at any
volume size and the result equals :func:`voxel_pr` bitwise on the same map.
"""

from __future__ import annotations

import numpy as np
import torch

from flypylib_tpu_torch.io.synapses import Tbars
from flypylib_tpu_torch.ops.host_reference import sort_detections


def _match_dense(pred_locs, gt_locs, thresh2, tp, match_idx):
    """O(n_pred * n_gt) reference matcher (small lists)."""
    d2 = np.sum(
        (pred_locs[:, None, :] - gt_locs[None, :, :]) ** 2, axis=2
    )  # (n_pred, n_gt)
    taken = np.zeros(len(gt_locs), dtype=bool)
    for i in range(len(pred_locs)):
        row = np.where(taken, np.inf, d2[i])
        j = int(np.argmin(row))  # argmin returns lowest index on ties
        if row[j] <= thresh2:
            tp[i] = True
            match_idx[i] = j
            taken[j] = True


def _match_kdtree(pred_locs, gt_locs, thresh, thresh2, tp, match_idx):
    """cKDTree matcher for large lists (10^5-10^6 detections): each
    prediction only examines ground truths within the distance threshold,
    so cost is O((n_pred + n_gt) log n_gt + matches) instead of the dense
    O(n_pred * n_gt) matrix.  Identical results to :func:`_match_dense`
    including the tie rule: candidates are re-scored with the same
    ``sum((p - g)**2)`` arithmetic and taken in (d2, gt_index) order."""
    from scipy.spatial import cKDTree

    tree = cKDTree(gt_locs)
    # tiny inflation so boundary points survive the tree's own metric
    # rounding; the exact d2 <= thresh2 filter below decides membership
    neighbors = tree.query_ball_point(
        pred_locs, r=float(thresh) * (1 + 1e-9) + 1e-12, workers=-1
    )
    taken = np.zeros(len(gt_locs), dtype=bool)
    for i, nbrs in enumerate(neighbors):
        if not nbrs:
            continue
        nbrs = np.asarray(nbrs, dtype=np.int64)
        d2 = np.sum((pred_locs[i] - gt_locs[nbrs]) ** 2, axis=1)
        order = np.lexsort((nbrs, d2))  # d2 asc, gt index asc on ties
        for k in order:
            j = int(nbrs[k])
            if d2[k] > thresh2:
                break
            if not taken[j]:
                tp[i] = True
                match_idx[i] = j
                taken[j] = True
                break


def match_detections(
    pred: Tbars, gt: Tbars, dist_thresh: float = 10.0
) -> tuple[np.ndarray, np.ndarray, Tbars]:
    """Greedy one-to-one matching.

    Returns ``(tp, match_idx, pred_sorted)`` where ``tp[i]`` says whether the
    i-th prediction (canonical order) matched, ``match_idx[i]`` is the
    matched ground-truth index (-1 if none).  Small lists use the dense
    matrix; large ones switch to a cKDTree with bit-identical results.
    """
    pred = sort_detections(pred.locs, pred.conf)
    n_pred, n_gt = len(pred), len(gt)
    tp = np.zeros(n_pred, dtype=bool)
    match_idx = np.full(n_pred, -1, dtype=np.int64)
    if n_pred == 0 or n_gt == 0:
        return tp, match_idx, pred

    thresh2 = float(dist_thresh) ** 2
    if n_pred * n_gt <= 4_000_000:
        _match_dense(pred.locs, gt.locs, thresh2, tp, match_idx)
    else:
        _match_kdtree(
            pred.locs, gt.locs, float(dist_thresh), thresh2, tp, match_idx
        )
    return tp, match_idx, pred


def obj_pr_curve(
    pred: Tbars, gt: Tbars, dist_thresh: float = 10.0
) -> dict[str, np.ndarray]:
    """PR curve over the confidence sweep.

    Returns dict with ``conf``, ``precision``, ``recall``, ``tp``, ``fp``
    arrays (one entry per prediction, confidence descending) plus scalar
    ``num_gt``.
    """
    tp, _, pred_sorted = match_detections(pred, gt, dist_thresh)
    cum_tp = np.cumsum(tp.astype(np.float64))
    n = np.arange(1, len(tp) + 1, dtype=np.float64)
    n_gt = max(len(gt), 1)
    return {
        "conf": pred_sorted.conf.copy(),
        "precision": cum_tp / n,
        "recall": cum_tp / n_gt,
        "tp": cum_tp,
        "fp": n - cum_tp,
        "num_gt": np.float64(len(gt)),
    }


def obj_pr(
    pred: Tbars,
    gt: Tbars,
    dist_thresh: float = 10.0,
    conf_threshold: float | None = None,
) -> tuple[float, float]:
    """(precision, recall) at one operating point (all preds, or conf>=t)."""
    if conf_threshold is not None:
        keep = pred.conf >= conf_threshold
        pred = Tbars(locs=pred.locs[keep], conf=pred.conf[keep])
    tp, _, _ = match_detections(pred, gt, dist_thresh)
    n_tp = float(tp.sum())
    precision = n_tp / max(len(tp), 1)
    recall = n_tp / max(len(gt), 1)
    return precision, recall


def voxel_pr(
    prob: np.ndarray,
    labels: np.ndarray,
    mask: np.ndarray | None = None,
    thresholds: np.ndarray | None = None,
) -> dict[str, np.ndarray]:
    """Voxel-wise PR over a threshold sweep, restricted to the loss mask."""
    prob = np.asarray(prob, dtype=np.float32).reshape(-1)
    labels = np.asarray(labels).reshape(-1) > 0.5
    if mask is not None:
        keep = np.asarray(mask).reshape(-1) > 0.5
        prob, labels = prob[keep], labels[keep]
    if thresholds is None:
        thresholds = np.linspace(0.05, 0.95, 19)
    thresholds = np.asarray(thresholds, dtype=np.float32)
    n_pos = max(int(labels.sum()), 1)
    precision = np.zeros_like(thresholds, dtype=np.float64)
    recall = np.zeros_like(thresholds, dtype=np.float64)
    for k, t in enumerate(thresholds):
        p = prob >= t
        tp = float(np.sum(p & labels))
        precision[k] = tp / max(float(p.sum()), 1.0)
        recall[k] = tp / n_pos
    return {"thresholds": thresholds, "precision": precision, "recall": recall}


def _vpr_counts(prob: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor | None, thr: torch.Tensor,
                z_lo: int, z_hi: int):
    """Per-threshold (pred-positive, true-positive) counts and the positive
    count over rows ``[z_lo, z_hi)`` of one volume, as int64 tensors on the
    map's device (``thr`` f32 on the same device): ``(prob >= t) & valid``
    summed per threshold, ``valid`` the rows and ``mask > 0.5``."""
    prob = prob[z_lo:z_hi].float()
    pos = labels[z_lo:z_hi] > 0.5
    valid = None if mask is None else mask[z_lo:z_hi] > 0.5
    if valid is not None:
        pos &= valid
    n_pos = pos.sum(dtype=torch.int64)
    pp, tp = [], []
    for t in thr:
        p = prob >= t
        if valid is not None:
            p &= valid
        pp.append(p.sum(dtype=torch.int64))
        tp.append((p & pos).sum(dtype=torch.int64))
    return torch.stack(pp), torch.stack(tp), n_pos


def _vpr_finish(thresholds, pp, tp, n_pos) -> dict[str, np.ndarray]:
    """Counts -> the exact dict :func:`voxel_pr` returns."""
    n_pos = max(int(n_pos), 1)
    pp = np.asarray(pp, dtype=np.float64)
    tp = np.asarray(tp, dtype=np.float64)
    return {
        "thresholds": np.asarray(thresholds, dtype=np.float32),
        "precision": tp / np.maximum(pp, 1.0),
        "recall": tp / n_pos,
    }


def voxel_pr_device(
    prob,
    labels,
    mask=None,
    thresholds: np.ndarray | None = None,
) -> dict[str, np.ndarray]:
    """:func:`voxel_pr` with the counting on the map's device.

    ``prob`` is a tensor (on any device, e.g. from ``infer(...,
    keep_on_device=True)``) or a numpy array (counted on the CPU);
    ``labels`` and ``mask`` are moved to its device.  The counts are int64,
    so the result equals :func:`voxel_pr` bitwise on the same map at any
    volume size; only three integers per threshold reach the host."""
    if thresholds is None:
        thresholds = np.linspace(0.05, 0.95, 19)
    prob = torch.as_tensor(prob)
    dev = prob.device
    thr = torch.as_tensor(np.asarray(thresholds, np.float32), device=dev)
    lab = torch.as_tensor(labels).to(dev)
    msk = None if mask is None else torch.as_tensor(mask).to(dev)
    pp, tp, n_pos = _vpr_counts(prob, lab, msk, thr, 0, prob.shape[0])
    return _vpr_finish(thresholds, pp.cpu().numpy(), tp.cpu().numpy(),
                       int(n_pos))


def voxel_pr_streaming(
    spec,
    variables,
    gray,
    labels,
    mask=None,
    thresholds: np.ndarray | None = None,
    slab: int = 64,
    tile_out: int | None = None,
    tile_batch: int | None = None,
) -> dict[str, np.ndarray]:
    """Exact out-of-core voxel PR: forward + count in bounded memory.

    Streams the volume in pooling-phase-aligned z-slabs: each slab window
    is an exact ``size_multiple``-aligned window of the monolithic
    reflect-padded volume (true-data context halos; reflect only at real
    volume faces; the tiled engine runs in ``pad_mode="none"`` so no second
    pad shifts the pooling phase), counted on the module's device against
    the matching label/mask slab; only integer counts reach the host.
    Results equal ``voxel_pr(infer(gray), labels, mask)`` without ever
    holding the whole probability map.

    Unlike the reference, a window holds the true rows of every tile of
    the slab's grid, not only the slab's ``sz + 2 context``: in a U-Net of
    two or more levels an output voxel's field reaches past ``context`` on
    one side, by its pooling phase, so the rows past the slab that a tile
    reads reach the slab's last outputs.  The reference fills them with
    zeros, which the monolithic map does not hold, and its counts then
    differ from ``voxel_pr(infer(gray))`` (tests/test_torch_matching.py).

    ``gray``/``labels``/``mask`` each accept an ndarray or a ``(shape,
    read_fn)`` pair (:func:`~flypylib_tpu_torch.infer.large.h5_reader` /
    ``array_reader``).  The grayscale is consumed as-is (uint8 stays uint8
    until the model casts it), matching :meth:`FplNetwork.infer`.
    ``variables`` must be None: the port's modules hold their own weights."""
    from flypylib_tpu_torch.infer.large import array_reader
    from flypylib_tpu_torch.infer.tiled import TiledInference, default_tiling

    if variables is not None:
        raise ValueError("variables must be None: the port's modules hold "
                         "their own weights")

    def as_reader(src):
        if src is None:
            return None, None
        if isinstance(src, tuple) and len(src) == 2 and callable(src[1]):
            return src
        return array_reader(src)

    g_shape, g_read = as_reader(gray)
    l_shape, l_read = as_reader(labels)
    m_shape, m_read = as_reader(mask)
    if tuple(l_shape) != tuple(g_shape) or (
        m_shape is not None and tuple(m_shape) != tuple(g_shape)
    ):
        raise ValueError(
            f"shape mismatch: gray {g_shape}, labels {l_shape}, "
            f"mask {m_shape}"
        )
    Z, Y, X = (int(s) for s in g_shape)
    if thresholds is None:
        thresholds = np.linspace(0.05, 0.95, 19)

    ctx = spec.context
    mult = max(1, spec.size_multiple)
    if min(Z, Y, X) <= ctx:
        raise ValueError(
            f"volume {g_shape} too small to reflect context {ctx}"
        )
    # static slab extent, multiple of the pooling stride; slab starts
    # stay == 0 mod size_multiple so every slab forward keeps the
    # monolithic pooling phase
    sz = max(mult, (min(slab, Z) // mult) * mult)

    def read_win(read, w0):
        """Rows [w0-ctx, w0+ext+ctx) of the monolithic reflect-padded
        volume, ``ext`` the extent of the slab's tile grid; rows past its
        end are zero, as the monolithic engine's grid extension is."""
        lo, hi = w0 - ctx, w0 + ext + ctx
        clo, chi = max(0, lo), min(Z, hi)
        win = np.asarray(read((clo, 0, 0), (chi, Y, X)))
        if win.dtype != np.uint8:  # uint8 is uploaded as it is (exact)
            win = win.astype(np.float32)
        pad_lo = clo - lo
        pad_hi = min(hi, Z + ctx) - chi
        if pad_lo or pad_hi:
            win = np.pad(win, ((pad_lo, pad_hi), (0, 0), (0, 0)),
                         mode="reflect")
        zeros = hi - (Z + ctx)
        if zeros > 0:
            win = np.pad(win, ((0, zeros), (0, 0), (0, 0)))
        # y/x: the monolithic reflect halo, whole extent
        return np.pad(win, ((0, 0), (ctx, ctx), (ctx, ctx)),
                      mode="reflect")

    if tile_out is None or tile_batch is None:
        d_out, d_batch = default_tiling(spec, (sz, Y, X))
        tile_out = d_out if tile_out is None else tile_out
        tile_batch = d_batch if tile_batch is None else tile_batch
    engine = TiledInference(spec, tile_out=tile_out, tile_batch=tile_batch,
                            pad_mode="none")
    ext = engine.plan((sz, Y, X))[1][0]  # output rows the slab's grid covers
    dev = engine.device
    thr = torch.as_tensor(np.asarray(thresholds, np.float32), device=dev)

    starts: list[int] = []
    z0 = 0
    while z0 + sz <= Z:
        starts.append(z0)
        z0 += sz
    if not starts or starts[-1] + sz < Z:
        # tail slab: phase-aligned start, may overshoot Z (the z_hi bound
        # keeps counts exact; overshoot rows read zeros)
        starts.append(max(0, ((Z - sz + mult - 1) // mult) * mult))

    def read_slab(read, w0):
        """Label/mask rows [w0, w0+sz), zero past Z (outside z_hi)."""
        hi = min(Z, w0 + sz)
        arr = np.asarray(read((w0, 0, 0), (hi, Y, X)))
        if arr.dtype != np.uint8:
            arr = arr.astype(np.float32)
        if hi - w0 < sz:
            arr = np.pad(arr, ((0, sz - (hi - w0)), (0, 0), (0, 0)))
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    pp = torch.zeros(len(thr), dtype=torch.int64, device=dev)
    tp = torch.zeros_like(pp)
    n_pos = torch.zeros((), dtype=torch.int64, device=dev)
    done_z = 0
    for w0 in starts:
        prob = engine.infer(read_win(g_read, w0), keep_on_device=True)
        lab = read_slab(l_read, w0)
        msk = None if m_read is None else read_slab(m_read, w0)
        z_lo = max(0, done_z - w0)
        z_hi = min(sz, Z - w0)
        p_, t_, n_ = _vpr_counts(prob, lab, msk, thr, z_lo, z_hi)
        pp += p_
        tp += t_
        n_pos += n_
        done_z = w0 + sz
    return _vpr_finish(thresholds, pp.cpu().numpy(), tp.cpu().numpy(),
                       int(n_pos))


def evaluate(
    prob_or_pred,
    gt: Tbars,
    dist_thresh: float = 10.0,
    window=3,
    threshold: float = 0.5,
) -> dict[str, np.ndarray]:
    """Public ``evaluate`` verb: probability volume (numpy or tensor) or
    detection list vs ground truth -> PR curve dict."""
    if isinstance(prob_or_pred, Tbars):
        pred = prob_or_pred
    else:
        from flypylib_tpu_torch.ops.nms import nms

        pred = nms(prob_or_pred, window=window, threshold=threshold)
    return obj_pr_curve(pred, gt, dist_thresh)
