"""The numbers that decide ``correct``: how far the program's outputs lie
from the reference's.  Each is a share or a gap that is 0 when the two
agree; the limits they are held to sit in each cell's workload file.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def flat_index(locs: np.ndarray, shape) -> np.ndarray:
    """Integer (z, y, x) locations as flat indices into ``shape``."""
    z, y, x = (np.rint(locs[:, a]).astype(np.int64) for a in range(3))
    return (z * shape[1] + y) * shape[2] + x


def nms_numbers(locs, conf, ref_idx, ref_conf, shape) -> dict:
    """``nms_miss``: the share of the two NMS lists' detections that the
    other list lacks at the same voxel; ``nms_conf_gap``: the widest gap
    between the two lists' probabilities at the voxels both report (the
    map, compared where the lists sample it)."""
    idx = flat_index(np.asarray(locs), shape)
    both, i, j = np.intersect1d(idx, ref_idx, return_indices=True)
    total = len(idx) + len(ref_idx)
    miss = (total - 2 * len(both)) / max(total, 1)
    gap = (float(np.max(np.abs(np.asarray(conf, np.float64)[i]
                               - np.asarray(ref_conf, np.float64)[j])))
           if len(both) else (float("inf") if total else 0.0))
    return {"nms_miss": miss, "nms_conf_gap": gap}


def cc_numbers(cent, conf, ref_cent, ref_conf, tol: float = 1.0) -> dict:
    """``cc_miss``: the share of the two component lists' detections with
    no detection of the other list within ``tol`` voxels; ``cc_logit_gap``:
    of the pairs matched so (nearest neighbours), the widest gap between
    the two probabilities as logits (:func:`logit`, which keeps its
    resolution where probabilities crowd at 0 or 1)."""
    cent = np.asarray(cent, np.float64).reshape(-1, 3)
    ref_cent = np.asarray(ref_cent, np.float64).reshape(-1, 3)
    total = len(cent) + len(ref_cent)
    if not len(cent) or not len(ref_cent):
        return {"cc_miss": 1.0 if total else 0.0,
                "cc_logit_gap": float("inf") if total else 0.0}
    d1, j1 = cKDTree(ref_cent).query(cent, distance_upper_bound=tol)
    d2, _ = cKDTree(cent).query(ref_cent, distance_upper_bound=tol)
    hit = np.isfinite(d1)
    unmatched = int(np.sum(~hit)) + int(np.sum(~np.isfinite(d2)))
    gap = np.abs(logit(np.asarray(conf)[hit])
                 - logit(np.asarray(ref_conf)[j1[hit]]))
    return {"cc_miss": unmatched / total,
            "cc_logit_gap": float(np.max(gap)) if hit.any() else 0.0}


def logit(p) -> np.ndarray:
    """``log p - log1p(-p)`` in f64 of an f32 probability, read no closer
    to 0 or 1 than f32 resolves (an f32 sigmoid gives 1.0 for every logit
    above ~16.6)."""
    p = np.clip(np.asarray(p, np.float64), 2.0 ** -126, 1.0 - 2.0 ** -24)
    return np.log(p) - np.log1p(-p)


def leaf_gap(got: dict, want: dict, counted) -> float:
    """The worst leaf's gap between the program's and the reference's
    norms, ``| |got| - |want| |``, against the larger of that leaf's
    reference norm and the median leaf's; over the leaves ``counted``."""
    norms = {k: float(np.linalg.norm(np.asarray(want[k], np.float64)))
             for k in want}
    med = float(np.median([norms[k] for k in counted]))
    return max(abs(float(np.linalg.norm(np.asarray(got[k], np.float64)))
                   - norms[k]) / max(norms[k], med) for k in counted)


def moved_leaves(ref_grad: dict, floor: float = 1e-3) -> list:
    """The leaves whose reference gradient norm is at least ``floor`` of
    the median leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(np.linalg.norm(np.asarray(v, np.float64)))
             for k, v in ref_grad.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= floor * med]


def judge(numbers: dict, limits: dict) -> dict:
    """``{name: {"value": v, "limit": l}}`` for every number that has a
    limit, in the order of ``limits``; a limit without its number is an
    error in the cell.  (A cell may read further numbers that its limits
    leave uncompared: no control or fault separates them from sound runs.)"""
    missing = [k for k in limits if k not in numbers]
    if missing:
        raise KeyError(f"no reading of {missing}")
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])}
            for k in limits}


def diff_gap(got: dict, want: dict, counted) -> float:
    """The worst leaf's ``|got - want|`` (the norm of the difference),
    against the larger of that leaf's reference norm and the median
    leaf's: unlike :func:`leaf_gap` it sees a change of direction."""
    norms = {k: float(np.linalg.norm(np.asarray(want[k], np.float64)))
             for k in want}
    med = float(np.median([norms[k] for k in counted]))
    return max(float(np.linalg.norm(np.asarray(got[k], np.float64)
                                    - np.asarray(want[k], np.float64)))
               / max(norms[k], med) for k in counted)


def passed(checks: dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
