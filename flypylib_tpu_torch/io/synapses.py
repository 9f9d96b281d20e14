"""T-bar annotation I/O and rasterization.

Parity: flypylib fplsynapses (SURVEY.md section 2.2 row 4): parse T-bar
annotation JSON (Raveler-style ``{"data": [{"T-bar": {...}}]}`` and
DVID-style element lists) into point arrays, and rasterize point annotations
into binary label volumes plus loss masks for training.

Conventions (pinned by tests):

- JSON locations are ``[x, y, z]`` (DVID/Raveler convention); in-memory
  point arrays are ``(N, 3)`` float64 in ``(z, y, x)`` index order matching
  numpy volume indexing, with a separate ``(N,)`` confidence array.
- Labels: binary ball of ``radius`` voxels (Euclidean, inclusive) around
  each T-bar center.
- Loss mask: 1 everywhere except (a) an "ignore" annulus
  ``radius < d <= radius_ign`` around each positive where the true label is
  ambiguous, and (b) a ``border`` shell at the volume edge where a
  valid-convolution network has no prediction.

A copy of ``flypylib_tpu/io/synapses.py`` (numpy and json only): importing
the JAX package would pull in jax.  tests/test_torch_detect.py checks it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from flypylib_tpu_torch.utils import to3d


@dataclass
class Tbars:
    """Point annotations: centers in (z, y, x) voxel coords + confidence.

    ``partners`` optionally carries each T-bar's postsynaptic partner
    (PSD) locations as a list of (k_i, 3) float arrays in (z, y, x) —
    preserved through both the Raveler JSON round-trip and the DVID
    element round-trip (``PreSynTo``/``PostSynTo`` relationships).
    """

    locs: np.ndarray  # (N, 3) float64, (z, y, x)
    conf: np.ndarray = field(default=None)  # (N,) float64
    partners: list = field(default=None)  # list of (k_i, 3) arrays or None

    def __post_init__(self):
        self.locs = np.asarray(self.locs, dtype=np.float64).reshape(-1, 3)
        if self.conf is None:
            self.conf = np.ones(len(self.locs), dtype=np.float64)
        self.conf = np.asarray(self.conf, dtype=np.float64).reshape(-1)
        assert len(self.conf) == len(self.locs)
        if self.partners is not None:
            assert len(self.partners) == len(self.locs)
            self.partners = [
                np.asarray(p, dtype=np.float64).reshape(-1, 3)
                for p in self.partners
            ]

    def __len__(self):
        return len(self.locs)

    def as_xyzc(self) -> np.ndarray:
        """(N, 4) array with columns [x, y, z, conf] (JSON convention)."""
        return np.concatenate(
            [self.locs[:, ::-1], self.conf[:, None]], axis=1
        )


def load_from_json(source) -> Tbars:
    """Parse T-bar annotations from a JSON file path, dict, or list.

    Accepts Raveler-style ``{"data": [{"T-bar": {"location": [x,y,z],
    "confidence": c}, "partners": [...]}]}`` and DVID-style
    ``[{"Kind": "PreSyn"|"PostSyn", "Pos": [x,y,z], "Prop": {"conf": c},
    "Rels": [{"Rel": "PreSynTo"|"PostSynTo", "To": [x,y,z]}]}, ...]``.
    Partner PSDs are recovered from either side's relationships.
    """
    if isinstance(source, str):
        with open(source) as f:
            obj = json.load(f)
    else:
        obj = source

    locs_xyz, conf, partners = [], [], []
    if isinstance(obj, dict) and "data" in obj:  # Raveler-style
        for item in obj["data"]:
            tb = item.get("T-bar", item.get("tbar"))
            if tb is None:
                continue
            locs_xyz.append(tb["location"])
            conf.append(float(tb.get("confidence", 1.0)))
            plocs = []
            for p in item.get("partners") or []:
                loc = p["location"] if isinstance(p, dict) else p
                plocs.append(list(loc)[::-1])  # [x,y,z] -> (z,y,x)
            partners.append(np.asarray(plocs, np.float64).reshape(-1, 3))
    elif isinstance(obj, list):  # DVID element list (PreSyn + PostSyn)
        # Partner (T-bar -> PSD) structure is carried by relationships on
        # BOTH sides of the synapse: PreSyn elements list their PSDs as
        # ``Rels: [{"Rel": "PreSynTo", "To": [x,y,z]}]`` and PostSyn
        # elements point back with ``PostSynTo``.  Union the two views
        # (either side alone is valid DVID data) and dedup by position.
        pre_pos_xyz, post_rel = [], {}  # post_rel: PreSyn pos -> [PSD pos]
        for el in obj:
            kind = el.get("Kind", "PreSyn")
            rels = el.get("Rels") or []
            if kind == "PreSyn":
                pre_pos_xyz.append(tuple(el["Pos"]))
                locs_xyz.append(el["Pos"])
                prop = el.get("Prop") or {}
                conf.append(float(prop.get("conf", 1.0)))
                partners.append(
                    [tuple(r["To"]) for r in rels
                     if r.get("Rel", "PreSynTo") == "PreSynTo"]
                )
            elif kind == "PostSyn":
                psd = tuple(el["Pos"])
                for r in rels:
                    if r.get("Rel", "PostSynTo") == "PostSynTo":
                        post_rel.setdefault(tuple(r["To"]), []).append(psd)
        for i, pos in enumerate(pre_pos_xyz):
            merged = list(partners[i])
            merged += [p for p in post_rel.get(pos, []) if p not in merged]
            partners[i] = np.asarray(
                [list(p)[::-1] for p in merged], np.float64  # xyz -> zyx
            ).reshape(-1, 3)
    else:
        raise ValueError("unrecognized T-bar JSON structure")

    locs_xyz = np.asarray(locs_xyz, dtype=np.float64).reshape(-1, 3)
    return Tbars(
        locs=locs_xyz[:, ::-1], conf=np.asarray(conf), partners=partners
    )


def save_to_json(tbars: Tbars, path: str | None = None, style: str = "raveler"):
    """Serialize T-bars back to JSON (Raveler or DVID element style)."""
    if style == "raveler":
        data = []
        for i, (x, y, z, c) in enumerate(tbars.as_xyzc()):
            plist = []
            if tbars.partners is not None:
                plist = [
                    {"location": [int(round(px)), int(round(py)), int(round(pz))]}
                    for (pz, py, px) in tbars.partners[i]
                ]
            data.append(
                {
                    "T-bar": {
                        "location": [int(round(x)), int(round(y)), int(round(z))],
                        "confidence": float(c),
                    },
                    "partners": plist,
                }
            )
        obj = {
            "data": data,
            "metadata": {"description": "synapse annotations", "file version": 1},
        }
    elif style == "dvid":
        # PreSyn elements carry their PSDs as PreSynTo relationships and
        # each (deduped) PSD position becomes a PostSyn element pointing
        # back with PostSynTo — the full DVID synapse structure, so a
        # detected T-bar pushed to DVID keeps its partner PSDs
        # (SURVEY.md section 2.2 row 4).
        obj = []
        post_to = {}  # PSD pos (xyz tuple) -> [PreSyn pos]
        for i, (x, y, z, c) in enumerate(tbars.as_xyzc()):
            pos = [int(round(x)), int(round(y)), int(round(z))]
            el = {
                "Kind": "PreSyn",
                "Pos": pos,
                "Prop": {"conf": str(float(c))},
            }
            plist = (
                tbars.partners[i] if tbars.partners is not None else []
            )
            rels = []
            for (pz, py, px) in plist:
                psd = [int(round(px)), int(round(py)), int(round(pz))]
                rels.append({"Rel": "PreSynTo", "To": psd})
                post_to.setdefault(tuple(psd), []).append(pos)
            if rels:
                el["Rels"] = rels
            obj.append(el)
        for psd, pres in post_to.items():
            obj.append(
                {
                    "Kind": "PostSyn",
                    "Pos": list(psd),
                    "Rels": [
                        {"Rel": "PostSynTo", "To": p} for p in pres
                    ],
                }
            )
    else:
        raise ValueError(f"unknown style {style!r}")
    if path is not None:
        with open(path, "w") as f:
            json.dump(obj, f)
    return obj


def _ball_offsets(radius: float) -> np.ndarray:
    """Integer (z, y, x) offsets within Euclidean ``radius`` (inclusive)."""
    r = int(np.floor(radius))
    g = np.arange(-r, r + 1)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    keep = zz * zz + yy * yy + xx * xx <= radius * radius
    return np.stack([zz[keep], yy[keep], xx[keep]], axis=1)


def tbars_to_volume(
    tbars: Tbars, shape, radius: float = 5.0, dtype=np.uint8
) -> np.ndarray:
    """Rasterize T-bar points into a binary label volume (ball stamping)."""
    shape = to3d(shape)
    vol = np.zeros(shape, dtype=dtype)
    if len(tbars) == 0:
        return vol
    offs = _ball_offsets(radius)
    centers = np.round(tbars.locs).astype(np.int64)
    coords = centers[:, None, :] + offs[None, :, :]  # (N, K, 3)
    coords = coords.reshape(-1, 3)
    ok = np.all((coords >= 0) & (coords < np.asarray(shape)), axis=1)
    coords = coords[ok]
    vol[coords[:, 0], coords[:, 1], coords[:, 2]] = 1
    return vol


def make_training_volumes(
    tbars: Tbars,
    shape,
    radius: float = 5.0,
    radius_ign: float | None = None,
    border=0,
) -> tuple[np.ndarray, np.ndarray]:
    """Build (labels, loss_mask) float32 volumes from point annotations.

    labels: 1 inside a ``radius`` ball around each T-bar, else 0.
    mask:   0 in the ``radius < d <= radius_ign`` annulus around each T-bar
            (ambiguous) and within ``border`` voxels of the volume faces,
            else 1.
    """
    shape = to3d(shape)
    if radius_ign is None:
        radius_ign = 2.0 * radius
    labels = tbars_to_volume(tbars, shape, radius, dtype=np.float32)
    ign = tbars_to_volume(tbars, shape, radius_ign, dtype=np.float32)
    mask = 1.0 - np.clip(ign - labels, 0.0, 1.0)
    bz, by, bx = to3d(border)
    if any((bz, by, bx)):
        edge = np.zeros(shape, dtype=bool)
        edge[:] = True
        edge[
            bz : shape[0] - bz if bz else shape[0],
            by : shape[1] - by if by else shape[1],
            bx : shape[2] - bx if bx else shape[2],
        ] = False
        mask[edge] = 0.0
    return labels, mask.astype(np.float32)
