"""Whole-volume detection, staged on the device or streamed from the host.

Counterpart of ``flypylib_tpu/infer/large.py``.  Two transports share one
plan and postprocess engine (:class:`_StreamPlan`, :func:`make_stream_plan`):

- :func:`detect_staged`: the raw volume is uploaded once (uint8 stays
  uint8; :func:`stage_volume`, :func:`stage_volume_chunked`) and
  reflect-padded on the device;
- :func:`detect_streaming` (out of core): windows are read on the host
  through a ``(shape, read_fn)`` pair (:func:`h5_reader`,
  :func:`dvid_reader`, :func:`array_reader`; :func:`detect_h5`) by a
  prefetch thread, uploaded one at a time and reflect-padded on the
  device, so host and device memory stay bounded.

Either runs one of two forward modes:

- ``forward="roi"``: each core ROI of a disjoint grid runs its own forward
  over its window, with a halo of ``context + window // 2`` true neighbour
  voxels (so every probability a core voxel's NMS window reads is computed
  from real data), or
- ``forward="shared"``: the whole volume (staged) or each z-band of whole
  ROI rows (streaming, :meth:`_StreamPlan.band_rpb` rows a band) runs one
  forward, written straight into a map with a -inf shell (the voxels
  outside the volume, the rule ``mask_valid_region`` applies per ROI,
  applied once), and each postprocess box is a window of that map.

``devices=`` fans either transport over several devices (or repeated
slots of one): ROI forwards round-robin over them, shared forwards split
the grid's z-rows into one band per device.  The staged volume and the
module are copied once per distinct device (``parallel/mesh.per_device``);
every device forwards the same plan and tiling with
:meth:`DetectPipeline.forward_from`, and the merge runs in grid order, so
the lists are bitwise the single-device call's.

A postprocess box keeps the candidates of its own core only, so a detection
at a seam is reported exactly once, with exactly the whole-volume decision:
NMS candidates (local maximum over a ``window`` box, -inf outside the
volume, and >= threshold) and, for CC, every above-threshold core voxel
(``cc_impl="sparse"``: the host labels their union by 6-connectivity,
``ops/components.components_from_candidates``) or the core box labelled on
the device (``cc_impl="device"``: component stats and the labels on the
box's six faces, merged across seams on the host by
``ops/components.merge_component_fragments``).  Each box costs one device ->
host copy.  The lists equal the host reference's on the whole-volume map,
in every mode and transport.

Left out, as the reference's TPU and XLA workarounds: the compile caches,
``copy_to_host_async``, the donated buffers, and the slot caps with their
grow-and-retry: ``max_detections_per_roi`` and ``max_components_per_roi``
are accepted under their reference names and bound nothing
(``torch.nonzero`` compacts every candidate).  Of the reference's
dispatch-ahead only what the fan-out needs is kept: with ``n`` devices
about ``n`` forwards (ROIs or bands) are queued before a box's copy to the
host waits for the oldest.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import Counter, deque

import numpy as np
import torch

from flypylib_tpu_torch.infer.pipeline import (DetectPipeline, as_wire,
                                               reflect_pad, to_host,
                                               zero_extend)
from flypylib_tpu_torch.infer.tiled import (default_tiling,
                                            grid_tiling_min_cost,
                                            tiling_regime)
from flypylib_tpu_torch.io.synapses import Tbars
from flypylib_tpu_torch.models.zoo import ModelSpec
from flypylib_tpu_torch.ops.components import (compact_true_indices,
                                               component_stats,
                                               components_from_candidates,
                                               label_volume,
                                               merge_component_fragments)
from flypylib_tpu_torch.ops.host_reference import sort_detections
from flypylib_tpu_torch.ops.nms import mask_valid_region, max_filter
from flypylib_tpu_torch.parallel.mesh import as_device, per_device
from flypylib_tpu_torch.utils import round_up, to3d

# the dataset h5_reader opens when none is named and the file has it (the
# reference's io/hdf5.py default)
DEFAULT_DATASET = "main"


def array_reader(vol: np.ndarray):
    """In-RAM adapter with the same (shape, read_fn) interface."""
    vol = np.asarray(vol)

    def read(lo, hi):
        return vol[tuple(slice(a, b) for a, b in zip(lo, hi))]

    return vol.shape, read


def h5_reader(path: str, dataset: str | None = None):
    """(shape, read_fn) for an HDF5 dataset; read_fn(lo, hi) -> array.
    ``dataset=None`` opens ``DEFAULT_DATASET`` when the file has it, else
    its first dataset.  The file stays open while ``read_fn`` lives."""
    import h5py

    f = h5py.File(path, "r")
    if dataset is None:
        dataset = DEFAULT_DATASET if DEFAULT_DATASET in f else next(iter(f))
    ds = f[dataset]

    def read(lo, hi):
        return ds[tuple(slice(a, b) for a, b in zip(lo, hi))]

    return tuple(ds.shape), read


def dvid_reader(client, instance: str, shape, offset=(0, 0, 0)):
    """(shape, read_fn) streaming grayscale from a DVID node through
    ``client.get_gray3d(instance, size=, offset=)``, one cutout per window,
    so the whole volume is never held in host RAM.  ``shape``/``offset``
    are (z, y, x): the box of the DVID volume to treat as the detection
    domain."""
    shape = to3d(shape)
    offset = to3d(offset)

    def read(lo, hi):
        size = tuple(int(b - a) for a, b in zip(lo, hi))
        off = tuple(int(o + a) for o, a in zip(offset, lo))
        return client.get_gray3d(instance, size=size, offset=off)

    return tuple(int(s) for s in shape), read


def _default_tile(extent: int, spec: ModelSpec, target: int = 64,
                  cap: int = 176) -> int:
    """Default ROI tile: the valid, phase-aligned divisor of the ROI extent
    nearest ``target`` (within [target // 2, cap]), so that the tile grid
    covers the ROI exactly; the extent itself when it is at most
    ``2 target``; without such a divisor, the largest valid tile under
    ``cap`` (an overshooting grid).  The reference's rule and numbers,
    which were chosen on a TPU."""
    if extent <= cap:
        if extent <= 2 * target:
            return extent
    mult = max(spec.size_multiple, 1)
    best = None
    for d in range(max(target // 2, mult), min(cap, extent) + 1):
        if extent % d == 0 and d % mult == 0 and spec.is_valid_size(
            d + 2 * spec.context
        ):
            if best is None or abs(d - target) < abs(best - target):
                best = d
    if best is not None:
        return best
    for d in range(min(cap, extent), mult - 1, -1):
        if d % mult == 0 and spec.is_valid_size(d + 2 * spec.context):
            return d
    return extent  # degenerate (extent < size_multiple): nothing to split


def memory_bytes(device) -> tuple[int, int]:
    """(available, total) bytes of ``device``'s memory.  CUDA: the free
    bytes ``torch.cuda.mem_get_info`` reports plus the caching allocator's
    reserved but unallocated bytes, and the card's total; the CPU: the
    host's available and physical memory."""
    device = torch.device(device)
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return free + cached, total
    page = os.sysconf("SC_PAGE_SIZE")
    return (os.sysconf("SC_AVPHYS_PAGES") * page,
            os.sysconf("SC_PHYS_PAGES") * page)


def staged_fits(vol: np.ndarray, device, headroom: float = 0.6,
                devices=None) -> bool:
    """True when the staged mode fits ``device``: the volume at its wire
    dtype plus the most loaded device's share of the f32 probability shell
    within ``headroom`` of the device's total memory (the reference's
    ``_staged_fits_hbm`` arithmetic, against the card's own size).  With
    the fan-out's ``devices`` the shell splits into one z-band per slot, so
    a device holding ``k`` of ``n`` slots holds ``k / n`` of it: the whole
    shell when every slot is one device."""
    share = (max(Counter(as_device(d) for d in devices).values())
             / len(devices) if devices else 1)
    return vol.nbytes + 4 * vol.size * share <= \
        headroom * memory_bytes(device)[1]


class _StreamPlan:
    """Geometry and per-box postprocess/merge engine of the staged modes."""

    # high-water of one tile batch's forward, bytes per tile-input voxel
    # (torch.cuda.max_memory_allocated over one bf16 forward, less what was
    # allocated before it; chip_smoke.py phase 10 on an NVIDIA H100 80GB
    # HBM3): "cover" the packed U-Net at its 1024^3 shared tile (in 388),
    # "grid" the widest zoo conv stack, packed vgg_like (in 94, batch 16)
    act_bytes_per_voxel = {"cover": 267.69, "grid": 292.47}

    def __init__(self, spec: ModelSpec, variables, shape, core,
                 tile_out: int | None, tile_batch: int | None, window,
                 threshold: float, max_detections_per_roi: int,
                 max_components_per_roi: int, method: str,
                 cc_impl: str = "sparse", fused_impl: str = "filter"):
        if method not in ("nms", "components", "both"):
            raise ValueError(f"unknown method {method!r}")
        if cc_impl not in ("sparse", "device"):
            raise ValueError(f"unknown cc_impl {cc_impl!r}")
        if fused_impl not in ("nbr", "filter"):
            raise ValueError(f"unknown fused_impl {fused_impl!r}")
        self.fused_impl = fused_impl
        self.want_nms = method in ("nms", "both")
        self.want_cc = method in ("components", "both")
        self.method = method
        self.cc_impl = cc_impl
        self.threshold = threshold

        self.shape = shape = to3d(shape)
        self.window = win = to3d(window)
        ctx = spec.context
        h = ctx + (max(win) // 2 if self.want_nms else 0)
        mult = spec.size_multiple
        # a model whose valid input sizes step by size_multiple computes a
        # voxel the same way only at the same phase modulo size_multiple:
        # the U-Net's pooling, and the packed engines' space-to-depth (the
        # order of a packed conv's sums depends on the output voxel's
        # parity, so an ROI forward at another phase differs in the last
        # bits).  An ROI forward keeps the whole-volume phase iff corner -
        # h = 0 (mod size_multiple), so h is rounded up and the core
        # snapped below.  The reference does this for pooling ("cover")
        # models only.
        phased = mult > 1
        if phased:
            h = round_up(h, mult)
        self.ctx, self.h = ctx, h
        self.fetch_halo = h + ctx  # plus the context of the halo's own probs

        self.core = int(core) if np.isscalar(core) else tuple(to3d(core))
        core3 = [round_up(c, mult) if phased else c for c in to3d(core)]
        self.core_dims = [min(c, s) for c, s in zip(core3, shape)]
        starts = [list(range(0, s, c)) for s, c in zip(shape, self.core_dims)]
        self.grid = [
            ((iz, iy, ix), (z0, y0, x0))
            for iz, z0 in enumerate(starts[0])
            for iy, y0 in enumerate(starts[1])
            for ix, x0 in enumerate(starts[2])
        ]

        self.req_tile = (tile_out, tile_batch)  # as passed (for _check_plan)
        roi_extent = max(self.core_dims) + 2 * h
        if tiling_regime(spec) == "cover":
            d_out, d_batch = default_tiling(spec, (roi_extent,) * 3)
            tile_out = d_out if tile_out is None else tile_out
            tile_batch = d_batch if tile_batch is None else tile_batch
        if tile_out is None:
            tile_out = _default_tile(roi_extent, spec)
        if tile_batch is None:
            tile_batch = min(16, max(1, (roi_extent // tile_out) ** 2))
        self.pipe = DetectPipeline(
            spec, variables, vol_shape=tuple(c + 2 * h for c in self.core_dims),
            tile_out=min(tile_out, roi_extent), tile_batch=tile_batch,
            window=window, threshold=threshold,
            max_detections=max_detections_per_roi, run_cc=False,
            pre_padded=True,
        )
        self._fp = None
        self._band_pipes = {}
        # seconds the last detect_streaming call's prefetch thread spent
        # reading windows and padding them
        self.fetch_seconds = {"read": 0.0, "pad": 0.0}

    @property
    def device(self) -> torch.device:
        return self.pipe.device

    def region(self, corner):
        """(lo_want, vlo, vhi) for an ROI corner: the wanted fetch box and
        the map coordinates of the true-volume box (voxels outside are
        masked to -inf: the whole-volume boundary rule)."""
        lo_want = [c - self.fetch_halo for c in corner]
        region0 = [v + self.ctx for v in lo_want]
        vlo = [max(0, -r0) for r0 in region0]
        vhi = [
            min(cd + 2 * self.h, s - r0)
            for cd, s, r0 in zip(self.core_dims, self.shape, region0)
        ]
        return lo_want, vlo, vhi

    # -- the postprocess of one box ---------------------------------------
    def _box(self, prob: torch.Tensor, at, dims, nbr=None) -> dict:
        """Candidates of the box ``prob[at : at + dims]`` (``prob`` holds
        the window's halo around it, -inf outside the volume), in ONE
        device -> host copy: ``idx`` (box-local flat indices, ascending)
        and ``conf`` of the NMS candidates, or with sparse CC of every
        above-threshold core voxel, plus ``is_max`` for ``method="both"``;
        with device CC, ``cc`` (:meth:`_cc_core_export`).

        NMS candidates (local maximum over the window and >= threshold)
        are a subset of the CC candidates (>= threshold), so ``"both"``
        with sparse CC compacts the CC set once and gathers each
        candidate's local-max bit: from a max filter over the box +-
        window // 2 only (no suppression reaches farther into the box) or,
        with ``nbr`` (``(raw, vlo, vhi)``, ROI mode and ``fused_impl=
        "nbr"``), from each candidate's own neighbourhood
        (:meth:`_nbr_is_max`)."""
        thr = self.threshold
        sparse = self.want_cc and self.cc_impl == "sparse"
        fused_nbr = nbr is not None and self.want_nms and sparse
        core3 = prob[at[0]:at[0] + dims[0], at[1]:at[1] + dims[1],
                     at[2]:at[2] + dims[2]]
        core = core3.reshape(-1)
        if self.want_nms and not fused_nbr:
            lo = [w // 2 for w in self.window]
            hi = [w - 1 - w // 2 for w in self.window]
            sub = prob[at[0] - lo[0]:at[0] + dims[0] + hi[0],
                       at[1] - lo[1]:at[1] + dims[1] + hi[1],
                       at[2] - lo[2]:at[2] + dims[2] + hi[2]]
            cand = (sub == max_filter(sub, self.window)) & (sub >= thr)
            cand = cand[lo[0]:lo[0] + dims[0], lo[1]:lo[1] + dims[1],
                        lo[2]:lo[2] + dims[2]].reshape(-1)
        parts = []
        if sparse:
            idx = compact_true_indices(core >= thr)
            parts = [idx, core[idx]]
            if fused_nbr:
                parts.append(self._nbr_is_max(*nbr, at, dims, idx, core[idx]))
            elif self.want_nms:
                parts.append(cand[idx])
        elif self.want_nms:
            idx = compact_true_indices(cand)
            parts = [idx, core[idx]]
        n_own = len(parts)
        if self.want_cc and not sparse:
            parts += self._cc_core_export(core3, thr)
        host = to_host(*parts)
        out = {}
        if n_own:
            out = {"idx": host[0].astype(np.int64), "conf": host[1]}
        if n_own > 2:
            out["is_max"] = host[2].astype(bool)
        if len(host) > n_own:
            out["cc"] = host[n_own:]
        return out

    def _nbr_is_max(self, raw: torch.Tensor, vlo, vhi, at, dims,
                    idx: torch.Tensor, conf: torch.Tensor) -> torch.Tensor:
        """``fused_impl="nbr"``: each compacted candidate's local-max bit
        from a gather of its window neighbourhood in the ROI's raw map
        (``raw``, map coordinates; the box sits at ``at``), neighbours
        outside the true volume ``[vlo, vhi)`` read as -inf by a coordinate
        compare.  A candidate is a maximum iff no neighbour is strictly
        larger, so plateau ties count, as the max filter's ``==`` does."""
        dev = raw.device
        cz, cy, cx = dims
        pos = torch.stack([idx // (cy * cx) + at[0], (idx // cx) % cy + at[1],
                           idx % cx + at[2]], 1)
        offs = torch.stack(torch.meshgrid(
            *[torch.arange(-(w // 2), w - w // 2, device=dev)
              for w in self.window], indexing="ij"), -1).reshape(-1, 3)
        nb = pos[:, None, :] + offs[None]
        lo = torch.tensor(vlo, device=dev)
        hi = torch.tensor(vhi, device=dev)
        inb = ((nb >= lo) & (nb < hi)).all(-1)
        size = torch.tensor(raw.shape, device=dev)
        nb = torch.minimum(torch.clamp(nb, min=0), size - 1)
        flat = (nb[..., 0] * raw.shape[1] + nb[..., 1]) * raw.shape[2] \
            + nb[..., 2]
        nval = torch.where(inb, raw.reshape(-1)[flat], -torch.inf)
        return (nval <= conf[:, None]).all(1)

    def _cc_core_export(self, corep: torch.Tensor, thr) -> list:
        """Device CC of one core box ``corep`` (``core_dims``): labelled by
        ``label_volume``, exported as ``[uniq, sums, count, conf]``
        (:func:`component_stats`: ascending local roots, int64 coordinate
        sums) and then, for each of the 6 faces (z-lo, z-hi, y-lo, y-hi,
        x-lo, x-hi), the face-local flat positions of its labelled voxels
        and their labels, compacted by ``torch.nonzero`` (no slot cap)."""
        mask = corep >= thr
        lab = label_volume(mask)
        parts = list(component_stats(corep, lab, compact_true_indices(mask)))
        n = mask.numel()
        for plane in (lab[0], lab[-1], lab[:, 0], lab[:, -1], lab[:, :, 0],
                      lab[:, :, -1]):
            flat = plane.reshape(-1)
            pos = compact_true_indices(flat < n)
            parts += [pos, flat[pos]]
        return parts

    def _dense_faces(self, faces):
        """Dense face label planes from the sparse export (host side;
        ``merge_component_fragments`` consumes dense planes)."""
        cz, cy, cx = self.core_dims
        sentinel = cz * cy * cx
        shapes = [(cy, cx), (cy, cx), (cz, cx), (cz, cx), (cz, cy),
                  (cz, cy)]
        dense = []
        for (idx, labs), shp in zip(faces, shapes):
            d = np.full(shp[0] * shp[1], sentinel, np.int32)
            d[np.asarray(idx, np.int64)] = labs
            dense.append(d.reshape(shp))
        return dense

    def _dispatch(self, key, corner, out, vlo, vhi) -> dict:
        """One ROI's postprocess over its own map ``out`` (ROI mode)."""
        vz, vy, vx = self.pipe.vol_shape
        raw = out[:vz, :vy, :vx]
        prob, _ = mask_valid_region(raw, vlo, vhi)
        h = self.h
        nbr = (raw, vlo, vhi) if self.fused_impl == "nbr" else None
        return {"key": key, "corner": corner, "dims": tuple(self.core_dims),
                **self._box(prob, (h, h, h), self.core_dims, nbr)}

    def _dispatch_shared(self, key, corner, shell, dims=None,
                         corner_local=None) -> dict:
        """One box's postprocess over a shared shell (no masking: the shell
        is -inf outside the volume).  ``corner`` is the box's global
        corner, ``corner_local`` (band shells) the same corner in the
        shell's own coordinates.  ``fused_impl="nbr"`` falls back to the
        max filter here, as in the reference."""
        dims = tuple(self.core_dims if dims is None else dims)
        h = self.h
        local = corner if corner_local is None else corner_local
        at = tuple(c + h for c in local)
        return {"key": key, "corner": corner, "dims": dims,
                **self._box(shell, at, dims)}

    def _collect(self, rec: dict, progress=None) -> None:
        """Merge one box's candidates, made global (int64 flat indices),
        or its device-CC fragments; then ``progress(corner, n_nms)``."""
        corner, (cz, cy, cx) = rec["corner"], rec["dims"]
        n_own = 0
        if "idx" in rec:
            idx = rec["idx"]
            gz = idx // (cy * cx) + corner[0]
            rem = idx % (cy * cx)
            gy = rem // cx + corner[1]
            gx = rem % cx + corner[2]
            conf = rec["conf"].astype(np.float32)
            if self.want_nms:
                own = rec.get("is_max", np.ones(idx.shape, bool))
                self._all_locs.append(
                    np.stack([gz, gy, gx], axis=1).astype(np.float64)[own])
                self._all_conf.append(conf[own])
                n_own = int(own.sum())
            if self.want_cc and self.cc_impl == "sparse":
                vz, vy, vx = self.shape
                self._cc_rois[rec["key"]] = {
                    "gflat": (gz * vy + gy) * vx + gx, "prob": conf}
        if "cc" in rec:
            uniq, sums, count, conf, *faces = rec["cc"]
            count = count.astype(np.int64)
            self._cc_rois[rec["key"]] = {
                "uniq": uniq.astype(np.int64),
                # globalised by the corner, in integers (exact centroids)
                "sums": (sums.astype(np.int64)
                         + np.asarray(corner, np.int64) * count[:, None]),
                "count": count, "conf": conf,
                "valid": np.ones(count.shape, bool),
                "faces": self._dense_faces(zip(faces[::2], faces[1::2])),
            }
        if progress:
            progress(corner, n_own)

    def _start(self) -> None:
        self._all_locs, self._all_conf = [], []
        self._cc_rois = {}

    def _finalize(self):
        results = []
        empty = Tbars(locs=np.zeros((0, 3)), conf=np.zeros((0,)))
        if self.want_nms:
            results.append(sort_detections(np.concatenate(self._all_locs),
                                           np.concatenate(self._all_conf))
                           if self._all_locs else empty)
        if self.want_cc and self.cc_impl == "device":
            cz, cy, cx = self.core_dims
            results.append(merge_component_fragments(self._cc_rois,
                                                     cz * cy * cx))
        elif self.want_cc:
            if self._cc_rois:
                gflat = np.concatenate(
                    [r["gflat"] for r in self._cc_rois.values()])
                probs = np.concatenate(
                    [r["prob"] for r in self._cc_rois.values()])
                order = np.argsort(gflat)
                results.append(components_from_candidates(
                    gflat[order], probs[order], self.shape))
            else:
                results.append(empty)
        if self.method == "both":
            return tuple(results)
        return results[0]

    def consume(self, outs, progress=None, ahead: int = 1):
        """Postprocess and merge an iterator of ``(key, corner, out, vlo,
        vhi)`` ROI forwards (ROI mode) in grid order.  ``ahead`` forwards
        are drawn (so queued on their devices) before the oldest one's box
        is copied to the host: one ROI map is held at a time with the
        default, about ``ahead`` with the fan-out."""
        self._start()
        pend = deque()
        for item in outs:
            pend.append(item)
            if len(pend) >= ahead:
                self._collect(self._dispatch(*pend.popleft()), progress)
        while pend:
            self._collect(self._dispatch(*pend.popleft()), progress)
        return self._finalize()

    # -- shared whole-volume forward ----------------------------------------
    def full_pipe(self) -> DetectPipeline:
        """The whole-volume forward pipeline of the shared mode (one per
        plan)."""
        if self._fp is None:
            self._fp = self._make_shared_pipe(self.shape)
        return self._fp

    def _make_shared_pipe(self, vol_shape) -> DetectPipeline:
        """Forward-only pipeline over ``vol_shape`` with the shared mode's
        tiles: the cost-minimal grid for "cover" models, the ROI rule over
        the whole extent for conv stacks, or the caller's explicit
        ``make_stream_plan(tile_out=, tile_batch=)``."""
        spec = self.pipe.spec
        if tiling_regime(spec) == "cover":
            t_out, t_batch = grid_tiling_min_cost(spec, vol_shape)
        else:
            ext = max(vol_shape)
            t_out = _default_tile(ext, spec)
            t_batch = min(16, max(1, (ext // t_out) ** 2))
        if self.req_tile[0] is not None:
            t_out = min(int(self.req_tile[0]), max(vol_shape))
        if self.req_tile[1] is not None:
            t_batch = int(self.req_tile[1])
        return DetectPipeline(spec, None, vol_shape=vol_shape, tile_out=t_out,
                              tile_batch=t_batch, window=self.window,
                              threshold=self.threshold, max_detections=1,
                              run_cc=False, pre_padded=True)

    def _shell_ext(self):
        """Per-axis high-side -inf slack so every box of the shell stays in
        bounds (the last core may overhang a non-divisible volume)."""
        return [
            max(0, max(c[d] for _, c in self.grid) + self.core_dims[d] - s)
            for d, s in enumerate(self.shape)
        ]

    def _shell_shape(self):
        """Shell dims: volume + h low halo + max(h + overhang slack, the
        forward's grid extension) high side."""
        h = self.h
        os_ = self.full_pipe()._out_shape
        return tuple(
            max(s + 2 * h + e, h + o)
            for s, e, o in zip(self.shape, self._shell_ext(), os_)
        )

    @torch.no_grad()
    def shared_prob(self, staged) -> torch.Tensor:
        """Forward the whole volume once, from a staged upload of either
        form, straight into the -inf-shelled shared map; the volume's voxel
        (z, y, x) sits at shell (z + h, y + h, x + h)."""
        fp = self.full_pipe()
        ctx, h = self.ctx, self.h
        tin = fp._tin
        _, py, px = fp.padded_shape
        off = _staged_halo(staged) - ctx
        if off < 0:
            raise ValueError(f"staged halo {off + ctx} < context {ctx}")
        z_top = max(zs for zs, _ in fp._slabs) + tin
        fetch = _staged_windows(staged, [self.device],
                                (off + z_top, off + py, off + px))[self.device]
        shell = torch.full(self._shell_shape(), -torch.inf,
                           dtype=torch.float32, device=self.device)
        fp.forward_slabs(lambda zs: fetch((off + zs, off, off), (tin, py, px)),
                         out=shell, offset=(h, h, h))
        return self._mask_shell(shell, -h)

    def _mask_shell(self, shell: torch.Tensor, z0: int) -> torch.Tensor:
        """Restore -inf outside the volume in a shell whose index 0 sits at
        global ``(z0, -h, -h)`` (grid-extension tiles wrote there): the
        whole-volume shell (``z0 = -h``) or a z-band's (``z0 = b0 - h``)."""
        h = self.h
        for axis, (s, g0) in enumerate(zip(self.shape, (z0, -h, -h))):
            n = shell.shape[axis]
            lo = min(max(0, -g0), n)
            hi = min(max(lo, s - g0), n)
            shell.narrow(axis, 0, lo).fill_(-torch.inf)
            shell.narrow(axis, hi, n - hi).fill_(-torch.inf)
        return shell

    def _shared_boxes(self, entries=None):
        """The shared sweep's postprocess boxes: the base ROI grid with
        consecutive cores grouped into boxes of about ``shared_box_target``
        (512) per axis; coverage, and so the lists, stay the base grid's.
        Device CC keeps the base grid: its face exports are sized by
        ``core_dims`` and keyed by grid position.  ``entries`` restricts
        the partition to a full sub-grid (a band's rows).  Returns ``[(key,
        corner, dims)]``."""
        grid = self.grid if entries is None else entries
        base = [(k, c, tuple(self.core_dims)) for k, c in grid]
        if not grid or (self.want_cc and self.cc_impl == "device"):
            return base
        target = getattr(self, "shared_box_target", 512)
        ks = [max(1, target // c) for c in self.core_dims]
        if all(k == 1 for k in ks):
            return base
        starts = [sorted({c[d] for _, c in grid}) for d in range(3)]
        ext = [s[-1] + cd for s, cd in zip(starts, self.core_dims)]
        boxes = []
        for d in range(3):
            grp = [starts[d][i:i + ks[d]]
                   for i in range(0, len(starts[d]), ks[d])]
            boxes.append([
                (g[0], min(g[-1] + self.core_dims[d], ext[d]) - g[0])
                for g in grp
            ])
        return [
            ((z0, y0, x0), (z0, y0, x0), (dz, dy, dx))
            for z0, dz in boxes[0]
            for y0, dy in boxes[1]
            for x0, dx in boxes[2]
        ]

    def consume_shared(self, shell: torch.Tensor, progress=None):
        """Postprocess sweep over the shared shell, box by box."""
        self._start()
        for key, corner, dims in self._shared_boxes():
            self._collect(self._dispatch_shared(key, corner, shell, dims),
                          progress)
        return self._finalize()

    # -- z-bands: the out-of-core shared forward ----------------------------
    # The grid's z-rows split into contiguous bands of ``rpb`` rows; each
    # band forwards its rows plus the +-h NMS halo (so boxes at a band seam
    # read real probabilities) into a band-local -inf shell, and each box is
    # postprocessed on its own band.  The band grid anchors at b0 - h, which
    # is 0 modulo size_multiple (core and h are rounded to it), so every
    # probability is the whole-volume map's, bit for bit.

    def _band_partition(self, n_devices: int):
        """``(rows_per_band, n_bands, band_z0s)`` splitting the grid's
        z-rows across ``n_devices``: uniform bands, the last shifted down
        (:meth:`_band_starts`)."""
        n_rows = len({c[0] for _, c in self.grid}) or 1
        nb = max(1, min(int(n_devices), n_rows))
        rpb = -(-n_rows // nb)
        b0s = self._band_starts(rpb)
        return rpb, len(b0s), b0s

    def _band_starts(self, rpb: int):
        """Band z0s (global voxel coordinates) for ``rpb`` rows a band, the
        last band shifted down to keep one band extent (its shell overlaps
        the previous band's; each box is still postprocessed once, on its
        own band)."""
        cz = self.core_dims[0]
        n_rows = len({c[0] for _, c in self.grid}) or 1
        nb = -(-n_rows // rpb)
        return [min(i * rpb, n_rows - rpb) * cz for i in range(nb)]

    def band_pipe(self, rows_per_band: int) -> DetectPipeline:
        """Forward pipeline of one z-band (one per band extent)."""
        fp = self._band_pipes.get(rows_per_band)
        if fp is None:
            bz = rows_per_band * self.core_dims[0] + 2 * self.h
            fp = self._band_pipes[rows_per_band] = self._make_shared_pipe(
                (bz, self.shape[1], self.shape[2]))
        return fp

    def _band_shell_shape(self, fp: DetectPipeline):
        """Band shell dims: the band's forward span (and grid overshoot) in
        z, shell index 0 at global ``b0 - h``; the whole-volume shell's y
        and x."""
        h = self.h
        _, sy, sx = self._shell_shape()
        return (max(fp.vol_shape[0], fp._out_shape[0]),
                max(sy, h + fp._out_shape[1]), max(sx, h + fp._out_shape[2]))

    @torch.no_grad()
    def shared_prob_band_local(self, W: torch.Tensor, b0: int,
                               fp: DetectPipeline, module=None) -> torch.Tensor:
        """Forward one z-band from its band-local padded window ``W`` (index
        0 at global ``(b0 - h - ctx, -ctx, -ctx)``: :func:`_band_window`
        streamed, or a window of a staged volume) into a -inf band shell on
        ``W``'s device: the probabilities of global z ``[b0 - h, b0 - h +
        band extent)``, bitwise the whole-volume shell's there; ``module``
        as in ``forward_slabs``."""
        h, tin = self.h, fp._tin
        _, py, px = fp.padded_shape
        shell = torch.full(self._band_shell_shape(fp), -torch.inf,
                           dtype=torch.float32, device=W.device)
        fp.forward_slabs(lambda zs: W[zs:zs + tin, :py, :px],
                         out=shell, offset=(0, h, h), module=module)
        return self._mask_shell(shell, b0 - h)

    def _post_bytes(self) -> int:
        """Bytes of the largest postprocess box's temporaries (~6 f32
        copies of it and its window halo)."""
        w = [w - 1 if self.want_nms else 0 for w in self.window]
        return 6 * 4 * max(int(np.prod([d + e for d, e in zip(dims, w)]))
                           for _, _, dims in self._shared_boxes())

    def _act_bytes(self, fp: DetectPipeline) -> int:
        """One tile batch's activation high-water of ``fp``'s forward."""
        regime = tiling_regime(self.pipe.spec)
        return int(self.act_bytes_per_voxel[regime] * fp._tiled.tile_batch
                   * fp._tin ** 3)

    def _shared_cost_ok(self, fp: DetectPipeline, n_grids: int = 1) -> bool:
        """The reference's cost gate: ``n_grids`` sweeps of ``fp``'s tile
        grid read at most 0.85 times the conv input voxels of the per-ROI
        sweep (the 0.85 was chosen on a TPU)."""
        n_sh = n_grids * fp.n_batches * fp._tiled.tile_batch
        n_roi = self.pipe.n_batches * self.pipe._tiled.tile_batch
        return (n_sh * fp._tin ** 3
                <= 0.85 * len(self.grid) * n_roi * self.pipe._tin ** 3)

    def band_rpb(self, itemsize: int = 4, cost_gate: bool = True,
                 shells: int = 2):
        """Rows per band of the out-of-core shared forward: the largest
        whose peak fits the device now, or ``None`` when none fits or, with
        ``cost_gate``, when the band grids would not cut the conv input
        voxels against the per-ROI sweep (:meth:`_shared_cost_ok`).  The
        peak holds ``shells`` band shells (two on one device; more when the
        fan-out queues several bands on one), two band windows of
        ``itemsize`` bytes a voxel, one tile batch's activations
        (``act_bytes_per_voxel``) and the largest box's temporaries, within
        90% of the device's available memory (``memory_bytes``), as
        :meth:`shared_auto` counts."""
        n_rows = len({c[0] for _, c in self.grid}) or 1
        avail = 0.9 * memory_bytes(self.device)[0]
        post = self._post_bytes()
        for rpb in range(n_rows, 0, -1):
            nb = -(-n_rows // rpb)
            if -(-n_rows // nb) != rpb:
                continue  # nb bands of fewer rows cover the grid as well
            fp = self.band_pipe(rpb)
            shell = 4 * int(np.prod(self._band_shell_shape(fp)))
            z_top = max(zs for zs, _ in fp._slabs) + fp._tin
            _, py, px = fp.padded_shape
            window = int(itemsize) * z_top * py * px
            if (shells * shell + 2 * window + self._act_bytes(fp) + post
                    > avail):
                continue
            if cost_gate and not self._shared_cost_ok(fp, nb):
                return None
            return rpb
        return None

    def consume_shared_stream(self, shell_for, rpb: int, progress=None,
                              n_devices: int = 1):
        """:meth:`consume_shared` over band shells built lazily:
        ``shell_for(band, b0)`` runs once per band, in grid z-row order.
        Each band's shell and the next ``n_devices - 1`` bands' are built
        (their forwards queued, one per device of the fan-out) before its
        boxes are copied back, and its shell is dropped after them: one
        band shell is held at a time on one device, about ``n_devices``
        with the fan-out.  Grid order is kept, so the merge is the
        whole-volume sweep's."""
        b0s = self._band_starts(rpb)
        nb = len(b0s)
        self._start()
        shells = {}
        for band, b0 in enumerate(b0s):
            entries = [(k, c) for k, c in self.grid
                       if min(k[0] // rpb, nb - 1) == band]
            shell = None  # the previous band's, dropped before the forward
            for k in range(band, min(band + max(1, int(n_devices)), nb)):
                if k not in shells:
                    shells[k] = shell_for(k, b0s[k])
            shell = shells.pop(band)
            for key, corner, dims in self._shared_boxes(entries):
                local = (corner[0] - b0, corner[1], corner[2])
                self._collect(self._dispatch_shared(key, corner, shell, dims,
                                                    local), progress)
        return self._finalize()

    def shared_auto(self, staged_bytes: int = 0, n_devices: int = 1,
                    devices=None) -> bool:
        """True when the shared forward's peak fits the device now: the -inf
        shell, one tile batch's activations (``act_bytes_per_voxel``) and
        the largest postprocess box's temporaries (~6 f32 copies of it)
        within 90% of the device's available memory (``memory_bytes``).
        ``staged_bytes`` is not added on the plan's own device: the staged
        volume is resident already, so the available memory excludes it.
        For "cover" models also only when the shared grid cuts the conv
        input voxels by 15% or more against the per-ROI sweep, as the
        reference.

        With ``n_devices > 1`` the estimate is per device: each holds its
        z-band's shell (:meth:`_band_partition`) and, off the plan's
        device, a copy of the staged volume.  ``devices`` (the fan-out's
        list) counts the shells that repeated slots put on one device;
        without it each device holds one band."""
        if n_devices > 1:
            rpb, nb, _ = self._band_partition(n_devices)
            fp = self.band_pipe(rpb)
            shell = 4 * int(np.prod(self._band_shell_shape(fp)))
        else:
            nb, fp = 1, self.full_pipe()
            shell = 4 * int(np.prod(self._shell_shape()))
        if tiling_regime(self.pipe.spec) == "cover" and \
                not self._shared_cost_ok(fp, nb):
            return False
        rest = self._act_bytes(fp) + self._post_bytes()
        share = (Counter(as_device(d) for d in devices[:nb]) if devices
                 else {self.device: 1})
        return all(k * shell + rest + (0 if d == self.device else staged_bytes)
                   <= 0.9 * memory_bytes(d)[0] for d, k in share.items())


def _default_core(spec: ModelSpec, window, grid_default: int,
                  shape=None) -> int:
    """Model-aware default ROI core: conv stacks keep ``grid_default``;
    pooling ("cover") models take the core that minimises the processed
    voxels (ROI count x covering tile volume) under the reference's tile
    input cap of 428 (chosen on a TPU), preferring the larger core on
    ties."""
    if tiling_regime(spec) != "cover":
        return grid_default
    ctx = spec.context
    mult = max(spec.size_multiple, 1)
    h = round_up(ctx + max(to3d(window)) // 2, mult)
    over = 2 * (h + ctx)
    max_core = (428 - over) // mult * mult
    while max_core > mult and spec.valid_size(max_core + over) > 428:
        max_core -= mult
    if shape is None:
        return max(max_core, mult)
    dims = to3d(shape)
    best, best_cost = max_core, float("inf")
    for core in range(mult, max_core + 1, mult):
        tin = spec.valid_size(min(core, max(dims)) + over)
        cost = tin**3
        for d in dims:
            cost *= -(-d // min(core, d))
        if cost <= best_cost:
            best, best_cost = core, cost
    return best


def make_stream_plan(spec: ModelSpec, variables, shape, core: int | None = None,
                     tile_out: int | None = None, tile_batch: int | None = None,
                     window=5, threshold: float = 0.5,
                     max_detections_per_roi: int = 4096,
                     max_components_per_roi: int = 4096, method: str = "nms",
                     cc_impl: str = "sparse", fused_impl: str = "filter"):
    """The reusable staged-detection engine (ROI grid and pipelines) for
    :func:`detect_staged`.  ``core`` is the ROI ownership box, an int or a
    ``(z, y, x)`` triple; ``None`` picks :func:`_default_core` (128 for
    conv stacks).  For models with a ``size_multiple`` above 1 (pooling,
    and the packed engines) the core and the NMS halo are snapped up to
    it, so every ROI forward keeps the whole-volume phase.  ``tile_out`` /
    ``tile_batch`` apply to both the per-ROI and the shared forward.
    ``variables`` must be None (the port's modules hold their own
    weights); the ``max_*_per_roi`` slot caps are accepted and unused."""
    if tile_out is not None and int(tile_out) < spec.size_multiple:
        raise ValueError(
            f"tile_out={tile_out} is below the model's size_multiple "
            f"({spec.size_multiple}); the tile forward cannot keep the "
            "pooling phase at that size")
    if tile_batch is not None and int(tile_batch) < 1:
        raise ValueError(f"tile_batch must be >= 1, got {tile_batch}")
    if core is None:
        core = _default_core(spec, window, 128, shape)
    return _StreamPlan(spec, variables, shape, core, tile_out, tile_batch,
                       window, threshold, max_detections_per_roi,
                       max_components_per_roi, method, cc_impl, fused_impl)


def _check_plan(plan, shape, window, method, threshold, cc_impl=None,
                core=None, tile_out=None, tile_batch=None):
    """Geometry arguments are baked into a plan: reject a mismatch, and
    retarget the threshold.  ``core`` / ``tile_out`` / ``tile_batch`` are
    checked only when the caller passed them."""
    if plan.shape != to3d(shape):
        raise ValueError(f"plan shape {plan.shape} != volume {to3d(shape)}")
    if plan.window != to3d(window):
        raise ValueError(f"plan window {plan.window} != {to3d(window)}")
    if plan.method != method:
        raise ValueError(f"plan method {plan.method!r} != {method!r}")
    if cc_impl is not None and plan.cc_impl != cc_impl:
        raise ValueError(f"plan cc_impl {plan.cc_impl!r} != {cc_impl!r}")
    if core is not None and tuple(to3d(core)) != tuple(to3d(plan.core)):
        raise ValueError(f"plan core {plan.core} != caller core {core}")
    for name, want, have in (("tile_out", tile_out, plan.req_tile[0]),
                             ("tile_batch", tile_batch, plan.req_tile[1])):
        if want is not None and want != have:
            raise ValueError(f"plan {name} {have} != caller {name} {want} "
                             "(rebuild the plan with the desired tiling)")
    plan.threshold = threshold
    plan.pipe.threshold = float(threshold)
    return plan


class _StagedChunks:
    """Disjoint raw z-chunks of a volume on the device (see
    :func:`stage_volume_chunked`); each window of the reflect-padded volume
    is assembled from the chunks it covers."""

    __slots__ = ("chunks", "halo", "bounds")

    def __init__(self, chunks, halo, bounds):
        self.chunks = chunks
        self.halo = halo
        self.bounds = bounds

    def window(self, start, size) -> torch.Tensor:
        """``B[start : start + size]`` on the device, where ``B`` is the
        volume reflect-padded by ``halo`` and zero-extended on the high
        side: bitwise :func:`stage_volume`'s ``big`` there.  Per axis the
        window's padded indices map to volume indices by one reflection;
        z gathers only the chunks it covers."""
        H = self.halo
        shape = (self.bounds[-1],) + tuple(self.chunks[0].shape[1:3])
        dev = self.chunks[0].device
        idx, n_real = [], []
        for c, P, S in zip(start, size, shape):
            i = torch.arange(c - H, c - H + P)
            n = int((i < S + H).sum())  # past the back reflection: zeros
            i = i[:n]
            i = torch.where(i < 0, -i, torch.where(i >= S, 2 * (S - 1) - i, i))
            idx.append(i)
            n_real.append(n)
        out = self.chunks[0].new_zeros(tuple(size))
        if min(n_real) == 0:
            return out
        z_lo, z_hi = int(idx[0].min()), int(idx[0].max()) + 1
        b = self.bounds
        parts = [self.chunks[k][max(z_lo, b[k]) - b[k]:min(z_hi, b[k + 1]) - b[k]]
                 for k in range(len(self.chunks))
                 if b[k] < z_hi and b[k + 1] > z_lo]
        raw = parts[0] if len(parts) == 1 else torch.cat(parts)
        raw = raw.index_select(0, (idx[0] - z_lo).to(dev))
        raw = raw.index_select(1, idx[1].to(dev)).index_select(2, idx[2].to(dev))
        out[:n_real[0], :n_real[1], :n_real[2]] = raw
        return out

    def to(self, device) -> "_StagedChunks":
        """The same chunks on ``device`` (``self`` when they live there)."""
        device = as_device(device)
        if self.chunks[0].device == device:
            return self
        return _StagedChunks([c.to(device) for c in self.chunks], self.halo,
                             self.bounds)


def _staged_halo(staged) -> int:
    """The reflect halo of a staged upload of either form."""
    return staged.halo if isinstance(staged, _StagedChunks) else staged[1]


def _staged_windows(staged, devices, extent) -> dict:
    """``{device: window(start, size)}`` over a staged upload of either
    form, copied once per distinct device of ``devices``: ``window``
    returns ``B[start : start + size]`` there, ``B`` the volume
    reflect-padded by the staged halo and zero-extended to at least
    ``extent`` (the zeros feed only voxels outside the volume, masked or
    -inf'd before use).  A whole upload gives views; chunks assemble each
    window from the chunks it covers (:meth:`_StagedChunks.window`)."""
    if isinstance(staged, _StagedChunks):
        return {d: staged.to(d).window
                for d in dict.fromkeys(as_device(x) for x in devices)}
    big = staged[0]
    big = zero_extend(big, [max(s, n) for s, n in zip(big.shape, extent)])

    def view(b):
        return lambda start, size: b[tuple(slice(a, a + n)
                                           for a, n in zip(start, size))]

    return {d: view(b) for d, b in per_device(big, devices).items()}


def _staging_device(plan, device):
    if device is not None:
        return torch.device(device)
    return plan.device if plan is not None else torch.device("cuda")


def stage_volume(volume, plan=None, halo: int | None = None, device=None):
    """Upload a whole volume with its reflect halo: ``(big, halo)`` for
    :func:`detect_staged`'s ``staged=``, reusable across calls.  ``halo``
    must be >= the plan's ``fetch_halo``.  Only the raw volume crosses the
    bus; the halo is built on the device (:func:`reflect_pad`, bitwise
    ``np.pad``), or on the host when an extent is <= ``halo`` (more than
    one reflection).  ``device`` defaults to the plan's, else CUDA."""
    if plan is None and halo is None:
        raise ValueError(
            "stage_volume needs a plan (from make_stream_plan) or an "
            "explicit halo to size the staged reflect border")
    h = plan.fetch_halo if halo is None else halo
    vol = as_wire(volume)
    dev = _staging_device(plan, device)
    if min(vol.shape) > h:
        return reflect_pad(torch.from_numpy(vol).to(dev), h), h
    return torch.from_numpy(np.pad(vol, h, mode="reflect")).to(dev), h


def stage_volume_chunked(volume, plan=None, halo: int | None = None,
                         chunk: int = 128, device=None):
    """Upload a volume as disjoint raw z-chunks of ``chunk`` planes for
    :func:`detect_staged`: only the raw bytes are uploaded and each window
    of the padded volume is assembled on the device from its own chunks
    (bitwise :func:`stage_volume`'s).  Falls back to :func:`stage_volume`
    when an extent is <= the halo."""
    if plan is None and halo is None:
        raise ValueError(
            "stage_volume_chunked needs a plan (from make_stream_plan) "
            "or an explicit halo to size the reflect border")
    h = plan.fetch_halo if halo is None else halo
    vol = as_wire(volume)
    if min(vol.shape) <= h:
        return stage_volume(vol, halo=h, device=_staging_device(plan, device))
    dev = _staging_device(plan, device)
    vz = vol.shape[0]
    bounds = list(range(0, vz, max(1, chunk))) + [vz]
    chunks = [torch.from_numpy(vol[b0:b1]).to(dev)
              for b0, b1 in zip(bounds, bounds[1:])]
    return _StagedChunks(chunks, h, bounds)


def detect_staged(spec: ModelSpec, variables, volume, core: int | None = None,
                  tile_out: int | None = None, tile_batch: int | None = None,
                  window=5, threshold: float = 0.5,
                  max_detections_per_roi: int = 4096,
                  max_components_per_roi: int = 4096, method: str = "nms",
                  cc_impl: str = "sparse", progress=None, staged=None,
                  plan: "_StreamPlan | None" = None, devices=None,
                  forward: str = "auto"):
    """Detection over a whole volume staged on the spec's device.

    ``method`` is ``"nms"``, ``"components"`` or ``"both"`` (an ``(nms,
    components)`` tuple).  ``staged`` (from :func:`stage_volume` or
    :func:`stage_volume_chunked`) reuses an upload and ``plan`` (from
    :func:`make_stream_plan`) the engine across calls; ``volume`` then
    gives only the shape.  ``forward`` is ``"roi"`` (a forward per ROI),
    ``"shared"`` (one whole-volume forward into the -inf shell) or
    ``"auto"``: shared when :meth:`_StreamPlan.shared_auto` says its peak
    fits the device.  The lists are the same in every mode and equal the
    host reference's on the whole-volume map.  ``core=None`` takes 256 for
    conv stacks.  ``progress(corner, n_nms)`` is called after each box.

    ``devices`` (several devices, or repeated slots of one) fans the sweep
    out: in roi mode the ROIs round-robin over them
    (:func:`_detect_staged_roi`), in shared mode the grid's z-rows split
    into one band per device (:func:`_detect_staged_shared`); the
    lists stay bitwise the single-device call's.  A list of one device runs
    the single-device path, as the reference."""
    if forward not in ("roi", "shared", "auto"):
        raise ValueError(f"unknown forward mode {forward!r}")
    shape = np.shape(volume)
    if plan is None:
        plan = make_stream_plan(
            spec, variables, shape,
            core=_default_core(spec, window, 256, shape) if core is None
            else core,
            tile_out=tile_out, tile_batch=tile_batch, window=window,
            threshold=threshold, max_detections_per_roi=max_detections_per_roi,
            max_components_per_roi=max_components_per_roi, method=method,
            cc_impl=cc_impl)
    else:
        plan = _check_plan(plan, shape, window, method, threshold, cc_impl,
                           core, tile_out, tile_batch)
    if staged is None:
        staged = stage_volume(volume, plan=plan)
    if _staged_halo(staged) < plan.fetch_halo:
        raise ValueError(f"staged halo {_staged_halo(staged)} < required "
                         f"{plan.fetch_halo} (stage with the same window "
                         "and method)")
    devs = _fanout_devices(plan, devices)
    n_bytes = sum(c.nbytes for c in (staged.chunks if isinstance(
        staged, _StagedChunks) else staged[:1]))
    if forward == "shared" or (forward == "auto" and plan.shared_auto(
            n_bytes, len(devs), devs)):
        return _detect_staged_shared(plan, staged, devs, progress)
    return _detect_staged_roi(plan, staged, devs, progress)


def _fanout_devices(plan, devices) -> list:
    """The devices a sweep runs on: ``devices`` when it lists several
    (slots of one device may repeat), else the plan's one device (a list
    of one runs the single-device path, as the reference)."""
    if devices is not None and len(devices) > 1:
        return [as_device(d) for d in devices]
    return [plan.device]


def _detect_staged_roi(plan, staged, devs, progress=None):
    """:func:`detect_staged`'s ROI sweep over ``devs`` (one device, or the
    fan-out's slots): the staged volume and the module copied once per
    distinct device, ROI ``i`` forwarded on ``devs[i % n]`` from its padded
    window with the same plan, about ``n`` forwards queued before a box is
    copied back, the merge in grid order."""
    off = _staged_halo(staged) - plan.fetch_halo  # the halo may be generous
    P = plan.pipe.padded_shape
    # zero-extended so the highest ROI's window fits: the extension feeds
    # only voxels outside the volume, masked by [vlo, vhi) before use
    windows = _staged_windows(staged, devs, [
        max(c[d] for _, c in plan.grid) + off + P[d] for d in range(3)])
    modules = per_device(plan.pipe.spec.module, devs)

    def outs():
        for i, (key, corner) in enumerate(plan.grid):
            d = devs[i % len(devs)]
            _, vlo, vhi = plan.region(corner)
            win = windows[d](tuple(c + off for c in corner), P)
            yield key, corner, plan.pipe.forward_from(
                win, module=modules[d]), vlo, vhi

    return plan.consume(outs(), progress, ahead=len(devs))


def _detect_staged_shared(plan, staged, devs, progress=None):
    """:func:`detect_staged`'s shared forward over ``devs``: one
    whole-volume shell on one device; with the fan-out the grid's z-rows
    split into uniform bands (:meth:`_StreamPlan._band_partition`), band
    ``i`` forwarded into its band shell on ``devs[i]`` (every band's
    forward queued first), each box postprocessed on its band's shell in
    grid order.  The band grids anchor at ``b0 - h``, 0 modulo
    ``size_multiple``, so every probability is the whole-volume shell's."""
    rpb, nb, b0s = plan._band_partition(len(devs))
    if nb == 1:
        return plan.consume_shared(plan.shared_prob(staged), progress)
    fp = plan.band_pipe(rpb)
    off = _staged_halo(staged) - plan.ctx
    z_top = max(zs for zs, _ in fp._slabs) + fp._tin
    _, py, px = fp.padded_shape
    devs = devs[:nb]
    windows = _staged_windows(staged, devs, (
        off + b0s[-1] - plan.h + z_top, off + py, off + px))
    modules = per_device(plan.pipe.spec.module, devs)
    shells = [plan.shared_prob_band_local(
        windows[d]((off + b0 - plan.h, off, off), (z_top, py, px)), b0, fp,
        modules[d]) for b0, d in zip(b0s, devs)]
    return plan.consume_shared_stream(lambda band, b0: shells[band], rpb,
                                      progress)


def _prefetched(items, fetch, depth: int, name):
    """Yield ``(item, fetch(item))`` for each of ``items`` in order, with
    ``fetch`` run ahead in a thread (at most ``depth`` results waiting), so
    the host's reads and pads ride under the device's work.  A fetch error
    is raised here as ``RuntimeError`` naming ``name(item)``.  The thread
    ends with the generator, however it ends."""
    items = list(items)
    fetched: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        for item in items:
            if stop.is_set():
                return
            try:
                fetched.put((item, fetch(item), None))
            except Exception as e:  # surfaced on the consumer side
                fetched.put((item, None, e))
                return

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        for _ in items:
            item, result, err = fetched.get()
            if err is not None:
                raise RuntimeError(f"{name(item)}: fetch failed") from err
            yield item, result
    finally:
        stop.set()
        while thread.is_alive():  # unblock a producer waiting to put
            try:
                fetched.get(timeout=0.05)
            except queue.Empty:
                pass
        thread.join()


def _timed(stats: dict, key: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its host-clock seconds added to
    ``stats[key]``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    stats[key] += time.perf_counter() - t0
    return out


def detect_streaming(spec: ModelSpec, variables, shape, read_fn,
                     core: int | None = None, tile_out: int | None = None,
                     tile_batch: int | None = None, window=5,
                     threshold: float = 0.5,
                     max_detections_per_roi: int = 4096,
                     max_components_per_roi: int = 4096, method: str = "nms",
                     cc_impl: str = "sparse", progress=None,
                     plan: "_StreamPlan | None" = None, forward: str = "auto",
                     devices=None):
    """Exact out-of-core detection over a volume of any size, read through
    ``read_fn(lo, hi)`` (e.g. from :func:`h5_reader`).

    ``method`` is ``"nms"``, ``"components"`` or ``"both"`` (an ``(nms,
    components)`` tuple); ``plan`` (from :func:`make_stream_plan`) reuses
    the engine across calls.  ``forward`` is

    * ``"roi"``: a prefetch thread reads each ROI's window clipped to the
      volume while the previous ROI runs; each window is uploaded,
      reflect-padded past the true faces on the device (one
      ``reflect_pad``, bitwise ``np.pad``: the whole-volume run's face
      padding) and forwarded on its own;
    * ``"shared"``: z-bands of :meth:`_StreamPlan.band_rpb` ROI rows, each
      read once (:func:`_band_read`, the next band's meanwhile), padded on
      the device (:func:`_band_window`), forwarded once into a band shell
      and postprocessed box by box; raises ``ValueError`` when no band fits
      the device;
    * ``"auto"``: ``"shared"`` when a band fits and its grid cuts the conv
      input voxels by 15% against the per-ROI sweep, else ``"roi"``.

    The lists are the same in every mode and equal the host reference's on
    the whole-volume map.  ``core=None`` takes 128 for conv stacks.
    ``progress(corner, n_nms)`` is called after each box; the plan's
    ``fetch_seconds`` holds the prefetch thread's read seconds (and its pad
    seconds, for ROI windows that need several reflections).

    ``devices`` (several devices, or repeated slots of one) fans the sweep
    out: roi windows round-robin over them (the prefetch thread reads
    ``n + 1`` ahead), bands round-robin over them (the band height sized
    for one device's budget, split further so that every device gets a
    band); the module is copied once per distinct device, the read thread
    and the merge are unchanged, so the lists stay bitwise the
    single-device call's.  A list of one device runs the single-device
    path."""
    if forward not in ("roi", "shared", "auto"):
        raise ValueError(f"unknown forward mode {forward!r}")
    if plan is None:
        plan = make_stream_plan(
            spec, variables, shape,
            core=_default_core(spec, window, 128, shape) if core is None
            else core,
            tile_out=tile_out, tile_batch=tile_batch, window=window,
            threshold=threshold, max_detections_per_roi=max_detections_per_roi,
            max_components_per_roi=max_components_per_roi, method=method,
            cc_impl=cc_impl)
    else:
        plan = _check_plan(plan, shape, window, method, threshold, cc_impl,
                           core, tile_out, tile_batch)
    shape = plan.shape
    devs = _fanout_devices(plan, devices)
    rpb = None
    if forward != "roi" and min(shape) > plan.fetch_halo:
        # a band window's single reflect needs every pad under the read
        # extent; smaller volumes stay on the roi path
        probe = np.asarray(read_fn((0, 0, 0), (1, 1, 1)))
        rpb = plan.band_rpb(itemsize=1 if probe.dtype == np.uint8 else 4,
                            cost_gate=forward == "auto",
                            shells=max(2, *Counter(devs).values()))
    if forward == "shared" and rpb is None:
        raise ValueError(
            "the shared streaming forward does not fit this device or "
            "geometry (no band passes the memory budget, or the volume is "
            "not larger than the fetch halo); use forward='roi'")
    if rpb is not None:
        # split further so every device gets a band, never past one
        # device's budget
        rpb = min(rpb, plan._band_partition(len(devs))[0])
        return _detect_streaming_shared(plan, read_fn, rpb, progress, devs)

    fh, core_dims = plan.fetch_halo, plan.core_dims
    stats = plan.fetch_seconds = {"read": 0.0, "pad": 0.0}

    def prep(entry):
        """Read one ROI's window clipped to the volume (in the prefetch
        thread), with the reflect pads that continue it past the true
        faces; a pad past the block's extent (several reflections) is
        applied here, on the host."""
        _, corner = entry
        lo_want, vlo, vhi = plan.region(corner)
        hi_want = [c + cd + fh for c, cd in zip(corner, core_dims)]
        lo = [max(0, v) for v in lo_want]
        hi = [min(s, v) for s, v in zip(shape, hi_want)]
        block = _timed(stats, "read", _read_block, read_fn, lo, hi)
        pads = [(a - aw, bw - b)
                for a, aw, bw, b in zip(lo, lo_want, hi_want, hi)]
        if any(max(p) >= n for p, n in zip(pads, block.shape)):
            block = _timed(stats, "pad", np.pad, block, pads, mode="reflect")
            pads = [(0, 0)] * 3
        return block, pads, vlo, vhi

    modules = per_device(plan.pipe.spec.module, devs)

    def outs():
        for i, ((key, corner), (block, pads, vlo, vhi)) in enumerate(
                _prefetched(plan.grid, prep, len(devs) + 1,
                            lambda e: f"ROI {e[1]}")):
            d = devs[i % len(devs)]
            # ONE reflect pad on the device: the whole-volume run's faces
            big = zero_extend(reflect_pad(torch.from_numpy(block).to(d), pads),
                              plan.pipe.padded_shape)
            yield key, corner, plan.pipe.forward_from(
                big, module=modules[d]), vlo, vhi

    return plan.consume(outs(), progress, ahead=len(devs))


def _read_block(read_fn, lo, hi) -> np.ndarray:
    """``read_fn(lo, hi)`` as the host array that is uploaded (uint8 and f32
    as they are, other dtypes as f32), contiguous and writable."""
    block = as_wire(read_fn(lo, hi))
    return block if block.flags.writeable else block.copy()


def _band_read(plan, fp: DetectPipeline, read_fn, b0: int):
    """The host half of one z-band's input window (the out-of-core shared
    forward): the band's planes clipped to the volume (``_read_block``)
    and the ``(before, after)`` reflect pads per axis that
    :func:`_band_window` applies."""
    h, ctx = plan.h, plan.ctx
    fh = h + ctx
    vz, vy, vx = plan.shape
    z_top = max(zs for zs, _ in fp._slabs) + fp._tin
    _, py, px = fp.padded_shape
    zlo = b0 - h - ctx  # >= -fh, so the front reflect always fits
    clo, chi = max(0, zlo), min(vz, zlo + z_top)
    block = _read_block(read_fn, (clo, 0, 0), (chi, vy, vx))
    pads = [(clo - zlo, min(max(0, zlo + z_top - vz), fh)),
            (ctx, min(max(0, py - ctx - vy), fh)),
            (ctx, min(max(0, px - ctx - vx), fh))]
    return block, pads


def _band_window(fp: DetectPipeline, block: torch.Tensor,
                 pads) -> torch.Tensor:
    """One z-band's input window on ``block``'s device, from
    :func:`_band_read`: bitwise the slice the staged shared forward's tiles
    read from the staged volume at global anchor ``(b0 - h - ctx, -ctx,
    -ctx)``.  That volume is reflect-padded by ``fetch_halo = h + ctx`` at
    every true face and zero-extended beyond, so the window reflects at most
    ``fetch_halo`` past a face (one ``reflect_pad``; ``fetch_halo`` is below
    every extent in the band mode) and zero-fills the rest.  The full
    ``fetch_halo`` matters: pooled models reach past ``ctx``, so their
    probabilities near a face read that reflect band."""
    z_top = max(zs for zs, _ in fp._slabs) + fp._tin
    _, py, px = fp.padded_shape
    return zero_extend(reflect_pad(block, pads), (z_top, py, px))


def _detect_streaming_shared(plan, read_fn, rpb: int, progress=None,
                             devs=None):
    """Out-of-core shared forward: z-bands of ``rpb`` ROI rows, each band's
    planes read once by a prefetch thread (the next band's while this one
    runs), uploaded, reflect-padded on the device (:func:`_band_window`),
    forwarded once into its band shell and postprocessed box by box
    (:meth:`_StreamPlan.consume_shared_stream`).  The band maps are bitwise
    the staged shared map's.  Band ``i`` runs on ``devs[i % n]`` (the
    fan-out's slots; the plan's device by default) with that device's
    module copy, ``n`` bands read ahead."""
    fp = plan.band_pipe(rpb)
    devs = devs or [plan.device]
    modules = per_device(plan.pipe.spec.module, devs)
    stats = plan.fetch_seconds = {"read": 0.0, "pad": 0.0}
    bands = _prefetched(
        plan._band_starts(rpb),
        lambda b0: _timed(stats, "read", _band_read, plan, fp, read_fn, b0),
        len(devs), lambda b0: f"band z0={b0}")

    def shell_for(band, b0):
        got, (block, pads) = next(bands)
        if got != b0:
            raise RuntimeError(f"band z0={b0} read out of order ({got})")
        d = devs[band % len(devs)]
        W = _band_window(fp, torch.from_numpy(block).to(d), pads)
        return plan.shared_prob_band_local(W, b0, fp, modules[d])

    try:
        return plan.consume_shared_stream(shell_for, rpb, progress,
                                          n_devices=len(devs))
    finally:
        bands.close()


def detect_h5(spec: ModelSpec, variables, path: str,
              dataset: str | None = None, **kw):
    """Streaming detection straight from an HDF5 file
    (:func:`h5_reader`, then :func:`detect_streaming` with ``kw``)."""
    shape, read = h5_reader(path, dataset)
    return detect_streaming(spec, variables, shape, read, **kw)
