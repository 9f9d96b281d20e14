"""Elastic multi-worker ROI streaming.

Counterpart of ``flypylib_tpu/infer/elastic.py``, copied (the standard
library and numpy only), with ``torch.distributed`` in place of JAX's
process count and index.  ``stream_rois`` drives ONE card; a run over many
hosts needs the ROI work-list split across them with failure domains.  The
natural failure domain is the worker process: each claims ROIs from a
shared queue, processes them on its own card through its own
``DetectPipeline`` (or any callable), and marks them done.  A worker that
dies mid-ROI leaves a *lease* that expires; surviving workers reclaim and
re-run the ROI — detection is idempotent, so at-least-once execution with
single-writer results is exact.

Coordination is a shared directory (NFS or another shared file system;
a temporary directory in tests) — no extra service:

- ``done/<roi>.json``      completed ROI + detection counts (atomic
  rename; the resume state, compatible in spirit with ROIQueue's file),
- ``claims/<roi>.json``    exclusive-create lease with worker id +
  heartbeat timestamp; stale leases (older than ``lease_s``) are stolen
  with an atomic rename so exactly one thief wins.

Workers iterate the ROI list starting at their own offset (worker k of n
starts at position k*len/n), so contention on fresh queues is near zero;
a second sweep reclaims expired leases.  Tested with concurrent workers
and a mid-run crash in tests/test_torch_io_queue.py.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

import torch

from flypylib_tpu_torch.infer.roi_queue import ROI
from flypylib_tpu_torch.io.synapses import Tbars


def _process_group() -> bool:
    """Whether a ``torch.distributed`` process group is initialised."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def default_worker_id() -> str:
    """Stable per-worker id: the ``torch.distributed`` rank when a process
    group is initialised, else the pid."""
    if _process_group():
        return f"proc{torch.distributed.get_rank()}"
    return f"pid{os.getpid()}"


class SharedROIQueue:
    """Filesystem-coordinated work queue over ROIs for N workers."""

    def __init__(self, state_dir: str, worker_id: str | None = None,
                 lease_s: float = 600.0):
        self.dir = state_dir
        self.worker_id = worker_id or default_worker_id()
        self.lease_s = float(lease_s)
        self.done_dir = os.path.join(state_dir, "done")
        self.claim_dir = os.path.join(state_dir, "claims")
        os.makedirs(self.done_dir, exist_ok=True)
        os.makedirs(self.claim_dir, exist_ok=True)

    # -- state ----------------------------------------------------------
    def is_done(self, roi: ROI) -> bool:
        return os.path.exists(self._done_path(roi))

    def _done_path(self, roi: ROI) -> str:
        return os.path.join(self.done_dir, roi.key + ".json")

    def _claim_path(self, roi: ROI) -> str:
        return os.path.join(self.claim_dir, roi.key + ".json")

    # -- claiming -------------------------------------------------------
    def try_claim(self, roi: ROI) -> bool:
        """Claim an unprocessed ROI; False if done or claimed elsewhere."""
        if self.is_done(roi):
            return False
        path = self._claim_path(roi)
        payload = json.dumps({"worker": self.worker_id, "ts": time.time()})
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL)
        except FileExistsError:
            return self._try_steal(roi)
        with os.fdopen(fd, "w") as f:
            f.write(payload)
        # mark_done deletes the claim AFTER creating the done record, so
        # an exclusive-create can succeed on an ROI that finished between
        # our is_done check and the open — re-check closes that window
        # (the done rename is ordered before the claim unlink, so a
        # post-create re-check always sees it)
        if self.is_done(roi):
            self._release(roi)
            return False
        return True

    def _release(self, roi: ROI) -> None:
        try:
            os.unlink(self._claim_path(roi))
        except OSError:
            pass

    def _try_steal(self, roi: ROI) -> bool:
        """Take over an expired lease (dead worker); atomic via rename —
        exactly one thief's rename sees the stale file."""
        path = self._claim_path(roi)
        try:
            with open(path) as f:
                claim = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        if claim.get("worker") == self.worker_id:
            return True  # our own (resumed) claim
        if time.time() - claim.get("ts", 0) < self.lease_s:
            return False
        steal = path + f".steal.{self.worker_id}"
        try:
            os.rename(path, steal)
        except OSError:
            return False  # somebody else won the steal
        with open(steal, "w") as f:
            f.write(json.dumps(
                {"worker": self.worker_id, "ts": time.time(),
                 "stolen_from": claim.get("worker")}
            ))
        os.replace(steal, path)
        if self.is_done(roi):  # owner finished while its lease looked stale
            self._release(roi)
            return False
        return True

    def heartbeat(self, roi: ROI) -> None:
        """Refresh the lease while processing a long ROI."""
        tmp = self._claim_path(roi) + ".hb"
        with open(tmp, "w") as f:
            f.write(json.dumps({"worker": self.worker_id,
                                "ts": time.time()}))
        os.replace(tmp, self._claim_path(roi))

    def mark_done(self, roi: ROI, info: dict) -> None:
        tmp = self._done_path(roi) + f".tmp.{self.worker_id}"
        with open(tmp, "w") as f:
            f.write(json.dumps({"worker": self.worker_id, **info}))
        os.replace(tmp, self._done_path(roi))  # atomic
        try:
            os.unlink(self._claim_path(roi))
        except OSError:
            pass

    def summary(self) -> dict:
        """{roi_key: done-record} of everything completed so far."""
        out = {}
        for name in os.listdir(self.done_dir):
            if name.endswith(".json"):
                with open(os.path.join(self.done_dir, name)) as f:
                    out[name[:-5]] = json.load(f)
        return out


def stream_rois_elastic(
    pipeline,
    rois: list[ROI],
    source,
    sink=None,
    state_dir: str = ".flypylib_roi_state",
    worker_id: str | None = None,
    lease_s: float = 600.0,
    progress=None,
    n_workers_hint: int | None = None,
):
    """Process ROIs cooperatively with other workers sharing ``state_dir``.

    Same per-ROI contract as :func:`flypylib_tpu_torch.infer.roi_queue.stream_rois`
    (``pipeline(volume) -> (nms Tbars, cc Tbars|None)``, ownership
    filtering, optional ``sink``), but any number of hosts may run this
    concurrently: each ROI is processed by exactly one live worker, and
    ROIs orphaned by a dead worker are reclaimed after ``lease_s``.
    ``n_workers_hint`` defaults to the ``torch.distributed`` world size
    when a process group is initialised, else 1.

    Returns ``{roi.key: nms Tbars}`` for the ROIs THIS worker processed.
    """
    q = SharedROIQueue(state_dir, worker_id=worker_id, lease_s=lease_s)
    results: dict[str, Tbars] = {}

    # start at this worker's own slice of the list to avoid claim races
    if n_workers_hint is None:
        n_workers_hint = (torch.distributed.get_world_size()
                          if _process_group() else 1)
    widx = hash(q.worker_id) % max(n_workers_hint, 1)
    offset = (len(rois) * widx) // max(n_workers_hint, 1)
    order = rois[offset:] + rois[:offset]

    def process(roi: ROI):
        # heartbeat while processing: a single ROI can legitimately take
        # minutes (a first kernel build, a slow source) against the lease — without
        # refreshes a live worker's ROI would be stolen and re-run
        # (at-least-once keeps results exact, but the device work and any
        # ``sink`` POST would duplicate)
        import threading

        stop = threading.Event()

        def beat():
            while not stop.wait(q.lease_s / 3.0):
                try:
                    q.heartbeat(roi)
                except OSError:
                    pass  # shared FS hiccup: next beat retries

        beater = threading.Thread(target=beat, daemon=True)
        beater.start()
        try:
            vol = source(roi)
            t0 = time.perf_counter()
            nms_det, cc_det = pipeline(vol)
            dt = time.perf_counter() - t0
        finally:
            # stop BEFORE mark_done unlinks the claim, so a late beat
            # can't resurrect a claim file for a finished ROI
            stop.set()
            beater.join()

        def filter_owned(det):
            if det is None or len(det) == 0:
                return det
            lo, hi = roi.owned()
            local_lo = lo - np.asarray(roi.offset)
            local_hi = hi - np.asarray(roi.offset)
            keep = np.all(
                (det.locs >= local_lo) & (det.locs < local_hi), axis=1
            )
            return Tbars(locs=det.locs[keep], conf=det.conf[keep])

        nms_det = filter_owned(nms_det)
        cc_det = filter_owned(cc_det)
        if sink is not None:
            sink(roi, nms_det)
        info = {
            "nms_detections": len(nms_det),
            "cc_components": len(cc_det) if cc_det is not None else None,
            "seconds": round(dt, 4),
        }
        q.mark_done(roi, info)
        results[roi.key] = nms_det
        if progress:
            progress(roi, info)

    # pass 1: fresh work; pass 2: reclaim expired leases left by crashes
    for sweep in (0, 1):
        for roi in order:
            if q.try_claim(roi):
                process(roi)
    return results
