"""Elastic multi-worker ROI streaming on the PyTorch/CUDA port.

The port's counterpart of ``examples/elastic_workers.py``: two workers on
one machine share a file-system ROI queue (``infer/elastic.py``) and split
a synthetic volume's ROI grid; the first "crashes" after five ROIs, and
the second reclaims its expired lease and finishes the job.  Across hosts
every worker runs ``stream_rois_elastic`` with the same ``state_dir`` on a
shared file system and its own ``DetectPipeline``; under
``torch.distributed`` the rank is the default worker id.

Run: python3 examples/torch_elastic_workers.py [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path
import shutil
import sys
import tempfile
import threading

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from flypylib_tpu_torch import FplNetwork  # noqa: E402
from flypylib_tpu_torch.infer import DetectPipeline, grid_rois  # noqa: E402
from flypylib_tpu_torch.infer.elastic import SharedROIQueue, stream_rois_elastic  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    net = FplNetwork("baseline", device=args.device)  # the packed engine
    rng = np.random.default_rng(0)
    size, roi = 192, 64
    vol = rng.integers(0, 256, (size,) * 3).astype(np.uint8)
    rois = grid_rois(size, roi)
    print(f"{len(rois)} ROIs of {roi}^3 over a {size}^3 volume")
    pipe = DetectPipeline(net.infer_spec, None, (roi,) * 3, tile_out=roi,
                          threshold_quantile=1.0 - 500.0 / roi**3,
                          run_cc=False)
    lock = threading.Lock()  # one pipeline, one device: a call at a time

    def source(r):
        return vol[tuple(slice(o, o + s) for o, s in zip(r.offset, r.size))]

    state_dir = tempfile.mkdtemp(prefix="elastic_rois_")
    done = {}

    def worker(name, crash_after=None):
        n = [0]

        def guard(v):
            n[0] += 1
            if crash_after is not None and n[0] > crash_after:
                raise RuntimeError(f"{name} simulated crash")
            with lock:
                return pipe(v)

        try:
            done[name] = stream_rois_elastic(
                guard, rois, source, state_dir=state_dir, worker_id=name,
                lease_s=0.5, n_workers_hint=2)
            print(f"{name}: processed {len(done[name])} ROIs")
        except RuntimeError as e:
            print(f"{name}: {e} (leases left for the survivor)")

    try:
        for name, crash in (("workerA", 5), ("workerB", None)):
            t = threading.Thread(target=worker, args=(name, crash))
            t.start()
            t.join()
        summary = SharedROIQueue(state_dir, worker_id="audit").summary()
        total = sum(r["nms_detections"] for r in summary.values())
        assert len(summary) == len(rois), "every ROI must be done exactly once"
        print(f"all {len(summary)} ROIs done, {total} detections")
    finally:
        shutil.rmtree(state_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
