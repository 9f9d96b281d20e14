"""Profiling demo on the PyTorch/CUDA port: per-stage timers and a
``torch.profiler`` Chrome trace.

The port's counterpart of ``examples/profile_infer.py``: ``StageTimer``
Mvox/s counters around the detect pipeline (the host clock; on a card each
stage synchronises at its ends) and, with ``--trace``, a trace of one call
(``trace.json`` in the directory, for ``chrome://tracing`` or Perfetto,
with the port's spans as ``fpl.*`` ranges) and the ops that took the most
device time.

Run: python3 examples/torch_profile_infer.py [--device cuda] [--size 128]
     [--trace DIR]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
import sys

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from flypylib_tpu_torch import FplNetwork  # noqa: E402
from flypylib_tpu_torch.infer.pipeline import DetectPipeline  # noqa: E402
from flypylib_tpu_torch.utils.metrics import StageTimer, profile_trace  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    cuda = torch.device(args.device).type == "cuda"
    net = FplNetwork("baseline", device=args.device)  # the packed engine
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 256, (args.size,) * 3).astype(np.uint8)
    pipe = DetectPipeline(net.infer_spec, None, vol.shape,
                          tile_out=min(args.size, 128),
                          threshold_quantile=1.0 - 2000.0 / vol.size)
    timer = StageTimer()
    with timer.stage("build+first_run", voxels=vol.size):
        pipe(vol)
    for _ in range(3):
        with timer.stage("detect_pipeline", voxels=vol.size):
            nms_det, cc_det = pipe(vol)
    if args.trace:
        with profile_trace(args.trace) as prof:
            pipe(vol)
            if cuda:
                torch.cuda.synchronize()
        key = "self_cuda_time_total" if cuda else "self_cpu_time_total"
        print(prof.key_averages().table(sort_by=key, row_limit=10))
        print(f"trace written to {args.trace}/trace.json")
    print(json.dumps(timer.report()))
    print(f"detections: nms={len(nms_det)} cc={len(cc_det)}")


if __name__ == "__main__":
    main()
