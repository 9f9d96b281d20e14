"""Multi-ROI streaming on the PyTorch/CUDA port: resumable ``stream_rois``
through the packed baseline's ``DetectPipeline``.

The port's counterpart of ``examples/multiroi_streaming.py``.  ROIs are
prefetched on a thread, detected on the device one ROI at a time, and
recorded in a JSON state file, so a stopped job resumes where it stopped.
The source is a synthetic volume unless ``--dvid`` names a DVID node.

Run: python3 examples/torch_multiroi_streaming.py [--device cuda]
     [--roi 64] [--n 4]
     python3 examples/torch_multiroi_streaming.py --dvid host:port --uuid U
     --instance grayscale
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
import sys
import tempfile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from flypylib_tpu_torch import FplNetwork  # noqa: E402
from flypylib_tpu_torch.infer import (DetectPipeline, dvid_source, grid_rois,  # noqa: E402
                                      stream_rois)
from flypylib_tpu_torch.io import DVIDClient  # noqa: E402
from flypylib_tpu_torch.utils.metrics import MetricsLog  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--roi", type=int, default=64)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--dvid", default=None)
    ap.add_argument("--uuid", default=None)
    ap.add_argument("--instance", default="grayscale")
    args = ap.parse_args()

    net = FplNetwork("baseline", device=args.device)  # the packed engine
    roi_shape = (args.roi,) * 3
    pipe = DetectPipeline(net.infer_spec, None, roi_shape, tile_out=args.roi,
                          threshold_quantile=1.0 - 500.0 / np.prod(roi_shape))
    if args.dvid:
        source = dvid_source(DVIDClient(args.dvid, args.uuid), args.instance)
        rois = grid_rois((args.roi * args.n, args.roi, args.roi), args.roi)
    else:
        rng = np.random.default_rng(0)
        big = rng.integers(0, 256, (args.roi * args.n, args.roi, args.roi)
                           ).astype(np.uint8)

        def source(roi):
            return big[tuple(slice(o, o + s)
                             for o, s in zip(roi.offset, roi.size))]

        rois = grid_rois(big.shape, args.roi)

    fd, state = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    os.unlink(state)  # a fresh queue: no state file yet
    log = MetricsLog()
    try:
        results = stream_rois(pipe, rois, source, state_path=state,
                              progress=lambda r, info: log.log(
                                  {"roi": r.key, **info}))
        total = sum(len(v) for v in results.values())
        print(f"processed {len(results)} ROIs, {total} detections on "
              f"{pipe.device}; state at {state}")
        again = stream_rois(pipe, rois, source, state_path=state)
        print(f"resume check: {len(again)} ROIs re-processed (expected 0)")
    finally:
        if os.path.exists(state):
            os.unlink(state)


if __name__ == "__main__":
    main()
