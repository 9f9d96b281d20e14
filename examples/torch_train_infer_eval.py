"""End-to-end demo on the PyTorch/CUDA port: train -> infer -> nms ->
evaluate -> detect on a synthetic cutout.

The port's counterpart of ``examples/train_infer_eval.py``: the cutout is
synthetic (Gaussian-blob "T-bars" on noise), with the same JSON annotation
round trip the real pipeline uses.  Everything runs on ``--device``
(default ``cuda``); ``--device cpu`` runs the kernels' plain versions.

Run: python3 examples/torch_train_infer_eval.py [--device cuda] [--size 64]
     [--epochs 3] [--model baseline]
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
import sys
import tempfile
import time

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import flypylib_tpu_torch as fpl  # noqa: E402
from flypylib_tpu_torch.io.synapses import Tbars, load_from_json, save_to_json  # noqa: E402
from flypylib_tpu_torch.ops.matching import evaluate  # noqa: E402
from flypylib_tpu_torch.train.trainer import TrainConfig  # noqa: E402


def synthetic_cutout(size: int, n_pts: int, seed: int):
    """(f32 (size,)*3 image, Tbars): blobs of sigma 2.5 at ``n_pts`` seeded
    centres on N(0, 0.05) noise."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(10, size - 10, (n_pts, 3)).astype(np.float64)
    zz, yy, xx = np.meshgrid(*[np.arange(size)] * 3, indexing="ij")
    image = np.zeros((size,) * 3, dtype=np.float32)
    for c in centers:
        d2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        image = np.maximum(image, np.exp(-d2 / (2 * 2.5**2)).astype(np.float32))
    image += rng.normal(0, 0.05, image.shape).astype(np.float32)
    return image, Tbars(locs=centers)


def describe(device: str) -> str:
    if torch.device(device).type == "cuda":
        return (f"{torch.cuda.get_device_name(0)} x "
                f"{torch.cuda.device_count()}")
    return "cpu"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--model", default="baseline")
    args = ap.parse_args()
    print(f"device: {describe(args.device)}; torch {torch.__version__}")

    # --- data: synthetic cutout + JSON annotation round trip --------------
    train_img, train_tb = synthetic_cutout(args.size, 8, seed=0)
    test_img, test_tb = synthetic_cutout(args.size, 8, seed=1)
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(save_to_json(test_tb), f)
        gt_path = f.name
    test_gt = load_from_json(gt_path)
    os.unlink(gt_path)

    # --- train ------------------------------------------------------------
    net = fpl.FplNetwork(
        args.model, device=args.device,
        train_config=TrainConfig(patch_size=25, batch_size=32,
                                 steps_per_epoch=60, learning_rate=5e-4),
    )
    t0 = time.time()
    hist = net.train(train_img, tbars=train_tb, epochs=args.epochs, radius=3)
    print(f"train: {time.time() - t0:.1f}s  "
          + " ".join(f"epoch{h['epoch']} loss={h['loss']:.4f}" for h in hist))

    # --- infer ------------------------------------------------------------
    net.infer(test_img, tile_out=32, tile_batch=2)  # warm
    t0 = time.time()
    prob = net.infer(test_img, tile_out=32, tile_batch=2)
    dt = time.time() - t0
    print(f"infer: {dt:.3f}s ({test_img.size / dt / 1e6:.1f} Mvox/s)  prob "
          f"range [{prob.min():.3f}, {prob.max():.3f}]")

    # --- nms + evaluate ---------------------------------------------------
    det = fpl.nms(prob, window=5, threshold=0.5)
    print(f"nms: {len(det)} detections (gt has {len(test_gt)})")
    curve = evaluate(det, test_gt, dist_thresh=5.0)
    if len(curve["precision"]):
        print(f"evaluate: precision={curve['precision'][-1]:.3f} "
              f"recall={curve['recall'][-1]:.3f} at conf>="
              f"{curve['conf'][-1]:.3f}")
    else:
        print("evaluate: no detections")

    # --- detect in one pass (the map stays on the device) -----------------
    det2 = net.detect(test_img, window=5, threshold=0.5, tile_out=32,
                      tile_batch=2)
    assert len(det2) == len(det), (len(det2), len(det))
    print("detect (on-device pipeline) matches infer+nms:", len(det2))


if __name__ == "__main__":
    main()
