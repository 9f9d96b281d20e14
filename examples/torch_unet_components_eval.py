"""3D U-Net on the PyTorch/CUDA port: train on object masks, detect via
connected components, evaluate with PR matching and voxel-wise PR.

The port's counterpart of ``examples/unet_components_eval.py``.  The U-Net
predicts blob masks rather than sharp peaks, so detection uses the CC path
(component centroids) instead of NMS.

Run: python3 examples/torch_unet_components_eval.py [--device cuda]
     [--size 64] [--epochs 3]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import flypylib_tpu_torch as fpl  # noqa: E402
from flypylib_tpu_torch.io.synapses import make_training_volumes  # noqa: E402
from flypylib_tpu_torch.models.zoo import unet  # noqa: E402
from flypylib_tpu_torch.ops.matching import evaluate  # noqa: E402
from flypylib_tpu_torch.train.trainer import TrainConfig  # noqa: E402
from examples.torch_train_infer_eval import describe, synthetic_cutout  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args()
    print(f"device: {describe(args.device)}")

    train_img, train_tb = synthetic_cutout(args.size, 8, seed=0)
    test_img, test_tb = synthetic_cutout(args.size, 8, seed=1)

    spec = unet(base_features=16, levels=2, convs_per_stage=2)
    print(f"unet: context={spec.context}, size_multiple={spec.size_multiple}")
    net = fpl.FplNetwork(
        spec, device=args.device,
        train_config=TrainConfig(patch_size=spec.valid_size(40), batch_size=16,
                                 steps_per_epoch=60, learning_rate=5e-4),
    )
    t0 = time.time()
    hist = net.train(train_img, tbars=train_tb, epochs=args.epochs, radius=4)
    print(f"train: {time.time() - t0:.1f}s  last loss={hist[-1]['loss']:.4f}")

    t0 = time.time()
    det = net.detect(test_img, threshold=0.5, tile_out=40, method="components")
    print(f"detect (CC path): {time.time() - t0:.1f}s, {len(det)} components "
          f"(gt has {len(test_tb)})")
    curve = evaluate(det, test_tb, dist_thresh=5.0)
    if len(curve["precision"]):
        print(f"precision={curve['precision'][-1]:.3f} "
              f"recall={curve['recall'][-1]:.3f}")

    # voxel-wise PR on the device (the map never leaves it; large volumes
    # stream in bounded memory)
    test_lab, test_mask = make_training_volumes(
        test_tb, test_img.shape, radius=4, border=net.context)
    t0 = time.time()
    vpr = net.evaluate_voxels(test_img, test_lab, test_mask,
                              thresholds=np.asarray([0.3, 0.5, 0.7], np.float32))
    print(f"voxel PR (on-device): {time.time() - t0:.1f}s  " + "  ".join(
        f"t={t:.1f}: p={p:.3f} r={r:.3f}"
        for t, p, r in zip(vpr["thresholds"], vpr["precision"], vpr["recall"])))


if __name__ == "__main__":
    main()
