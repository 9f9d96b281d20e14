"""Training-loop throughput on the PyTorch/CUDA port.

The port's counterpart of ``examples/bench_train.py``: steady-state
steps/s and patch Mvox/s of the train step — sampling and flip/rotation
augmentation on the device, forward, backward, Adam — with augmentation on
and off.  The port runs a Python loop of steps where the reference scans
an epoch in one dispatch; each epoch ends by reading the loss.

Run: python3 examples/torch_bench_train.py [--device cuda] [--steps 200]
     [--batch 32] [--patch 33] [--engine plain|packed]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
import sys
import time

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from flypylib_tpu_torch.models.zoo import baseline_model  # noqa: E402
from flypylib_tpu_torch.train.trainer import (TrainConfig, TrainData, Trainer,  # noqa: E402
                                              make_train_step)


def sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def measure(cfg, spec, image, labels, mask, steps, device):
    tr = Trainer(spec, cfg, seed=0, device=device)
    state = tr.init_state()
    _, train_steps, patch = make_train_step(spec, cfg)
    data = TrainData.build(image, labels, mask, patch, device=device)
    float(train_steps(state, tr.generator, data, steps)["loss"])  # warm
    sync(device)
    t0 = time.perf_counter()
    float(train_steps(state, tr.generator, data, steps)["loss"])
    return time.perf_counter() - t0, patch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--patch", type=int, default=33)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--engine", default="plain", choices=("plain", "packed"))
    args = ap.parse_args()

    spec = baseline_model()
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (args.size,) * 3).astype(np.uint8)
    labels = (rng.random((args.size,) * 3) > 0.999).astype(np.float32)
    mask = np.ones((args.size,) * 3, np.float32)

    results = {"device": (torch.cuda.get_device_name(0)
                          if torch.device(args.device).type == "cuda"
                          else "cpu")}
    for augment in (True, False):
        cfg = TrainConfig(patch_size=args.patch, batch_size=args.batch,
                          augment=augment, steps_per_epoch=args.steps,
                          engine=args.engine)
        dt, patch = measure(cfg, spec, image, labels, mask, args.steps,
                            args.device)
        results["augment_on" if augment else "augment_off"] = {
            "steps_per_s": round(args.steps / dt, 1),
            "patch_mvox_per_s": round(args.steps * args.batch * patch**3
                                      / dt / 1e6, 1),
            "seconds": round(dt, 3),
        }
    on, off = results["augment_on"], results["augment_off"]
    results["augment_overhead_pct"] = round(
        100.0 * (off["steps_per_s"] / on["steps_per_s"] - 1.0), 1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
