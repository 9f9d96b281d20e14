"""Multi-device end to end on the PyTorch/CUDA port: data-parallel training,
volume-sharded inference and the ``detect_large(devices=)`` fan-out.

The port's counterpart of ``examples/multichip_train_detect.py``:

- ``FplNetwork.train(..., mesh=make_mesh(...))``: data-parallel training
  (the global batch split over the mesh's ``data`` axis, the gradients
  summed over the ranks); the same seed gives the same parameters as the
  single-device run;
- ``sharded_infer`` / ``sharded_nms`` over a ``space`` mesh with halo
  exchange, its list that of ``nms`` on the gathered map;
- ``detect_large(..., devices=...)``: the staged ROI sweep round-robined
  over the devices, its lists bit for bit the single-device call's.

``--devices N`` takes N slots of ``--device`` for the sharded inference and
the fan-out: distinct cards where the host has them (``cuda:0``,
``cuda:1``, ...), else N repeated slots of one (allowed on one card, and on
the CPU).  Data-parallel training runs one process per card: in a single
process its mesh is N slots of the first device; under ``torchrun`` every
process runs this script and the meshes span all of them (one card each).

Run: python3 examples/torch_multichip_train_detect.py [--device cuda]
     [--devices 2]
     torchrun --nproc-per-node 4 examples/torch_multichip_train_detect.py
"""

from __future__ import annotations

import argparse
from pathlib import Path
import sys
import time

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import flypylib_tpu_torch as fpl  # noqa: E402
from flypylib_tpu_torch.io.synapses import Tbars, make_training_volumes  # noqa: E402
from flypylib_tpu_torch.train.trainer import TrainConfig  # noqa: E402


def slots(device: str, n: int) -> list[torch.device]:
    """``n`` slots of ``device``: one per card while there are cards, the
    rest repeating them."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--size", type=int, default=64)
    args = ap.parse_args()

    distributed = fpl.ensure_initialized()
    rank = torch.distributed.get_rank() if distributed else 0
    if distributed:  # one card a process under torchrun
        local = [fpl.parallel.distributed.local_device()
                 if args.device == "cuda" else torch.device(args.device)]
    else:
        local = slots(args.device, args.devices)
    device = local[0]
    mesh = fpl.make_mesh(devices=local if distributed
                         else [device] * args.devices, axis="data")
    n_data = mesh.shape["data"]
    if rank == 0:
        print(f"mesh {mesh.shape}: {[str(s.device) for s in mesh.slots]}")

    rng = np.random.default_rng(0)  # the same cutout on every rank
    size = args.size
    centers = rng.integers(10, size - 10, (10, 3)).astype(np.float64)
    tbars = Tbars(locs=centers)
    vol = rng.normal(0.1, 0.05, (size,) * 3).astype(np.float32)
    for z, y, x in tbars.locs.astype(int):
        vol[max(0, z - 2): z + 3, max(0, y - 2): y + 3,
            max(0, x - 2): x + 3] += 0.6
    vol = np.clip(vol, 0, 1)
    labels, mask = make_training_volumes(tbars, vol.shape, radius=3.0,
                                         border=6)

    net = fpl.FplNetwork(
        "baseline", device=device, features=(8, 12), dilations=(1, 2),
        head_features=16, dtype=torch.float32,
        train_config=TrainConfig(patch_size=18, batch_size=4 * n_data,
                                 steps_per_epoch=20, learning_rate=3e-3))
    t0 = time.perf_counter()
    hist = net.train(vol, labels, mask, epochs=3, mesh=mesh)
    if rank == 0:
        print(f"data-parallel train ({n_data}-way): "
              f"{time.perf_counter() - t0:.1f} s, loss {hist[0]['loss']:.4f} "
              f"-> {hist[-1]['loss']:.4f}")

    space = fpl.make_mesh(devices=local, axis="space")
    prob = fpl.sharded_infer(net.infer_spec, None, vol, space)
    gathered = np.asarray(prob)
    # a briefly trained net: the threshold leaves the top 0.1% of the map
    thr = float(np.quantile(gathered, 0.999))
    det = fpl.sharded_nms(prob, space, window=5, threshold=thr)
    want = fpl.nms(gathered, window=5, threshold=thr)
    same_sharded = np.array_equal(det.locs, want.locs)
    if rank == 0:
        dprob = float(np.abs(gathered - net.infer(vol)).max())
        print(f"sharded_infer + sharded_nms over {space.shape} at threshold "
              f"{thr:.4g}: {len(det)} detections, the same as nms on the "
              f"gathered map: "
              f"{same_sharded}; max |dprob| against infer {dprob:.3g}")

    if not distributed:
        t0 = time.perf_counter()
        one = net.detect_large(vol, core=32, threshold=thr)
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        many = net.detect_large(vol, core=32, threshold=thr, devices=local)
        tn = time.perf_counter() - t0
        same = (len(one) == len(many) and np.array_equal(one.locs, many.locs)
                and np.array_equal(one.conf, many.conf))
        print(f"detect_large: one device {len(one)} detections ({t1:.2f} s); "
              f"devices={[str(d) for d in local]} {len(many)} ({tn:.2f} s); "
              f"bit for bit: {same}")
        assert same
    assert same_sharded and len(det) > 0


if __name__ == "__main__":
    main()
