#!/usr/bin/env python3
"""256^3 detect(nms) rates of the plain and packed engines of one checkout.

    python3 scripts/ab_detect.py [--root DIR] [--iters N]    # on a CUDA card

Imports ``flypylib_tpu_torch`` and ``chip_smoke`` from DIR (default: this
checkout), so two checkouts can be compared on one card by running it once
per checkout, in turns (A, B, B, A).  For the plain baseline
(``packed=False``), the packed baseline (the default), the packed U-Net with
the K3 tail (``pallas2``), the K2 tail (``pallas``) and the unfused tail
(``xla``, the default), and the plain U-Net, all bf16 with seed-0 weights on
``chip_smoke``'s 256^3 blob volume at its operating threshold (the 2000th
largest probability): one warm-up detect, then N timed detects, each
ending in a synchronise.  Prints the median, min and max Mvox/s per engine
and the card.
"""

import argparse
import statistics
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=9)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    cs.require(torch.cuda.is_available(), "needs a CUDA card")
    port = cs.import_port()
    cs.require(Path(port.__file__).resolve().parents[1] == root,
               f"imported the port from outside {root}")
    card = cs.card()
    vol = cs.make_volume_u8(cs.VOLUME, cs.N_BLOBS, seed=0)
    engines = {
        "plain baseline": lambda: port.FplNetwork("baseline", device="cuda",
                                                  seed=0, packed=False),
        "packed baseline": lambda: port.FplNetwork("baseline", device="cuda",
                                                   seed=0),
        "unet pallas2": lambda: cs.unet_net(port, "pallas2", "cuda"),
        "unet pallas": lambda: cs.unet_net(port, "pallas", "cuda"),
        "unet xla": lambda: cs.unet_net(port, "xla", "cuda"),
        "unet plain": lambda: cs.unet_net(port, "plain", "cuda"),
    }
    for name, make in engines.items():
        net = make()
        prob = net.infer(vol, keep_on_device=True)
        thr = float(torch.topk(prob.reshape(-1), cs.N_CAND).values[-1])
        del prob
        net.detect(vol, threshold=thr)  # warm
        rates = []
        for _ in range(args.iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.detect(vol, threshold=thr)
            torch.cuda.synchronize()
            rates.append(vol.size / 1e6 / (time.perf_counter() - t0))
        print(f"{root.name} {name} detect(nms): median "
              f"{statistics.median(rates):.3f} Mvox/s, min {min(rates):.3f}, "
              f"max {max(rates):.3f} over {args.iters} ({cs.VOLUME}^3, bf16) "
              f"[{card}]", flush=True)
        del net
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
