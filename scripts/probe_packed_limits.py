#!/usr/bin/env python3
"""Sound and broken readings behind chip_smoke.py's packed-baseline map limit.

    python3 scripts/probe_packed_limits.py     # on a CUDA card

For volume seeds 1-3 and f32 / bf16, ``FplNetwork("baseline")`` (the packed
engine, seed-0 weights) maps a 48^3 blob volume in 24-wide tiles on the card
and on the CPU, and prints max |logit difference| between the two: the
sound reading, then the card's map with one kernel output broken in memory
against the same CPU map:
- "K5 channel zeroed": channel 0 of every lattice K5 writes set to 0;
- "K5 x column zeroed": x position 0 of every lattice K5 writes set to 0;
- "layer 2 one ulp high": every output of stage B's first conv one ulp
  further from 0 (bf16 only), a rounding slip the size of the sound gap.
A limit must sit above every sound reading and below the broken ones.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    chip_smoke.require(torch.cuda.is_available(), "needs a CUDA card")
    port = chip_smoke.import_port()
    from flypylib_tpu_torch.ops import packed_conv

    card = chip_smoke.card()
    real_split, real_conv = packed_conv.parity_split_kernel, packed_conv._conv

    def split_channel_zeroed(x):
        y = real_split(x)
        y[..., 0] = 0
        return y

    def split_column_zeroed(x):
        y = real_split(x)
        y[:, :, :, 0] = 0
        return y

    def conv_ulp_high(x, w):
        y = real_conv(x, w)
        if w.shape[:3] == (3, 3, 3) and w.shape[4] == 48 and y.dtype == torch.bfloat16:
            bits = y.view(torch.int16)
            y = torch.where(y != 0, bits + 1, bits).view(torch.bfloat16)
        return y

    broken = {"K5 channel zeroed": ("parity_split_kernel", split_channel_zeroed),
              "K5 x column zeroed": ("parity_split_kernel", split_column_zeroed),
              "layer 2 one ulp high": ("_conv", conv_ulp_high)}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).replace("torch.", "")
        for seed in (1, 2, 3):
            vol = chip_smoke.make_volume_u8(chip_smoke.SMALL, 2, seed=seed)
            gpu = port.FplNetwork("baseline", device="cuda", seed=0, dtype=dtype)
            cpu = port.FplNetwork("baseline", device="cpu", seed=0, dtype=dtype)
            cpu.module.load_state_dict(gpu.module.state_dict())
            lc = chip_smoke.logits(cpu.infer(vol, *chip_smoke.SMALL_TILING))
            readings = {"sound": gpu.infer(vol, *chip_smoke.SMALL_TILING)}
            for name, (attr, fn) in broken.items():
                if name.startswith("layer") and dtype != torch.bfloat16:
                    continue
                setattr(packed_conv, attr, fn)
                try:
                    readings[name] = gpu.infer(vol, *chip_smoke.SMALL_TILING)
                finally:
                    packed_conv.parity_split_kernel = real_split
                    packed_conv._conv = real_conv
            line = "; ".join(
                f"{k} {float(np.abs(chip_smoke.logits(p) - lc).max()):.6g}"
                for k, p in readings.items())
            print(f"packed baseline {chip_smoke.SMALL}^3 seed {seed} {dt}, max "
                  f"|dlogit| card vs CPU: {line} (max|logit| "
                  f"{float(np.abs(lc).max()):.6g}) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
