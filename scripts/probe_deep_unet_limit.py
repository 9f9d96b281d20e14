#!/usr/bin/env python3
"""Sound and broken readings behind chip_smoke.py's three-level U-Net limit.

    python3 scripts/probe_deep_unet_limit.py     # on a CUDA card

For volume seeds 1-3 and f32 / bf16, ``FplNetwork("unet", levels=3,
packed=False)`` (seed-0 weights) runs the first tile batch of a 36^3 blob
volume on the card and on the CPU, and prints max |logit difference| over max |logit| between
the two, as ``chip_smoke.check_deep_unet`` reads it: the sound reading, then
the card's logits with the output of every Co = 192 conv (the bottleneck,
which K1's wgmma route runs as two launches of 96 channels) broken in memory
against the same CPU logits:
- "second chunk zeroed": channels 96-191 set to 0;
- "second chunk one channel off": channels 96-191 rotated by one channel,
  what a wrong output offset of the second launch would write;
- "one ulp high": every output one bf16 ulp further from 0 (bf16 only), a
  rounding slip the size of the sound gap.
A limit must sit above every sound reading; a limit that also sits below the
broken readings catches such a fault on its own.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    chip_smoke.require(torch.cuda.is_available(), "needs a CUDA card")
    port = chip_smoke.import_port()
    from flypylib_tpu_torch.models import zoo

    card = chip_smoke.card()
    real = zoo.conv3d_bias_relu

    def breaking(fault):
        def conv(x, w, b, dilation=1):
            y = real(x, w, b, dilation)
            return fault(y) if x.is_cuda and w.shape[4] == 192 else y
        return conv

    def zeroed(y):
        y[..., 96:] = 0
        return y

    def shifted(y):
        y[..., 96:] = torch.roll(y[..., 96:], 1, dims=-1)
        return y

    def ulp_high(y):
        bits = y.view(torch.int16)
        return torch.where(y != 0, bits + 1, bits).view(torch.bfloat16)

    broken = {"second chunk zeroed": zeroed,
              "second chunk one channel off": shifted,
              "one ulp high": ulp_high}
    for dtype, rtol in ((torch.float32, chip_smoke.DEEP_UNET_RTOL_F32),
                        (torch.bfloat16, chip_smoke.DEEP_UNET_RTOL_BF16)):
        dt = str(dtype).replace("torch.", "")
        kw = dict(seed=0, dtype=dtype, levels=3, packed=False)
        gpu = port.FplNetwork("unet", device="cuda", **kw)
        cpu = port.FplNetwork("unet", device="cpu", **kw)
        cpu.module.load_state_dict(gpu.module.state_dict())
        for seed in (1, 2, 3):
            vol = chip_smoke.make_volume_u8(chip_smoke.DEEP_UNET_SMALL, 2,
                                            seed=seed)
            tiles = chip_smoke.first_tile_batch(gpu.infer_spec, vol)
            tiles = tiles[:chip_smoke.DEEP_UNET_TILING[1]]
            with torch.no_grad():
                lc = cpu.module(tiles.cpu())
                readings = {"sound": gpu.module(tiles).cpu()}
                for name, fault in broken.items():
                    if fault is ulp_high and dtype != torch.bfloat16:
                        continue
                    zoo.conv3d_bias_relu = breaking(fault)
                    try:
                        readings[name] = gpu.module(tiles).cpu()
                    finally:
                        zoo.conv3d_bias_relu = real
            scale = float(lc.abs().max())
            line = "; ".join(f"{k} {float((v - lc).abs().max()) / scale:.6g}"
                             for k, v in readings.items())
            print(f"unet levels=3 plain {dt}, volume seed {seed}, max |dlogit| "
                  f"/ max |logit| card vs CPU: {line} (max|logit| {scale:.6g}; "
                  f"limit {rtol:g}) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
