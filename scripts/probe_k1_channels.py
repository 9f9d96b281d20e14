#!/usr/bin/env python3
"""K1's wgmma route at one output shape with 16, 24 and 32 input channels.

    python3 scripts/probe_k1_channels.py    # on a CUDA card, from the checkout

The baseline's layer 1 (8, 74^3, Ci) -> (8, 72^3, 32) and the plain U-Net's
conv 9 (1, 258^3, Ci) -> (1, 256^3, 24), bf16, each at Ci = 16, 24 and 32:
the kernel's median time and rate beside one cuDNN call.  Ci = 16 runs one 16-channel slice per tap,
Ci = 32 one 32-channel slice, Ci = 24 one 32-channel slice zero-filled past
channel 24 on a 48-byte voxel stride.  Every output is checked against the
plain version (one bf16 ulp).
"""

import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from flypylib_tpu_torch.ops.conv import (conv3d_bias_relu,  # noqa: E402
                                         conv3d_reference, k1_route)

SHAPES = (("baseline layer 1", 8, 74, 32, 1), ("unet conv 9", 1, 258, 24, 1))


def main() -> int:
    cs.require(torch.cuda.is_available(), "needs a CUDA card")
    card = cs.card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, batch, size, co, d in SHAPES:
        for ci in (16, 24, 32):
            x = torch.relu(torch.randn((batch, size, size, size, ci),
                                       generator=gen, device="cuda")).bfloat16()
            w = torch.randn((3, 3, 3, ci, co), generator=gen,
                            device="cuda") / math.sqrt(27 * ci)
            b = 0.1 * torch.randn((co,), generator=gen, device="cuda")
            got = conv3d_bias_relu(x, w, b, d)
            err, ok = cs.conv_check(got, conv3d_reference(x, w, b, d))
            cs.require(ok, f"{label} Ci={ci}: outside tolerance ({err})")
            ms = cs.median_ms(lambda: conv3d_bias_relu(x, w, b, d))
            lib = cs.median_ms(lambda: cs.cudnn_conv(x, w, b, d))
            flops = 2 * 27 * ci * got.numel()
            print(f"{label} x{tuple(x.shape)} -> Co {co} bf16 "
                  f"[{k1_route(x, w)}]: kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), cuDNN {lib:.4f} ms; "
                  f"max|err| {err:.4g} ok [{card}]", flush=True)
            del x, got
    return 0


if __name__ == "__main__":
    sys.exit(main())
