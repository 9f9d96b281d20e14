"""A toy architecture for the tests, with what a U-Net has that a conv stack
has not: a valid 3^3 conv, a 2^3 max-pool, a 3^3 conv at half resolution, a
2^3 stride-2 ``ConvTranspose``, a centre-cropped skip concatenated with the
upsampled features, a 3^3 conv and 1x1x1 logits; widths ``base_features``
and twice that.  The tests copy it into a temporary directory as
``archs/toy_unet.py``; the functions are those ``gpubench/archs`` lists.

An input extent ``s`` loses 2 voxels to the first conv (which must leave an
even extent to pool), 4 at half resolution and 2 after the skip: the
output is ``s - 8``, so the context is 4 and the grid (2, 0)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpubench.reference import conv3d, pointwise


def _widths(cfg) -> tuple[int, int]:
    b = cfg["base_features"]
    return b, 2 * b


def param_shapes(cfg):
    b, w = _widths(cfg)
    return [("Conv_0", (3, 3, 3, 1, b), 27),
            ("Conv_1", (3, 3, 3, b, w), 27 * b),
            ("ConvTranspose_0", (2, 2, 2, w, b), 8 * w),
            ("Conv_2", (3, 3, 3, 2 * b, b), 27 * 2 * b),
            ("Conv_3", (1, 1, 1, b, 1), b)]


def _up(x, p, q):
    w = p["kernel"].permute(3, 4, 0, 1, 2)
    return (F.conv_transpose3d(q(x), q(w), stride=2)
            + p["bias"].view(1, -1, 1, 1, 1))


def forward(cfg, params, x, q, logits=True):
    skip = F.relu(conv3d(x, params["Conv_0"], 1, q))
    x = F.relu(conv3d(F.max_pool3d(skip, 2), params["Conv_1"], 1, q))
    x = F.relu(_up(x, params["ConvTranspose_0"], q))
    c = [(a - b) // 2 for a, b in zip(skip.shape[2:], x.shape[2:])]
    skip = skip[:, :, c[0]:c[0] + x.shape[2], c[1]:c[1] + x.shape[3],
                c[2]:c[2] + x.shape[4]]
    x = F.relu(conv3d(torch.cat([skip, x], dim=1), params["Conv_2"], 1, q))
    return pointwise(x, params["Conv_3"], q) if logits else x


def context(cfg) -> int:
    return 4


def grid(cfg) -> tuple[int, int]:
    return 2, 0


def train_patch(cfg, patch_size: int, engine: str) -> int:
    if engine != "plain" or patch_size % 2 or patch_size <= 8:
        raise ValueError(f"no {engine} patch {patch_size}")
    return patch_size


def layer_macs(cfg, out: int):
    b, w = _widths(cfg)
    half = (out + 2) // 2
    return [("Conv_0", 27 * b * (out + 6) ** 3),
            ("Conv_1", 27 * b * w * half ** 3),
            ("ConvTranspose_0", 8 * w * b * half ** 3),
            ("Conv_2", 27 * 2 * b * b * out ** 3),
            ("Conv_3", b * out ** 3)]


def flax_name(cfg, name: str) -> str:
    parts = name.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}[parts[-1]]
    if parts[0] == "convts":
        return f"ConvTranspose_{parts[1]}/{leaf}"
    k = 3 if parts[0] == "logits" else parts[1]
    return f"Conv_{k}/{leaf}"


def logits_layer(cfg) -> str:
    return "Conv_3"
