"""Inputs made from ``--seed`` on the device: weights, volumes, training data.

Every draw comes from a ``torch.Generator`` on the run's device, in a few
large calls, so a seed gives the same inputs on every run of a cell.  Each
kind of input has its own stream (:func:`generator`), so adding a draw to
one does not move another.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpubench.reference import param_shapes

# stddev correction of a normal truncated to +-2 sigma (Flax's lecun_normal)
_TRUNC_STD = 0.87962566103423978
STREAMS = {"weights": 0, "volumes": 1, "train": 2, "sample": 3, "probe": 4}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """The generator of one input stream of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * len(STREAMS) + STREAMS[stream]) % (1 << 63))
    return g


def make_params(cfg: dict, seed: int, device) -> dict:
    """Weights in the JAX package's variable layout, f32 on ``device``:
    kernels from a fan-in normal truncated at 2 sigma (Flax's
    ``lecun_normal``), biases normal with the configuration's
    ``assumed.bias_std``; all from one draw."""
    shapes = param_shapes(cfg)
    bias_std = float(cfg["assumed"]["bias_std"])
    sizes = [(math.prod(s), s[-1]) for _, s, _ in shapes]
    total = sum(k + b for k, b in sizes)
    flat = torch.randn(total, generator=generator(seed, "weights", device),
                       device=device)
    params, at = {}, 0
    for (name, shape, fan), (nk, nb) in zip(shapes, sizes):
        std = math.sqrt(1.0 / fan) / _TRUNC_STD
        kernel = flat[at:at + nk].clamp(-2.0, 2.0).mul(std).reshape(shape)
        bias = flat[at + nk:at + nk + nb].mul(bias_std)
        params[name] = {"kernel": kernel, "bias": bias}
        at += nk + nb
    return params


def calibrate(params: dict, logits: torch.Tensor) -> tuple[float, float]:
    """Rescale the logits layer in place so that ``logits`` (the
    reference's logits of a probe volume under ``params``) would have mean
    0 and standard deviation 1: ``z' = a z + c``.  Random weights on raw
    intensities otherwise give logits whose scale the seed sets (from
    ~0.01 to a map saturated at 1.0), and with it the detection work.
    Returns ``(a, c)``."""
    z = logits.double()
    std = float(z.std())
    a, c = 1.0 / std, -float(z.mean()) / std
    last = max((k for k in params if k.startswith("Conv_")),
               key=lambda k: int(k.split("_")[1]))
    p = params[last]
    params[last] = {"kernel": p["kernel"] * a, "bias": p["bias"] * a + c}
    return a, c


def blob_cores(shape, centers, radius: int, device) -> torch.Tensor:
    """Boolean ``shape`` mask: the voxels within ``radius`` of a centre."""
    g = torch.arange(-radius, radius + 1, device=device)
    ball = (g[:, None, None] ** 2 + g[None, :, None] ** 2
            + g[None, None, :] ** 2) <= radius ** 2
    mask = torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    r = radius
    for z, y, x in centers:
        sl = (slice(z - r, z + r + 1), slice(y - r, y + r + 1),
              slice(x - r, x + r + 1))
        mask[sl] |= ball
    return mask


def flax_variables(params: dict) -> dict:
    """``params`` as the numpy variables ``FplNetwork.load_flax_params``
    takes."""
    return {"params": {k: {w: v.detach().cpu().numpy() for w, v in p.items()}
                       for k, p in params.items()}}


def add_blobs(vol: torch.Tensor, n_blobs: int, gen: torch.Generator) -> list:
    """Stamp ``n_blobs`` Gaussian blobs (sigma 2, 9^3 voxels, peak 255) at
    centres drawn from ``gen`` into the uint8 ``vol`` in place, each voxel
    the brighter of the two; returns the centres, a list of (z, y, x)."""
    size, device = vol.shape[0], vol.device
    centers = torch.randint(5, size - 5, (n_blobs, 3), generator=gen,
                            device=device).cpu().tolist()
    g = torch.arange(-4, 5, device=device, dtype=torch.float32)
    r2 = g[:, None, None] ** 2 + g[None, :, None] ** 2 + g[None, None, :] ** 2
    blob = (torch.exp(-r2 / 8.0) * 255.0).to(torch.uint8)
    for z, y, x in centers:
        sl = (slice(z - 4, z + 5), slice(y - 4, y + 5), slice(x - 4, x + 5))
        vol[sl] = torch.maximum(vol[sl], blob)
    return centers


def blob_volume(size: int, n_blobs: int, gen: torch.Generator, device,
                slab: int = 64):
    """uint8 ``(size,)*3`` volume: noise ~25 +- 13 (a normal of 0.1 +- 0.05
    clipped to [0, 1], times 255) plus ``n_blobs`` Gaussian blobs (sigma 2,
    9^3 voxels) that peak at 255."""
    vol = torch.empty((size,) * 3, dtype=torch.uint8, device=device)
    for z0 in range(0, size, slab):
        z1 = min(size, z0 + slab)
        t = torch.empty((z1 - z0, size, size), device=device)
        t.normal_(0.1, 0.05, generator=gen)
        vol[z0:z1] = t.clamp_(0.0, 1.0).mul_(255.0).to(torch.uint8)
    add_blobs(vol, n_blobs, gen)
    return vol


def host_volumes(size: int, n_blobs: int, count: int, seed: int, device):
    """``count`` distinct blob volumes, made on ``device`` and copied to
    pageable host memory, as a caller hands them to the program."""
    gen = generator(seed, "volumes", device)
    return [blob_volume(size, n_blobs, gen, device).cpu().numpy()
            for _ in range(count)]


def region_volume(size: int, n_blobs: int, regions: dict,
                  gen: torch.Generator, device):
    """uint8 ``(size,)*3`` volume whose regions differ, as stained tissue
    does, plus ``n_blobs`` blobs as in :func:`blob_volume`; and the blobs'
    centres.  Three smooth fields (uniform draws on a grid of
    ``regions["knots"]`` knots a side, trilinear between them) set each
    voxel's mean brightness (the first field to the power
    ``regions["power"]``, mapped onto ``regions["brightness"]``, so that
    most regions are dark and a few bright), its contrast (0.1 to 1 times
    the mean) and its texture (white noise blended with noise smoothed
    over 5^3 voxels).  Patches from different regions then pull a
    gradient different ways."""
    k = int(regions["knots"])
    lo, hi = regions["brightness"]
    fields = torch.nn.functional.interpolate(
        torch.rand((1, 3, k, k, k), generator=gen, device=device),
        size=(size,) * 3, mode="trilinear", align_corners=True)[0]
    mean = fields[0].pow_(float(regions["power"])).mul_(hi - lo).add_(lo)
    spread = fields[1].mul_(0.9).add_(0.1).mul_(mean)
    mix = fields[2]
    white = torch.randn((size,) * 3, generator=gen, device=device)
    smooth = torch.nn.functional.avg_pool3d(
        torch.randn((1, 1) + (size,) * 3, generator=gen, device=device),
        5, stride=1, padding=2)[0, 0].mul_(125 ** 0.5)
    noise = white.mul_(1.0 - mix).add_(smooth.mul_(mix))
    vol = noise.mul_(spread).add_(mean).clamp_(0.0, 1.0).mul_(255.0).to(
        torch.uint8)
    del fields, white, smooth, noise
    return vol, add_blobs(vol, n_blobs, gen)


def train_volume(size: int, n_blobs: int, radius: int, regions: dict,
                 seed: int, device):
    """``(image uint8, labels f32, mask f32)`` on ``device``: a volume of
    regions and blobs (:func:`region_volume`), labels positive within
    ``radius`` of each blob's centre (T-bar-like ground truth), the mask
    all ones."""
    image, centers = region_volume(size, n_blobs, regions,
                                   generator(seed, "train", device), device)
    labels = blob_cores(image.shape, centers, radius, device).float()
    return image, labels, torch.ones_like(labels)


def prior_bias(params: dict, prior: float) -> None:
    """Set the logits layer's bias in place to ``logit(prior)``, the
    prior initialisation of a detector of rare positives: every voxel
    starts at probability ``prior``, so the gradient comes from the
    positives and the content of each patch, not from a push down that
    every patch shares."""
    last = max((k for k in params if k.startswith("Conv_")),
               key=lambda k: int(k.split("_")[1]))
    b = params[last]["bias"]
    params[last] = {**params[last],
                    "bias": torch.full_like(b, math.log(prior / (1 - prior)))}
