"""The ``unet`` architecture: flypylib's valid-conv 3D U-Net (``BASELINE.json``
config 4), the 3D U-Net of Cicek et al. (arXiv:1606.06650) with valid convs
and crop-and-concat skips as in Ronneberger et al. (arXiv:1505.04597).  Its
configuration gives ``base_features``, ``levels`` and ``convs_per_stage``.
The functions are those ``gpubench/archs`` lists.

The layers, in order (``f`` = ``base_features``; at the published 24, 2, 2:
``Conv_0..Conv_10`` and ``ConvTranspose_0..1``):

- each encoder level: ``convs_per_stage`` valid 3^3 conv + bias + ReLU to
  ``f``, the features kept as the level's skip, then a 2^3 stride-2 max-pool,
  and ``f`` doubles;
- the bottleneck: ``convs_per_stage`` such convs at the deepest width;
- each decoder level, deepest first: ``f`` halves, a kernel-2 stride-2
  ``ConvTranspose`` (+ bias, no activation) to ``f``, the level's skip
  cropped about its centre to the upsampled extent, the concat ``[skip,
  up]`` on channels, then ``convs_per_stage`` convs to ``f``;
- 1x1x1 logits in f32.

The ``ConvTranspose`` is Flax's: with its DHWIO kernel ``K``, per axis
``out[2 r + p] = x[r] @ K[1 - p]`` (``p`` in {0, 1}), the flip of
``F.conv_transpose3d``'s ``out[2 r + p] = x[r] @ W[p]``; so the kernel is
flipped on its three spatial axes before ``F.conv_transpose3d``.

Departures from the JAX package's ``UNetValid``: none.  The max-pool floors
odd extents as Flax's does, but the extents this reference is run at are on
its grid, where every pooled extent is even.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference import conv3d, pointwise


def _widths(cfg: dict) -> tuple[list, list, int]:
    """``(encoder widths a level, decoder widths a level (deepest first),
    bottleneck width)``."""
    f, n = cfg["base_features"], cfg["levels"]
    enc = [f << i for i in range(n)]
    return enc, enc[::-1], f << n


def param_shapes(cfg: dict) -> list[tuple[str, tuple, int]]:
    """Flax's creation order: the encoder's and the bottleneck's convs, then
    each decoder level's ``ConvTranspose`` and convs, then the logits."""
    cps = cfg["convs_per_stage"]
    enc, dec, deep = _widths(cfg)
    out, ci, k, j = [], 1, 0, 0

    def convs(co):
        nonlocal ci, k
        for _ in range(cps):
            out.append((f"Conv_{k}", (3, 3, 3, ci, co), 27 * ci))
            ci, k = co, k + 1

    for co in enc + [deep]:
        convs(co)
    for co in dec:
        out.append((f"ConvTranspose_{j}", (2, 2, 2, ci, co), 8 * ci))
        j += 1
        ci = 2 * co  # [skip, up]
        convs(co)
    out.append((f"Conv_{k}", (1, 1, 1, ci, 1), ci))
    return out


def up(x, p, q):
    """Flax's kernel-2 stride-2 ``ConvTranspose`` of ``x`` (NCDHW) with the
    DHWIO kernel and the bias of ``p``: ``F.conv_transpose3d`` against the
    spatially flipped kernel."""
    w = p["kernel"].flip(0, 1, 2).permute(3, 4, 0, 1, 2)
    return (F.conv_transpose3d(q(x), q(w), stride=2)
            + p["bias"].view(1, -1, 1, 1, 1))


def centre_crop(skip, like):
    """``skip`` (NCDHW) cut about its centre to ``like``'s spatial extent
    (the lower side takes the smaller half of an odd margin)."""
    c = [(a - b) // 2 for a, b in zip(skip.shape[2:], like.shape[2:])]
    d, h, w = like.shape[2:]
    return skip[:, :, c[0]:c[0] + d, c[1]:c[1] + h, c[2]:c[2] + w]


def forward(cfg, params, x, q, logits=True):
    cps, levels = cfg["convs_per_stage"], cfg["levels"]
    convs = (f"Conv_{k}" for k in range(len(params)))

    def block(x):
        for _ in range(cps):
            x = F.relu(conv3d(x, params[next(convs)], 1, q))
        return x

    skips = []
    for _ in range(levels):
        x = block(x)
        skips.append(x)
        x = F.max_pool3d(x, 2)
    x = block(x)
    for j, skip in enumerate(reversed(skips)):
        x = up(x, params[f"ConvTranspose_{j}"], q)
        x = block(torch.cat([centre_crop(skip, x), x], dim=1))
    return pointwise(x, params[next(convs)], q) if logits else x


def extents(cfg, s: int) -> list[tuple[str, int]] | None:
    """``(layer, output extent)`` of every layer of a valid forward of input
    extent ``s``, in order; None where the valid-size rule refuses ``s``: a
    pooled extent that is odd (pooling would drop a plane), an extent that
    reaches 0, or a skip narrower than the upsampled tensor it is cropped
    to.  Pools and crops are not layers."""
    cps, levels = cfg["convs_per_stage"], cfg["levels"]
    res, k, skips = [], 0, []

    def convs(s):
        nonlocal k
        for _ in range(cps):
            s -= 2
            res.append((f"Conv_{k}", s))
            k += 1
        return s

    for _ in range(levels):
        s = convs(s)
        if s <= 0 or s % 2:
            return None
        skips.append(s)
        s //= 2
    s = convs(s)
    for j, skip in enumerate(reversed(skips)):
        if s <= 0 or skip < 2 * s:
            return None
        s *= 2
        res.append((f"ConvTranspose_{j}", s))
        s = convs(s)
    if s <= 0:
        return None
    res.append((f"Conv_{k}", s))
    return res


def _valid(cfg, lo: int = 8, hi: int = 200) -> list[tuple[int, int]]:
    """``(input extent, output extent)`` of the valid forwards from ``lo``
    to ``hi`` that lose the least (floor-pooling never applies on them)."""
    got = [(s, e[-1][1]) for s in range(lo, hi)
           if (e := extents(cfg, s)) is not None]
    ctx = min(s - o for s, o in got)
    return [(s, o) for s, o in got if s - o == ctx]


def context(cfg) -> int:
    s, o = _valid(cfg)[0]
    return (s - o) // 2


def grid(cfg) -> tuple[int, int]:
    """The valid input extents step by the gcd of their differences, and
    every slab of ``reference.volume_logits`` starts a multiple of it from
    the volume's first plane, so it pools the blocks the whole forward
    pools."""
    sizes = [s for s, _ in _valid(cfg)]
    mult = int(np.gcd.reduce(np.diff(sizes)))
    return mult, sizes[0] % mult


def packed_extent(cfg, s: int) -> int | None:
    """Output extent of the packed engine's forward for input extent ``s``,
    or None where it cannot run: the input is packed 2^3 voxels to one (an
    even extent), each 3^3 conv loses one packed cell, each pool needs an
    even count of cells (a 2^3 pool is a max over the parity groups, then
    a repack), the bottleneck's cells unpack to the dense coarse extent the
    first decoder level reads, and each decoder level doubles it, crops
    its skip to that and loses a cell a conv."""
    cps, levels = cfg["convs_per_stage"], cfg["levels"]
    if s % 2:
        return None
    c, skips = s // 2, []
    for _ in range(levels):
        c -= cps
        if c <= 0 or c % 2:
            return None
        skips.append(c)
        c //= 2
    c -= cps
    if c <= 0:
        return None
    n = 2 * c
    for skip in reversed(skips):
        if skip < n or n - cps <= 0:
            return None
        n = 2 * (n - cps)
    return n


def train_patch(cfg, patch_size: int, engine: str) -> int:
    """The smallest extent from ``patch_size`` up whose valid forward (the
    plain engine's) or packed forward loses just the context on each face:
    the trainer's ``valid_size`` of the engine's spec."""
    if engine not in ("plain", "packed"):
        raise ValueError(f"unknown engine {engine!r}")
    ctx = context(cfg)
    s = patch_size
    while True:
        if engine == "plain":
            e = extents(cfg, s)
            out = e[-1][1] if e is not None else None
        else:
            out = packed_extent(cfg, s)
        if out == s - 2 * ctx:
            return s
        s += 1


def layer_macs(cfg: dict, out: int) -> list[tuple[str, int]]:
    """A 3^3 conv 27 ci co multiply-adds an output voxel; a ``ConvTranspose``
    ci co a voxel of its finer output (each output voxel takes one tap of
    the 2^3 kernel); the logits ci.  The pools and the crops count none."""
    shapes = {name: shape for name, shape, _ in param_shapes(cfg)}
    ext = extents(cfg, out + 2 * context(cfg))
    if ext is None:
        raise ValueError(f"output extent {out} is off the grid {grid(cfg)}")
    res = []
    for name, e in ext:
        kz, ky, kx, ci, co = shapes[name]
        taps = 1 if name.startswith("ConvTranspose") else kz * ky * kx
        res.append((name, taps * ci * co * e ** 3))
    return res


def flax_name(cfg, name: str) -> str:
    """``convs.i.*`` -> ``Conv_i/*``, ``convts.j.*`` -> ``ConvTranspose_j/*``,
    ``logits.*`` -> the last ``Conv``."""
    parts = name.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}[parts[-1]]
    if parts[0] == "convs":
        return f"Conv_{parts[1]}/{leaf}"
    if parts[0] == "convts":
        return f"ConvTranspose_{parts[1]}/{leaf}"
    if parts[0] == "logits":
        return f"{logits_layer(cfg)}/{leaf}"
    raise KeyError(name)


def logits_layer(cfg) -> str:
    return param_shapes(cfg)[-1][0]
