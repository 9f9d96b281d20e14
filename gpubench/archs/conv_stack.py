"""The ``conv_stack`` architecture: valid 3^3 convs with a dilation schedule,
bias and ReLU, a 1x1x1 head with ReLU, 1x1x1 logits (flypylib's baseline
and vgg_like).  Its configuration gives ``features``, ``dilations`` and
``head_features``.  The functions are those ``gpubench/archs`` lists."""

from __future__ import annotations

import torch.nn.functional as F

from gpubench.reference import conv3d, pointwise


def param_shapes(cfg: dict) -> list[tuple[str, tuple, int]]:
    feats = cfg["features"]
    ins = [1, *feats[:-1]]
    out = [(f"Conv_{i}", (3, 3, 3, ci, co), 27 * ci)
           for i, (ci, co) in enumerate(zip(ins, feats))]
    n, h = len(feats), cfg["head_features"]
    out.append((f"Conv_{n}", (1, 1, 1, feats[-1], h), feats[-1]))
    out.append((f"Conv_{n + 1}", (1, 1, 1, h, 1), h))
    return out


def _convs(params: dict) -> list:
    return sorted((k for k in params if k.startswith("Conv_")),
                  key=lambda k: int(k.split("_")[1]))


def forward(cfg, params, x, q, logits=True):
    names = _convs(params)
    n = len(cfg["features"])
    for name, d in zip(names[:n], cfg["dilations"]):
        x = F.relu(conv3d(x, params[name], d, q))
    x = F.relu(pointwise(x, params[names[n]], q))
    return pointwise(x, params[names[n + 1]], q) if logits else x


def context(cfg) -> int:
    return sum(cfg["dilations"])


def grid(cfg) -> tuple[int, int]:
    """Any extent: a voxel reads only its receptive field, so any z-slab is
    exact."""
    return 1, 0


def packed_extent(cfg, s: int) -> int | None:
    """Output extent of the packed engine's forward for input extent
    ``s``, or None where it cannot run: the input is packed 2^3 voxels to
    one (a parity split, so its extent must be even), and packed 2^3 again
    before any layer whose dilation is wider than the packing (again an
    even extent); a layer of dilation ``d`` loses ``2 d`` voxels, ``2 d /
    f`` packed ones at packing ``f``."""
    f, c = 2, s
    if c % 2:
        return None
    c //= 2
    for d in cfg["dilations"]:
        while f < d:
            if c % 2:
                return None
            c, f = c // 2, 2 * f
        c -= 2 * d // f
        if c <= 0:
            return None
    return c * f


def train_patch(cfg, patch_size: int, engine: str) -> int:
    """The plain engine's valid forward takes any extent wider than twice
    the context; the packed one the smallest extent from ``patch_size`` up
    whose packed forward loses just the context on each face."""
    ctx = context(cfg)
    if engine == "plain":
        if patch_size <= 2 * ctx:
            raise ValueError(f"patch {patch_size} within the context {ctx}")
        return patch_size
    if engine != "packed":
        raise ValueError(f"unknown engine {engine!r}")
    s = patch_size
    while packed_extent(cfg, s) != s - 2 * ctx:
        s += 1
    return s


def layer_extents(cfg: dict, out: int) -> list[tuple[str, tuple, int]]:
    """``(name, kernel shape, output extent)`` of every layer of a valid
    forward whose output extent is ``out``."""
    shapes = param_shapes(cfg)
    n = len(cfg["features"])
    ext, res = out, []
    for (name, shape, _), d in zip(reversed(shapes[:n]),
                                   reversed(cfg["dilations"])):
        res.append((name, shape, ext))
        ext += 2 * d
    res.reverse()
    return res + [(name, shape, out) for name, shape, _ in shapes[n:]]


def layer_macs(cfg: dict, out: int) -> list[tuple[str, int]]:
    """Every kernel tap a multiply-add at every output voxel of its layer."""
    res = []
    for name, (kz, ky, kx, ci, co), ext in layer_extents(cfg, out):
        res.append((name, kz * ky * kx * ci * co * ext ** 3))
    return res


def flax_name(cfg, name: str) -> str:
    """``convs.i.weight`` -> ``Conv_i/kernel``; the head and the logits
    after the convs."""
    parts = name.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}[parts[-1]]
    if parts[0] == "convs":
        return f"Conv_{parts[1]}/{leaf}"
    n_convs = len(cfg["features"])
    k = {"head": n_convs, "logits": n_convs + 1}[parts[0]]
    return f"Conv_{k}/{leaf}"


def logits_layer(cfg) -> str:
    return f"Conv_{len(cfg['features']) + 1}"
