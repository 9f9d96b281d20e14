"""The plain reference the benchmark holds the port against.

Plain PyTorch, NumPy and SciPy, computed in float32 with TF32 off
(:func:`exact_f32`).  It imports neither ``jax`` nor ``flypylib_tpu`` nor
anything of ``flypylib_tpu_torch``, and takes nothing the program made: it
reads the configuration file's widths, the weights in the JAX package's
variable layout (``Conv_i`` / ``ConvTranspose_j`` with DHWIO kernels, as the
benchmark draws them) and the raw inputs, and works out the rest itself.

- Models: one module per architecture, ``archs/<arch>.py``, found by the
  configuration's ``"arch"`` (:func:`gpubench.archs.of`); the functions
  here that depend on the architecture ask it.
- Detection: NMS is a voxel that equals the max of its window (outside the
  volume counts as -inf) and is >= the threshold; connected components are
  6-connected sets of voxels >= the threshold, each reported at its mean
  voxel coordinate with its largest probability.
- Training: the patch each engine samples (:func:`train_patch`), the
  trainer's sampling (draws from a ``torch.Generator`` in the trainer's
  order, uniform and positive-centred corners), the 16-element flip /
  yx-transpose augmentation, masked sigmoid cross-entropy and Adam.

``precision="fp8"`` is the control: the same computation with every conv's
and matmul's operands rounded to float8 e4m3 (a per-tensor scale to the
format's range; products summed in f32), and in training the gradients
reaching those operands rounded to e5m2, as fp8 training recipes do.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from gpubench import archs

# the f32 reciprocal a uint8 volume is multiplied by on the staged path
U8_SCALE = float(np.float32(1.0 / 255.0))


@contextlib.contextmanager
def exact_f32():
    """cuDNN's and cuBLAS's TF32 off for the block (both are process-wide
    flags; TF32 rounds f32 operands to 10 mantissa bits)."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def _round_fp8(x: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, fmax / amax, torch.ones_like(amax))
    return (x * scale).clamp(-fmax, fmax).to(dtype).float() / scale


class _FP8(torch.autograd.Function):
    """Forward: e4m3 rounding; backward: the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, 57344.0)


def operand(precision: str):
    """The rounding applied to every conv and matmul operand."""
    if precision == "f32":
        return lambda t: t
    if precision == "fp8":
        return _FP8.apply
    raise ValueError(f"unknown precision {precision!r}")


# -- weights ---------------------------------------------------------------

def param_shapes(cfg: dict) -> list[tuple[str, tuple, int]]:
    """``(name, kernel shape, fan-in)`` of every layer, in the JAX package's
    creation order and names."""
    return archs.of(cfg).param_shapes(cfg)


# -- forward -----------------------------------------------------------------

def conv3d(x, p, dilation, q):
    """A valid conv of ``x`` (NCDHW) with the DHWIO kernel and the bias of
    ``p``, its operands rounded by ``q``."""
    w = p["kernel"].permute(4, 3, 0, 1, 2)
    return F.conv3d(q(x), q(w), dilation=dilation) + p["bias"].view(1, -1, 1, 1, 1)


def pointwise(x, p, q):
    """A 1x1x1 conv of ``x`` with ``p``, as a matmul over the channels."""
    k = p["kernel"]
    w = k.reshape(k.shape[-2], k.shape[-1]).t().reshape(k.shape[-1], k.shape[-2],
                                                       1, 1, 1)
    return F.conv3d(q(x), q(w)) + p["bias"].view(1, -1, 1, 1, 1)


def forward(cfg, params, x, precision="f32", logits=True):
    """Logits ``(N, 1, d, h, w)`` of an f32 input ``(N, 1, D, H, W)``; with
    ``logits=False`` the features the logits layer reads, ``(N, C, ...)``."""
    return archs.of(cfg).forward(cfg, params, x, operand(precision), logits)


def context(cfg) -> int:
    """Voxels a valid forward loses on each face."""
    return archs.of(cfg).context(cfg)


def train_patch(cfg, patch_size: int, engine: str) -> int:
    """The patch the training ``engine`` samples for ``patch_size``."""
    return archs.of(cfg).train_patch(cfg, patch_size, engine)


def reflect_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices of ``np.pad(a, (lo, hi), mode="reflect")`` into ``a`` of
    extent ``n`` (one reflection)."""
    if max(lo, hi) >= n:
        raise ValueError(f"reflect pad {max(lo, hi)} needs an extent > {n}")
    i = torch.arange(-lo, n + hi, device=device)
    return torch.where(i < 0, -i, torch.where(i >= n, 2 * (n - 1) - i, i))


def volume_logits(cfg, params, vol: torch.Tensor, scale: float | None,
                  precision: str = "f32", slab: int = 16) -> torch.Tensor:
    """f32 logits of a whole (z, y, x) volume as one valid forward over the
    volume reflect-padded by the context, computed in z-slabs of about
    ``slab`` planes.  Each slab starts on the architecture's grid, so it
    reads what the whole forward reads there and slabs are exact; the
    grid has to give output extents that are multiples of it, and so does
    the volume.  ``scale`` multiplies the raw values (None: raw)."""
    ctx = context(cfg)
    mult, off = archs.of(cfg).grid(cfg)
    if (off - 2 * ctx) % mult or any(n % mult for n in vol.shape):
        raise ValueError(f"volume {tuple(vol.shape)} is off the grid: each "
                         f"extent a multiple of {mult}")
    step = max(mult, slab - slab % mult)
    dev = vol.device
    Z, Y, X = vol.shape
    iy = reflect_index(Y, ctx, ctx, dev)
    ix = reflect_index(X, ctx, ctx, dev)
    iz = reflect_index(Z, ctx, ctx, dev)
    out = torch.empty((Z, Y, X), dtype=torch.float32, device=dev)
    with exact_f32(), torch.no_grad():
        for z0 in range(0, Z, step):
            z1 = min(Z, z0 + step)
            x = vol.index_select(0, iz[z0:z1 + 2 * ctx])
            x = x.index_select(1, iy).index_select(2, ix).float()
            if scale is not None:
                x = x * scale
            out[z0:z1] = forward(cfg, params, x[None, None], precision)[0, 0]
    return out


# -- detection -------------------------------------------------------------

def nms(prob: torch.Tensor, window: int, threshold: float):
    """``(flat indices, conf)`` of the NMS detections, as NumPy arrays."""
    with torch.no_grad():
        mx = F.max_pool3d(prob[None, None], window, stride=1,
                          padding=window // 2)[0, 0]
        cand = (prob == mx) & (prob >= threshold)
        del mx
        idx = torch.nonzero(cand.reshape(-1))[:, 0]
        conf = prob.reshape(-1)[idx]
    return idx.cpu().numpy(), conf.cpu().numpy()


def components(prob: torch.Tensor, threshold: float):
    """``(centroids (n, 3) f64, conf (n,))`` of the 6-connected components
    of ``prob >= threshold``: labelled on the host over the above-threshold
    voxels only."""
    shape = prob.shape
    with torch.no_grad():
        idx = torch.nonzero((prob >= threshold).reshape(-1))[:, 0]
        conf = prob.reshape(-1)[idx]
    idx, conf = idx.cpu().numpy(), conf.cpu().numpy()
    n = len(idx)
    if n == 0:
        return np.zeros((0, 3)), np.zeros((0,))
    yx = shape[1] * shape[2]
    coords = np.stack([idx // yx, (idx // shape[2]) % shape[1],
                       idx % shape[2]], axis=1)
    rows, cols = [], []
    for axis, step in ((0, yx), (1, shape[2]), (2, 1)):
        ok = coords[:, axis] < shape[axis] - 1
        nb = idx[ok] + step
        j = np.searchsorted(idx, nb)
        j = np.minimum(j, n - 1)
        hit = idx[j] == nb
        rows.append(np.nonzero(ok)[0][hit])
        cols.append(j[hit])
    r, c = np.concatenate(rows), np.concatenate(cols)
    graph = coo_matrix((np.ones(len(r), np.int8), (r, c)), shape=(n, n))
    k, lab = connected_components(graph, directed=False)
    count = np.bincount(lab, minlength=k).astype(np.float64)
    cent = np.stack([np.bincount(lab, weights=coords[:, a].astype(np.float64),
                                 minlength=k) / count for a in range(3)], 1)
    best = np.full(k, -np.inf)
    np.maximum.at(best, lab, conf.astype(np.float64))
    return cent, best


# -- training --------------------------------------------------------------

def augment(batch: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Per-patch flips of z, y, x (code bits 0, 1, 2), then a (y, x)
    transpose (bit 3), of ``batch`` (B, Z, Y, X)."""
    out = []
    for b in range(batch.shape[0]):
        c = int(codes[b])
        v = batch[b]
        dims = [a for a, bit in ((0, 0), (1, 1), (2, 2)) if c >> bit & 1]
        if dims:
            v = v.flip(dims)
        if c >> 3 & 1:
            v = v.transpose(1, 2)
        out.append(v)
    return torch.stack(out)


class TrainData:
    """The labelled volume on the device and what sampling needs of it."""

    def __init__(self, image, labels, mask, patch: int):
        self.image, self.labels, self.mask = image, labels, mask
        self.corner_max = torch.tensor([s - patch for s in image.shape],
                                       device=image.device)
        self.pos = torch.nonzero(labels > 0.5)
        self.n_pos = int(self.pos.shape[0])


def sample(gen: torch.Generator, data: TrainData, tc: dict, patch: int,
           ctx: int):
    """One batch ``(x, y, m, codes)``: the random draws in the trainer's
    order (volume pick, uniform corner, positive pick, jitter, mix, then
    the augmentation codes), from ``gen``."""
    dev = data.image.device
    n, j = tc["batch_size"], tc["pos_jitter"]
    vidx_u = torch.randint(0, 1, (n,), generator=gen, device=dev)
    u = torch.rand((n, 3), generator=gen, device=dev)
    pidx = torch.randint(0, max(data.n_pos, 1), (n,), generator=gen, device=dev)
    jitter = torch.randint(-j, j + 1, (n, 3), generator=gen, device=dev)
    mix = torch.rand((n,), generator=gen, device=dev)
    del vidx_u  # one volume: every pick is volume 0
    uniform = torch.floor(u * (data.corner_max + 1)).to(torch.int64)
    if data.n_pos:
        centre = data.pos[pidx] + jitter
        pos = torch.minimum(torch.clamp(centre - patch // 2, min=0),
                            data.corner_max)
        corners = torch.where((mix < tc["pos_fraction"])[:, None], pos, uniform)
    else:
        corners = uniform
    codes = (torch.randint(0, 16, (n,), generator=gen, device=dev)
             if tc["augment"] else None)
    out = patch - 2 * ctx
    cs = corners.cpu().tolist()
    x = torch.stack([data.image[z:z + patch, y:y + patch, x_:x_ + patch]
                     for z, y, x_ in cs]).float() * (1.0 / 255.0)
    y = torch.stack([data.labels[z + ctx:z + ctx + out, y_ + ctx:y_ + ctx + out,
                                 x_ + ctx:x_ + ctx + out] for z, y_, x_ in cs])
    m = torch.stack([data.mask[z + ctx:z + ctx + out, y_ + ctx:y_ + ctx + out,
                               x_ + ctx:x_ + ctx + out] for z, y_, x_ in cs])
    if codes is not None:
        x, y, m = (augment(v, codes) for v in (x, y, m))
    return x, y, m


def bce(logits, y, m) -> torch.Tensor:
    """Mask-weighted mean of the sigmoid cross-entropy."""
    ls = -y * F.logsigmoid(logits) - (1.0 - y) * F.logsigmoid(-logits)
    return (ls * m).sum() / torch.clamp(m.sum(), min=1.0)


def train(cfg, params, data: TrainData, gen: torch.Generator, tc: dict,
          patch: int, steps: int, precision: str = "f32",
          fault: str | None = None) -> dict:
    """``steps`` training steps from ``params`` (not changed): each step's
    loss, the first step's gradient of every leaf and the leaves after the
    last step, keyed ``name/kernel`` and ``name/bias``.  ``fault`` plants
    one of the check's faults into this program: ``"half_batch"`` (the
    loss over the first half of the batch only)."""
    ctx = context(cfg)
    leaves = {f"{k}/{w}": params[k][w].detach().clone().requires_grad_(True)
              for k in params for w in ("kernel", "bias")}
    m1 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    m2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, tc["learning_rate"]
    losses, first = [], None
    with exact_f32():
        for t in range(1, steps + 1):
            x, y, m = sample(gen, data, tc, patch, ctx)
            if fault == "half_batch":
                h = x.shape[0] // 2
                x, y, m = x[:h], y[:h], m[:h]
            p = {k: {w: leaves[f"{k}/{w}"] for w in ("kernel", "bias")}
                 for k in params}
            logits = forward(cfg, p, x[:, None], precision)[:, 0]
            loss = bce(logits, y, m)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in zip(leaves, grads)}
            with torch.no_grad():
                for (k, v), g in zip(leaves.items(), grads):
                    m1[k].mul_(b1).add_(g, alpha=1 - b1)
                    m2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    den = (m2[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                    v.addcdiv_(m1[k], den, value=-lr / (1 - b1 ** t))
    return {"loss": losses, "grad": first,
            "params": {k: v.detach() for k, v in leaves.items()}}
