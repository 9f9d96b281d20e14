"""3D CNN model zoo for voxel-wise synapse detection, in PyTorch.

Counterpart of ``flypylib_tpu/models/zoo.py``: the plain valid-conv
stacks (the baseline and the deeper VGG-like variant) and the valid-conv
U-Net.  Each zoo entry returns a ``ModelSpec`` carrying the module and its
geometry: the receptive-field ``context`` (voxels lost per face to valid
convolution) and, for the U-Net, the input sizes its pooling admits, which
drive the tiling math.

Layout and numerics follow the reference: activations are NDHWC, conv
weights DHWIO ``(3, 3, 3, Ci, Co)``, compute in ``dtype`` (bf16 by default),
logits in f32.  Every 3^3 conv runs ``ops.conv.conv3d_bias_relu`` (K1); the
1x1x1 head and logits and the U-Net's ConvTranspose are matmuls over the
channel axis, which the reference also leaves outside any Pallas kernel.
A ``ConvStack(use_batchnorm=True)`` puts Flax's ``BatchNorm`` between each
body conv (K1 with ``relu=False``) and its ReLU (:class:`BatchNorm`).

Models return logits; apply ``torch.sigmoid`` for probabilities.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from flypylib_tpu_torch.ops.conv import Conv3dBiasReLU, matmul_f32
from flypylib_tpu_torch.ops.packed_conv import convT_packed_weight, unpack_volume

# stddev correction of a normal truncated to +-2 sigma (Flax/JAX
# variance_scaling "truncated_normal")
_TRUNC_STD = 0.87962566103423978


@dataclass(frozen=True)
class ModelSpec:
    """A model plus the geometry facts the inference engine needs.

    - ``context``: voxels lost per face (isotropic int): output spatial size
      = input - 2*context.
    - ``size_multiple`` / ``size_offset``: valid input sizes are
      ``s = size_offset + k * size_multiple`` (plain conv stacks have
      multiple=1).
    - ``min_size``: smallest valid input size producing non-empty output.
    """

    name: str
    module: nn.Module
    context: int
    size_multiple: int = 1
    size_offset: int = 0
    min_size: int = 0
    metadata: dict = field(default_factory=dict)

    def valid_size(self, s: int) -> int:
        """Smallest valid input size >= s (and >= min_size)."""
        s = max(int(s), self.min_size)
        if self.size_multiple == 1:
            return s
        rem = (s - self.size_offset) % self.size_multiple
        return s if rem == 0 else s + (self.size_multiple - rem)

    def is_valid_size(self, s: int) -> bool:
        return s >= self.min_size and (
            (s - self.size_offset) % self.size_multiple == 0
        )


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Fan-in truncated normal, as Flax's default ``lecun_normal``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class Conv3BiasReLU(nn.Module):
    """One valid 3x3x3 conv (dilation ``dilation``) + bias + ReLU (no ReLU
    with ``relu=False``): K1, through :class:`~flypylib_tpu_torch.ops.conv.
    Conv3dBiasReLU`, so that it has a gradient (with or without grad
    enabled, the same kernel)."""

    def __init__(self, in_features: int, features: int, dilation: int,
                 relu: bool = True):
        super().__init__()
        self.dilation = int(dilation)
        self.relu = bool(relu)
        self.weight = nn.Parameter(torch.empty(3, 3, 3, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return Conv3dBiasReLU.apply(x, self.weight, self.bias, self.dilation,
                                    self.relu)


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over the channel (last) axis, as the
    reference's ``ConvStack`` uses it (``epsilon=1e-5``, ``momentum=0.99``,
    f32 ``scale``/``bias`` parameters and ``mean``/``var`` buffers).

    Train mode normalises with the batch's statistics, reduced in f32
    whatever the input dtype, by the fast variance ``max(E[x^2] - E[x]^2,
    0)``, and updates the buffers with the biased batch variance:
    ``r = momentum * r + (1 - momentum) * batch`` (``F.batch_norm`` would
    use the unbiased one).  Eval mode normalises with the buffers.  Both
    compute ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32 and
    round to the input dtype once.

    ``reduce`` (None: the local batch) takes a (3, C) f32 tensor of
    per-channel ``[sum, sum of squares, count]`` and returns it summed over
    a data-parallel world (``parallel/train.py`` sets it for a step), so
    train mode normalises with the global batch's moments."""

    reduce = None

    def __init__(self, features: int, epsilon: float = 1e-5,
                 momentum: float = 0.99):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            if self.reduce is None:
                mean = xf.mean(axes)
                var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            else:
                n = xf.new_full((xf.shape[-1],), xf.numel() // xf.shape[-1])
                s = self.reduce(torch.stack([xf.sum(axes), (xf * xf).sum(axes),
                                             n]))
                mean = s[0] / s[2]
                var = torch.clamp(s[1] / s[2] - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)

    def affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Eval mode as a per-channel f32 ``(scale, shift)``: the
        reference packed engine's ``_affine`` (``rsqrt(var + 1e-5)``)."""
        scale = self.scale.float() * torch.rsqrt(self.var.float() + self.epsilon)
        return scale, self.bias.float() - self.mean.float() * scale


class Pointwise(nn.Module):
    """1x1x1 conv as a matmul over the channel axis, computed in ``dtype``
    (in f32 with TF32 off)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if dtype == torch.float32:
            return matmul_f32(x, self.weight) + self.bias.float()
        return (torch.matmul(x.to(dtype), self.weight.to(dtype))
                + self.bias.to(dtype))


class ConvTranspose2(nn.Module):
    """Kernel-2 stride-2 ConvTranspose in ``dtype``, with Flax's
    orientation ``out[2r+p] = x[r] @ K[1-p]``: one matmul against the
    parity-packed kernel, summed in f32 and rounded to ``dtype`` once, plus
    the ``dtype`` bias, then unpacked."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(2, 2, 2, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        k = convT_packed_weight(self.weight.to(dtype))
        y = matmul_f32(x.to(dtype), k).to(dtype) + self.bias.to(dtype).repeat(8)
        return unpack_volume(y)


class ConvStack(nn.Module):
    """Plain valid-conv stack with a dilation schedule.

    context = sum(dilations) (3^3 kernels).  Input (B, D, H, W, 1) of any
    dtype is cast to ``dtype`` as it is, without normalisation (uint8 gives
    raw 0-255 values, as ``ConvStack.__call__`` in the reference).  With
    ``use_batchnorm`` each body layer is conv + bias (K1 with
    ``relu=False``), :class:`BatchNorm` (``norms[i]``), then ReLU; the
    module's train/eval mode is BatchNorm's, and it is built in eval mode
    (the reference's ``apply`` defaults to ``train=False``)."""

    def __init__(
        self,
        features: Sequence[int] = (24, 32, 48, 64),
        dilations: Sequence[int] = (1, 1, 2, 2),
        head_features: int = 96,
        dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
        use_batchnorm: bool = False,
    ):
        super().__init__()
        if len(features) != len(dilations):
            raise ValueError("features and dilations differ in length")
        self.dtype = dtype
        self.use_batchnorm = bool(use_batchnorm)
        ins = (1, *features[:-1])
        self.convs = nn.ModuleList(
            Conv3BiasReLU(ci, co, d, relu=not use_batchnorm)
            for ci, co, d in zip(ins, features, dilations)
        )
        self.norms = nn.ModuleList(
            BatchNorm(co) for co in (features if use_batchnorm else ()))
        self.train(False)
        self.head = Pointwise(features[-1], head_features)
        self.logits = Pointwise(head_features, 1)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Flax's defaults: lecun_normal kernels in layer order, zero biases."""
        for conv in self.convs:
            lecun_normal_(conv.weight, 27 * conv.weight.shape[3], generator)
            conv.bias.zero_()
        for pw in (self.head, self.logits):
            lecun_normal_(pw.weight, pw.weight.shape[0], generator)
            pw.bias.zero_()
        for norm in self.norms:  # Flax's: scale 1, bias 0, mean 0, var 1
            norm.scale.fill_(1.0)
            norm.bias.zero_()
            norm.mean.zero_()
            norm.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if self.use_batchnorm:
                x = torch.relu(self.norms[i](x))
        x = torch.relu(self.head(x, self.dtype))
        return self.logits(x, torch.float32)


class WindowMax(torch.autograd.Function):
    """Max over the window axis (-2) of (..., 8, C), in window order (z, y,
    x row-major), whose gradient goes whole to the FIRST maximum in that
    order: the gradient of Flax's ``nn.max_pool`` (``reduce_window`` max,
    whose transpose is ``select_and_scatter_add``).  ``amax``'s gradient
    splits a tie evenly instead (as ``jnp.max``'s).  ReLU zeros tie often,
    harmlessly (ReLU'(0) = 0); a positive tie is where the two differ."""

    @staticmethod
    def forward(ctx, x):
        m = x.amax(dim=-2)
        ctx.save_for_backward(x, m)
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        hit = x == m.unsqueeze(-2)
        first = hit & (hit.cumsum(dim=-2) == 1)
        return g.unsqueeze(-2) * first


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2^3 max-pool with stride 2 over NDHWC, flooring odd extents (Flax's
    ``nn.max_pool`` with VALID padding, its tie gradient included: with
    grad enabled the windows are gathered for :class:`WindowMax`)."""
    b, d, h, w, c = x.shape
    x = x[:, : d - d % 2, : h - h % 2, : w - w % 2]
    x = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
    if not torch.is_grad_enabled():
        return x.amax(dim=(2, 4, 6))
    win = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, d // 2, h // 2, w // 2,
                                                    8, c)
    return WindowMax.apply(win)


class UNetValid(nn.Module):
    """3D U-Net with VALID convolutions and crop-and-concat skips (the
    reference's ``UNetValid``).

    Every conv is valid and each skip is center-cropped to the upsampled
    decoder size, so the output is an exact center crop of the input and
    tiled inference stays bitwise exact.  Input sizes must satisfy a
    divisibility constraint (see :func:`unet`).

    Parameters follow Flax's creation order: ``convs[i]`` is ``Conv_i``
    (encoder, bottleneck, decoder), ``convts[j]`` is ``ConvTranspose_j``
    (deepest first) and ``logits`` is the last ``Conv``."""

    def __init__(
        self,
        base_features: int = 24,
        levels: int = 2,
        convs_per_stage: int = 2,
        dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.base_features = base_features
        self.levels = levels
        self.convs_per_stage = convs_per_stage
        self.dtype = dtype
        convs, convts = [], []
        ci, f = 1, base_features
        for _ in range(levels + 1):  # the encoder levels, then the bottleneck
            for _ in range(convs_per_stage):
                convs.append(Conv3BiasReLU(ci, f, 1))
                ci = f
            f *= 2
        f //= 2
        for _ in range(levels):
            f //= 2
            convts.append(ConvTranspose2(ci, f))
            ci = 2 * f  # [skip, up]
            for _ in range(convs_per_stage):
                convs.append(Conv3BiasReLU(ci, f, 1))
                ci = f
        self.convs = nn.ModuleList(convs)
        self.convts = nn.ModuleList(convts)
        self.logits = Pointwise(ci, 1)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Flax's defaults: lecun_normal kernels, zero biases."""
        for conv in self.convs:
            lecun_normal_(conv.weight, 27 * conv.weight.shape[3], generator)
            conv.bias.zero_()
        for up in self.convts:
            lecun_normal_(up.weight, 8 * up.weight.shape[3], generator)
            up.bias.zero_()
        lecun_normal_(self.logits.weight, self.logits.weight.shape[0], generator)
        self.logits.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        cps = self.convs_per_stage
        convs = iter(self.convs)
        skips = []
        for _ in range(self.levels):
            for _ in range(cps):
                x = next(convs)(x)
            skips.append(x)
            x = _max_pool2(x)
        for _ in range(cps):
            x = next(convs)(x)
        for up, skip in zip(self.convts, reversed(skips)):
            x = up(x, self.dtype)
            c = [(skip.shape[i] - x.shape[i]) // 2 for i in (1, 2, 3)]
            skip_c = skip[:, c[0]: c[0] + x.shape[1], c[1]: c[1] + x.shape[2],
                          c[2]: c[2] + x.shape[3]]
            x = torch.cat([skip_c, x], dim=-1)
            for _ in range(cps):
                x = next(convs)(x)
        return self.logits(x, torch.float32)


def params_from_flax(variables) -> dict[str, torch.Tensor]:
    """The JAX package's variables as the port's state dict: a ``ConvStack``
    tree (``Conv_0..Conv_{n+1}``, and ``BatchNorm_0..`` with a
    ``batch_stats`` collection for a BatchNorm stack) or a ``UNetValid``
    tree (``Conv_0..Conv_n`` and ``ConvTranspose_0..``), with DHWIO
    ``kernel`` and ``bias``, as numpy or jax arrays, with or without the
    ``{"params": ...}`` wrapper."""
    params = variables.get("params", variables)
    stats = variables.get("batch_stats", {}) if "params" in variables else {}

    def numbered(prefix):
        return sorted((k for k in params if k.startswith(prefix + "_")),
                      key=lambda k: int(k.split("_")[-1]))

    names, ups = numbered("Conv"), numbered("ConvTranspose")
    bns = numbered("BatchNorm")
    if len(names) < 3:
        raise ValueError(f"expected Conv_0..Conv_n (n >= 2), got {names}")

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def pointwise(prefix, name):
        k = np.asarray(params[name]["kernel"])
        return {f"{prefix}.weight": t(k.reshape(k.shape[-2], k.shape[-1])),
                f"{prefix}.bias": t(params[name]["bias"])}

    sd = {}
    if ups:  # UNetValid: every Conv but the last is a 3^3 conv
        body, tail = names[:-1], [("logits", names[-1])]
        for j, name in enumerate(ups):
            sd[f"convts.{j}.weight"] = t(params[name]["kernel"])
            sd[f"convts.{j}.bias"] = t(params[name]["bias"])
    else:
        body, tail = names[:-2], [("head", names[-2]), ("logits", names[-1])]
    for i, name in enumerate(body):
        sd[f"convs.{i}.weight"] = t(params[name]["kernel"])
        sd[f"convs.{i}.bias"] = t(params[name]["bias"])
    for prefix, name in tail:
        sd.update(pointwise(prefix, name))
    if bns and len(bns) != len(body):
        raise ValueError(f"{len(bns)} BatchNorm layers for {len(body)} convs")
    for i, name in enumerate(bns):
        if name not in stats:
            raise ValueError(f"{name}: no batch_stats")
        sd[f"norms.{i}.scale"] = t(params[name]["scale"])
        sd[f"norms.{i}.bias"] = t(params[name]["bias"])
        sd[f"norms.{i}.mean"] = t(stats[name]["mean"])
        sd[f"norms.{i}.var"] = t(stats[name]["var"])
    return sd


def flax_from_params(state_dict) -> dict[str, dict]:
    """Inverse of :func:`params_from_flax`: a ``ConvStack`` or ``UNetValid``
    state dict as the JAX package's variables, ``{"params": {...},
    "batch_stats": {...}}`` of f32 numpy arrays (``batch_stats`` empty
    without BatchNorm)."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}

    def count(prefix):
        return len({k.split(".")[1] for k in sd if k.startswith(prefix + ".")})

    n_convs = count("convs")
    params, stats = {}, {}
    for i in range(n_convs):
        params[f"Conv_{i}"] = {"kernel": sd[f"convs.{i}.weight"],
                               "bias": sd[f"convs.{i}.bias"]}
    for j in range(count("convts")):
        params[f"ConvTranspose_{j}"] = {"kernel": sd[f"convts.{j}.weight"],
                                        "bias": sd[f"convts.{j}.bias"]}
    tail = ["head", "logits"] if "head.weight" in sd else ["logits"]
    for k, prefix in enumerate(tail):
        w = sd[f"{prefix}.weight"]
        params[f"Conv_{n_convs + k}"] = {"kernel": w.reshape(1, 1, 1, *w.shape),
                                         "bias": sd[f"{prefix}.bias"]}
    for i in range(count("norms")):
        params[f"BatchNorm_{i}"] = {"scale": sd[f"norms.{i}.scale"],
                                    "bias": sd[f"norms.{i}.bias"]}
        stats[f"BatchNorm_{i}"] = {"mean": sd[f"norms.{i}.mean"],
                                   "var": sd[f"norms.{i}.var"]}
    return {"params": params, "batch_stats": stats}


def _probe_geometry(out_size: Callable[[int], int | None], lo: int = 8,
                   hi: int = 120) -> tuple[int, int, int, int]:
    """``(context, size_multiple, size_offset, min_size)`` from the output
    extent ``out_size(s)`` of each input extent ``s`` in ``[lo, hi)`` (None
    where the model refuses ``s``): the reference's ``_probe_geometry``,
    fed by a shape walk instead of ``jax.eval_shape``."""
    valid = []
    for s in range(lo, hi):
        o = out_size(s)
        if o is not None and o > 0 and (s - o) % 2 == 0:
            valid.append((s, o))
    if not valid:
        raise ValueError("no valid input size found while probing model geometry")
    # keep only sizes realizing the minimal (true) context: odd sizes through
    # floor-pooling can lose extra voxels
    ctx = min((s - o) // 2 for s, o in valid)
    sizes = [s for s, o in valid if (s - o) // 2 == ctx]
    mult = 1 if len(sizes) < 2 else int(np.gcd.reduce(np.diff(sizes)))
    return ctx, mult, sizes[0] % mult if mult > 1 else 0, sizes[0]


def _unet_out_size(s: int, levels: int, convs_per_stage: int) -> int | None:
    """Output extent of ``UNetValid`` for input extent ``s``, or None where
    the module fails (a size reaches 0, or a skip is smaller than the
    upsampled tensor it is cropped to)."""
    skips = []
    for _ in range(levels):
        s -= 2 * convs_per_stage
        if s <= 0:
            return None
        skips.append(s)
        s //= 2
    s -= 2 * convs_per_stage
    if s <= 0:
        return None
    for skip in reversed(skips):
        s *= 2
        if skip < s:
            return None
        s -= 2 * convs_per_stage
        if s <= 0:
            return None
    return s


@functools.cache
def _unet_geometry(levels: int, convs_per_stage: int):
    return _probe_geometry(lambda s: _unet_out_size(s, levels, convs_per_stage))


def _conv_stack_spec(name, features, dilations, head_features, dtype, seed):
    module = ConvStack(
        features=tuple(features),
        dilations=tuple(dilations),
        head_features=head_features,
        dtype=dtype,
        generator=torch.Generator().manual_seed(int(seed)),
    )
    ctx = sum(dilations)
    return ModelSpec(
        name=name,
        module=module,
        context=ctx,
        min_size=2 * ctx + 1,
        metadata={"features": tuple(features), "dilations": tuple(dilations)},
    )


def baseline_model(
    features=(24, 32, 48, 64),
    dilations=(1, 1, 2, 2),
    head_features: int = 96,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> ModelSpec:
    """Baseline voxel-wise 3D CNN (parity: flypylib fplmodels baseline).

    context = sum(dilations); receptive field = 2*context + 1 (13 voxels by
    default).  Weights are drawn from ``torch.Generator().manual_seed(seed)``.
    """
    return _conv_stack_spec("baseline", features, dilations, head_features,
                            dtype, seed)


def vgg_like(
    features=(32, 32, 48, 48, 64, 64, 96),
    dilations=(1, 1, 1, 2, 2, 4, 4),
    head_features: int = 128,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> ModelSpec:
    """Deeper VGG-style valid-conv stack (parity: flypylib fplmodels
    vgg-like variant).  Default receptive field = 31 voxels (context 15)."""
    return _conv_stack_spec("vgg_like", features, dilations, head_features,
                            dtype, seed)


def unet(base_features: int = 24, levels: int = 2, convs_per_stage: int = 2,
         dtype: torch.dtype = torch.bfloat16, seed: int = 0) -> ModelSpec:
    """Valid-conv 3D U-Net (parity: flypylib fplmodels U-Net variant, eval
    config 4).  Weights are drawn from ``torch.Generator().manual_seed(seed)``."""
    module = UNetValid(
        base_features=base_features,
        levels=levels,
        convs_per_stage=convs_per_stage,
        dtype=dtype,
        generator=torch.Generator().manual_seed(int(seed)),
    )
    ctx, mult, off, min_size = _unet_geometry(levels, convs_per_stage)
    return ModelSpec(
        name="unet",
        module=module,
        context=ctx,
        size_multiple=mult,
        size_offset=off,
        min_size=min_size,
        metadata={
            "base_features": base_features,
            "levels": levels,
            "convs_per_stage": convs_per_stage,
        },
    )


MODEL_ZOO: dict[str, Callable[..., ModelSpec]] = {
    "baseline": baseline_model,
    "vgg_like": vgg_like,
    "unet": unet,
}
