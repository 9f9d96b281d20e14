"""3D CNN model zoo for voxel-wise synapse detection, in PyTorch.

Counterpart of ``flypylib_tpu/models/zoo.py`` for the plain valid-conv
stacks: the baseline and the deeper VGG-like variant.  Each zoo entry
returns a ``ModelSpec`` carrying the module and its receptive-field
``context`` (voxels lost per face to valid convolution), which drives the
tiling math.

Layout and numerics follow the reference: activations are NDHWC, conv
weights DHWIO ``(3, 3, 3, Ci, Co)``, compute in ``dtype`` (bf16 by default),
logits in f32.  The body layers run ``ops.conv.conv3d_bias_relu`` (K1);
the 1x1x1 head and logits are matmuls over the channel axis, which the
reference also leaves outside any Pallas kernel.

Models return logits; apply ``torch.sigmoid`` for probabilities.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from flypylib_tpu_torch.ops.conv import conv3d_bias_relu

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
    """One valid 3x3x3 conv (dilation ``dilation``) + bias + ReLU: K1."""

    def __init__(self, in_features: int, features: int, dilation: int):
        super().__init__()
        self.dilation = int(dilation)
        self.weight = nn.Parameter(torch.empty(3, 3, 3, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d_bias_relu(x, self.weight, self.bias, self.dilation)


class Pointwise(nn.Module):
    """1x1x1 conv as a matmul over the channel axis, computed in ``dtype``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return (torch.matmul(x.to(dtype), self.weight.to(dtype))
                + self.bias.to(dtype))


class ConvStack(nn.Module):
    """Plain valid-conv stack with a dilation schedule.

    context = sum(dilations) (3^3 kernels).  Input (B, D, H, W, 1) of any
    dtype is cast to ``dtype`` as it is, without normalisation (uint8 gives
    raw 0-255 values, as ``ConvStack.__call__`` in the reference)."""

    def __init__(
        self,
        features: Sequence[int] = (24, 32, 48, 64),
        dilations: Sequence[int] = (1, 1, 2, 2),
        head_features: int = 96,
        dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if len(features) != len(dilations):
            raise ValueError("features and dilations differ in length")
        self.dtype = dtype
        ins = (1, *features[:-1])
        self.convs = nn.ModuleList(
            Conv3BiasReLU(ci, co, d)
            for ci, co, d in zip(ins, features, dilations)
        )
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for conv in self.convs:
            x = conv(x)
        x = torch.relu(self.head(x, self.dtype))
        return self.logits(x, torch.float32)


def params_from_flax(variables) -> dict[str, torch.Tensor]:
    """The JAX package's ``ConvStack`` params (``Conv_0..Conv_{n+1}`` with
    DHWIO ``kernel`` and ``bias``, as numpy or jax arrays, with or without
    the ``{"params": ...}`` wrapper) as a ``ConvStack`` state dict."""
    params = variables.get("params", variables)
    names = sorted((k for k in params if k.startswith("Conv_")),
                   key=lambda k: int(k.split("_")[1]))
    if len(names) < 3:
        raise ValueError(f"expected Conv_0..Conv_n (n >= 2), got {names}")

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {}
    body, head, logits = names[:-2], names[-2], names[-1]
    for i, name in enumerate(body):
        sd[f"convs.{i}.weight"] = t(params[name]["kernel"])
        sd[f"convs.{i}.bias"] = t(params[name]["bias"])
    for prefix, name in (("head", head), ("logits", logits)):
        k = np.asarray(params[name]["kernel"])
        sd[f"{prefix}.weight"] = t(k.reshape(k.shape[-2], k.shape[-1]))
        sd[f"{prefix}.bias"] = t(params[name]["bias"])
    return sd


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


MODEL_ZOO: dict[str, Callable[..., ModelSpec]] = {
    "baseline": baseline_model,
    "vgg_like": vgg_like,
}
