"""Operations and bytes of the benchmark's work, from the configuration's
widths alone (never from the program's modules), and the card's peaks.

A forward is counted as one monolithic valid forward over the volume: each
layer's multiply-adds at the extent that forward gives it, as its
architecture counts them (``archs/<arch>.py::layer_macs``), two operations a
multiply-add, biases and activations not counted.  So work the program does
twice (tile halos computed again) counts as waste against these bounds.
"""

from __future__ import annotations

from gpubench import archs
from gpubench.reference import context, param_shapes

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def layer_flops(cfg: dict, out: int) -> list[float]:
    """Operations of every layer of a valid forward whose output extent is
    ``out``, the layer that reads the input first."""
    return [2.0 * m for _, m in archs.of(cfg).layer_macs(cfg, out)]


def forward_flops(cfg: dict, out: int) -> float:
    """Operations of a monolithic valid forward with output extent ``out``
    (per volume)."""
    return sum(layer_flops(cfg, out))


def train_flops(cfg: dict, patch: int) -> float:
    """Operations of one training step on one ``patch``-wide patch: each
    layer's forward, its weight gradient and its input gradient (each as
    many operations as the forward), less the first layer's input
    gradient, which nothing needs."""
    layers = layer_flops(cfg, patch - 2 * context(cfg))
    return 3.0 * sum(layers) - layers[0]


def forward_bytes(cfg: dict, out: int, in_itemsize: int = 1) -> float:
    """Bytes a forward must move at least: the padded input read once, the
    f32 probability map written once, the weights read once."""
    s = out + 2 * context(cfg)
    weights = sum(4.0 * (s_[0] * s_[1] * s_[2] * s_[3] * s_[4] + s_[4])
                  for _, s_, _ in param_shapes(cfg))
    return in_itemsize * float(s) ** 3 + 4.0 * float(out) ** 3 + weights


def forward_bound_s(cfg: dict, out: int, in_itemsize: int = 1) -> tuple[float, str]:
    """``(least seconds, what bounds it)`` of a forward on the card."""
    t_ops = forward_flops(cfg, out) / PEAK_BF16_FLOPS
    t_bytes = forward_bytes(cfg, out, in_itemsize) / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
