"""Whole step's share of the card's bf16 peak: the model operations of the
calls in the profiled stretch (counted from the configuration's widths) over
the stretch's time, against 989 TFLOP/s."""

from gpubench.counts import PEAK_BF16_FLOPS


def read(obs):
    w = obs.work
    return 100.0 * w["calls"] * w["flops"] / obs.profile["window_s"] / PEAK_BF16_FLOPS
