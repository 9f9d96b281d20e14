"""Staging (the upload, the reflect pad and the grid's zeros on the card): stream time of the port's ``detect.stage`` spans (``infer/large.py::stage_volume``, ``shared_prob``), mean ms a call over the profiled stretch."""

from gpubench.portspans import per_root_ms


def read(obs):
    return per_root_ms(obs, "detect", ("detect.stage",))
