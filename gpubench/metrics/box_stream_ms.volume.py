"""Box postprocess on the card (max filter, compaction, the f64 concat): stream time of the port's ``box.filter`` spans (``infer/large.py::_StreamPlan._box``), summed a call, mean ms a call over the profiled stretch."""

from gpubench.portspans import per_root_ms


def read(obs):
    return per_root_ms(obs, "detect", ("box.filter",))
