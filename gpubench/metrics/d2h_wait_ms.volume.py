"""Device-to-host copies: host time of the port's ``box.copy`` spans (``infer/pipeline.py::to_host``), the host waiting on the card, summed a call, mean ms a call over the profiled stretch."""

from gpubench.portspans import per_root_ms


def read(obs):
    return per_root_ms(obs, "detect", ("box.copy",), "host_ms")
