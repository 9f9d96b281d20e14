"""Host merge, sort and CC: host time of the port's ``box.merge`` (``infer/large.py::_StreamPlan._collect``) and ``detect.finalize`` (``_finalize``) spans, mean ms a call over the profiled stretch."""

from gpubench.portspans import per_root_ms


def read(obs):
    return per_root_ms(obs, "detect", ("box.merge", "detect.finalize"), "host_ms")
