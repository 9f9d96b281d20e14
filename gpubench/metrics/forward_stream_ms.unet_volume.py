"""Model forward, the whole sweep: stream time of the port's ``detect.forward`` spans (``infer/large.py::_StreamPlan.shared_prob``, or each ROI's forward), mean ms a call over the profiled stretch."""

from gpubench.portspans import per_root_ms


def read(obs):
    return per_root_ms(obs, "detect", ("detect.forward",))
