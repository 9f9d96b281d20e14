"""Device-to-host bytes: the port's ``d2h_bytes`` counter (``infer/pipeline.py::to_host``), in MB (1e6 bytes) a call over the profiled stretch."""

from gpubench.portspans import per_root_count


def read(obs):
    v = per_root_count(obs, "detect", "d2h_bytes")
    return None if v is None else v / 1e6
