"""Host-to-device bytes: the port's ``h2d_bytes`` counter (``infer/large.py::_upload``, the staging uploads), in MB (1e6 bytes) a call over the profiled stretch."""

from gpubench.portspans import per_root_count


def read(obs):
    v = per_root_count(obs, "detect", "h2d_bytes")
    return None if v is None else v / 1e6
