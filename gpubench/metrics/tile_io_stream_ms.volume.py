"""Tile gather and scatter around the module calls: stream time of the port's ``forward.gather`` (slab, stack, uint8 scaling) and ``forward.scatter`` (sigmoid, writes into the map) spans (``infer/pipeline.py::DetectPipeline.forward_slabs``), mean ms a call over the profiled stretch."""

from gpubench.portspans import per_root_ms


def read(obs):
    return per_root_ms(obs, "detect", ("forward.gather", "forward.scatter"))
