"""The tiles' halo: the input voxels the forward's tile batches read over the output voxels their distinct tiles keep, the port's counters ``tile_in_voxels`` / ``tile_out_voxels`` (``infer/pipeline.py::DetectPipeline.forward_slabs``), each summed a call, over the profiled stretch."""

from gpubench.portspans import per_root_count


def read(obs):
    tin = per_root_count(obs, "detect", "tile_in_voxels")
    tout = per_root_count(obs, "detect", "tile_out_voxels")
    return None if not tin or not tout else tin / tout
