"""U-Net bottleneck (the bottleneck's packed convs and the unpack to the dense deepest lattice): stream time of the port's ``unet.bottleneck`` spans (``ops/packed_unet.py::PackedUNet._forward``, one a tile batch), summed a call, mean ms a call over the profiled stretch."""

from gpubench.portspans import per_root_ms


def read(obs):
    return per_root_ms(obs, "detect", ("unet.bottleneck",))
