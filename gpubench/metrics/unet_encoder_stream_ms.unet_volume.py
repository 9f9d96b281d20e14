"""U-Net encoder (the packed convs, pools and repacks of the encoder's levels): stream time of the port's ``unet.encoder`` spans (``ops/packed_unet.py::PackedUNet._forward``, one a tile batch), summed a call, mean ms a call over the profiled stretch."""

from gpubench.portspans import per_root_ms


def read(obs):
    return per_root_ms(obs, "detect", ("unet.encoder",))
