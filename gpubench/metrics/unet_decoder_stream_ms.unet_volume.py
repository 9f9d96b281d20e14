"""U-Net decoder (each decoder level's skip crop, ConvTranspose fold and packed convs): stream time of the port's ``unet.decoder`` spans (``ops/packed_unet.py::PackedUNet._forward``, one a tile batch), summed a call, mean ms a call over the profiled stretch."""

from gpubench.portspans import per_root_ms


def read(obs):
    return per_root_ms(obs, "detect", ("unet.decoder",))
