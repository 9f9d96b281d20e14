"""U-Net logits (the f32 logits and the unpack): stream time of the port's ``unet.logits`` spans (``ops/packed_unet.py::PackedUNet._forward``, one a tile batch), summed a call, mean ms a call over the profiled stretch."""

from gpubench.portspans import per_root_ms


def read(obs):
    return per_root_ms(obs, "detect", ("unet.logits",))
