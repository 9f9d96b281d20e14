from flypylib_tpu_torch.utils.core import (
    to3d,
    ceil_div,
    round_up,
    block_starts,
    pad_to_multiple,
    crop_center,
)

__all__ = [
    "to3d",
    "ceil_div",
    "round_up",
    "block_starts",
    "pad_to_multiple",
    "crop_center",
]
