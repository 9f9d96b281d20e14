from flypylib_tpu_torch.io.synapses import (
    Tbars,
    load_from_json,
    save_to_json,
    tbars_to_volume,
    make_training_volumes,
)

__all__ = [
    "Tbars",
    "load_from_json",
    "save_to_json",
    "tbars_to_volume",
    "make_training_volumes",
]
