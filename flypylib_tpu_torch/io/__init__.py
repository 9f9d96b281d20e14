from flypylib_tpu_torch.io.hdf5 import read_h5, write_h5
from flypylib_tpu_torch.io.synapses import (
    Tbars,
    load_from_json,
    save_to_json,
    tbars_to_volume,
    make_training_volumes,
)
from flypylib_tpu_torch.io.dvid import DVIDClient

__all__ = [
    "read_h5",
    "write_h5",
    "Tbars",
    "load_from_json",
    "save_to_json",
    "tbars_to_volume",
    "make_training_volumes",
    "DVIDClient",
]
