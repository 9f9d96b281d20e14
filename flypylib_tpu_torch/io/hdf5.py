"""HDF5 volume I/O.

Counterpart of ``flypylib_tpu/io/hdf5.py``, copied; h5py is imported inside
the two functions, so the module imports where h5py is missing.  flypylib
reads/writes FIB-SEM grayscale cutouts and label/mask volumes as HDF5
datasets via h5py.  Volumes are (z, y, x) arrays; grayscale is uint8,
probability maps float32.
"""

from __future__ import annotations

import numpy as np

DEFAULT_DATASET = "main"


def read_h5(path: str, dataset: str | None = None, roi=None) -> np.ndarray:
    """Read a (z, y, x) volume from an HDF5 file.

    ``roi`` is an optional tuple of slices (or ``(start, stop)`` pairs) for a
    chunked partial read so 1k^3+ volumes never need to fit host RAM twice.
    """
    import h5py

    with h5py.File(path, "r") as f:
        if dataset is None:
            dataset = DEFAULT_DATASET if DEFAULT_DATASET in f else next(iter(f))
        ds = f[dataset]
        if roi is None:
            return ds[()]
        sl = tuple(
            s if isinstance(s, slice) else slice(int(s[0]), int(s[1])) for s in roi
        )
        return ds[sl]


def write_h5(
    path: str,
    vol: np.ndarray,
    dataset: str = DEFAULT_DATASET,
    compression: str | None = "gzip",
    chunks=None,
) -> None:
    """Write a volume to HDF5, chunked for partial-read streaming."""
    import h5py

    vol = np.asarray(vol)
    if chunks is None and vol.ndim == 3:
        chunks = tuple(min(64, s) for s in vol.shape)
    with h5py.File(path, "w") as f:
        f.create_dataset(
            dataset, data=vol, compression=compression, chunks=chunks
        )
