"""Device meshes: an n-d array of device slots with named axes.

Counterpart of ``flypylib_tpu/parallel/mesh.py`` (``jax.sharding.Mesh``):

- a ``data`` axis carries batch-sharded training (``parallel/train.py``),
- ``space`` axes carry volume-sharded halo inference, NMS and CC
  (``parallel/halo.py``).

Each slot is a ``(rank, torch.device)`` pair.  By default a mesh uses the
process's CUDA devices (under a ``torch.distributed`` world, its own
``cuda:LOCAL_RANK``) and spans ``world_size`` times those local slots, rank
by rank; it never falls back to the CPU unless ``devices=`` names it.
``devices=`` may repeat a device: ``["cpu"] * 8`` is a virtual 8-slot mesh
on the CPU, ``["cuda:0"] * 4`` a 4-slot mesh on one card.  Whatever runs on
a mesh copies a module or a tensor once per distinct device
(:func:`per_device`), never once per slot.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch

from flypylib_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class Slot:
    """One mesh position: the rank that owns it and its device there."""

    rank: int
    device: torch.device


class Mesh:
    """Slots in an n-d array with one name per axis; ``shape`` maps each
    name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, slots, axis_names):
        self.slots = slots
        self.axis_names = tuple(axis_names)
        if slots.ndim != len(self.axis_names):
            raise ValueError(f"{slots.ndim}-d slots with axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.slots.shape))

    def local(self) -> list[tuple[tuple, Slot]]:
        """``[(mesh index, slot)]`` of this process's slots, in mesh order."""
        me = distributed.rank()
        return [(i, s) for i, s in np.ndenumerate(self.slots) if s.rank == me]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def as_device(d) -> torch.device:
    """``d`` as a ``torch.device``, a bare ``"cuda"`` as the current card
    (so that equal devices compare equal)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _local_devices(devices) -> list[torch.device]:
    if devices is None:
        if distributed.world_size() > 1 or not torch.cuda.is_available():
            # one card a rank; without a card this raises, naming devices=
            return [distributed.local_device()]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devs = [as_device(d) for d in devices]
    if not devs:
        raise ValueError("devices= names no device")
    return devs


def _world_slots(n: int | None, devices) -> list[Slot]:
    """The first ``n`` slots of the world (all without ``n``), rank by rank:
    every rank contributes ``n / world_size`` of its local slots."""
    local = _local_devices(devices)
    world = distributed.world_size()
    per_rank = distributed.all_gather_objects([str(d) for d in local])
    if len({len(p) for p in per_rank}) != 1:
        raise ValueError(f"ranks hold different slot counts: "
                         f"{[len(p) for p in per_rank]}")
    take = len(local)
    if n is not None:
        if n % world or n // world > len(local):
            raise ValueError(f"{n} slots over {world} processes of "
                             f"{len(local)} local slots each")
        take = n // world
    return [Slot(r, torch.device(d)) for r, devs in enumerate(per_rank)
            for d in devs[:take]]


def _mesh(slots: list[Slot], shape, axes) -> Mesh:
    arr = np.empty(len(slots), dtype=object)
    arr[:] = slots
    return Mesh(arr.reshape(shape), axes)


def make_mesh(n_devices: int | None = None, axis: str = "data",
              devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` slots (all by default)."""
    slots = _world_slots(n_devices, devices)
    return _mesh(slots, (len(slots),), (axis,))


def make_mesh_2d(shape: tuple[int, int], axes=("data", "space"),
                 devices=None) -> Mesh:
    return _mesh(_world_slots(int(np.prod(shape)), devices), shape, axes)


def make_mesh_3d(shape: tuple[int, int, int],
                 axes=("spacez", "spacey", "spacex"), devices=None) -> Mesh:
    return _mesh(_world_slots(int(np.prod(shape)), devices), shape, axes)


@dataclass(frozen=True)
class Placement:
    """Where a tensor lives on a mesh (``NamedSharding``'s role): whole on
    every slot (``axes == ()``) or split along its first dim over the named
    mesh axis."""

    mesh: Mesh
    axes: tuple = ()

    @property
    def is_fully_replicated(self) -> bool:
        return not self.axes

    def place(self, x: torch.Tensor) -> dict[tuple, torch.Tensor]:
        """``{mesh index: part}`` for this process's slots, each part on its
        slot's device (one copy per distinct device for a replicated
        tensor)."""
        if self.is_fully_replicated:
            copies = per_device(x, [s.device for _, s in self.mesh.local()])
            return {i: copies[s.device] for i, s in self.mesh.local()}
        (axis,) = self.axes
        k = self.mesh.axis_names.index(axis)
        n = self.mesh.shape[axis]
        if x.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                             f"{n} slots of axis {axis!r}")
        step = x.shape[0] // n
        return {i: x[i[k] * step:(i[k] + 1) * step].to(s.device)
                for i, s in self.mesh.local()}


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh)


def batch_sharded(mesh: Mesh, axis: str = "data") -> Placement:
    return Placement(mesh, (axis,))


def per_device(obj, devices) -> dict:
    """``{device: obj there}`` for each distinct device of ``devices``: a
    tensor's ``.to(device)`` or a module's deep copy moved there; ``obj``
    itself where it already lives."""
    out = {}
    for dev in dict.fromkeys(as_device(d) for d in devices):
        if isinstance(obj, torch.nn.Module):
            here = next(obj.parameters()).device
            out[dev] = obj if here == dev else copy.deepcopy(obj).to(dev)
        else:
            out[dev] = obj.to(dev)
    return out
