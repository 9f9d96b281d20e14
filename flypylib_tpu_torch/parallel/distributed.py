"""Multi-process bring-up and the collectives the parallel layer uses.

Counterpart of ``flypylib_tpu/parallel/distributed.py``.  Every process runs
the same program; :func:`ensure_initialized` joins them into one
``torch.distributed`` world (``tcp://`` rendezvous), after which a mesh
(``parallel/mesh.py``) spans ``world_size`` times each process's local slots
and the halo exchange, the data-parallel step and the list merges of this
package reach across processes.  A single process is a no-op, so library
code may call it unconditionally.

The arguments default from torchrun's variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).  The reference's
Cloud-TPU topology variables (``TPU_WORKER_HOSTNAMES``, ``MEGASCALE_*``) are
TPU plumbing and are not read.

Backends: NCCL for processes that compute on CUDA, gloo for CPU processes,
or what ``backend=`` names (two processes sharing one card must name gloo:
NCCL refuses two ranks on one GPU).  gloo's point-to-point and collectives
take host tensors here, so on gloo every transfer of a CUDA tensor goes
through the host; that is chosen by the backend, not as a fallback.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger("flypylib_tpu_torch")


def ensure_initialized(coordinator_address: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None,
                       backend: str | None = None) -> bool:
    """Join this process to a ``torch.distributed`` world when running
    multi-process; a no-op otherwise.  Returns True when a world is active.

    ``coordinator_address`` is ``host:port`` (default ``MASTER_ADDR:
    MASTER_PORT``), ``num_processes`` the world size (default
    ``WORLD_SIZE``), ``process_id`` this rank (default ``RANK``).  Any
    explicit argument, or ``WORLD_SIZE > 1``, initializes (a world of one
    included, when asked for explicitly).  A CUDA rank's device is set to
    ``cuda:LOCAL_RANK`` (default: the rank modulo the visible cards)."""
    if dist.is_initialized():
        return True
    env = os.environ
    multi = (coordinator_address is not None or num_processes is not None
             or process_id is not None or int(env.get("WORLD_SIZE", "1")) > 1)
    if not multi:
        return False
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    world = int(env.get("WORLD_SIZE", "1") if num_processes is None
                else num_processes)
    rank = int(env.get("RANK", "0") if process_id is None else process_id)
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    logger.info("torch.distributed initialized: rank %d/%d, backend %s",
                rank, world, backend)
    return True


def world_size() -> int:
    """Processes in the world (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a world)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_device() -> torch.device:
    """This process's default compute device: its CUDA device (``cuda:
    LOCAL_RANK`` under a world, set by :func:`ensure_initialized`)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices=['cpu'] * n for a "
                           "mesh of CPU slots")
    return torch.device("cuda", torch.cuda.current_device())


def local_batch_size(global_batch: int) -> int:
    """Per-process batch for a globally sharded batch axis."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} "
                         "processes")
    return global_batch // n


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every rank (a new tensor on ``t``'s device; ``t``
    itself without a world).  Every rank receives the same bits."""
    if not dist.is_initialized():
        return t
    if t.is_cuda and dist.get_backend() == "gloo":
        h = t.detach().cpu()
        dist.all_reduce(h)
        return h.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


class SumOverRanks(torch.autograd.Function):
    """Differentiable sum over ranks: forward all-reduces the value, backward
    all-reduces the gradient (each rank's output is the same function of
    every rank's input)."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_sum(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous())


def all_gather_objects(obj) -> list:
    """Every rank's ``obj``, in rank order (``[obj]`` without a world)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def exchange(sends, recvs) -> list[torch.Tensor]:
    """Point-to-point transfers in one batch: ``sends`` ``[(tensor, dst,
    tag)]`` and ``recvs`` ``[(shape, dtype, device, src, tag)]``, the tag
    of each transfer taken from a plan every rank derives alike, so that a
    send and its receive carry the same tag and come in the same order
    between a pair of ranks.  Returns the received tensors on their
    devices.  On gloo the wire tensors are host copies."""
    if not sends and not recvs:
        return []
    gloo = dist.get_backend() == "gloo"
    ops, bufs = [], []
    for t, dst, tag in sends:
        w = t.contiguous()
        if gloo and w.is_cuda:
            w = w.cpu()
        ops.append(dist.P2POp(dist.isend, w, dst, tag=tag))
    for shape, dtype, device, src, tag in recvs:
        dev = torch.device(device)
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if gloo else dev)
        bufs.append((buf, dev))
        ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(dev) for b, dev in bufs]
