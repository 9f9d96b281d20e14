"""Mesh data-parallel training.

Counterpart of ``flypylib_tpu/parallel/train.py`` (``make_dp_train_step``),
whose step is the single-device one with the patch batch sharded over a
mesh's ``data`` axis and the gradients summed over it.  Here the unit of
data parallelism is the process: each rank forwards its slots' rows of the
batch on its one device (its slots on that device run as one shard: a
rank's slots must share a device, so a multi-card host runs one process per
card, as under ``torchrun``).  Four things keep the pinned property of the
reference, the same seed giving the same parameters as the single-device
step:

(a) one global batch: every rank draws the whole batch from the same
    ``torch.Generator`` on the same device type, then takes its rows;
(b) global loss normalisation: each shard divides its masked BCE sum by the
    mask count summed over the world, and the gradients are summed over the
    ranks (one bucket, ``all_reduce``), not averaged;
(c) global BatchNorm moments: train-mode ``BatchNorm`` sums its per-channel
    sum, sum of squares and count over the world before the fast variance,
    through a differentiable sum (``distributed.SumOverRanks``);
(d) identical Adam updates: every rank steps the same Adam on the same
    summed gradients.

With ``torch.distributed`` initialized the collectives run even in a world
of one (each an identity there); without it the step is the single-device
step on the mesh's rows.
"""

from __future__ import annotations

import contextlib

import torch

from flypylib_tpu_torch.models.zoo import BatchNorm, ModelSpec
from flypylib_tpu_torch.ops.conv import no_tf32
from flypylib_tpu_torch.parallel import distributed
from flypylib_tpu_torch.parallel.mesh import Mesh
from flypylib_tpu_torch.train.trainer import (_PACKED, TrainConfig,
                                              make_loss_fn, resolve_train_spec)


def _global_count(count: torch.Tensor) -> torch.Tensor:
    """(b): the mask count summed over the world."""
    return distributed.all_reduce_sum(count)


def _global_moments(stats: torch.Tensor) -> torch.Tensor:
    """(c): BatchNorm's (3, C) moments summed over the world, with their
    gradient."""
    return distributed.SumOverRanks.apply(stats)


@contextlib.contextmanager
def _moments_over_ranks(module: torch.nn.Module, reduce):
    """Every ``BatchNorm`` of ``module`` reduces its moments with ``reduce``
    for the block."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.reduce = reduce
    try:
        yield
    finally:
        for m in norms:
            m.reduce = None


def _sum_grads(module: torch.nn.Module) -> None:
    """(b): every parameter's gradient summed over the world, in one
    flattened bucket."""
    params = [p for p in module.parameters() if p.grad is not None]
    flat = distributed.all_reduce_sum(
        torch.cat([p.grad.reshape(-1) for p in params]))
    at = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[at:at + n].view_as(p.grad))
        at += n


def rank_rows(mesh: Mesh, data_axis: str, batch: int):
    """``(rows, device)``: this rank's rows of a ``batch``-row global batch
    (its slots' contiguous run of the data axis) and the device they run
    on.  Ranks must hold disjoint runs that cover the axis."""
    n = mesh.shape[data_axis]
    k = mesh.axis_names.index(data_axis)
    local = mesh.local()
    if not local:
        raise ValueError("this process holds no slot of the mesh")
    devices = {s.device for _, s in local}
    if len(devices) > 1:
        raise ValueError(
            f"a rank's slots must share one device, got {sorted(map(str, devices))}"
            ": run one process per card (e.g. under torchrun)")
    coords = sorted({i[k] for i, _ in local})
    lo, hi = coords[0], coords[-1] + 1
    spans = sorted(distributed.all_gather_objects((lo, hi)))
    if (coords != list(range(lo, hi)) or spans[0][0] != 0
            or spans[-1][1] != n
            or any(a[1] != b[0] for a, b in zip(spans, spans[1:]))):
        raise ValueError(f"the ranks' runs of the {data_axis!r} axis {spans} "
                         f"do not partition its {n} slots")
    per = batch // n
    return slice(lo * per, hi * per), devices.pop()


def make_dp_train_step(spec: ModelSpec, cfg: TrainConfig, mesh: Mesh,
                       data_axis: str = "data"):
    """A data-parallel train step over ``mesh``'s ``data_axis``.

    ``cfg.batch_size`` is the GLOBAL batch; it must divide by the axis's
    size.  Returns ``(train_step, train_steps, patch_size)`` with
    :func:`~flypylib_tpu_torch.train.trainer.make_train_step`'s signatures
    (``train_step(state, gen, data) -> metrics``); the metrics are the
    global batch's (the loss summed over the ranks, the means averaged)."""
    n_data = mesh.shape[data_axis]
    if cfg.batch_size % n_data != 0:
        raise ValueError(f"global batch {cfg.batch_size} not divisible by "
                         f"data axis {n_data}")
    rows, device = rank_rows(mesh, data_axis, cfg.batch_size)
    loss_fn, sample_fn, patch = make_loss_fn(spec, cfg)
    module = resolve_train_spec(spec, cfg).module
    plain = module.inner if isinstance(module, _PACKED) else module
    world = torch.distributed.is_initialized()

    def train_step(state, gen: torch.Generator, data):
        if data.images.device != device:
            raise ValueError(f"the data lie on {data.images.device}, this "
                             f"rank's slots on {device}")
        with no_tf32(device):
            x, y, m, codes = sample_fn(gen, data)  # (a): the global batch
            x, y, m = x[rows], y[rows], m[rows]
            codes = None if codes is None else codes[rows]
            with _moments_over_ranks(plain, _global_moments if world
                                     else None):
                loss, metrics = loss_fn(x, y, m, codes, count=(
                    _global_count if world else None))
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if world:
                _sum_grads(state.module)
            state.optimizer.step()
        state.step += 1
        if world:
            n = distributed.world_size()
            metrics = {"loss": distributed.all_reduce_sum(metrics["loss"]),
                       **{k: distributed.all_reduce_sum(metrics[k]) / n
                          for k in ("pos_frac", "pred_mean")}}
        return metrics

    def train_steps(state, gen: torch.Generator, data, n: int):
        ms = [train_step(state, gen, data) for _ in range(n)]
        return {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

    return train_step, train_steps, patch
