"""Training: patch sampling and augmentation on the device, the train step,
the epoch loop, validation and checkpoints.

Counterpart of ``flypylib_tpu/train/trainer.py`` (flypylib's
``fplnetwork.train`` + ``fplobjdetect.gen_batches``): random patch sampling
from labeled cubes restricted by a loss mask, flip/rotation augmentation,
masked binary cross-entropy, Adam.  Several volumes are padded to a common
shape and stacked on a leading axis, with per-volume corner bounds so
sampling never strays into padding.

The labeled volumes live on the device (uint8 grayscale stays uint8 and is
scaled in the step) and every step samples on it: the volume pick and the
corners (half uniform, half jittered around known positives) from an
explicit ``torch.Generator`` on the device, the patch gather as one batched
index, the per-patch augmentation as another (``ops/augment.py``).  The
random draws are kept apart from the arithmetic that turns them into
corners (:func:`_draws`, :func:`_corners`), so a test can feed the JAX
package's draws through the port's arithmetic.  The random streams differ
from ``jax.random``'s, so training is not bitwise the reference's; on the
same parameters and batch, loss and gradients are (tests/test_torch_train.py).

Where the reference scans a whole epoch in one jit dispatch, the port runs
a plain Python loop of steps; CUDA graphs and ``torch.compile`` are later
perf work.  Every step runs with TF32 off, its backward included (cuDNN's
default would round f32 convolution inputs to 10 mantissa bits).

Engines: "plain" differentiates the plain module (K1 on every 3^3 conv,
through ``ops.conv.Conv3dBiasReLU``), "packed" the packed engine's
``forward_train`` (K5 through ``ops.packed_conv.ParityBatch``), "auto" picks
by batch size as the reference does, and plain for a BatchNorm model.

A BatchNorm model's loss runs the module in train mode: batch statistics,
and the running ones updated once a step, as the reference's
``mutable=["batch_stats"]``.  Everything else (validation, the inference
engines, which share the module's buffers) runs it in eval mode.
Checkpoints hold the parameters under ``"params"`` and the buffers (the
running statistics) under ``"batch_stats"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flypylib_tpu_torch.models.zoo import ModelSpec
from flypylib_tpu_torch.ops.augment import AUGMENT_GROUP_SIZE, augment_batch
from flypylib_tpu_torch.ops.conv import no_tf32
from flypylib_tpu_torch.ops.packed_conv import PackedConvStack, packed_spec
from flypylib_tpu_torch.ops.packed_unet import PackedUNet, packed_unet_spec
from flypylib_tpu_torch.utils.metrics import span

_PACKED = (PackedConvStack, PackedUNet)


@dataclass(frozen=True)
class TrainConfig:
    patch_size: int = 33  # input patch edge (model-valid size enforced)
    batch_size: int = 32
    learning_rate: float = 1e-3
    pos_fraction: float = 0.5  # fraction of batch sampled near positives
    pos_jitter: int = 5  # voxel jitter around positive centers
    augment: bool = True
    steps_per_epoch: int = 100
    # "plain" differentiates the plain module; "packed" the packed
    # engine's forward_train (ConvStack or the valid-conv U-Net): the same
    # objective up to rounding.  "auto" (default) resolves to packed below
    # the batch crossover when the model has a packed engine, else plain.
    engine: str = "auto"


# The reference's packed-vs-plain crossover, kept for behaviour parity: the
# batch at and above which "auto" trains the plain module.  It was measured
# on a TPU; chip_smoke.py phase 12 reads the card's own crossover (PERF.md).
_PACKED_BATCH_CROSSOVER = 96


def resolve_engine(spec: ModelSpec, cfg: TrainConfig) -> str:
    """The concrete engine ("plain" | "packed") a config runs.

    ``engine="auto"`` resolves to "packed" when the batch size is below the
    crossover and the model has a differentiable packed forward (a
    ``ConvStack`` without BatchNorm or a ``UNetValid``, or a spec already
    packed); otherwise "plain".  Explicit engines pass through (an
    unsupported model then raises in :func:`resolve_train_spec`, a
    BatchNorm stack in the packed ``forward_train``)."""
    if cfg.engine != "auto":
        if cfg.engine not in ("plain", "packed"):
            raise ValueError(f"unknown engine {cfg.engine!r}")
        return cfg.engine
    if cfg.batch_size >= _PACKED_BATCH_CROSSOVER:
        return "plain"
    module = spec.module
    if isinstance(module, _PACKED):
        module, pspec = module.inner, spec
    else:
        pspec = packed_spec(spec) or packed_unet_spec(spec)
    if pspec is None or getattr(module, "use_batchnorm", False):
        return "plain"  # no differentiable packed forward for this model
    return "packed"


def resolve_train_spec(spec: ModelSpec, cfg: TrainConfig) -> ModelSpec:
    """The spec the train step differentiates.

    ``engine="packed"`` (or "auto" resolving to it) swaps in the packed spec
    (the same parameters, stricter size constraints: its ``valid_size``
    governs patch sampling).  A packed U-Net with a kernel tail trains
    through its unfused twin, as the reference's does (its ``forward_train``
    never runs a Pallas tail)."""
    if resolve_engine(spec, cfg) != "packed":
        return spec
    module = spec.module
    if isinstance(module, PackedConvStack):
        return spec
    if isinstance(module, PackedUNet):
        if module.tail_impl == "xla":
            return spec
        return dataclasses.replace(spec, module=PackedUNet(module.inner, "xla"))
    pspec = packed_spec(spec) or packed_unet_spec(spec)
    if pspec is None:
        raise ValueError(
            f"engine='packed' needs a ConvStack or UNetValid model "
            f"(got {module!r})"
        )
    return pspec


def masked_bce_loss(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor, count=None) -> torch.Tensor:
    """Loss-mask-weighted sigmoid binary cross-entropy (mean over mask), in
    f32: ``optax.sigmoid_binary_cross_entropy``'s formula.  ``count``
    (default: ``mask.sum()``) maps the mask's sum to the denominator; a
    data-parallel shard passes the sum over the world, so its part of the
    loss is its share of the global mean."""
    logits, labels, mask = logits.float(), labels.float(), mask.float()
    bce = -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)
    den = mask.sum() if count is None else count(mask.sum())
    return (bce * mask).sum() / torch.clamp(den, min=1.0)


@dataclass
class TrainData:
    """Stacked labeled volumes resident on the device.

    images/labels/masks: (V, Z, Y, X) (images uint8 or f32, the others
    f32); corner_max: (V, 3) inclusive upper corner bound per volume;
    pos_locs: (N, 4) [v, z, y, x]; n_pos: the number of positives."""

    images: torch.Tensor
    labels: torch.Tensor
    masks: torch.Tensor
    corner_max: torch.Tensor
    pos_locs: torch.Tensor
    n_pos: int

    @classmethod
    def build(cls, images, labels, masks, patch: int, pos_cap: int = 65536,
              device="cuda"):
        """Stack single or lists of (image, labels, mask) volumes; pads to
        a common shape (padding is mask-0 and never sampled) and uploads
        to ``device``.  More than ``pos_cap`` positives are subsampled by
        ``np.random.default_rng(0)``, as in the reference."""
        if not isinstance(images, (list, tuple)):
            images, labels, masks = [images], [labels], [masks]
        if not len(images) == len(labels) == len(masks):
            raise ValueError(f"{len(images)} images, {len(labels)} labels and "
                             f"{len(masks)} masks")
        shapes = [np.asarray(im).shape for im in images]
        for s in shapes:
            if any(dim < patch for dim in s):
                raise ValueError(f"volume {s} smaller than patch {patch}")
        common = tuple(np.max(np.asarray(shapes), axis=0))

        def padded(v, fill=0.0):
            v = np.asarray(v, np.float32)
            pads = [(0, c - s) for s, c in zip(v.shape, common)]
            return np.pad(v, pads, constant_values=fill)

        img_dtype = np.asarray(images[0]).dtype
        if img_dtype == np.uint8:
            imgs = np.stack(
                [np.pad(np.asarray(im),
                        [(0, c - s) for s, c in zip(np.shape(im), common)])
                 for im in images]
            )
        else:
            imgs = np.stack([padded(im) for im in images])
        labs = np.stack([padded(lb) for lb in labels])
        msks = np.stack([padded(mk) for mk in masks])

        corner_max = np.asarray(
            [[dim - patch for dim in s] for s in shapes], np.int64
        )
        locs = []
        for v, lb in enumerate(labels):
            pts = np.argwhere(np.asarray(lb) > 0.5)
            if len(pts):
                locs.append(
                    np.concatenate(
                        [np.full((len(pts), 1), v), pts], axis=1
                    )
                )
        if locs:
            locs = np.concatenate(locs).astype(np.int64)
            if len(locs) > pos_cap:
                sel = np.random.default_rng(0).choice(
                    len(locs), pos_cap, replace=False
                )
                locs = locs[sel]
            n_pos = len(locs)
        else:
            locs = np.zeros((1, 4), np.int64)
            n_pos = 0
        dev = torch.device(device)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return cls(images=up(imgs), labels=up(labs), masks=up(msks),
                   corner_max=up(corner_max), pos_locs=up(locs), n_pos=n_pos)


def _draws(gen: torch.Generator, n: int, data: TrainData,
           cfg: TrainConfig) -> dict:
    """The random draws of one batch's corners, from ``gen`` on the data's
    device: ``vidx_u`` (n,) volume of a uniform corner, ``u`` (n, 3) f32 in
    [0, 1), ``pidx`` (n,) positive index, ``jitter`` (n, 3) in [-j, j],
    ``mix`` (n,) f32 in [0, 1) (the reference's keys k_v, k_u, k_p, k_j,
    k_mix)."""
    dev = data.images.device
    n_vols = data.images.shape[0]
    j = cfg.pos_jitter
    return {
        "vidx_u": torch.randint(0, n_vols, (n,), generator=gen, device=dev),
        "u": torch.rand((n, 3), generator=gen, device=dev),
        "pidx": torch.randint(0, max(data.n_pos, 1), (n,), generator=gen,
                              device=dev),
        "jitter": torch.randint(-j, j + 1, (n, 3), generator=gen, device=dev),
        "mix": torch.rand((n,), generator=gen, device=dev),
    }


def _corners(draws: dict, data: TrainData, patch: int,
             cfg: TrainConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(vidx (n,), corners (n, 3)) from :func:`_draws`: a uniform corner
    ``floor(u * (corner_max + 1))`` or, with probability ``pos_fraction``
    when there are positives, a positive's centre plus the jitter, less
    ``patch // 2``, clipped to ``[0, corner_max]`` (the reference's
    ``_sample_batch`` arithmetic)."""
    vidx_u = draws["vidx_u"]
    uniform = torch.floor(
        draws["u"] * (data.corner_max[vidx_u] + 1)).to(torch.int64)
    pos = data.pos_locs[draws["pidx"]]  # (n, 4) [v, z, y, x]
    centers = pos[:, 1:] + draws["jitter"]
    pos_corner = torch.minimum(torch.clamp(centers - patch // 2, min=0),
                               data.corner_max[pos[:, 0]])
    use_pos = (draws["mix"] < cfg.pos_fraction) & (data.n_pos > 0)
    vidx = torch.where(use_pos, pos[:, 0], vidx_u)
    corners = torch.where(use_pos[:, None], pos_corner, uniform)
    return vidx, corners


def _sample_batch(gen: torch.Generator, n: int, data: TrainData, patch: int,
                  cfg: TrainConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(vidx (n,), corners (n, 3)) mixing uniform and positive-centered."""
    return _corners(_draws(gen, n, data, cfg), data, patch, cfg)


def _gather(vols: torch.Tensor, vidx: torch.Tensor, corners: torch.Tensor,
            size: int) -> torch.Tensor:
    """(n, size, size, size) patches ``vols[vidx[i], c_z:c_z+size, ...]``,
    one batched index on the volumes' device."""
    r = torch.arange(size, device=vols.device)
    z, y, x = (corners[:, a, None] + r for a in range(3))  # (n, size) each
    return vols[vidx[:, None, None, None], z[:, :, None, None],
                y[:, None, :, None], x[:, None, None, :]]


def _train_forward(spec: ModelSpec, engine: str):
    """The callable the step differentiates: the packed engine's
    ``forward_train``, or the plain module (the inner one of a packed
    spec)."""
    module = spec.module
    if engine == "packed":
        return module.forward_train
    return module.inner if isinstance(module, _PACKED) else module


@contextlib.contextmanager
def train_mode(module: nn.Module):
    """``module`` in train mode for the block (BatchNorm on batch
    statistics, updating its running ones), its mode before restored."""
    was = module.training
    module.train(True)
    try:
        yield module
    finally:
        module.train(was)


def make_loss_fn(spec: ModelSpec, cfg: TrainConfig):
    """``(loss_fn, sample_fn, patch_size)``.

    ``sample_fn(gen, data)`` draws one batch on the data's device: ``(x,
    y, m, codes)`` with x (B, p, p, p) f32 (uint8 scaled by 1/255), y and
    m (B, p - 2c, ...) the label and mask crops, codes (B,) augmentation
    codes or None.  ``loss_fn(x, y, m, codes)`` augments, runs the engine's
    forward and returns ``(loss, metrics)`` (``loss``, ``pos_frac``,
    ``pred_mean``, as 0-d tensors); the module runs in train mode (a
    BatchNorm model's running statistics update once a call); ``count`` is
    :func:`masked_bce_loss`'s.  A batch made elsewhere (a test's, from
    numpy) goes through ``loss_fn`` alone.  ``loss_fn`` opens the tracer's
    spans ``train.forward`` (augment and forward) and ``train.loss`` (the
    loss and the metrics)."""
    engine = resolve_engine(spec, cfg)
    spec = resolve_train_spec(spec, cfg)
    forward = _train_forward(spec, engine)
    plain = spec.module.inner if isinstance(spec.module, _PACKED) else spec.module
    patch = spec.valid_size(cfg.patch_size)
    ctx = spec.context
    out = patch - 2 * ctx
    if out <= 0:
        raise ValueError(f"patch_size {patch} too small for context {ctx}")

    def sample_fn(gen: torch.Generator, data: TrainData):
        vidx, corners = _sample_batch(gen, cfg.batch_size, data, patch, cfg)
        x = _gather(data.images, vidx, corners, patch)
        yc = corners + ctx
        y = _gather(data.labels, vidx, yc, out)
        m = _gather(data.masks, vidx, yc, out)
        uint8 = x.dtype == torch.uint8
        x = x.float()
        if uint8:
            x = x * (1.0 / 255.0)
        codes = None
        if cfg.augment:
            codes = torch.randint(0, AUGMENT_GROUP_SIZE, (cfg.batch_size,),
                                  generator=gen, device=x.device)
        return x, y, m, codes

    def loss_fn(x, y, m, codes, count=None):
        dev = x.device
        with span("train.forward", device=dev):
            if codes is not None:
                x, y, m = (augment_batch(v, codes) for v in (x, y, m))
            with train_mode(plain):
                logits = forward(x[..., None])[..., 0]
        with span("train.loss", device=dev):
            loss = masked_bce_loss(logits, y, m, count)
            metrics = {
                "loss": loss.detach(),
                "pos_frac": y.float().mean(),
                "pred_mean": torch.sigmoid(logits.detach()).mean(),
            }
        return loss, metrics

    return loss_fn, sample_fn, patch


@dataclass
class TrainState:
    """The module whose parameters train, its Adam and the step count."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, module: nn.Module, learning_rate: float):
        # optax.adam's defaults
        opt = torch.optim.Adam(module.parameters(), lr=learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        return cls(module=module, optimizer=opt)


def make_train_step(spec: ModelSpec, cfg: TrainConfig):
    """``(train_step, train_steps, patch_size)``.

    ``train_step(state, gen, data)`` runs one step (sample, augment,
    forward, masked BCE, backward, Adam; TF32 off throughout) and returns
    its metrics as 0-d tensors; ``train_steps(state, gen, data, n)`` runs
    ``n`` and returns each metric's mean over them (the reference's
    ``lax.scan`` + mean), still on the device.

    A step is the tracer's root span ``train.step``, over ``train.sample``,
    ``loss_fn``'s ``train.forward`` and ``train.loss``, ``train.backward``
    (``zero_grad``, which launches nothing, and the backward) and
    ``train.adam`` (the optimizer's step), each with stream-time events."""
    loss_fn, sample_fn, patch = make_loss_fn(spec, cfg)

    def train_step(state: TrainState, gen: torch.Generator, data: TrainData):
        dev = data.images.device
        with span("train.step", device=dev), no_tf32(dev):
            with span("train.sample", device=dev):
                batch = sample_fn(gen, data)
            loss, metrics = loss_fn(*batch)
            del batch  # the sampled patches are not held through the backward
            with span("train.backward", device=dev):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            with span("train.adam", device=dev):
                state.optimizer.step()
        state.step += 1
        return metrics

    def train_steps(state: TrainState, gen: torch.Generator, data: TrainData,
                    n: int):
        ms = [train_step(state, gen, data) for _ in range(n)]
        return {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

    return train_step, train_steps, patch


class Trainer:
    """Training loop: uploads the volumes once, runs steps on the device,
    tracks metrics, validates and checkpoints."""

    def __init__(self, spec: ModelSpec, cfg: TrainConfig | None = None,
                 seed: int = 0, infer_spec: ModelSpec | None = None,
                 device="cuda"):
        """``infer_spec`` — the spec validation inference runs with (e.g.
        the packed engine); defaults to the training spec.  The parameters
        that train are the plain module's (the inner one of a packed spec),
        as the spec holds them: the port's zoo draws them when the spec is
        built, from its own seed.  ``seed`` seeds the sampling generator.
        ``device="cuda"`` without a usable GPU raises."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer(device='cuda'): CUDA is not available "
                "(pass device='cpu' to train on the CPU)")
        self.spec = spec
        self.cfg = cfg or TrainConfig()
        self.infer_spec = infer_spec or spec
        self.device = device
        m = spec.module
        self.module = m.inner if isinstance(m, _PACKED) else m
        self.module.to(device)
        self.generator = torch.Generator(device=device).manual_seed(int(seed))
        self.state: TrainState | None = None
        self._train_steps = None
        self._fit_mesh = None
        self._val_engine = None  # cached TiledInference
        self._val_engine_key = None
        self.history: list[dict] = []

    def init_state(self, patch_size: int | None = None) -> TrainState:
        """A fresh Adam (step 0) over the module's current parameters.
        ``patch_size`` is accepted for the reference's signature (it sizes
        the reference's parameter init); the port's parameters exist
        already."""
        self.state = TrainState.create(self.module, self.cfg.learning_rate)
        return self.state

    def fit(
        self,
        image,
        labels,
        mask,
        epochs: int = 1,
        callback=None,
        val_data=None,
        val_tbars=None,
        val_every: int = 1,
        val_threshold: float = 0.5,
        val_window=3,
        val_dist_thresh: float = 10.0,
        metrics_log=None,
        mesh=None,
    ):
        """Train on one labeled volume or lists of them.

        ``val_data``: optional ``(image, labels, mask)`` held-out volume —
        each ``val_every`` epochs the model runs full inference on it and
        the epoch record gains ``val_loss`` (masked BCE) and
        ``val_voxel_precision``/``val_voxel_recall`` (at
        ``val_threshold``).  ``val_tbars``: optional ground-truth point
        list — adds object-level ``val_obj_precision``/``val_obj_recall``
        (NMS at ``val_window``/``val_threshold``, greedy matching within
        ``val_dist_thresh``).  ``metrics_log``: optional
        :class:`flypylib_tpu_torch.utils.metrics.MetricsLog` receiving every
        epoch record.

        ``mesh``: a :class:`flypylib_tpu_torch.parallel.mesh.Mesh` with a
        ``"data"`` axis; the steps are then data-parallel
        (``parallel/train.py``: the global ``cfg.batch_size`` split over the
        axis, gradients summed over the ranks).  Every rank runs ``fit``
        with the same seed and data; the same seed gives the same
        parameters as the single-device path."""
        patch = resolve_train_spec(self.spec, self.cfg).valid_size(
            self.cfg.patch_size
        )
        data = TrainData.build(image, labels, mask, patch, device=self.device)
        if self.state is None:
            self.init_state()
        if self._train_steps is None or mesh is not self._fit_mesh:
            if mesh is not None:
                from flypylib_tpu_torch.parallel.train import make_dp_train_step

                _, self._train_steps, _ = make_dp_train_step(
                    self.spec, self.cfg, mesh)
            else:
                _, self._train_steps, _ = make_train_step(self.spec, self.cfg)
            self._fit_mesh = mesh

        for epoch in range(epochs):
            metrics = self._train_steps(self.state, self.generator, data,
                                        self.cfg.steps_per_epoch)
            ep = {k: float(v) for k, v in metrics.items()}
            ep["epoch"] = epoch
            if val_data is not None and epoch % max(val_every, 1) == 0:
                ep.update(self._validate(
                    val_data, val_tbars, val_threshold, val_window,
                    val_dist_thresh,
                ))
            self.history.append(ep)
            if metrics_log is not None:
                metrics_log.log(ep)
            if callback:
                callback(ep)
        return self.history

    def _validate(self, val_data, val_tbars, threshold, window,
                  dist_thresh) -> dict:
        """Held-out metrics: masked-BCE loss, voxel PR, optional obj PR.
        One inference engine (``infer_spec`` at ``default_tiling``, as
        ``FplNetwork.infer``) is built and reused across epochs; it reads
        the module's current weights."""
        from flypylib_tpu_torch.infer.tiled import TiledInference, default_tiling
        from flypylib_tpu_torch.ops.matching import obj_pr, voxel_pr
        from flypylib_tpu_torch.ops.nms import nms

        v_img, v_lab, v_mask = val_data
        v_img = np.asarray(v_img)
        tile_out, tile_batch = default_tiling(self.infer_spec, v_img.shape)
        key = (tile_out, tile_batch)
        if self._val_engine is None or self._val_engine_key != key:
            self._val_engine = TiledInference(
                self.infer_spec, tile_out=tile_out, tile_batch=tile_batch,
            )
            self._val_engine_key = key
        prob = self._val_engine.infer(v_img)
        lab = np.asarray(v_lab, np.float32)
        msk = np.asarray(v_mask, np.float32)
        eps = 1e-7
        p = np.clip(prob, eps, 1 - eps)
        bce = -(lab * np.log(p) + (1 - lab) * np.log1p(-p))
        out: dict = {
            "val_loss": float(
                (bce * msk).sum() / max(msk.sum(), 1.0)
            )
        }
        vpr = voxel_pr(
            prob, lab, msk, thresholds=np.asarray([threshold], np.float32)
        )
        out["val_voxel_precision"] = float(vpr["precision"][0])
        out["val_voxel_recall"] = float(vpr["recall"][0])
        if val_tbars is not None:
            pred = nms(prob, window=window, threshold=threshold)
            pr, rc = obj_pr(pred, val_tbars, dist_thresh=dist_thresh)
            out["val_obj_precision"] = float(pr)
            out["val_obj_recall"] = float(rc)
        return out

    def save(self, path: str):
        """``torch.save`` of ``{"params", "batch_stats"}`` (the content the
        reference's orbax checkpoint holds): the module's parameters and its
        buffers (a BatchNorm stack's running statistics), by state-dict
        name, on the CPU."""
        torch.save({
            "params": {k: v.detach().cpu()
                       for k, v in self.module.named_parameters()},
            "batch_stats": {k: v.detach().cpu()
                            for k, v in self.module.named_buffers()},
        }, path)

    def restore(self, path: str) -> TrainState:
        """Load a :meth:`save` checkpoint into the module, parameters and
        running statistics (the optimizer's state is kept, as the reference
        keeps its ``opt_state``)."""
        if self.state is None:
            self.init_state()
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        self.module.load_state_dict({**ckpt["params"], **ckpt["batch_stats"]})
        return self.state
