"""FplNetwork — the flypylib-compatible public API surface, in PyTorch.

Counterpart of ``flypylib_tpu/network.py``: ``train`` (``train/trainer.py``),
``infer``, ``nms``, ``components``, ``detect``, ``detect_large`` (the
staged and streaming whole-volume engine, ``infer/large.py``), ``evaluate``
and ``evaluate_voxels`` (``ops/matching.py``), ``save`` and ``restore``,
with the reference's defaults (``detect`` uses window 5, the bare ``nms`` verb window 3,
threshold 0.5, ``default_tiling`` and ``packed="auto"``, which runs every
model with a packed engine through it: ``PackedConvStack`` for the conv
stacks, ``PackedUNet`` for the U-Net; ``packed=False`` runs the plain
module, K1 on every 3^3 conv).  Construction takes a zoo name
(``FplNetwork("unet")``), a zoo callable or a ready ``ModelSpec`` (a packed
spec included).

The device is explicit.  ``device="cuda"`` without a usable GPU raises; the
network never moves itself to the CPU.  On ``device="cpu"`` every kernel
runs its plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

from flypylib_tpu_torch.infer.tiled import TiledInference, default_tiling
from flypylib_tpu_torch.io.synapses import Tbars, make_training_volumes
from flypylib_tpu_torch.models.zoo import (
    MODEL_ZOO,
    ModelSpec,
    params_from_flax,
)
from flypylib_tpu_torch.ops.components import label_components
from flypylib_tpu_torch.ops.nms import nms
from flypylib_tpu_torch.ops.packed_conv import PackedConvStack, packed_spec
from flypylib_tpu_torch.ops.packed_unet import PackedUNet, packed_unet_spec
from flypylib_tpu_torch.train.trainer import TrainConfig, Trainer

_PACKED = (PackedConvStack, PackedUNet)


class FplNetwork:
    def __init__(self, model="baseline", seed: int = 0, device="cuda",
                 packed: bool | str = "auto",
                 train_config: TrainConfig | None = None, **model_kwargs):
        """``model`` is a ``MODEL_ZOO`` name, a zoo callable (called with
        ``seed`` and ``model_kwargs``) or a ``ModelSpec``.  ``seed`` draws
        the weights and seeds the trainer's sampling; ``train_config`` is
        the :class:`~flypylib_tpu_torch.train.trainer.TrainConfig` of
        :meth:`train`.

        ``packed`` selects the space-to-depth inference engine for the
        infer/detect verbs, as in the reference: ``"auto"`` uses it
        whenever the model has one (``ConvStack`` and ``UNetValid``),
        ``True`` requires it, ``False`` runs the plain module.  Both share
        one set of weights.  A spec that is already packed is used as
        given."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "FplNetwork(device='cuda'): CUDA is not available "
                "(pass device='cpu' to run the plain versions on the CPU)"
            )
        if isinstance(model, ModelSpec):
            spec = model
        elif callable(model):
            spec = model(seed=seed, **model_kwargs)
        else:
            spec = MODEL_ZOO[model](seed=seed, **model_kwargs)
        infer_spec = spec
        if packed and not isinstance(spec.module, _PACKED):
            pspec = packed_spec(spec) or packed_unet_spec(spec)
            if pspec is None and packed is True:
                raise ValueError(f"model {spec.name!r} does not support the "
                                 "packed inference engine")
            infer_spec = pspec or spec
        infer_spec.module.to(device).eval()
        self.spec = spec
        self.infer_spec = infer_spec
        self.context = spec.context
        self.device = device
        self.trainer = Trainer(spec, train_config, seed=seed,
                               infer_spec=infer_spec, device=device)
        self._tiled: TiledInference | None = None
        self._tiled_key = None

    # -- train ------------------------------------------------------------
    def train(
        self,
        image,
        labels=None,
        mask=None,
        tbars=None,
        epochs: int = 1,
        radius: float = 5.0,
        callback=None,
        **fit_kwargs,
    ):
        """Train on one labeled cutout or a list of them (flypylib trained
        over lists of labeled cubes), on the network's device.

        Either pass rasterized ``labels`` (+ ``mask``, default all ones)
        volumes, or raw ``tbars`` annotations, rasterized here with the
        standard radius / ignore-annulus rules and the border masked by the
        model's context.  ``fit_kwargs`` go to :meth:`Trainer.fit`
        (``val_data``, ``val_tbars``, ``metrics_log``, ...).  The weights
        the inference engines read are the ones that train."""
        is_multi = isinstance(image, (list, tuple))
        images = list(image) if is_multi else [image]
        if labels is None:
            if tbars is None:
                raise ValueError("need labels+mask or tbars")
            tbars_list = list(tbars) if is_multi else [tbars]
            pairs = [
                make_training_volumes(
                    tb, np.shape(im), radius=radius, border=self.context
                )
                for tb, im in zip(tbars_list, images)
            ]
            labels = [p[0] for p in pairs]
            mask = [p[1] for p in pairs]
        else:
            labels = list(labels) if is_multi else [labels]
            if mask is None:
                mask = [np.ones_like(lb, dtype=np.float32) for lb in labels]
            else:
                mask = list(mask) if is_multi else [mask]
        history = self.trainer.fit(images, labels, mask, epochs=epochs,
                                   callback=callback, **fit_kwargs)
        self._tiled = None  # the weights changed: rebuild the tiling lazily
        return history

    @property
    def module(self) -> torch.nn.Module:
        """The plain module that holds the weights (a packed engine shares
        them)."""
        m = self.spec.module
        return m.inner if isinstance(m, _PACKED) else m

    @property
    def variables(self) -> dict[str, torch.Tensor]:
        """The model's parameters and a BatchNorm stack's running
        statistics (a state dict)."""
        return self.module.state_dict()

    def load_flax_params(self, variables):
        """Load the JAX package's ``ConvStack`` (BatchNorm's ``batch_stats``
        included) or ``UNetValid`` variables (see
        :func:`~flypylib_tpu_torch.models.zoo.params_from_flax`)."""
        self.module.load_state_dict(params_from_flax(variables))

    # -- infer ------------------------------------------------------------
    def tiled_inference(self, vol_shape, tile_out: int | None = None,
                        tile_batch: int | None = None) -> TiledInference:
        """The tiling engine :meth:`infer` uses for a volume of ``vol_shape``;
        ``tile_out``/``tile_batch`` default to :func:`default_tiling`."""
        if tile_out is None or tile_batch is None:
            d_out, d_batch = default_tiling(self.infer_spec, vol_shape)
            tile_out = d_out if tile_out is None else tile_out
            tile_batch = d_batch if tile_batch is None else tile_batch
        key = (tile_out, tile_batch)
        if self._tiled is None or self._tiled_key != key:
            self._tiled = TiledInference(
                self.infer_spec, tile_out=tile_out, tile_batch=tile_batch
            )
            self._tiled_key = key
        return self._tiled

    def infer(self, volume: np.ndarray, tile_out: int | None = None,
              tile_batch: int | None = None, keep_on_device: bool = False):
        """Whole-volume probability map via overlap-tiled inference: a numpy
        f32 array, or with ``keep_on_device=True`` a tensor on the network's
        device.  Tiled == monolithic bitwise, whatever the tiling."""
        vol = np.asarray(volume)
        return self.tiled_inference(vol.shape, tile_out, tile_batch).infer(
            vol, keep_on_device=keep_on_device
        )

    # -- nms / detect ------------------------------------------------------
    @staticmethod
    def nms(prob, window=3, threshold: float = 0.5) -> Tbars:
        return nms(prob, window=window, threshold=threshold)

    @staticmethod
    def components(prob, threshold: float = 0.5) -> Tbars:
        return label_components(prob, threshold=threshold)

    def detect(
        self,
        volume: np.ndarray,
        window=5,
        threshold: float = 0.5,
        tile_out: int | None = None,
        tile_batch: int | None = None,
        method: str = "nms",
    ) -> Tbars:
        """infer + nms/cc in one pass with the probability map kept on the
        device.  ``window`` defaults to 5, the reference's detection-verb
        default (the bare :meth:`nms` verb keeps window 3)."""
        if method not in ("nms", "components"):
            raise ValueError(f"unknown method {method!r}")
        prob = self.infer(volume, tile_out=tile_out, tile_batch=tile_batch,
                          keep_on_device=True)
        if method == "nms":
            return nms(prob, window=window, threshold=threshold)
        return label_components(prob, threshold=threshold)

    def detect_large(
        self,
        volume,
        window=5,
        threshold: float = 0.5,
        core: int | None = None,
        method: str = "nms",
        staged=None,
        **kw,
    ):
        """Detection over a volume of any size with exact whole-volume
        semantics (``infer/large.py``).  ``volume`` is an in-RAM array, an
        HDF5 path (:func:`~flypylib_tpu_torch.infer.large.detect_h5`) or a
        ``(shape, read_fn)`` pair (:func:`~flypylib_tpu_torch.infer.large.
        detect_streaming`); ``kw`` goes to the engine (``forward``,
        ``tile_out``, ``tile_batch``, ``plan``, ``cc_impl``, ...).
        ``method`` is ``"nms"``, ``"components"`` or ``"both"``;
        ``devices=`` (several devices, or repeated slots of one) fans the
        engine out, the lists bitwise the single-device call's.

        An array is staged on the network's device
        (:func:`~flypylib_tpu_torch.infer.large.detect_staged`) when
        ``staged`` is True, a staged upload (from ``stage_volume`` or
        ``stage_volume_chunked``, reused as it is), or None and the volume
        and its f32 map fit the device (:func:`~flypylib_tpu_torch.infer.
        large.staged_fits`, the reference's arithmetic against the card's
        memory); otherwise (``staged=False``, or a volume that does not
        fit) its windows stream from host memory through
        ``array_reader``.  Note that a uint8 volume enters the model as ``x
        * f32(1/255)`` here, where :meth:`detect` feeds its raw values, as
        in the reference."""
        from flypylib_tpu_torch.infer.large import (array_reader, detect_h5,
                                                    detect_staged,
                                                    detect_streaming,
                                                    staged_fits)

        common = dict(window=window, threshold=threshold, core=core,
                      method=method, **kw)
        if isinstance(volume, str):
            return detect_h5(self.infer_spec, None, volume, **common)
        if isinstance(volume, tuple) and len(volume) == 2 and callable(volume[1]):
            shape, read = volume
            return detect_streaming(self.infer_spec, None, shape, read,
                                    **common)
        vol = np.asarray(volume)
        if staged is None:
            staged = staged_fits(vol, self.device, devices=kw.get("devices"))
        if staged is False:
            shape, read = array_reader(vol)
            return detect_streaming(self.infer_spec, None, shape, read,
                                    **common)
        upload = None if staged is True else staged
        return detect_staged(self.infer_spec, None, vol, staged=upload,
                             **common)

    # -- evaluate ----------------------------------------------------------
    @staticmethod
    def evaluate(pred_or_prob, gt: Tbars, dist_thresh: float = 10.0,
                 window=3, threshold: float = 0.5):
        """PR curve of a probability map (nms at ``window``/``threshold``)
        or a detection list against ground truth (``ops/matching.py``)."""
        from flypylib_tpu_torch.ops.matching import evaluate as _evaluate

        return _evaluate(pred_or_prob, gt, dist_thresh=dist_thresh,
                         window=window, threshold=threshold)

    def evaluate_voxels(self, image, labels, mask=None, thresholds=None,
                        slab: int | None = None, tile_out: int | None = None,
                        tile_batch: int | None = None):
        """Voxel-wise PR of this model's prediction against a label volume.

        A small in-RAM volume (the reference's rule: 8 bytes a voxel under
        2 GiB) with no ``slab`` runs one forward kept on the device and
        counts there (:func:`~flypylib_tpu_torch.ops.matching.
        voxel_pr_device`); anything else, or any ``(shape, read_fn)`` input,
        streams phase-aligned z-slabs in bounded memory
        (:func:`~flypylib_tpu_torch.ops.matching.voxel_pr_streaming`) with
        the same result.  ``tile_out``/``tile_batch`` (default
        :func:`default_tiling`'s) apply to both routes: cuDNN's bf16 sums
        follow the tile shape, so compare the two routes at one tiling."""
        from flypylib_tpu_torch.ops.matching import (voxel_pr_device,
                                                     voxel_pr_streaming)

        is_reader = isinstance(image, tuple) and callable(image[1])
        small = (
            not is_reader
            and np.asarray(image).size * 8 < 2 << 30  # prob+labels+mask f32
            and slab is None
        )
        if small:
            prob = self.infer(image, tile_out=tile_out, tile_batch=tile_batch,
                              keep_on_device=True)
            return voxel_pr_device(prob, np.asarray(labels, np.float32),
                                   mask, thresholds=thresholds)
        return voxel_pr_streaming(
            self.infer_spec, None, image, labels, mask=mask,
            thresholds=thresholds, tile_out=tile_out, tile_batch=tile_batch,
            **({} if slab is None else {"slab": slab}),
        )

    # -- checkpointing -----------------------------------------------------
    def save(self, path: str):
        """Write the weights (``torch.save``, :meth:`Trainer.save`)."""
        self.trainer.save(path)

    def restore(self, path: str):
        """Load weights written by :meth:`save`."""
        self.trainer.restore(path)
        self._tiled = None
