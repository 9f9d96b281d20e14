"""Fused detect pipeline: tiled forward and postprocess on one device, with
only the detection lists coming back to the host.

Counterpart of ``flypylib_tpu/infer/pipeline.py`` (``DetectPipeline``), in
PyTorch idiom: plain functions on tensors on the module's device, and one
device -> host copy per postprocess.

- **Staging**: the raw volume is uploaded as it is (uint8 stays uint8), then
  reflect-padded by the model's ``context`` and zero-extended to the tile
  grid on the device (:func:`reflect_pad`: index copies, so bit for bit
  ``np.pad(mode="reflect")``).  A volume with an extent <= ``context``
  (more than one reflection) is padded on the host instead, as the
  reference does.
- **Forward**: tiles are sliced from the staged volume on the device, run
  through the module in batches grouped by tile z start (the last batch of
  a group padded by repeating its last corner; duplicate writes are bitwise
  identical), passed through a sigmoid and written into an f32 map, or into
  a caller's buffer at an offset (the staged engine's -inf shell).
- **uint8 scaling**: a uint8 volume enters the module as ``x * f32(1/255)``,
  a multiply by the f32 reciprocal as in the reference, not a division
  (the two differ in the last bit).  ``FplNetwork.detect`` feeds raw 0-255
  values instead; ``detect(vol.astype(f32) * f32(1/255))`` is this
  pipeline's map.
- **Postprocess**: NMS candidates (``ops/nms.candidate_mask``) and, with
  ``run_cc``, ``components_device``, with an optional in-bounds region
  (outside it the map is -inf) and an optional plane-subsampled quantile
  threshold.

Left out, as the reference's TPU and XLA workarounds: the two-phase and
split-write dispatch forms, the raw-chunk staging plan (a raw upload plus a
pad on the device takes its place), and the scatter-grid / ``lax.scan``
stitching.  ``max_detections`` and ``max_components`` are accepted under
their reference names and bound nothing: ``torch.nonzero`` compacts every
candidate in one pass, so there is no slot cap to saturate or grow.
"""

from __future__ import annotations

import numpy as np
import torch

from flypylib_tpu_torch.infer.tiled import TiledInference
from flypylib_tpu_torch.models.zoo import ModelSpec
from flypylib_tpu_torch.ops.components import (compact_true_indices,
                                               components_device)
from flypylib_tpu_torch.ops.host_reference import sort_detections
from flypylib_tpu_torch.ops.nms import candidate_mask, mask_valid_region
from flypylib_tpu_torch.utils import ceil_div, to3d
from flypylib_tpu_torch.utils.metrics import count, span

# the f32 reciprocal a uint8 volume is multiplied by (a python float that
# holds the f32 value exactly, so torch's f32 multiply uses it unchanged)
U8_SCALE = float(np.float32(1.0 / 255.0))


def reflect_pad(vol: torch.Tensor, pad) -> torch.Tensor:
    """``np.pad(vol, pad, mode="reflect")`` on ``vol``'s device, for any
    dtype: one ``index_select`` per axis with reflected indices, so the
    values are copies, bit for bit.  ``pad`` is an int, one per axis, or
    one ``(before, after)`` pair per axis; each must be below its axis'
    extent (a single reflection)."""
    out = vol
    pads = [(p, p) if np.isscalar(p) else tuple(p)
            for p in (to3d(pad) if np.isscalar(pad) else pad)]
    for axis, (lo, hi) in enumerate(pads):
        if not (lo or hi):
            continue
        n = out.shape[axis]
        if max(lo, hi) >= n:
            raise ValueError(f"reflect pad {max(lo, hi)} needs an extent > "
                             f"{max(lo, hi)}, got {n}")
        i = torch.arange(-lo, n + hi, device=out.device)
        i = torch.where(i < 0, -i, torch.where(i >= n, 2 * (n - 1) - i, i))
        out = out.index_select(axis, i)
    return out


def zero_extend(vol: torch.Tensor, shape) -> torch.Tensor:
    """``vol`` zero-padded on the high side of each axis to ``shape``."""
    shape = tuple(shape)
    if tuple(vol.shape) == shape:
        return vol
    out = vol.new_zeros(shape)
    out[: vol.shape[0], : vol.shape[1], : vol.shape[2]] = vol
    return out


def as_wire(volume) -> np.ndarray:
    """The host array as it is uploaded: uint8 and f32 as they are, any
    other dtype cast to f32."""
    vol = np.asarray(volume)
    if vol.dtype not in (np.uint8, np.float32):
        vol = vol.astype(np.float32)
    return np.ascontiguousarray(vol)


def to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Several device tensors in ONE device -> host copy: each is flattened
    to f64 (exact for int64 values below 2^53 and for f32), the pieces
    concatenated, copied (counter ``d2h_bytes``), and split back into f64
    arrays of their shapes."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    count("d2h_bytes", host.nbytes)
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(host[at:at + n].reshape(tuple(t.shape)))
        at += n
    return out


def unravel(idx: np.ndarray, shape) -> np.ndarray:
    """Flat indices (any numeric dtype) into a ``shape`` volume -> (n, 3)
    f64 (z, y, x)."""
    idx = np.asarray(idx).astype(np.int64)
    yx = shape[1] * shape[2]
    return np.stack([idx // yx, (idx % yx) // shape[2], idx % shape[2]],
                    axis=1).astype(np.float64)


def check_no_variables(variables) -> None:
    """The reference passes a model's weights beside its spec; the port's
    modules hold their own, so the argument must be None (load weights with
    ``FplNetwork.load_flax_params`` or the module's ``load_state_dict``)."""
    if variables is not None:
        raise ValueError("variables must be None: the port's modules hold "
                         "their own weights (load them into the spec's "
                         "module first)")


class DetectPipeline:
    """Volume -> detections engine for a fixed volume shape.

    If ``threshold_quantile`` is set, the operating threshold is that
    quantile of the in-bounds probability map (plane-subsampled, as the
    reference); otherwise ``threshold`` is used.  ``pre_padded=True``: the
    caller's volume already carries the ``context`` halo (shape
    ``vol_shape + 2 context``), and only the grid extension is added.
    ``variables`` must be None (the module holds the weights);
    ``max_detections`` / ``max_components`` are the reference's slot caps,
    accepted and unused."""

    def __init__(
        self,
        spec: ModelSpec,
        variables,
        vol_shape,
        tile_out: int = 128,
        tile_batch: int = 1,
        window=5,
        threshold: float = 0.5,
        threshold_quantile: float | None = None,
        max_detections: int = 4096,
        max_components: int = 4096,
        run_cc: bool = True,
        pre_padded: bool = False,
    ):
        check_no_variables(variables)
        self.spec = spec
        self.vol_shape = to3d(vol_shape)
        self.window = to3d(window)
        self.threshold = float(threshold)
        self.threshold_quantile = threshold_quantile
        self.run_cc = run_cc
        self.pre_padded = pre_padded

        self._tiled = TiledInference(spec, tile_out=tile_out,
                                     tile_batch=tile_batch)
        self._tin = self._tiled.tile_in
        corners, self._out_shape = self._tiled.plan(self.vol_shape)
        # tile corners grouped by z start, each group in batches of
        # tile_batch, the last batch padded with the group's last corner;
        # corners are local to the group's (tin, py, px) slab
        self._slabs = []
        B = tile_batch
        for zs in sorted({c[0] for c in corners}):
            cs = [(0, c[1], c[2]) for c in corners if c[0] == zs]
            nb = ceil_div(len(cs), B)
            cs = cs + [cs[-1]] * (nb * B - len(cs))
            self._slabs.append((zs, [cs[i * B:(i + 1) * B] for i in range(nb)]))

    @property
    def device(self) -> torch.device:
        return self._tiled.device

    @property
    def padded_shape(self) -> tuple:
        """Shape of the staged input (the region :meth:`forward_from` reads
        per call): the tile grid's output extent plus the context halo."""
        c = self._tiled.ctx
        return tuple(os + 2 * c for os in self._out_shape)

    @property
    def n_batches(self) -> int:
        """Tile batches (module calls) of one forward."""
        return sum(len(batches) for _, batches in self._slabs)

    # -- staging -----------------------------------------------------------
    def stage(self, volume) -> torch.Tensor:
        """Upload the volume and pad it on the device: the ``padded_shape``
        input of :meth:`forward_staged`, reusable across calls."""
        vol = as_wire(volume)
        c = self._tiled.ctx
        if self.pre_padded:
            expect = tuple(s + 2 * c for s in self.vol_shape)
            if vol.shape != expect:
                raise ValueError(f"pre_padded volume must have shape {expect}, "
                                 f"got {vol.shape}")
            big = torch.from_numpy(vol).to(self.device)
        else:
            if vol.shape != self.vol_shape:
                raise ValueError(f"volume must have shape {self.vol_shape}, "
                                 f"got {vol.shape}")
            if min(vol.shape) > c:
                big = reflect_pad(torch.from_numpy(vol).to(self.device), c)
            else:  # several reflections: on the host
                big = torch.from_numpy(np.pad(vol, c, mode="reflect")
                                       ).to(self.device)
        return zero_extend(big, self.padded_shape)

    def stage_full(self, volume) -> torch.Tensor:
        """The whole padded volume on the device (the same as :meth:`stage`:
        the port has one staged form)."""
        return self.stage(volume)

    # -- forward -----------------------------------------------------------
    @torch.no_grad()
    def forward_slabs(self, slab_for, out: torch.Tensor | None = None,
                      offset=(0, 0, 0), module=None) -> torch.Tensor:
        """The forward over caller-provided slabs: ``slab_for(zs)`` returns
        the ``(tin, py, px)`` window whose planes start at padded-volume z
        ``zs``.  Tiles land in ``out`` (default: a fresh f32 map of
        ``_out_shape`` on the module's device) at ``offset`` plus their grid
        position.  ``module`` (default the spec's) is a copy of it on
        another device, for the multi-device fan-out."""
        module = self.spec.module if module is None else module
        if out is None:
            out = torch.zeros(self._out_shape, dtype=torch.float32,
                              device=next(module.parameters()).device)
        oz, oy, ox = to3d(offset)
        tin, tout = self._tin, self._tiled.tile_out
        dev = out.device
        for zs, batches in self._slabs:
            with span("forward.gather", device=dev):
                slab = slab_for(zs)
            for batch in batches:
                with span("forward.gather", device=dev):
                    tiles = torch.stack([slab[z:z + tin, y:y + tin,
                                              x:x + tin] for z, y, x in batch])
                    x = tiles.to(torch.float32)
                    if tiles.dtype == torch.uint8:
                        x = x * U8_SCALE
                with span("forward.module", device=dev):
                    logits = module(x[..., None])
                with span("forward.scatter", device=dev):
                    probs = torch.sigmoid(logits[..., 0])
                    for (z, y, x_), p in zip(batch, probs):
                        z, y, x_ = oz + zs + z, oy + y, ox + x_
                        out[z:z + tout, y:y + tout, x_:x_ + tout] = p
        return out

    def forward_from(self, big: torch.Tensor, origin=(0, 0, 0),
                     out: torch.Tensor | None = None,
                     offset=(0, 0, 0), module=None) -> torch.Tensor:
        """Forward over the window of a device-resident volume ``big`` that
        starts at ``origin`` (``big[origin : origin + padded_shape]`` is
        what :meth:`stage` would have made for this volume), through
        ``module`` (:meth:`forward_slabs`)."""
        oz, oy, ox = to3d(origin)
        _, py, px = self.padded_shape
        z_top = max(zs for zs, _ in self._slabs) + self._tin
        need = (oz + z_top, oy + py, ox + px)
        if any(n > s for n, s in zip(need, big.shape)):
            raise ValueError(f"staged volume {tuple(big.shape)} ends before "
                             f"{need}")
        return self.forward_slabs(
            lambda zs: big[oz + zs:oz + zs + self._tin, oy:oy + py, ox:ox + px],
            out=out, offset=offset, module=module)

    def forward_staged(self, staged: torch.Tensor) -> torch.Tensor:
        """Staged volume (from :meth:`stage`) -> f32 map of ``_out_shape``
        on the device (the volume's voxels are ``[:vz, :vy, :vx]``)."""
        return self.forward_from(staged)

    def forward_full(self, big: torch.Tensor) -> torch.Tensor:
        """Whole-volume forward over :meth:`stage_full`'s upload."""
        return self.forward_from(big)

    def forward(self, volume) -> torch.Tensor:
        """volume -> f32 map of ``_out_shape`` on the device."""
        return self.forward_staged(self.stage(volume))

    # -- postprocess -------------------------------------------------------
    def quantile_threshold(self, prob: torch.Tensor,
                           inb: torch.Tensor) -> torch.Tensor:
        """The reference's plane-subsampled quantile, in f32: whole z planes
        at a stride that leaves ~2^20 voxels, sorted; the out-of-bounds
        voxels (-inf) sort low, so the in-bounds subset is the top ``n_in``
        slots, interpolated linearly."""
        q = self.threshold_quantile
        stride = max(1, prob.numel() // (1 << 20))
        sub = torch.sort(prob[::stride].reshape(-1)).values
        n_sub = sub.shape[0]
        n_in = max(int(inb[::stride].sum()), 1)
        pos = (torch.tensor(q, dtype=torch.float32)
               * torch.tensor(n_in - 1, dtype=torch.float32))
        lo = int(torch.floor(pos))
        frac = (pos - torch.tensor(lo, dtype=torch.float32)).to(prob.device)
        base = n_sub - n_in
        v0 = sub[min(base + lo, n_sub - 1)]
        v1 = sub[min(base + lo + 1, n_sub - 1)]
        return v0 * (1.0 - frac) + v1 * frac

    @torch.no_grad()
    def postprocess(self, out: torch.Tensor, valid_lo=None, valid_hi=None):
        """f32 map (from :meth:`forward`) -> (NMS Tbars, CC Tbars or None).

        ``valid_lo`` / ``valid_hi`` bound the region (in map coordinates)
        whose voxels are real; outside it the map is -inf."""
        vz, vy, vx = self.vol_shape
        prob, inb = mask_valid_region(
            out[:vz, :vy, :vx],
            (0, 0, 0) if valid_lo is None else valid_lo,
            self.vol_shape if valid_hi is None else valid_hi)
        if self.threshold_quantile is not None:
            thr = self.quantile_threshold(prob, inb)
        else:
            thr = self.threshold
        idx = compact_true_indices(candidate_mask(prob, self.window, thr))
        parts = [idx, prob.reshape(-1)[idx]]
        if self.run_cc:
            parts += components_device(prob, thr)
        host = to_host(*parts)
        nms_det = sort_detections(unravel(host[0], self.vol_shape), host[1])
        cc_det = sort_detections(host[2], host[3]) if self.run_cc else None
        return nms_det, cc_det

    def __call__(self, volume, valid_lo=None, valid_hi=None):
        """volume -> (NMS Tbars, CC Tbars or None)."""
        return self.postprocess(self.forward(volume), valid_lo, valid_hi)
