"""Overlap-tiled fully-convolutional whole-volume inference.

Counterpart of ``flypylib_tpu/infer/tiled.py`` (``TiledInference``,
``infer_volume``, ``tiling_regime``, ``default_tiling``): pad the volume by
the model's valid-conv context, cut it into equal tiles, run the network on
batches of tiles, stitch the outputs into the full probability map.

- **Static tile shapes**: every tile has the same input shape; the tile
  grid extends past the volume (extra voxels cropped) instead of changing
  shapes at the edges.
- **Padding**: the volume is reflect-padded by exactly ``context`` on every
  face once, on the host (matching a monolithic run), then zero-extended on
  the high side to fill the tile grid; the extension only feeds output
  voxels that are cropped away.  With ``pad_mode="none"`` the caller hands
  in a pre-padded window (``ops/matching.py::voxel_pr_streaming``) and the
  output is ``2 * context`` smaller on each axis.
- **Device sweep**: the padded volume is uploaded once (uint8 stays uint8:
  the cast to the model dtype is exact on the device); each tile batch is
  sliced, run, passed through a sigmoid and written into a preallocated f32
  map on the device.  The last batch is padded by repeating the final
  corner — duplicate writes are bitwise identical.
- **Host streaming** (``infer(host_stream=True)``, for volumes whose padded
  input and map do not fit the device together): the padded volume stays
  on the host; each tile batch is gathered into one of two pinned buffers
  and copied to the card on a side stream while the forward before it runs,
  events ordering each copy before the forward that reads it and each
  forward before the next copy into its buffer (:func:`stream_tiles`).
  The tiles are the device sweep's, so the map is bitwise the same.

Valid convolutions make tiled output bitwise equal to a monolithic run.
"""

from __future__ import annotations

import numpy as np
import torch

from flypylib_tpu_torch.models.zoo import ModelSpec, UNetValid
from flypylib_tpu_torch.ops.packed_unet import PackedUNet
from flypylib_tpu_torch.utils import ceil_div, to3d


class TiledInference:
    def __init__(self, spec: ModelSpec, tile_out: int = 64, tile_batch: int = 1,
                 pad_mode: str = "reflect"):
        """``pad_mode`` is ``"reflect"`` (the context halo is reflected, as
        in a monolithic run) or ``"none"`` (the volume passed to
        :meth:`infer` is already padded)."""
        if pad_mode not in ("reflect", "none"):
            raise ValueError(
                f"pad_mode must be 'reflect' or 'none', got {pad_mode!r}")
        self.spec = spec
        self.pad_mode = pad_mode
        ctx = spec.context
        # choose tile input size valid for the model, derive the true tile_out
        tin = spec.valid_size(tile_out + 2 * ctx)
        self.tile_in = tin
        self.tile_out = tin - 2 * ctx
        self.ctx = ctx
        self.tile_batch = tile_batch
        # tile starts must preserve pooling phase: stride multiple of this
        self.align = spec.size_multiple
        self.stride = (self.tile_out // self.align) * self.align
        if self.stride <= 0:
            raise ValueError(
                f"tile_out {self.tile_out} smaller than alignment {self.align}"
            )

    @property
    def device(self) -> torch.device:
        return next(self.spec.module.parameters()).device

    def _axis_plan(self, size: int) -> tuple[list[int], int]:
        """(aligned tile starts, padded output extent) for one axis."""
        k = max(0, ceil_div(size - self.tile_out, self.stride))
        starts = [i * self.stride for i in range(k + 1)]
        return starts, k * self.stride + self.tile_out

    def plan(self, shape):
        """(tile corners, padded output shape) for a (z, y, x) volume."""
        shape = to3d(shape)
        per_axis = [self._axis_plan(s) for s in shape]
        corners = [
            (z, y, x)
            for z in per_axis[0][0]
            for y in per_axis[1][0]
            for x in per_axis[2][0]
        ]
        padded_shape = tuple(p[1] for p in per_axis)
        return corners, padded_shape

    def n_batches(self, shape) -> int:
        """Tile batches (forward calls) that :meth:`infer` runs for ``shape``."""
        return ceil_div(len(self.plan(shape)[0]), self.tile_batch)

    @torch.no_grad()
    def infer(self, volume: np.ndarray, keep_on_device: bool = False,
              host_stream: bool = False):
        """Full-volume probability map, same shape as ``volume`` (``2 *
        context`` smaller per axis with ``pad_mode="none"``): a numpy f32
        array, or with ``keep_on_device=True`` an f32 tensor on the model's
        device.  The padded volume is uploaded whole, or with
        ``host_stream=True`` stays on the host and goes to the device one
        tile batch at a time, double-buffered (the same map, bit for bit)."""
        vol = np.asarray(volume)
        if vol.dtype != np.uint8:
            vol = vol.astype(np.float32)
        c = self.ctx
        if self.pad_mode == "none":
            # a pre-padded window; the pooling phase is the caller's to align
            shape = tuple(s - 2 * c for s in vol.shape)
            if any(s <= 0 for s in shape):
                raise ValueError(f"pre-padded window {vol.shape} smaller "
                                 f"than 2*context={2 * c}")
            padded = vol
        else:
            shape = vol.shape
            padded = np.pad(vol, c, mode="reflect") if c else vol
        corners, out_shape = self.plan(shape)
        padded = np.pad(padded, [(0, os - s) for s, os in zip(shape, out_shape)])

        B, tin, tout = self.tile_batch, self.tile_in, self.tile_out
        n_batches = ceil_div(len(corners), B)
        corners = corners + [corners[-1]] * (n_batches * B - len(corners))

        device = self.device
        batches = [corners[bi * B:(bi + 1) * B] for bi in range(n_batches)]
        if host_stream:
            tile_batches = stream_tiles(padded, batches, tin, device)
        else:
            src = torch.from_numpy(padded).to(device)
            tile_batches = (
                torch.stack([src[z:z + tin, y:y + tin, x:x + tin]
                             for z, y, x in cs])
                for cs in batches)
        out = torch.zeros(out_shape, dtype=torch.float32, device=device)
        module = self.spec.module
        for cs, tiles in zip(batches, tile_batches):
            probs = torch.sigmoid(module(tiles[..., None])[..., 0])
            for (z, y, x), p in zip(cs, probs):
                out[z:z + tout, y:y + tout, x:x + tout] = p
        out = out[: shape[0], : shape[1], : shape[2]].contiguous()
        return out if keep_on_device else out.cpu().numpy()


def stream_tiles(padded: np.ndarray, batches, tin: int, device):
    """Yield, in order, each batch of ``tin``^3 tiles of the host array
    ``padded`` (``batches``: lists of (z, y, x) corners of one length) as a
    tensor on ``device``: ``(B, tin, tin, tin)`` of ``padded``'s dtype.

    On a CUDA device two pinned host buffers and two device buffers take
    turns: batch i + 1 is gathered on the host and copied on a side stream
    (``non_blocking``) while the forward of batch i runs.  Events order
    each copy before the forward that reads it (the current stream waits
    on ``copied``) and each forward before the next copy into its device
    buffer (the side stream waits on ``read``, recorded when the consumer
    asks for the next batch, after it has queued its forward); the host
    waits for a copy to leave a pinned buffer before it refills it.  A
    yielded tensor is valid until the next one is asked for.  On the CPU
    each batch is the stacked host tiles."""
    shape = (len(batches[0]), tin, tin, tin) if batches else None
    if device.type != "cuda":
        for cs in batches:
            yield torch.from_numpy(np.stack(
                [padded[z:z + tin, y:y + tin, x:x + tin] for z, y, x in cs]))
        return
    dtype = torch.from_numpy(padded[:0, :0, :0]).dtype
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    host = [torch.empty(shape, dtype=dtype, pin_memory=True) for _ in range(2)]
    dev = [torch.empty(shape, dtype=dtype, device=device) for _ in range(2)]
    copied = [torch.cuda.Event() for _ in range(2)]
    read = [torch.cuda.Event() for _ in range(2)]

    def issue(i: int) -> None:
        k = i % 2
        copied[k].synchronize()  # the last copy out of host[k] has finished
        hv = host[k].numpy()
        for j, (z, y, x) in enumerate(batches[i]):
            hv[j] = padded[z:z + tin, y:y + tin, x:x + tin]
        with torch.cuda.stream(side):
            side.wait_event(read[k])  # the forward that read dev[k] is done
            dev[k].copy_(host[k], non_blocking=True)
            copied[k].record(side)

    if batches:
        issue(0)
    for i in range(len(batches)):
        if i + 1 < len(batches):
            issue(i + 1)
        k = i % 2
        main.wait_event(copied[k])
        yield dev[k]
        read[k].record(main)


def infer_volume(spec: ModelSpec, volume: np.ndarray, tile_out: int = 64,
                 tile_batch: int = 1, keep_on_device: bool = False):
    """One-shot convenience wrapper around TiledInference."""
    return TiledInference(spec, tile_out=tile_out, tile_batch=tile_batch).infer(
        volume, keep_on_device=keep_on_device
    )


def tiling_regime(spec: ModelSpec) -> str:
    """``"cover"`` (pooling topologies want one big tile) or ``"grid"``
    (conv stacks want batched small tiles), from the module topology;
    ``spec.metadata["tiling"]`` overrides."""
    regime = spec.metadata.get("tiling")
    if regime is not None:
        return regime
    return "cover" if isinstance(spec.module, (UNetValid, PackedUNet)) else "grid"


def default_tiling(spec: ModelSpec, vol_shape,
                   max_tile_in: int = 428) -> tuple[int, int]:
    """Default ``(tile_out, tile_batch)`` for a volume: the reference's
    choice, unchanged, so that the port tiles exactly as the JAX package.

    - ``"cover"`` (the U-Net, plain or packed): one covering tile, batch 1,
      whenever its input is at most ``max_tile_in``; larger volumes get the
      largest valid tile under the cap, batch 1.
    - ``"grid"`` (conv stacks): 64-wide tiles, batch up to 8 bounded by
      the grid size.

    Both were chosen on a TPU: ``max_tile_in=428`` is the tile input at
    which the reference's U-Net forward still compiled on a 16 GB TPU v5e.
    Neither has been re-measured on a GPU."""
    dims = to3d(vol_shape)
    ctx = spec.context
    if tiling_regime(spec) == "cover":
        ext = max(dims)
        if spec.valid_size(ext + 2 * ctx) <= max_tile_in:
            return ext, 1
        # largest valid tile input under the cap
        tin = max_tile_in
        while tin > spec.min_size and not spec.is_valid_size(tin):
            tin -= 1
        return max(tin - 2 * ctx, spec.size_multiple), 1
    tile = 64
    n_tiles = 1
    for d in dims:
        n_tiles *= max(1, -(-d // tile))
    return tile, max(1, min(8, n_tiles))


def grid_tiling_min_cost(spec: ModelSpec, vol_shape,
                         max_tile_in: int = 428) -> tuple[int, int]:
    """``(tile_out, tile_batch)`` minimising the total tile input voxels
    (tile count x tile_in^3) of a whole-volume grid, over the valid,
    phase-aligned tiles with ``tile_in <= max_tile_in``; batch 1.  The
    reference's choice for the shared whole-volume forward of "cover"
    models (the U-Net), unchanged, including the TPU-chosen 428 cap; on
    ties the larger tile wins.  Falls back to :func:`default_tiling` when
    no tile fits under the cap."""
    dims = to3d(vol_shape)
    ctx = spec.context
    mult = max(spec.size_multiple, 1)
    best, best_cost = None, None
    t = mult
    while True:
        tin = spec.valid_size(t + 2 * ctx)
        if tin > max_tile_in:
            break
        tout = tin - 2 * ctx
        stride = (tout // mult) * mult
        if stride > 0:
            n = 1
            for d in dims:
                n *= max(0, ceil_div(max(0, d - tout), stride)) + 1
            cost = n * tin**3
            if best is None or cost <= best_cost:
                best, best_cost = tout, cost
        t = tout + mult  # the next distinct valid size
    if best is None:
        return default_tiling(spec, vol_shape, max_tile_in)
    return best, 1
