"""Volume-sharded inference, NMS and CC with halo exchange.

Counterpart of ``flypylib_tpu/parallel/halo.py`` on a port mesh
(``parallel/mesh.py``):

- the volume is sharded along z (1 axis), z and y (2) or z, y and x (3) over
  the named mesh axes, one block per slot (slots along the other axes of
  the mesh stay idle);
- each shard's ``context``-deep boundary slabs go to its neighbours
  (:func:`_exchange_extend`): a device-to-device copy within a process,
  ``torch.distributed`` point-to-point across ranks.  The y exchange ships
  the z-extended block and the x exchange the z+y-extended block, so
  corners arrive by two or three hops and every shard sees exactly the
  monolithic neighbourhood;
- edge shards take the host reflect pads: ONE reflect pad of the original
  volume, zero-extended past the shard grid, where values feed only
  cropped outputs;
- the forward runs per shard on its slot's device (a module copy per
  distinct device), so the map is the monolithic one: every conv is valid.
  :func:`sharded_infer` returns it as a :class:`ShardedMap`, the blocks
  left where they were computed;
- :func:`sharded_nms` repeats the exchange with the NMS window over a
  -inf shell and compacts each shard's candidates with ``torch.nonzero`` in
  global coordinates; :func:`sharded_components` labels each block on its
  device and exports its component stats and boundary label faces, merged
  across seams on the host (``ops/components.merge_component_fragments``).
  Only those lists leave a shard; across ranks they are all-gathered, so
  every rank returns the same list.

Volumes thinner than ``n_shards * context`` along a sharded axis are
served: the shard grid extends past the volume and the extension is cropped
from every result.  ``max_per_shard`` and ``max_components`` are accepted
under their reference names and bound nothing (``torch.nonzero`` compacts
every candidate), so the reference's grow-and-retry is gone.
"""

from __future__ import annotations

import numpy as np
import torch

from flypylib_tpu_torch.infer.pipeline import (as_wire, check_no_variables,
                                               to_host, unravel, zero_extend)
from flypylib_tpu_torch.io.synapses import Tbars
from flypylib_tpu_torch.models.zoo import ModelSpec
from flypylib_tpu_torch.ops.components import (compact_true_indices,
                                               component_stats, label_volume,
                                               merge_component_fragments)
from flypylib_tpu_torch.ops.host_reference import sort_detections
from flypylib_tpu_torch.ops.nms import mask_valid_region, max_filter
from flypylib_tpu_torch.parallel import distributed
from flypylib_tpu_torch.parallel.mesh import Mesh, per_device
from flypylib_tpu_torch.utils import ceil_div, to3d


def _axes_tuple(axis) -> tuple[str, ...]:
    """Mesh axis names sharding (z,), (z, y), or (z, y, x)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(axes) not in (1, 2, 3):
        raise ValueError(f"axis must name 1-3 mesh axes, got {axes}")
    return axes


def _owners(mesh: Mesh, axes):
    """``(grid, {grid position: slot})``: the shard grid (1 along unsharded
    dims) and the slot that holds each block (index 0 along every mesh
    axis the sharding does not name)."""
    names = mesh.axis_names
    ks = [names.index(a) for a in axes]
    grid = tuple(mesh.shape[a] for a in axes) + (1,) * (3 - len(axes))
    owners = {}
    for i, slot in np.ndenumerate(mesh.slots):
        if any(i[k] for k in range(len(names)) if k not in ks):
            continue
        owners[tuple(i[k] for k in ks) + (0,) * (3 - len(axes))] = slot
    return grid, owners


def _local(owners) -> dict:
    me = distributed.rank()
    return {p: s for p, s in owners.items() if s.rank == me}


class ShardedMap:
    """A volume-sharded map: ``blocks`` holds this process's blocks, each on
    its slot's device, keyed by grid position; block ``p`` covers global
    ``[p * extent, (p + 1) * extent)`` of a grid that may extend past the
    volume ``shape`` (those voxels are not part of the map).
    :meth:`gather` (or ``np.asarray``) assembles the map on the host."""

    def __init__(self, mesh: Mesh, axes, grid, extent, shape, blocks):
        self.mesh, self.axes = mesh, tuple(axes)
        self.grid, self.extent = tuple(grid), tuple(extent)
        self.shape = tuple(shape)
        self.blocks = blocks

    def gather(self) -> np.ndarray:
        """The whole map on the host (every rank's blocks)."""
        parts = {}
        for ranks_blocks in distributed.all_gather_objects(
                {p: b.cpu().numpy() for p, b in self.blocks.items()}):
            parts.update(ranks_blocks)
        out = np.empty([g * e for g, e in zip(self.grid, self.extent)],
                       np.float32)
        for p, b in parts.items():
            out[tuple(slice(i * e, (i + 1) * e)
                      for i, e in zip(p, self.extent))] = b
        return out[: self.shape[0], : self.shape[1], : self.shape[2]]

    def __array__(self, dtype=None, copy=None):
        out = self.gather()
        return out if dtype is None else out.astype(dtype)


def _exchange_extend(blocks: dict, owners: dict, grid, dim: int, dlo: int,
                     dhi: int, lo_pad, hi_pad) -> dict:
    """Extend each local block along ``dim`` by ``dlo`` / ``dhi`` planes of
    its neighbours' blocks; edge shards take ``lo_pad(pos)`` /
    ``hi_pad(pos)`` (tensors on the block's device).  Every rank walks the
    same global plan, so a point-to-point send and its receive carry one
    tag.  Blocks share one shape."""
    if not (dlo or dhi):
        return blocks
    me = distributed.rank()
    n = grid[dim]
    got, sends, recvs, keys = {}, [], [], []
    tag = 0
    for pos in sorted(owners):
        for side, depth, step in (("lo", dlo, -1), ("hi", dhi, 1)):
            if not depth or pos[dim] == (0 if side == "lo" else n - 1):
                continue
            src = tuple(p + step * (d == dim) for d, p in enumerate(pos))
            dst_slot, src_slot = owners[pos], owners[src]
            tag += 1
            if src_slot.rank == me:
                b = blocks[src]
                at = b.shape[dim] - depth if side == "lo" else 0
                slab = b.narrow(dim, at, depth)
                if dst_slot.rank == me:
                    got[pos, side] = slab.to(dst_slot.device, non_blocking=True)
                else:
                    sends.append((slab, dst_slot.rank, tag))
            elif dst_slot.rank == me:
                shape = list(blocks[pos].shape)
                shape[dim] = depth
                recvs.append((tuple(shape), blocks[pos].dtype,
                              dst_slot.device, src_slot.rank, tag))
                keys.append((pos, side))
    got.update(zip(keys, distributed.exchange(sends, recvs)))
    out = {}
    for pos, b in blocks.items():
        parts = [b]
        if dlo:
            parts.insert(0, lo_pad(pos) if pos[dim] == 0 else got[pos, "lo"])
        if dhi:
            parts.append(hi_pad(pos) if pos[dim] == n - 1 else got[pos, "hi"])
        out[pos] = torch.cat(parts, dim)
    return out


def _shard_extent(v: int, n: int, minimum: int, spec: ModelSpec | None):
    """Per-shard extent along a sharded dim: >= ceil(v/n), >= minimum, and
    (for models) aligned so shard starts keep the packing/pooling phase and
    shard inputs are valid model sizes."""
    s = max(ceil_div(v, n), minimum, 1)
    if spec is not None and spec.size_multiple > 1:
        mult = spec.size_multiple
        s = ceil_div(s, mult) * mult
        if not spec.is_valid_size(s + 2 * spec.context):
            raise ValueError(
                f"model {spec.name}: no shard extent with aligned starts "
                f"gives a valid input size (size_multiple={mult}, "
                f"size_offset={spec.size_offset}, context={spec.context})")
    return s


def probabilities(logits: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid`` with every element on one code path.  The CPU's
    kernel computes a tail shorter than its vector width in scalar code,
    which rounds 1 ulp apart from the vector code, so a voxel's value would
    follow the size of the block it sits in; on the CPU the flat logits are
    padded to a multiple of 64 first.  A CUDA kernel computes every element
    alike."""
    if logits.device.type != "cpu":
        return torch.sigmoid(logits)
    flat = logits.reshape(-1)
    pad = -flat.numel() % 64
    out = torch.sigmoid(torch.cat([flat, flat.new_zeros(pad)]))
    return out[:flat.numel()].reshape(logits.shape)


def _tile_sweep(module, x: torch.Tensor, c: int, tout: int,
                tile_batch: int) -> torch.Tensor:
    """Batched small-cube tile sweep over one halo-extended block, the
    structure of ``TiledInference.infer``: tiles from the block's corner in
    steps of ``tout``, the block zero-extended to the grid (the extension
    feeds only cropped voxels), batches of ``tile_batch``, the last padded
    with its final corner so every call has the same batch."""
    tin = tout + 2 * c
    bshape = [s - 2 * c for s in x.shape]
    starts, padded = [], []
    for s in bshape:
        k = max(0, ceil_div(s - tout, tout))
        starts.append([i * tout for i in range(k + 1)])
        padded.append(k * tout + tout)
    x = zero_extend(x, [p + 2 * c for p in padded])
    corners = [(z, y, w) for z in starts[0] for y in starts[1]
               for w in starts[2]]
    B = min(tile_batch, len(corners))
    nb = ceil_div(len(corners), B)
    corners += [corners[-1]] * (nb * B - len(corners))
    out = torch.zeros(padded, dtype=torch.float32, device=x.device)
    for i in range(nb):
        cs = corners[i * B:(i + 1) * B]
        tiles = torch.stack([x[z:z + tin, y:y + tin, w:w + tin]
                             for z, y, w in cs])
        probs = probabilities(module(tiles[..., None])[..., 0])
        for (z, y, w), p in zip(cs, probs):
            out[z:z + tout, y:y + tout, w:w + tout] = p
    return out[: bshape[0], : bshape[1], : bshape[2]]


@torch.no_grad()
def sharded_infer(spec: ModelSpec, variables, volume, mesh: Mesh,
                  axis="space", pad_mode: str = "reflect",
                  tile_z: int | None = None, tile_out: int | None = None,
                  tile_batch: int = 8) -> ShardedMap:
    """Volume-sharded whole-volume inference over 1, 2 or 3 mesh axes
    (``axis`` a name, a pair ``(az, ay)`` or a triple ``(az, ay, ax)``).

    Returns the probability map as a :class:`ShardedMap`.  Each shard's
    forward runs over its whole block by default; ``tile_z`` scans it in
    z-subtiles (bounded activation memory), ``tile_out`` runs the batched
    small-cube tile sweep, ``tile_batch`` tiles a call (the fast conv
    regime; tile starts stay aligned to ``size_multiple`` relative to the
    global volume, so the map is ``TiledInference``'s at that tile and
    batch).  uint8 stays uint8 on the host, on the wire and into the
    module, which casts it (as ``TiledInference``); other dtypes become
    f32.  ``variables`` must be None (the module holds its weights).

    Multi-process: every rank passes the same host ``volume`` and uploads
    only its own blocks and edge pads."""
    check_no_variables(variables)
    axes = _axes_tuple(axis)
    grid, owners = _owners(mesh, axes)
    nsh = len(axes)
    c = spec.context
    vol = as_wire(volume)
    v = vol.shape
    ext = tuple(_shard_extent(v[d], grid[d], c, spec) if d < nsh else v[d]
                for d in range(3))
    vp = tuple(g * e for g, e in zip(grid, ext))
    if tile_z is not None:
        if tile_out is not None:
            raise ValueError("pass tile_z or tile_out, not both")
        if ext[0] % tile_z != 0:
            raise ValueError(f"tile_z {tile_z} must divide z-extent {ext[0]}")
        if spec.size_multiple > 1 and tile_z % spec.size_multiple != 0:
            raise ValueError(
                f"tile_z {tile_z} must be a multiple of {spec.size_multiple} "
                "for packing/pooling-phase alignment")
    if tile_out is not None:
        mult = max(spec.size_multiple, 1)
        if tile_out % mult != 0:
            raise ValueError(f"tile_out {tile_out} must be a multiple of "
                             f"{mult} for packing/pooling-phase alignment")
        if not spec.is_valid_size(tile_out + 2 * c):
            raise ValueError(f"tile_out {tile_out} + 2*context is not a "
                             "valid model input size")

    # ONE reflect pad of the original volume (the monolithic padding),
    # zero-extended to the shard grid
    mono = np.pad(vol, c, mode=pad_mode) if c else vol
    full = np.zeros([p + 2 * c for p in vp], vol.dtype)
    full[: v[0] + 2 * c, : v[1] + 2 * c, : v[2] + 2 * c] = mono

    def span(pos, d, extended):
        """``pos``'s range along ``d`` in ``full``: its own planes, or with
        ``extended`` its planes and both halos; an unsharded dim whole."""
        if d >= nsh:
            return slice(0, vp[d] + 2 * c)
        lo = pos[d] * ext[d] + (0 if extended else c)
        return slice(lo, lo + ext[d] + (2 * c if extended else 0))

    def upload(pos, sl):
        return torch.from_numpy(np.ascontiguousarray(full[sl])).to(
            owners[pos].device)

    def edge(dim, hi):
        """The edge-pad function of the exchange along ``dim``: dims before
        it already extended, dims after it not yet."""
        plane = slice(c + vp[dim], 2 * c + vp[dim]) if hi else slice(0, c)

        def pad(pos):
            return upload(pos, tuple(plane if d == dim else
                                     span(pos, d, d < dim) for d in range(3)))

        return pad

    local = _local(owners)
    blocks = {p: upload(p, tuple(span(p, d, False) for d in range(3)))
              for p in local}
    for d in range(nsh):
        blocks = _exchange_extend(blocks, owners, grid, d, c, c,
                                  edge(d, False), edge(d, True))
    modules = per_device(spec.module, [s.device for s in local.values()])
    out = {}
    for p, x in blocks.items():
        module = modules[local[p].device]
        if tile_out is not None:
            out[p] = _tile_sweep(module, x, c, tile_out, tile_batch)
        elif tile_z is None:
            out[p] = probabilities(module(x[None, ..., None])[0, ..., 0])
        else:
            o = torch.empty([s - 2 * c for s in x.shape], dtype=torch.float32,
                            device=x.device)
            for t in range(ext[0] // tile_z):
                xt = x[t * tile_z:t * tile_z + tile_z + 2 * c]
                o[t * tile_z:(t + 1) * tile_z] = probabilities(
                    module(xt[None, ..., None])[0, ..., 0])
            out[p] = o
    return ShardedMap(mesh, axes, grid, ext, v, out)


def _prob_blocks(prob, mesh: Mesh, axes, halo):
    """``(grid, owners, extent, shape, blocks)`` of an f32 map sharded over
    ``axes`` with each block's voxels outside the volume at -inf.  A
    :class:`ShardedMap` on the same mesh and axes, with extents that hold
    ``halo`` (per sharded dim, the deeper side), is used where it lies;
    anything else (numpy, a tensor, another layout) is sharded from the
    host."""
    grid, owners = _owners(mesh, axes)
    nsh = len(axes)
    if isinstance(prob, ShardedMap):
        if prob.mesh is mesh and prob.axes == axes and all(
                prob.extent[d] >= halo[d] for d in range(nsh)):
            blocks = {}
            for p, b in prob.blocks.items():
                hi = [s - i * e for s, i, e in zip(prob.shape, p, prob.extent)]
                blocks[p] = mask_valid_region(b.float(), (0, 0, 0), hi)[0]
            return grid, owners, prob.extent, prob.shape, blocks
        prob = prob.gather()
    if isinstance(prob, torch.Tensor):
        prob = prob.detach().cpu().numpy()
    host = np.asarray(prob, dtype=np.float32)
    v = host.shape
    ext = tuple(max(ceil_div(v[d], grid[d]), halo[d], 1) if d < nsh else v[d]
                for d in range(3))
    host = np.pad(host, [(0, g * e - s) for g, e, s in zip(grid, ext, v)],
                  constant_values=-np.inf)
    blocks = {p: torch.from_numpy(np.ascontiguousarray(host[tuple(
        slice(i * e, (i + 1) * e) for i, e in zip(p, ext))])).to(s.device)
        for p, s in _local(owners).items()}
    return grid, owners, ext, v, blocks


def _globalize(idx: np.ndarray, pos, ext, shape):
    """Block-local flat indices -> global (n, 3) f64 locations, and a mask
    of those inside the volume."""
    locs = unravel(idx, ext) + np.asarray(pos) * np.asarray(ext)
    return locs, (locs < np.asarray(shape)).all(axis=1)


@torch.no_grad()
def sharded_nms(prob, mesh: Mesh, axis="space", window=3,
                threshold: float = 0.5, max_per_shard: int = 1024) -> Tbars:
    """NMS on a sharded probability map with halo exchange (1-D, 2-D or 3-D
    spatial mesh; see :func:`sharded_infer` for ``axis``).  ``prob`` is a
    :class:`ShardedMap` (used where it lies), a numpy array or a tensor.

    Each shard's max filter sees the true neighbour planes through the
    halo, so a voxel at a seam is a candidate iff it is one in a monolithic
    NMS; the candidates are compacted in global coordinates and merged on
    the host.  ``max_per_shard`` is the reference's cap, accepted and
    unused."""
    axes = _axes_tuple(axis)
    nsh = len(axes)
    win = to3d(window)
    lo = [w // 2 if d < nsh else 0 for d, w in enumerate(win)]
    hi = [w - 1 - w // 2 if d < nsh else 0 for d, w in enumerate(win)]
    grid, owners, ext, shape, blocks = _prob_blocks(
        prob, mesh, axes, [max(a, b) for a, b in zip(lo, hi)])

    def neg(dim, depth):
        def pad(pos):
            b = ext_blocks[pos]
            s = list(b.shape)
            s[dim] = depth
            return torch.full(s, -torch.inf, device=b.device)

        return pad

    ext_blocks = blocks
    for d in range(nsh):
        ext_blocks = _exchange_extend(ext_blocks, owners, grid, d, lo[d],
                                      hi[d], neg(d, lo[d]), neg(d, hi[d]))
    locs, conf = [], []
    for p, slab in blocks.items():
        mf = max_filter(ext_blocks[p], win)[lo[0]:lo[0] + ext[0],
                                            lo[1]:lo[1] + ext[1],
                                            lo[2]:lo[2] + ext[2]]
        idx = compact_true_indices((slab == mf) & (slab >= threshold))
        i, c = to_host(idx, slab.reshape(-1)[idx])
        g, inside = _globalize(i, p, ext, shape)
        locs.append(g[inside])
        conf.append(c[inside])
    parts = distributed.all_gather_objects(
        (np.concatenate(locs) if locs else np.zeros((0, 3)),
         np.concatenate(conf) if conf else np.zeros((0,))))
    return sort_detections(np.concatenate([p[0] for p in parts]),
                           np.concatenate([p[1] for p in parts]))


@torch.no_grad()
def sharded_components(prob, mesh: Mesh, axis="space",
                       threshold: float = 0.5,
                       max_components: int = 1024) -> Tbars:
    """Connected components on a sharded probability map with an exact
    cross-shard seam merge (1-D, 2-D or 3-D spatial mesh).

    Each shard labels its block on its device (``ops/components.
    label_volume``, ``component_stats``) and exports its component stats
    and the label planes of its faces along the sharded dims; the host
    unions components whose boundary voxels are 6-adjacent across a seam
    (``merge_component_fragments``), so centroids and confidences equal a
    monolithic run's.  ``max_components`` is the reference's cap, accepted
    and unused."""
    axes = _axes_tuple(axis)
    nsh = len(axes)
    grid, owners, ext, shape, blocks = _prob_blocks(prob, mesh, axes,
                                                    [0, 0, 0])
    frags = {}
    for p, slab in blocks.items():
        mask = slab >= threshold
        lab = label_volume(mask)
        faces = [lab[0], lab[-1], lab[:, 0], lab[:, -1], lab[:, :, 0],
                 lab[:, :, -1]][: 2 * nsh]
        uniq, sums, count, conf, *fh = to_host(
            *component_stats(slab, lab, compact_true_indices(mask)), *faces)
        count = count.astype(np.int64)
        corner = np.asarray(p, np.int64) * np.asarray(ext, np.int64)
        frags[p] = {
            "uniq": uniq.astype(np.int64),
            "sums": sums.astype(np.int64) + corner * count[:, None],
            "count": count, "conf": conf,
            "valid": np.ones(count.shape, bool),
            # faces of unsharded dims never meet a neighbour
            "faces": [f.astype(np.int64) for f in fh]
                     + [None] * (6 - len(fh)),
        }
    for part in distributed.all_gather_objects(frags):
        frags.update(part)
    det = merge_component_fragments(frags, int(np.prod(ext)))
    if len(det) == 0:
        return det
    keep = (det.locs < np.asarray(shape)).all(axis=1)
    return Tbars(locs=det.locs[keep], conf=det.conf[keep])
