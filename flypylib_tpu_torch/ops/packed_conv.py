"""Space-to-depth packed inference engine for ConvStack models, in PyTorch.

Counterpart of ``flypylib_tpu/ops/packed_conv.py`` (inference only), plus
``convT_packed_weight`` of ``ops/packed_unet.py``.  A volume is packed
2x2x2 -> 8 channels; a valid 3^3 conv on the full lattice is then a valid
2^3 conv on the packed lattice with 8x the channels, whose kernel embeds the
27 original taps exactly (the other slots are zeros).  A dilation-d conv
(d = 2^k >= 2) only connects voxels of equal coordinates mod d, so on the
packed tensor the 8 parity channel groups are the d = 2 sub-lattices:
:class:`PackedConvStack` runs a ConvStack's dilation-1 lead layers packed
("stage A"), relays the parity groups out into the batch
(:func:`parity_batch`, K5 on the card), and runs the dilated layers as
dilation-1 convs on the lattices ("stage B"), splitting parities again
wherever the lattice step is below the dilation.  :func:`packed_spec`
exports the packed model's stricter size constraints as a drop-in
``ModelSpec``; the U-Net's engine is ``ops/packed_unet.py``.

The reference spells pack and unpack twice (one 8-D transpose, and the
per-axis ``_iv`` forms chosen for TPU layouts); both give the same values,
so the port has one of each.  Training (:meth:`PackedConvStack.
forward_train`) differentiates the same forward: :func:`parity_batch` goes
through :class:`ParityBatch` (K5 forward, the inverse relayout backward),
the counterpart of the reference's custom VJP; stage B's convs go through
:class:`PackedConv` (their input gradient a forward conv, not the
library's input gradient); every other op is a PyTorch op with its own
gradient.  Left out of the reference: the custom VJPs of ``parity_split``
/ ``parity_merge`` (plain reshapes here, differentiable as they stand),
the optimization barriers, the split-weight bf16 logits (the port keeps
the plain ConvStack's f32 logits, which the reference's docstring puts
~1e-6 relative from them, and which its ``forward_train`` uses) and
``stage_b="group"`` (measured and rejected there).

At inference on the card, each dilation-1 conv + bias + ReLU on the packed
lattice (:func:`packed_conv_relu`: stage A's convs, and the U-Net's but its
folds) is one launch of K2's wgmma stage kernel
(:func:`~flypylib_tpu_torch.ops.tail.stage_bias_relu`), whose epilogue
rounds as :func:`_epilogue` does, in place of a cuDNN conv and two
elementwise passes; :func:`fused_route` is the rule.

A BatchNorm ``ConvStack`` runs packed at inference as in the reference:
each BN is folded into the conv's epilogue from the running statistics
(``BatchNorm.affine``: scale and shift in f32, cast to the model dtype; ``y
+ b``, then ``y * scale + shift``, then ReLU).  That is eval-mode
semantics, so ``forward_train`` refuses such a model, as the reference's.
"""

from __future__ import annotations

import functools
import weakref
from itertools import product

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flypylib_tpu_torch.ops.conv import conv3d_f32, no_tf32
from flypylib_tpu_torch.ops.split import parity_split_kernel
from flypylib_tpu_torch.ops.tail import stage_bias_relu, stage_weights
from flypylib_tpu_torch.utils.metrics import count

_PARITY = list(product(range(2), repeat=3))  # (pz, py, px), px fastest


def pack_volume(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, D/2, H/2, W/2, 8C); dims must be even.

    Packed channel index = ((pz*2 + py)*2 + px)*C + c: cell r and parity p
    encode the original position 2r + p on each axis."""
    b, d, h, w, c = x.shape
    if d % 2 or h % 2 or w % 2:
        raise ValueError(f"pack_volume needs even spatial dims, got {tuple(x.shape)}")
    x = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, d // 2, h // 2, w // 2, 8 * c)


def unpack_volume(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_volume`: (B, D, H, W, 8C) -> (B, 2D, 2H, 2W, C)."""
    b, d, h, w, c8 = x.shape
    c = c8 // 8
    x = x.reshape(b, d, h, w, 2, 2, 2, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, 2 * d, 2 * h, 2 * w, c)


@functools.cache
def _tap_matrix() -> np.ndarray:
    """A[t, u, s, k] = 1 iff 2t + u - s == k (per-axis packed-tap map)."""
    a = np.zeros((2, 2, 2, 3), np.float32)
    for t, u, s in product(range(2), repeat=3):
        k = 2 * t + u - s
        if 0 <= k <= 2:
            a[t, u, s, k] = 1.0
    return a


@functools.cache
def _tap_index() -> np.ndarray:
    """Over (tz,ty,tx, uz,uy,ux, sz,sy,sx): the flat index (kz*3+ky)*3+kx
    of the 3^3 tap each packed slot holds (per axis the k of
    :func:`_tap_matrix`), or 27 for a slot that holds no tap."""
    t, u, s, k = np.nonzero(_tap_matrix())
    k1 = np.full((2, 2, 2), -1)
    k1[t, u, s] = k
    idx = np.full((2,) * 9, 27, np.int64)
    for tz, ty, tx, uz, uy, ux, sz, sy, sx in product(range(2), repeat=9):
        kz, ky, kx = k1[tz, uz, sz], k1[ty, uy, sy], k1[tx, ux, sx]
        if min(kz, ky, kx) >= 0:
            idx[tz, ty, tx, uz, uy, ux, sz, sy, sx] = (kz * 3 + ky) * 3 + kx
    return idx


def pack_weight_d1(w: torch.Tensor) -> torch.Tensor:
    """(3,3,3,Ci,Co) valid-conv kernel -> (2,2,2,8Ci,8Co) packed kernel.

    y[2r+s] = sum_delta w[delta] x[2r+s+delta]; writing s+delta = 2t+u gives
    the packed tap (t) / input-parity (u) / output-parity (s) map of
    :func:`_tap_matrix`.  Every slot holds one original tap or zero, so the
    kernel is gathered, with no arithmetic: exact in any dtype."""
    kz, ky, kx, ci, co = w.shape
    if (kz, ky, kx) != (3, 3, 3):
        raise ValueError(f"pack_weight_d1 needs a 3^3 kernel, got {tuple(w.shape)}")
    taps = torch.cat([w.reshape(27, ci, co), w.new_zeros(1, ci, co)])
    wp = taps[torch.from_numpy(_tap_index()).to(w.device)]
    # (tz,ty,tx, uz,uy,ux, sz,sy,sx, ci, co) -> (..., uz,uy,ux, ci, sz,sy,sx, co)
    wp = wp.permute(0, 1, 2, 3, 4, 5, 9, 6, 7, 8, 10)
    return wp.reshape(2, 2, 2, 8 * ci, 8 * co)


def convT_packed_weight(k: torch.Tensor) -> torch.Tensor:
    """(2,2,2,Ci,Co) ConvTranspose kernel -> (Ci, 8Co) matrix whose output
    channels are parity-major packed.  Flax's ConvTranspose computes
    ``out[2r+p] = x[r] @ K[1-p]`` for kernel == stride == 2, so parity p
    reads the flipped tap.  (Re-exported by ``ops.packed_unet``, the
    reference's module for it.)"""
    return torch.cat([k[1 - pz, 1 - py, 1 - px] for pz, py, px in _PARITY],
                     dim=-1)


def parity_split(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> (8B, D/2, H/2, W/2, C): batch the 8 parity
    sub-lattices (new batch = b*8 + ((pz*2+py)*2+px)); dims must be even."""
    b, d, h, w, c = x.shape
    if d % 2 or h % 2 or w % 2:
        raise ValueError(f"parity_split needs even spatial dims, got {tuple(x.shape)}")
    x = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b * 8, d // 2, h // 2, w // 2, c)


def parity_merge(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`parity_split`."""
    b8, d, h, w, c = x.shape
    x = x.reshape(b8 // 8, 2, 2, 2, d, h, w, c)
    x = x.permute(0, 4, 1, 5, 2, 6, 3, 7)
    return x.reshape(b8 // 8, 2 * d, 2 * h, 2 * w, c)


def parity_unbatch(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`parity_batch`: (8B, d, h, w, c) -> (B, d, h, w, 8c)."""
    b8, d, h, w, c = x.shape
    x = x.reshape(b8 // 8, 8, d, h, w, c).permute(0, 2, 3, 4, 1, 5)
    return x.reshape(b8 // 8, d, h, w, 8 * c)


class ParityBatch(torch.autograd.Function):
    """:func:`parity_batch` with a gradient (the reference's
    ``_mk_parity_vjp(_parity_batch_impl, _parity_unbatch_impl)``,
    ``packed_conv.py:197-235``).  Forward: K5 (``parity_split_kernel``, its
    plain version on the CPU), which writes a fresh tensor that autograd
    cannot see into.  Backward: the inverse relayout,
    ``parity_unbatch(g).contiguous()``; the reference's backward is an XLA
    transpose, not a Pallas kernel, so this is no kernel either."""

    @staticmethod
    def forward(ctx, x):
        return parity_split_kernel(x)

    @staticmethod
    def backward(ctx, g):
        return parity_unbatch(g).contiguous()


def parity_batch(x: torch.Tensor) -> torch.Tensor:
    """Packed parity-major channels -> parity-batched lattices: (B, d, h, w,
    8c) -> (8B, d, h, w, c) with new batch b*8 + parity.  The stage-A /
    stage-B boundary relayout: K5 (:func:`~flypylib_tpu_torch.ops.split.
    parity_split_kernel`) on a CUDA tensor, its plain version on a CPU one;
    through :class:`ParityBatch` when grad is enabled."""
    if torch.is_grad_enabled():
        return ParityBatch.apply(x)
    return parity_split_kernel(x)


def _fprop(x: torch.Tensor, w: torch.Tensor, padding=0) -> torch.Tensor:
    """Conv of NDHWC ``x`` with DHWIO ``w`` of its dtype (``x`` zero-padded
    by ``padding`` on each side), summed in f32 and rounded to ``x.dtype``
    once: a bf16 cuDNN conv on the card (f32 accumulators), else
    :func:`~flypylib_tpu_torch.ops.conv.conv3d_f32` (TF32 off, oneDNN off)."""
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                     padding=padding)
        return y.permute(0, 2, 3, 4, 1)
    return conv3d_f32(x, w, padding=padding).to(x.dtype)


class PackedConv(torch.autograd.Function):
    """:func:`_conv` with a gradient (``apply(x, w)``, ``w`` of ``x``'s
    dtype).  Forward: :func:`_fprop`, the call the engine makes without
    grad.  Backward, as every conv gradient here summed in f32 and rounded
    to the model dtype once:

    - ``dx`` is itself a forward valid conv: the output gradient zero-padded
      by ``k - 1`` a side (the conv's ``padding``), against the kernel
      flipped on all three axes with Ci and Co swapped, through
      :func:`_fprop`.  These are the products of the library's input
      gradient, in another order.  On the card cuDNN's own input gradient
      of the packed baseline's stage-B layer 2 (32 into 48 channels on the
      (256, 15^3) parity lattices of a batch of 32) runs a grouped direct
      kernel for ~34 ms, its forward conv ~0.7 ms; at the other 3^3 convs
      measured the forward conv runs from 0.6 ms faster to 0.3 ms slower
      (PERF.md §5-6).
    - ``dw`` is ``torch.nn.grad.conv3d_weight`` of the model-dtype values
      (at least f32 on the CPU), TF32 off, as :class:`~flypylib_tpu_torch.ops.conv.
      Conv3dBiasReLU`'s.

    A conv whose ``x`` needs a gradient adds 1 to the tracer's counter
    ``packed_dgrad_fprop`` when its forward runs (the backward runs on
    autograd's thread, outside the step's spans)."""

    @staticmethod
    def forward(ctx, x, w):
        if ctx.needs_input_grad[0]:
            count("packed_dgrad_fprop", 1)
        ctx.save_for_backward(x, w)
        return _fprop(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dt = x.dtype
        g = g.contiguous()
        dx = dw = None
        with no_tf32(x.device):
            if ctx.needs_input_grad[0]:
                pad = tuple(k - 1 for k in w.shape[:3])
                dx = _fprop(g, w.flip((0, 1, 2)).transpose(3, 4), pad)
            if ctx.needs_input_grad[1]:
                ct = dt if x.device.type == "cuda" else torch.promote_types(
                    dt, torch.float32)
                wshape = w.permute(4, 3, 0, 1, 2).shape           # OIDHW
                dw = torch.nn.grad.conv3d_weight(
                    x.to(ct).permute(0, 4, 1, 2, 3), wshape,
                    g.to(ct).permute(0, 4, 1, 2, 3))
                dw = dw.to(dt).permute(2, 3, 4, 1, 0)             # DHWIO
        return dx, dw


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Valid conv of NDHWC ``x`` with DHWIO ``w``, summed in f32 and rounded
    to ``x.dtype`` once (the reference's ``_conv``, an XLA conv in the
    compute dtype): :func:`_fprop` on ``w`` cast to ``x.dtype``.

    Under grad, a conv whose ``x`` needs a gradient and whose kernel spans
    3 or more taps a side (stage B's convs) goes through
    :class:`PackedConv`; the 2^3 convs on the packed lattice keep
    autograd's library gradients, whose input gradient was as fast as the
    forward conv's or faster at all but one of the 14 packed 2^3 shapes
    measured on the card, and which cost less host time a step (PERF.md
    §6)."""
    w = w.to(x.dtype)
    if torch.is_grad_enabled() and x.requires_grad and w.shape[0] >= 3:
        return PackedConv.apply(x, w)
    return _fprop(x, w)


def _epilogue(y: torch.Tensor, conv, norm=None, tile: int = 1) -> torch.Tensor:
    """The reference's ``_epilogue``: ``y`` (a conv rounded to its dtype)
    plus the dtype bias, then, with ``norm`` (a ``BatchNorm``), ``y * scale
    + shift`` from its running statistics (f32, cast to the dtype), then
    ReLU; the channel vectors repeated ``tile`` times (8 on the packed
    lattice, one per parity group)."""
    dt = y.dtype
    y = y + conv.bias.to(dt).repeat(tile)
    if norm is not None:
        scale, shift = norm.affine()
        y = y * scale.to(dt).repeat(tile) + shift.to(dt).repeat(tile)
    return torch.relu(y)


def fused_route(x: torch.Tensor, co: int, norm=None) -> bool:
    """Whether :func:`packed_conv_relu` on a CUDA tensor ``x`` runs its conv
    of ``co`` packed output channels as one launch of K2's wgmma stage
    kernel: ``x`` bf16, grad off, no BatchNorm to fold (``norm`` None), Ci
    and Co multiples of 8, ``x`` contiguous and on a 16-byte boundary (the
    kernel's tensor-map rules).  Every other call (f32, training under
    grad, a folded BatchNorm) keeps cuDNN and :func:`_epilogue`."""
    return (x.dtype == torch.bfloat16 and not torch.is_grad_enabled()
            and norm is None and x.dim() == 5 and x.shape[-1] % 8 == 0
            and co % 8 == 0 and x.is_contiguous() and x.data_ptr() % 16 == 0)


# conv -> {device: (weight ref, bias ref, version key, StageWeights)}; held
# beside the module, not on it, so a deep copy of the module (a replica on
# another device) neither carries nor pins the images of the original
_STAGE_OPERANDS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _stage_operands(conv, device: torch.device):
    """``conv``'s packed weight and its bias on all 8 parity groups as the
    wgmma stage kernel reads them (:func:`~flypylib_tpu_torch.ops.tail.
    stage_weights`), on ``device``: built once per version of the two
    parameters and kept while ``conv`` lives, so a forward's launches do no
    host work on them.  A version is the parameter object and its
    ``_version`` (bumped by every in-place write), storage and dtype (which
    a ``.data`` assignment or a ``Module.to`` changes without a bump)."""
    w, b = conv.weight, conv.bias
    key = tuple((t._version, t.data_ptr(), t.dtype) for t in (w, b))
    held = _STAGE_OPERANDS.setdefault(conv, {})
    got = held.get(device)
    if (got is not None and got[0]() is w and got[1]() is b
            and got[2] == key):
        return got[3]
    dt = torch.bfloat16
    sw = stage_weights(pack_weight_d1(w.detach().to(device, dt)),
                       b.detach().to(device, dt).repeat(8))
    held[device] = (weakref.ref(w), weakref.ref(b), key, sw)
    return sw


def packed_conv_relu(x: torch.Tensor, conv, norm=None) -> torch.Tensor:
    """``conv``'s valid 3^3 conv (dilation 1) + bias (+ ``norm``'s folded
    BatchNorm) + ReLU on the packed lattice: the 2^3 conv against
    ``pack_weight_d1``, rounded to ``x.dtype``, then :func:`_epilogue` on
    all 8 parity groups.  On a CUDA tensor that :func:`fused_route` takes,
    the same in one launch of K2's wgmma stage kernel (one count of the
    tracer's ``packed_conv_fused``)."""
    if x.device.type == "cuda" and fused_route(x, 8 * conv.weight.shape[-1],
                                               norm):
        count("packed_conv_fused", 1)
        return stage_bias_relu(x, _stage_operands(conv, x.device))
    dt = x.dtype
    y = _conv(x, pack_weight_d1(conv.weight.to(dt)))
    return _epilogue(y, conv, norm, tile=8)


class PackedConvStack(nn.Module):
    """Inference module running a ``ConvStack`` in packed layout.

    It holds the inner module (``self.inner``) and reads its parameters
    (and a BatchNorm stack's running statistics) at each forward, so the
    two share one set of weights.  Dilations must be powers of two and
    non-decreasing.  Each conv is summed in f32 and rounded to the model
    dtype, then the dtype bias is added, a BatchNorm folded in, and ReLU
    applied (the reference's ``_conv`` + ``_epilogue``)."""

    def __init__(self, inner):
        super().__init__()
        dils = [int(c.dilation) for c in inner.convs]
        for i, d in enumerate(dils):
            if d < 1 or d & (d - 1):
                raise ValueError(f"dilation {d} is not a power of two")
            if i and d < dils[i - 1]:
                raise ValueError(f"dilation schedule {dils} must be non-decreasing")
        self.inner = inner
        self.dilations = dils
        self.n_lead = next((i for i, d in enumerate(dils) if d > 1), len(dils))

    @property
    def dtype(self) -> torch.dtype:
        return self.inner.dtype

    def _norm(self, i: int):
        """Layer ``i``'s BatchNorm, or None without BatchNorm."""
        return self.inner.norms[i] if self.inner.use_batchnorm else None

    def apply_stage_a(self, x: torch.Tensor) -> torch.Tensor:
        """Phase 1: cast, pack, the dilation-1 lead convs on the packed
        lattice, then :func:`parity_batch`.  Returns the parity-batched
        stage-B input ``(8B, d, h, w, c)`` (the cast input when the model
        has no dilation-1 lead)."""
        dt = self.dtype
        x = x.to(dt)
        if not self.n_lead:
            return x
        x = pack_volume(x)
        for i, conv in enumerate(self.inner.convs[: self.n_lead]):
            x = packed_conv_relu(x, conv, self._norm(i))
        return parity_batch(x.contiguous())

    def apply_stage_b(self, x: torch.Tensor) -> torch.Tensor:
        """Phase 2: the dilated convs as dilation-1 convs on the parity
        lattices, the head, the f32 logits, and one :func:`parity_merge`
        per lattice level back to full resolution."""
        inner = self.inner
        dt = self.dtype
        level = 1 if self.n_lead else 0
        for i in range(self.n_lead, len(inner.convs)):
            conv, d = inner.convs[i], self.dilations[i]
            while (1 << level) < d:
                x = parity_split(x)
                level += 1
            if (1 << level) != d:
                raise ValueError(f"dilation {d} below current lattice step {1 << level}")
            x = _epilogue(_conv(x, conv.weight.to(dt)), conv, self._norm(i))
        x = torch.relu(inner.head(x, dt))
        x = inner.logits(x, torch.float32)
        for _ in range(level):
            x = parity_merge(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, S, 1) -> (B, S - 2 context, ..., 1) f32 logits."""
        return self.apply_stage_b(self.apply_stage_a(x))

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        """The differentiable packed forward (the reference's
        ``forward_train``, ``packed_conv.py:412-431``): the forward itself,
        stage A and stage B with the f32 logits, K5 through
        :class:`ParityBatch`.  The packed rewrite re-associates the plain
        stack's multiply-adds exactly, so its gradient optimizes the same
        objective up to rounding, on the inner module's parameters (an
        optimizer over ``inner.parameters()`` trains what the inference
        engine reads).  A BatchNorm stack raises: the packed epilogue folds
        the running statistics, which is inference-mode semantics."""
        if self.inner.use_batchnorm:
            raise ValueError(
                "packed training requires use_batchnorm=False (the "
                "packed epilogue folds inference-mode running stats)")
        return self.forward(x)


def _packed_out_size(s: int, dilations: tuple[int, ...]) -> int | None:
    """Output extent of :class:`PackedConvStack` for input extent ``s``, or
    None where the packed forward refuses it (an odd extent at a pack or a
    parity split, an extent reaching 0)."""
    n_lead = next((i for i, d in enumerate(dilations) if d > 1), len(dilations))
    level, c = 0, s
    if n_lead:
        if s % 2:
            return None
        level, c = 1, s // 2 - n_lead
    for d in dilations[n_lead:]:
        while (1 << level) < d:
            if c <= 0 or c % 2:
                return None
            c //= 2
            level += 1
        c -= 2
    return c << level if c > 0 else None


@functools.cache
def _packed_geometry(dilations: tuple[int, ...]):
    # the reference's probe range for the packed ConvStack (packed_conv.py:525)
    from flypylib_tpu_torch.models.zoo import _probe_geometry

    return _probe_geometry(lambda s: _packed_out_size(s, dilations), lo=8, hi=140)


def packed_spec(spec):
    """A ``ModelSpec`` running a ``ConvStack`` spec through the packed
    engine (sharing the inner module's weights, with the packed model's
    stricter size constraints), or None when the module is not a
    ``ConvStack`` or its dilation schedule is not supported."""
    # the zoo imports this module: import it here, not at the top
    from flypylib_tpu_torch.models.zoo import ConvStack, ModelSpec

    module = spec.module
    if not isinstance(module, ConvStack):
        return None
    try:
        pm = PackedConvStack(module)
        ctx, mult, off, min_size = _packed_geometry(tuple(pm.dilations))
    except ValueError:
        return None
    if ctx != spec.context:
        raise AssertionError(f"packed geometry context {ctx} != model context "
                             f"{spec.context}")
    return ModelSpec(
        name=spec.name + "+packed",
        module=pm,
        context=ctx,
        size_multiple=mult,
        size_offset=off,
        min_size=min_size,
        metadata={**spec.metadata, "packed": True},
    )
