"""Space-to-depth packed inference engine for the valid-conv U-Net, in PyTorch.

Counterpart of ``flypylib_tpu/ops/packed_unet.py`` (inference only):

- every valid 3^3 conv becomes a valid 2^3 conv on the 2x2x2-packed
  lattice (``pack_weight_d1`` embeds the original taps exactly);
- max-pool 2^3 stride 2 is an elementwise max over the 8 parity channel
  groups of the packed tensor (:func:`parity_group_max`), then a repack;
- the ConvTranspose (kernel 2, stride 2) is folded into the weights of the
  decoder block's first conv, which then reads the cropped skip and the
  dense coarse tensor, and the skip is cropped in the packed domain
  (:func:`crop_packed`);
- the level-0 decoder tail (fold conv, the block's other convs, logits)
  runs, by ``tail_impl``, unfused (``"xla"``, the default: each conv a
  cuDNN conv on the card, rounded per conv) or through the hand-written
  kernels of ``ops/tail.py``: K2 (``"pallas"``: the whole tail;
  ``"pallas_fold"``: the fold conv only, on the concat of skip and
  upsampled tensor) or K3 (``"pallas2"``, ``"pallas_fold2"``: the same with
  the two operands read apart).  The strings are the reference's, so a
  configuration means the same in both packages.

All rewrites re-associate the same multiply-adds, so outputs match
``UNetValid`` to accumulation tolerance.  :func:`packed_unet_spec` exports
the packed model's stricter size constraints as a drop-in ``ModelSpec``.
:meth:`PackedUNet.forward_train` is the differentiable forward (unfused
tail, f32 logits, the pool's gradient that of the plain ``UNetValid``).
Each forward opens the tracer's spans (``utils/metrics.py::span``)
``unet.encoder``, ``unet.bottleneck``, ``unet.decoder`` (a kernel tail's
logits inside it) and ``unet.logits``, with stream time on a card.

Left out of the reference: optimization barriers, the Pallas block shape,
the ``fold_form`` A/B forms (the port runs the reference's default,
``"split"``), and the batch-1 restriction of the kernel tails with its XLA
fallback: the port's kernels take a batch axis, so every batch runs them.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from flypylib_tpu_torch.models.zoo import (ModelSpec, UNetValid, WindowMax,
                                           _probe_geometry)
from flypylib_tpu_torch.ops.conv import matmul_f32, no_tf32
from flypylib_tpu_torch.ops.packed_conv import (
    _conv,
    convT_packed_weight,
    pack_volume,
    pack_weight_d1,
    packed_conv_relu,
    unpack_volume,
)
from flypylib_tpu_torch.ops.tail import logits_reference, packed_tail, packed_tail2
from flypylib_tpu_torch.utils.metrics import span

__all__ = [
    "TAIL_IMPLS",
    "PackedUNet",
    "convT_packed_weight",
    "crop_packed",
    "packed_unet_spec",
    "parity_group_max",
    "pool_pack",
]

TAIL_IMPLS = ("xla", "pallas", "pallas_fold", "pallas2", "pallas_fold2")


def parity_group_max(x: torch.Tensor, grad_exact: bool = False) -> torch.Tensor:
    """(B, D, H, W, 8C) packed -> (B, D, H, W, C): max over the parity
    groups == 2^3 stride-2 max-pool of the (even-extent) full-res tensor.
    The parity groups are in window order (z, y, x row-major), so with
    ``grad_exact`` the max goes through :class:`~flypylib_tpu_torch.models.
    zoo.WindowMax` and its gradient is the plain pool's."""
    b, d, h, w, c8 = x.shape
    x = x.reshape(b, d, h, w, 8, c8 // 8)
    return WindowMax.apply(x) if grad_exact else x.amax(dim=4)


def pool_pack(x: torch.Tensor, grad_exact: bool = False) -> torch.Tensor:
    """``pack_volume(parity_group_max(x))``: the U-Net's per-level pool and
    repack.  Every form gives the same values (max is exact); they differ in
    the gradient of a tie.  ``grad_exact=True`` (:meth:`PackedUNet.
    forward_train`) gives the whole gradient to the first maximum in window
    order, as the plain ``UNetValid``'s pool and Flax's ``nn.max_pool`` do.
    (The reference's ``grad_exact`` form is a reduce-max, whose gradient
    splits a positive tie evenly, unlike its own plain pool.)"""
    if any(s % 2 for s in x.shape[1:4]):
        raise ValueError(f"pool_pack needs even cell dims, got {tuple(x.shape)}")
    return pack_volume(parity_group_max(x, grad_exact))


def crop_packed(x: torch.Tensor, starts, sizes) -> torch.Tensor:
    """Crop a packed tensor in FULL-RESOLUTION coordinates without leaving
    the packed domain: ``pack_volume(unpack_volume(x)[starts : starts +
    sizes])`` by per-axis cell slices, plus a parity-group swap where a
    start is odd.

    ``sizes`` must be even.  Per axis, output index ``2r + p`` reads input
    ``2r + p + s``: for ``s = 2k`` that is cell ``r + k`` parity ``p``; for
    ``s = 2k + 1`` parity 0 reads old parity 1 at cell ``r + k`` and parity
    1 reads old parity 0 at cell ``r + k + 1``.  The result is contiguous
    (NDHWC), as the tail kernels take it."""
    b, d, h, w, c8 = x.shape
    c = c8 // 8
    x = x.reshape(b, d, h, w, 2, 2, 2, c)
    for ax, (s, out_full) in enumerate(zip(starts, sizes)):
        if out_full % 2:
            raise ValueError(f"crop_packed sizes must be even, got {sizes}")
        n = out_full // 2
        sp_ax, p_ax = 1 + ax, 4 + ax
        k, r = divmod(int(s), 2)
        if s < 0 or k + r + n > x.shape[sp_ax]:
            raise ValueError(f"crop {starts}+{sizes} outside the packed "
                             f"tensor {(b, d, h, w, c8)}")
        if r == 0:
            x = x.narrow(sp_ax, k, n)
        else:
            even = x.select(p_ax, 1).narrow(sp_ax, k, n)
            odd = x.select(p_ax, 0).narrow(sp_ax, k + 1, n)
            x = torch.stack([even, odd], dim=p_ax)
    return x.reshape(b, *(sz // 2 for sz in sizes), 8 * c).contiguous()


class PackedUNet(nn.Module):
    """Inference module running a ``UNetValid`` in packed layout.

    It holds the inner module (``self.inner``) and reads its parameters at
    each forward, so the two share one set of weights."""

    def __init__(self, inner: UNetValid, tail_impl: str = "xla"):
        super().__init__()
        if tail_impl not in TAIL_IMPLS:
            raise ValueError(f"unknown tail_impl {tail_impl!r}")
        self.inner = inner
        self.tail_impl = tail_impl

    @property
    def dtype(self) -> torch.dtype:
        return self.inner.dtype

    def _tail_stages(self, i):
        """Packed ``(w, b)`` of the decoder block's convs ``i`` onwards, in
        the model dtype, for the kernel tails."""
        dt = self.dtype
        return [(pack_weight_d1(c.weight.to(dt)), c.bias.to(dt).repeat(8))
                for c in self.inner.convs[i:]]

    def _logits_operands(self):
        """``(wcat, bl)`` of the logits on the packed lattice: the
        block-diagonal (8C, 8) f32 weight split into hi and lo columns of
        the model dtype, ``wcat`` (8C, 16), and the f32 bias on all 8
        parity lanes.  Every tail form takes its logits from here, so all
        round alike (the counterpart of ``_tail_epilogue_args``)."""
        dt = self.dtype
        lg = self.inner.logits
        w0 = lg.weight.float()[:, 0]  # (C,)
        eye = torch.eye(8, dtype=torch.float32, device=w0.device)
        # w_bd[g*C + c, p] = w0[c] if g == p: y[..., p] = group p @ w0
        w_bd = (eye[:, None, :] * w0[None, :, None]).reshape(8 * w0.shape[0], 8)
        w_hi = w_bd.to(dt)
        w_lo = (w_bd - w_hi.float()).to(dt)
        bl = lg.bias.float().expand(8).contiguous()
        return torch.cat([w_hi, w_lo], dim=-1), bl

    def _fold(self, lev, i, skip_c8):
        """The ConvTranspose of decoder level ``lev`` folded into conv
        ``i``: ``(w_skip, w_up_eff, b_fold)`` in f32.  The upsampled tensor
        is a per-parity 1x1 map of the dense coarse tensor with no
        activation before conv ``i``, so conv ``i``'s up-channel taps
        contract with the ConvTranspose kernel once, in the weights."""
        inner = self.inner
        up = inner.convts[inner.levels - 1 - lev]
        kt = up.weight.float()  # (2,2,2, Cc, Cu)
        cc, cu = kt.shape[-2], kt.shape[-1]
        cs = skip_c8 // 8
        conv = inner.convs[i]
        wp = pack_weight_d1(conv.weight.float())  # (2,2,2, 8(Cs+Cu), 8Co)
        co8 = wp.shape[-1]
        wp = wp.reshape(2, 2, 2, 8, cs + cu, co8)
        w_skip = wp[..., :cs, :].reshape(2, 2, 2, 8 * cs, co8)
        w_up = wp[..., cs:, :]  # (2,2,2, parity a, Cu, 8Co)
        k_par = convT_packed_weight(kt).reshape(cc, 8, cu)  # group a: K[1-a]
        with no_tf32(kt.device):
            w_up_eff = torch.einsum("cau,zyxauo->zyxco", k_par, w_up)
            # the ConvTranspose bias reaches every up channel before the
            # conv: it sums through all taps and parities into a per-output
            # constant
            b_fold = conv.bias.float().repeat(8) + torch.einsum(
                "u,zyxauo->o", up.bias.float(), w_up)
        return w_skip, w_up_eff, b_fold

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, S, 1) -> (B, S - 2 context, ..., 1) f32 logits."""
        return self._forward(x)

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        """The differentiable packed forward (the reference's
        ``forward_train``, ``packed_unet.py:240-257``): the same
        re-association as :meth:`forward` with the unfused (``"xla"``) tail
        at every level, the pool's gradient that of the plain ``UNetValid``
        (``pool_pack(grad_exact=True)``) and the f32 logits (a grouped f32
        dot, not the hi/lo split weight).  The ConvTranspose folds and the
        packed weights are built from the inner module's parameters inside
        the graph, so gradients reach them.  A kernel tail (``"pallas*"``)
        raises: the kernels have no backward, and the reference trains such
        a spec through the unfused tail (``train/trainer.py::
        resolve_train_spec`` swaps one in)."""
        if self.tail_impl != "xla":
            raise ValueError(
                f"PackedUNet.forward_train runs the unfused tail; tail_impl="
                f"{self.tail_impl!r} has no backward (use tail_impl='xla')")
        return self._forward(x, train=True)

    def _forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        inner = self.inner
        dt = self.dtype
        dev = x.device
        cps = inner.convs_per_stage
        conv_i = 0
        with span("unet.encoder", device=dev):
            x = pack_volume(x.to(dt))
            skips = []
            for _ in range(inner.levels):
                for _ in range(cps):
                    x = packed_conv_relu(x, inner.convs[conv_i])
                    conv_i += 1
                skips.append(x)
                x = pool_pack(x, grad_exact=train)
        with span("unet.bottleneck", device=dev):
            for _ in range(cps):  # one lattice deeper than the skip
                x = packed_conv_relu(x, inner.convs[conv_i])
                conv_i += 1
            x = unpack_volume(x)  # dense at the deepest resolution

        with span("unet.decoder", device=dev):  # a kernel tail ends here
            for lev in reversed(range(inner.levels)):
                # x is dense at this level's coarse resolution: exactly the
                # packed-fine lattice the folded conv runs on
                skip = skips[lev]
                w_skip, w_up_eff, b_fold = self._fold(lev, conv_i,
                                                      skip.shape[-1])
                sizes = [2 * x.shape[i] for i in (1, 2, 3)]
                starts = [skip.shape[i] - x.shape[i] for i in (1, 2, 3)]
                sc = crop_packed(skip, starts, sizes)
                impl = self.tail_impl if lev == 0 and not train else "xla"
                if impl in ("pallas2", "pallas_fold2"):
                    stage0 = (w_skip.to(dt), w_up_eff.to(dt), b_fold.to(dt))
                    if impl == "pallas2":
                        y = packed_tail2(sc, x, stage0,
                                         self._tail_stages(conv_i + 1),
                                         self._logits_operands())
                        return unpack_volume(y)
                    x = packed_tail2(sc, x, stage0)
                elif impl in ("pallas", "pallas_fold"):
                    xin = torch.cat([sc, x], dim=-1)
                    fold = (torch.cat([w_skip, w_up_eff], dim=3).to(dt),
                            b_fold.to(dt))
                    if impl == "pallas":
                        y = packed_tail(xin, [fold] + self._tail_stages(conv_i + 1),
                                        self._logits_operands())
                        return unpack_volume(y)
                    x = packed_tail(xin, [fold])
                else:
                    # the reference's "split" fold: two convs rounded apart
                    # and summed in the model dtype; the concat never exists
                    y = (_conv(sc, w_skip) + _conv(x, w_up_eff)) + b_fold.to(dt)
                    x = torch.relu(y)
                conv_i += 1
                for _ in range(cps - 1):
                    x = packed_conv_relu(x, inner.convs[conv_i])
                    conv_i += 1
                if lev > 0:
                    x = unpack_volume(x)  # dense input of the next fold
        with span("unet.logits", device=dev):
            if train:
                # f32 logits per parity group: (B, D, H, W, 8, C) @ (C, 1)
                lg = inner.logits
                b, d, h, w, c8 = x.shape
                xg = x.reshape(b, d, h, w, 8, c8 // 8)
                y = matmul_f32(xg, lg.weight)[..., 0] + lg.bias.float()
                return unpack_volume(y)
            return unpack_volume(logits_reference(x, *self._logits_operands()))


def _packed_out_size(s: int, levels: int, convs_per_stage: int) -> int | None:
    """Output extent of :class:`PackedUNet` for input extent ``s``, or None
    where the packed forward refuses it (an odd extent at a pack or pool,
    a size reaching 0, a skip smaller than its crop)."""
    if s % 2:
        return None
    c = s // 2
    skips = []
    for _ in range(levels):
        c -= convs_per_stage
        if c <= 0 or c % 2:
            return None
        skips.append(c)
        c //= 2
    c -= convs_per_stage
    if c <= 0:
        return None
    n = 2 * c  # dense extent below the first decoder level
    for lev in reversed(range(levels)):
        if skips[lev] < n:
            return None
        c = n - convs_per_stage
        if c <= 0:
            return None
        n = 2 * c
    return n


@functools.cache
def _packed_unet_geometry(levels: int, convs_per_stage: int):
    return _probe_geometry(
        lambda s: _packed_out_size(s, levels, convs_per_stage), lo=8, hi=200)


def packed_unet_spec(spec: ModelSpec, tail_impl: str = "xla") -> ModelSpec | None:
    """A ``ModelSpec`` running a ``UNetValid`` spec through the packed engine
    (sharing the inner module's weights, with the packed model's stricter
    size constraints), or None when the module is not a ``UNetValid``.

    ``tail_impl`` is one of :data:`TAIL_IMPLS` (see the module docstring);
    unlike the reference, an unknown value raises ``ValueError``."""
    module = spec.module
    if not isinstance(module, UNetValid):
        return None
    pm = PackedUNet(module, tail_impl=tail_impl)
    ctx, mult, off, min_size = _packed_unet_geometry(module.levels,
                                                     module.convs_per_stage)
    return ModelSpec(
        name=spec.name + "+packed",
        module=pm,
        context=ctx,
        size_multiple=mult,
        size_offset=off,
        min_size=min_size,
        metadata={**spec.metadata, "packed": True},
    )
