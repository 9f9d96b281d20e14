"""The packed U-Net's level-0 decoder tail — the port of K2 and K3.

Counterpart of ``flypylib_tpu/ops/pallas_tail.py``:

- :func:`packed_tail` (K2) runs a chain of n valid 2^3 conv stages on a
  packed-lattice activation, with an optional final logits dot;
- :func:`packed_tail2` (K3) is the same chain whose first stage reads the
  skip and upsampled operands apart (``relu(conv2(xa, wa) + conv2(xb, wb)
  + b)``), so their channel concat never exists.

On a CUDA tensor each launches the hand-written kernels of
``csrc/packed_tail.cu`` (one launch per stage, and one for the logits) and
adds one to its ``launches`` count; on a CPU tensor it runs its plain
version, :func:`tail_reference` / :func:`tail2_reference`.  There is no
fallback between the two: a CUDA tensor the kernels cannot take raises.

Unlike the reference, every operand carries a batch axis:
x is (B, D, H, W, C), as for K1.

Rounding, per stage, as the TPU kernel: the 8 taps x Ci products are
summed in f32 (both operands' sums together, for K3's first stage),
rounded to the model dtype, the model-dtype bias is added (the sum rounded
to the dtype), then ReLU.  This is not K1's epilogue, which adds the bias
in f32 before its one rounding.  Logits: with ``wl`` (Cn, 2L) holding the
hi and lo halves of the weight and ``bl`` (L,) f32,
``y = (a @ wl)[:, :L] + (a @ wl)[:, L:] + bl`` with the products summed in
f32, added in that order, in f32.
"""

from __future__ import annotations

import torch

from flypylib_tpu_torch.ops.conv import conv3d_f32, matmul_f32

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# -- plain versions ---------------------------------------------------------
def _stage_reference(cur, w, b):
    dt = cur.dtype
    return torch.relu(conv3d_f32(cur, w.to(dt)).to(dt) + b.to(dt))


def logits_reference(a: torch.Tensor, wl: torch.Tensor,
                     bl: torch.Tensor) -> torch.Tensor:
    """``(a @ wl)[..., :L] + (a @ wl)[..., L:] + bl`` in f32, the products
    of the dtype values summed in f32 (``L = bl.shape[-1]``)."""
    L = bl.shape[-1]
    y2 = matmul_f32(a, wl.to(a.dtype))
    return y2[..., :L] + y2[..., L:] + bl.float()


def tail_reference(x: torch.Tensor, stages, logits=None) -> torch.Tensor:
    """Plain version of :func:`packed_tail`: each stage an f32 ``F.conv3d``
    of the dtype values, one rounding to ``x.dtype``, the dtype bias, ReLU;
    then :func:`logits_reference`."""
    cur = x
    for w, b in stages:
        cur = _stage_reference(cur, w, b)
    if logits is None:
        return cur.contiguous()
    return logits_reference(cur, *logits).contiguous()


def tail2_reference(xa: torch.Tensor, xb: torch.Tensor, stage0, stages=(),
                    logits=None) -> torch.Tensor:
    """Plain version of :func:`packed_tail2`: stage 0 sums the two
    operands' f32 convs before its one rounding, then as
    :func:`tail_reference`."""
    wa, wb, b0 = stage0
    dt = xa.dtype
    y = (conv3d_f32(xa, wa.to(dt)) + conv3d_f32(xb, wb.to(dt))).to(dt)
    return tail_reference(torch.relu(y + b0.to(dt)), stages, logits)


# -- checks shared by both devices -----------------------------------------
def _check_chain(shape, ws, bs, logits):
    """Shape checks of the reference (``pallas_tail.py:256-280``) for a
    chain whose input has ``shape``, plus the channel chain, which the
    kernels need before they take pointers."""
    for w in ws:
        if w.dim() != 5 or tuple(w.shape[:3]) != (2, 2, 2):
            raise ValueError(
                f"packed_tail stages must be 2^3 convs, got {tuple(w.shape)}")
    if len(shape) != 5:
        raise ValueError(f"x must be (B, D, H, W, C), got {tuple(shape)}")
    n = len(ws)
    _, D, H, W, c = shape
    if min(D - n, H - n, W - n) < 1:
        raise ValueError(f"input {tuple(shape)} smaller than chain depth {n}")
    for w, b in zip(ws, bs):
        if w.shape[3] != c:
            raise ValueError(f"stage weight {tuple(w.shape)} takes "
                             f"{w.shape[3]} channels, its input has {c}")
        c = w.shape[4]
        if tuple(b.shape) != (c,):
            raise ValueError(f"stage bias must be ({c},), got {tuple(b.shape)}")
    if logits is not None:
        wl, bl = logits
        if wl.shape[-1] != 2 * bl.shape[-1]:
            raise ValueError(
                f"logits weight {tuple(wl.shape)} must stack hi/lo columns for "
                f"bias {tuple(bl.shape)}")
        if wl.dim() != 2 or wl.shape[0] != c or bl.dim() != 1:
            raise ValueError(f"logits weight must be ({c}, 2L) and bias (L,), "
                             f"got {tuple(wl.shape)} and {tuple(bl.shape)}")


def _check_cuda(tensors, x):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if any(t.device != x.device for t in tensors):
        raise ValueError("every operand must be on the same device")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NDHWC)")


# -- kernel launches ----------------------------------------------------------
def _stage(lib, stream, xa, xb, wa, wb, b):
    """One launch of the stage kernel: relu(round(conv2(xa, wa) [+
    conv2(xb, wb)]) + b), NDHWC in, NDHWC out, in xa's dtype."""
    dt = xa.dtype
    B, D, H, W, ca = xa.shape
    co = wa.shape[4]
    out = torch.empty((B, D - 1, H - 1, W - 1, co), dtype=dt, device=xa.device)
    wa = wa.to(dt).contiguous()
    b = b.to(dt).contiguous()
    if xb is None:
        cb, xb_ptr, wb_ptr = 0, None, None
    else:
        wb = wb.to(dt).contiguous()
        cb, xb_ptr, wb_ptr = xb.shape[4], xb.data_ptr(), wb.data_ptr()
    err = lib.fpl_tail_stage(xa.data_ptr(), xb_ptr, wa.data_ptr(), wb_ptr,
                             b.data_ptr(), out.data_ptr(), B, D, H, W, ca, cb,
                             co, _DTYPE_CODES[dt], stream)
    if err != 0:
        raise RuntimeError(f"packed tail stage kernel launch failed: cudaError {err}")
    return out


def _logits(lib, stream, a, wl, bl):
    L = bl.shape[0]
    out = torch.empty((*a.shape[:-1], L), dtype=torch.float32, device=a.device)
    wl = wl.to(a.dtype).contiguous()
    bl = bl.float().contiguous()
    err = lib.fpl_tail_logits(a.data_ptr(), wl.data_ptr(), bl.data_ptr(),
                              out.data_ptr(), a.numel() // a.shape[-1],
                              a.shape[-1], L, _DTYPE_CODES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"packed tail logits kernel launch failed: cudaError {err}")
    return out


def _run_chain(x, xb, stage0, ws, bs, logits):
    """Launch the chain on x's card; the first stage may have two operands."""
    from flypylib_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        cur = x
        if stage0 is not None:
            wa, wb, b0 = stage0
            cur = _stage(lib, stream, x, xb, wa, wb, b0)
        for w, b in zip(ws, bs):
            cur = _stage(lib, stream, cur, None, w, None, b)
        if logits is not None:
            cur = _logits(lib, stream, cur, *logits)
    return cur


def _empty_result(x, n, c_last, logits):
    """The (0, ...) result of a chain of n stages on an empty batch."""
    _, D, H, W, _ = x.shape
    if logits is not None:
        return x.new_empty((0, D - n, H - n, W - n, logits[1].shape[0]),
                           dtype=torch.float32)
    return x.new_empty((0, D - n, H - n, W - n, c_last))


# -- public wrappers ----------------------------------------------------------
def packed_tail(x: torch.Tensor, stages, logits=None) -> torch.Tensor:
    """Chain of valid 2^3 convs (+ReLU) with an optional final hi/lo logits
    dot — K2.

    x: (B, D, H, W, C0), bf16 or f32 (a packed-lattice activation).
    stages: sequence of ``(w, b)``, ``w`` (2, 2, 2, Ci, Co), ``b`` (Co,),
        cast to ``x.dtype``.
    logits: optional ``(wl, bl)``: ``wl`` (Cn, 2L), the hi/lo columns, cast
        to ``x.dtype``, and ``bl`` (L,) f32.
    Returns (B, D-n, H-n, W-n, L) f32 with logits, else (..., Cn) in
    ``x.dtype``.  A CPU tensor runs :func:`tail_reference`; a CUDA tensor
    launches the kernels (and adds one to ``packed_tail.launches``) or
    raises."""
    stages = list(stages)
    ws = [w for w, _ in stages]
    bs = [b for _, b in stages]
    _check_chain(tuple(x.shape), ws, bs, logits)
    if not ws and logits is None:  # an empty chain: nothing to launch
        return x
    if x.device.type == "cpu":
        return tail_reference(x, stages, logits)
    if x.device.type != "cuda":
        raise ValueError(f"no packed_tail for device {x.device}")
    _check_cuda([*ws, *bs, *(logits or ())], x)
    if x.shape[0] == 0:  # a launch with an empty grid is refused
        return _empty_result(x, len(ws), ws[-1].shape[4] if ws else x.shape[4],
                             logits)
    out = _run_chain(x, None, None, ws, bs, logits)
    packed_tail.launches += 1
    return out


def packed_tail2(xa: torch.Tensor, xb: torch.Tensor, stage0, stages=(),
                 logits=None) -> torch.Tensor:
    """:func:`packed_tail` whose first stage consumes the pre-concat decoder
    operands — K3: ``relu(round(conv2(xa, wa) + conv2(xb, wb)) + b)`` with
    ``stage0 = (wa, wb, b)``, the two f32 sums added before the rounding.
    ``stages``/``logits`` as in :func:`packed_tail`.  A CPU tensor runs
    :func:`tail2_reference`; a CUDA tensor launches the kernels (and adds
    one to ``packed_tail2.launches``) or raises."""
    wa, wb, b0 = stage0
    if wa.dim() != 5 or wb.dim() != 5 or tuple(wa.shape[:3]) != (2, 2, 2) \
            or tuple(wb.shape[:3]) != (2, 2, 2):
        raise ValueError(
            f"stage0 must be 2^3 convs, got {tuple(wa.shape)} / {tuple(wb.shape)}")
    if wa.shape[-1] != wb.shape[-1]:
        raise ValueError("stage0 halves must share the output width")
    if xb.dim() != xa.dim() or xb.shape[:-1] != xa.shape[:-1]:
        raise ValueError(f"operand shapes differ: {tuple(xa.shape)} {tuple(xb.shape)}")
    if wb.shape[3] != xb.shape[-1]:
        raise ValueError(f"stage0 weight {tuple(wb.shape)} takes {wb.shape[3]} "
                         f"channels, xb has {xb.shape[-1]}")
    stages = list(stages)
    ws = [w for w, _ in stages]
    bs = [b for _, b in stages]
    # xa through (wa, b0) and the stages: rank, depth, channels, logits
    _check_chain(tuple(xa.shape), [wa, *ws], [b0, *bs], logits)
    n = 1 + len(ws)
    co = wa.shape[4]
    if xa.device.type == "cpu":
        return tail2_reference(xa, xb, stage0, stages, logits)
    if xa.device.type != "cuda":
        raise ValueError(f"no packed_tail2 for device {xa.device}")
    if xb.dtype != xa.dtype:
        raise TypeError(f"xa and xb differ in dtype: {xa.dtype} {xb.dtype}")
    if not xb.is_contiguous():
        raise ValueError("xb must be contiguous (NDHWC)")
    _check_cuda([xb, wa, wb, b0, *ws, *bs, *(logits or ())], xa)
    if xa.shape[0] == 0:  # a launch with an empty grid is refused
        return _empty_result(xa, n, ws[-1].shape[4] if ws else co, logits)
    out = _run_chain(xa, xb, stage0, ws, bs, logits)
    packed_tail2.launches += 1
    return out


packed_tail.launches = 0
packed_tail2.launches = 0
