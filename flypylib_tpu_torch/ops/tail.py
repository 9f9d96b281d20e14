"""The packed U-Net's level-0 decoder tail — the port of K2 and K3.

Counterpart of ``flypylib_tpu/ops/pallas_tail.py``:

- :func:`packed_tail` (K2) runs a chain of n valid 2^3 conv stages on a
  packed-lattice activation, with an optional final logits dot;
- :func:`packed_tail2` (K3) is the same chain whose first stage reads the
  skip and upsampled operands apart (``relu(conv2(xa, wa) + conv2(xb, wb)
  + b)``), so their channel concat never exists.

On a CUDA tensor each launches hand-written kernels, one launch per stage,
and adds one to its ``launches`` count; on a CPU tensor it runs its plain
version, :func:`tail_reference` / :func:`tail2_reference`.  There is no
fallback between the two: a CUDA tensor the kernels cannot take raises.

Which kernel takes a stage is a rule on dtype, channel counts and alignment,
decided before the launch (:func:`tail_route`): bf16 with every channel
count a multiple of 8, Co <= 192 and 16-byte-aligned operands runs the
wgmma/TMA kernel of ``csrc/packed_tail_wgmma.cu`` ("wgmma"), which also
computes the logits in the last stage's epilogue (for up to 8 of them), so
that stage's output never reaches device memory; f32 with Ca and Cb
multiples of 4 and 16-byte-aligned operands runs the FMA/TMA kernel of
``csrc/conv3d_f32.cu`` ("simt": K1's f32 kernel at 2 taps a side, no TF32;
box and channel block from :func:`tail_simt_plan`, weight image from
:func:`tail_simt_weights`); ``csrc/packed_tail.cu`` keeps the other bf16
stages ("wmma"), the other f32 stages ("fma": TF32 would round the inputs)
and the logits of chains that do not end in a wgmma stage.
``packed_tail.routes`` / ``packed_tail2.routes`` count stage launches per
route.

The wgmma kernel also runs one stage alone for any Co, in output-channel
slices of at most 192 (:func:`stage_bias_relu`, with its own ``launches``
count): the packed engines' conv + bias + ReLU at inference
(``ops/packed_conv.py::packed_conv_relu``), whose rounding is a stage's.

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

from typing import NamedTuple

import torch

from flypylib_tpu_torch.ops.conv import (SIMT_SLICE, WGMMA_KC, conv3d_f32,
                                         matmul_f32, simt_plan, simt_weights,
                                         weight_images, wgmma_box,
                                         wgmma_chunks, wgmma_slices)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TAIL_ROUTES = ("wgmma", "wmma", "simt", "fma")
TAIL_N_TILES = (32, 64, 96, 128, 192)  # the wgmma kernel's N tiles
TAIL_ROWS = 192  # output voxels per block of the wgmma kernel
TAIL_MAX_LOGITS = 8  # logits the wgmma kernel's epilogue computes
TAIL_SIMT_STAGES = 4  # slices in the f32 kernel's ring for a 2^3 stage
TAIL_SIMT_WIDEST = 32  # output channels per block of it: three 4-warp
                       # blocks an SM (K1 runs one 8-warp block of 64)


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


# -- the routes' plain-Python parts --------------------------------------------
def tail_route(xa: torch.Tensor, xb: torch.Tensor | None,
               wa: torch.Tensor) -> str:
    """Which CUDA kernel takes the stage ``relu(round(conv2(xa, wa) [+
    conv2(xb, wb)]) + b)``: for f32, "simt" with Ca (> 0) and Cb multiples
    of 4 (16 bytes a voxel's slice) and ``xa`` and ``xb`` on 16-byte
    boundaries, else "fma" (the halo of a 2^3 stage, one voxel past the
    box, fits whatever the extents: :func:`tail_simt_plan` always finds a
    box); for bf16, "wgmma" with Ca, Cb and Co multiples of 8, Co at most
    the widest N tile (192) and ``xa`` and ``xb`` on 16-byte boundaries (the
    TMA tensor map's rules; the weights are repacked, so their alignment
    does not matter), else "wmma"."""
    co = wa.shape[-1]
    operands = [xa] if xb is None else [xa, xb]
    aligned = all(t.data_ptr() % 16 == 0 for t in operands)
    if xa.dtype != torch.bfloat16:
        if (aligned and xa.shape[-1] > 0
                and all(t.shape[-1] % SIMT_SLICE == 0 for t in operands)):
            return "simt"
        return "fma"
    if (aligned and all(t.shape[-1] % 8 == 0 for t in operands)
            and co % 8 == 0 and co <= TAIL_N_TILES[-1]):
        return "wgmma"
    return "wmma"


def tail_simt_plan(in_dhw: tuple[int, int, int],
                   co: int) -> tuple[int, int, int, int, int]:
    """``(bz, by, bx, width, smem bytes)`` of the f32 kernel for a stage
    whose input has ``in_dhw`` voxels: K1's plan (:func:`simt_plan`) for
    the output (one voxel less on each axis) at 2 taps a side, d = 1, a
    ring of TAIL_SIMT_STAGES slices and channel blocks of at most
    TAIL_SIMT_WIDEST."""
    out_dhw = tuple(e - 1 for e in in_dhw)
    return simt_plan(out_dhw, 1, co, 2, TAIL_SIMT_STAGES, TAIL_SIMT_WIDEST)


def tail_simt_weights(wa: torch.Tensor, wb: torch.Tensor | None,
                      width: int) -> torch.Tensor:
    """The weight image of the f32 kernel for a stage: :func:`simt_weights`
    of ``wa`` (2, 2, 2, Ca, Co), then of ``wb`` (2, 2, 2, Cb, Co), stacked
    along the slice axis, so the kernel's slices run xa's then xb's:
    (ceil(Co / width), (Ca + Cb) / 4, 8, width / 8, 4, 8), f32, zero past
    Co."""
    return torch.cat([simt_weights(w.float(), width) for w in (wa, wb)
                      if w is not None], dim=1)


def tail_tile(co: int) -> int:
    """The wgmma kernel's N tile for ``co`` output channels: the smallest
    that holds Co."""
    n_tile = next((n for n in TAIL_N_TILES if n >= co), None)
    if n_tile is None:
        raise ValueError(f"Co must be <= {TAIL_N_TILES[-1]}, got {co}")
    return n_tile


def tail_box(out_dhw: tuple[int, int, int]) -> tuple[int, int, int]:
    """The output box (bz, by, bx) of one tile of the wgmma kernel, at most
    ``TAIL_ROWS`` voxels: the fewest tiles, then the least halo (K1's
    search, :func:`wgmma_box`, with the 2^3 stage's one-voxel reach)."""
    return wgmma_box(tuple(out_dhw), TAIL_ROWS, 1)


def tail_slices(ca: int, cb: int = 0) -> list[tuple[str, int, int]]:
    """The wgmma kernel's K steps per tap, ``(operand, first channel,
    width)``: xa's 32-channel slices, its 16-channel slice (a rest of 1-16
    channels, ending at channel Ca), then the same of xb
    (:func:`wgmma_slices` per operand: a rest of 17-31 channels takes one
    more 32-channel slice, zero-filled past C)."""
    steps = []
    for name, c in (("a", ca), ("b", cb)):
        if c == 0:
            continue
        n_full, c_last = wgmma_slices(c)
        steps += [(name, WGMMA_KC * i, WGMMA_KC) for i in range(n_full)]
        if c_last is not None:
            steps.append((name, c_last, WGMMA_KC // 2))
    return steps


def tail_weights(wa: torch.Tensor, wb: torch.Tensor | None,
                 n_tile: int) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The weight images the wgmma kernel loads, one (n_tile, 32 or 16)
    K-major slice per K step (:func:`tail_slices`), tap = 4 tz + 2 ty + tx,
    ``[wa; wb]`` stacked along the slice axis:

    - ``w32[tap, s, o, c]`` for the s-th 32-channel slice (xa's, then
      xb's), shape (8, n32, n_tile, 32), or None when there is none;
    - ``w16[tap, s, o, c]`` for the s-th 16-channel slice, shape
      (8, n16, n_tile, 16), or None; zero for a channel a 32-channel slice
      of the same operand already holds;

    zero past C and where o >= Co; bf16, contiguous."""
    imgs = [weight_images(w.reshape(8, w.shape[3], w.shape[4]), n_tile)
            for w in (wa, wb) if w is not None and w.shape[3] > 0]
    w32 = torch.cat([i32 for i32, _ in imgs], dim=1)
    w16 = [i16 for _, i16 in imgs if i16 is not None]
    return (w32 if w32.shape[1] else None,
            torch.stack(w16, dim=1) if w16 else None)


def stage_slices(co: int) -> tuple[int, int, int]:
    """``(n, width, n_tile)``: the output-channel slices the wgmma kernel
    runs a stage of ``co`` channels in, without logits: n = ceil(Co / 192)
    slices of ``width`` channels (Co / n rounded up to a multiple of 8, the
    last slice holding the rest; :func:`wgmma_chunks` at a widest block of
    192), each on the smallest N tile that holds ``width``
    (:func:`tail_tile`): 192 -> 1 x 192, 256 -> 2 x 128, 384 -> 2 x 192,
    768 -> 4 x 192."""
    chunks = wgmma_chunks(co, TAIL_N_TILES[-1])
    width = chunks[0][1]
    return len(chunks), width, tail_tile(width)


class StageWeights(NamedTuple):
    """A stage ``relu(round(round(conv2(x, w)) + b))`` as
    :func:`stage_bias_relu` reads it (:func:`stage_weights`)."""
    w: torch.Tensor  # (2, 2, 2, Ci, Co) bf16: the plain version's weight
    b: torch.Tensor  # (Co,) bf16
    w32: torch.Tensor | None  # (n, 8, n32, n_tile, 32): a slice's tail_weights
    w16: torch.Tensor | None  # (n, 8, n16, n_tile, 16)
    width: int  # output channels of a slice (the last may hold fewer)
    n_tile: int


def stage_weights(w: torch.Tensor, b: torch.Tensor) -> StageWeights:
    """The operands of :func:`stage_bias_relu` for ``w`` (2, 2, 2, Ci, Co)
    and ``b`` (Co,), both cast to bf16: the weight images of each slice of
    :func:`stage_slices` (:func:`tail_weights` of its columns of ``w``),
    stacked along a leading slice axis, on ``w``'s device."""
    w = w.to(torch.bfloat16).contiguous()
    b = b.to(torch.bfloat16).contiguous()
    co = w.shape[4]
    _, width, n_tile = stage_slices(co)
    imgs = [tail_weights(w[..., c0:c0 + width], None, n_tile)
            for c0 in range(0, co, width)]

    def stacked(k):
        return None if imgs[0][k] is None else torch.stack(
            [img[k] for img in imgs])

    return StageWeights(w, b, stacked(0), stacked(1), width, n_tile)


# -- kernel launches ----------------------------------------------------------
def _stage_wgmma(lib, stream, xa, xb, wa, wb, b, logits):
    """One launch of the wgmma stage kernel; with ``logits = (wl, bl)`` its
    epilogue computes them and the stage output is not stored."""
    B, D, H, W, ca = xa.shape
    co = wa.shape[4]
    n_tile = tail_tile(co)
    w32, w16 = tail_weights(wa, None if xb is None else wb, n_tile)
    bz, by, bx = tail_box((D - 1, H - 1, W - 1))
    b = b.to(torch.bfloat16).contiguous()
    if logits is None:
        wl = bl = None
        n_logits = 0
        out = torch.empty((B, D - 1, H - 1, W - 1, co), dtype=torch.bfloat16,
                          device=xa.device)
    else:
        wl = logits[0].to(torch.bfloat16).contiguous()
        bl = logits[1].float().contiguous()
        n_logits = bl.shape[0]
        out = torch.empty((B, D - 1, H - 1, W - 1, n_logits),
                          dtype=torch.float32, device=xa.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.fpl_tail_stage_wgmma(
        xa.data_ptr(), ptr(xb), ptr(w32), ptr(w16), b.data_ptr(), ptr(wl),
        ptr(bl), out.data_ptr(), B, D, H, W, ca,
        0 if xb is None else xb.shape[4], co, n_logits, n_tile, bz, by, bx,
        stream)
    if err != 0:
        raise RuntimeError("packed tail stage kernel launch failed (wgmma "
                           f"route): cudaError {err}")
    return out


def _stage_simt(lib, stream, xa, xb, wa, wb, b):
    """One launch of the f32 kernel of ``csrc/conv3d_f32.cu`` at 2 taps a
    side: relu(conv2(xa, wa) [+ conv2(xb, wb)] + b), NDHWC, f32."""
    B, D, H, W, ca = xa.shape
    co = wa.shape[4]
    cb = 0 if xb is None else xb.shape[4]
    bz, by, bx, width, _ = tail_simt_plan((D, H, W), co)
    img = tail_simt_weights(wa, wb if cb else None, width)
    b = b.float().contiguous()
    out = torch.empty((B, D - 1, H - 1, W - 1, co), dtype=torch.float32,
                      device=xa.device)
    err = lib.fpl_tail_stage_f32(
        xa.data_ptr(), xb.data_ptr() if cb else None, img.data_ptr(),
        b.data_ptr(), out.data_ptr(), B, D, H, W, ca, cb, co, width, bz, by,
        bx, stream)
    if err != 0:
        raise RuntimeError("packed tail stage kernel launch failed (simt "
                           f"route): cudaError {err}")
    return out


def _stage(lib, stream, xa, xb, wa, wb, b):
    """One launch of the stage kernel of ``csrc/packed_tail.cu`` (the "wmma"
    and "fma" routes): relu(round(conv2(xa, wa) [+ conv2(xb, wb)]) + b),
    NDHWC in, NDHWC out, in xa's dtype."""
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
    """Launch the chain on x's card; the first stage may have two operands.
    Returns the result and the route of every stage launched."""
    from flypylib_tpu_torch.ops._build import load_library

    lib = load_library()
    stages = [(None, w, None, b) for w, b in zip(ws, bs)]
    if stage0 is not None:
        wa, wb, b0 = stage0
        stages.insert(0, (xb, wa, wb, b0))
    routes = []
    fused = False  # the logits came out of the last stage's epilogue
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        cur = x
        for i, (xb, wa, wb, b) in enumerate(stages):
            route = tail_route(cur, xb, wa)
            if route == "wgmma":
                fused = (logits is not None and i == len(stages) - 1
                         and logits[1].shape[0] <= TAIL_MAX_LOGITS)
                cur = _stage_wgmma(lib, stream, cur, xb, wa, wb, b,
                                   logits if fused else None)
            elif route == "simt":
                cur = _stage_simt(lib, stream, cur, xb, wa, wb, b)
            else:
                cur = _stage(lib, stream, cur, xb, wa, wb, b)
            routes.append(route)
        if logits is not None and not fused:
            cur = _logits(lib, stream, cur, *logits)
    return cur, routes


def _count(wrapper, routes):
    wrapper.launches += 1
    for route in routes:
        wrapper.routes[route] += 1


def _empty_result(x, n, c_last, logits):
    """The (0, ...) result of a chain of n stages on an empty batch."""
    _, D, H, W, _ = x.shape
    if logits is not None:
        return x.new_empty((0, D - n, H - n, W - n, logits[1].shape[0]),
                           dtype=torch.float32)
    return x.new_empty((0, D - n, H - n, W - n, c_last))


# -- public wrappers ----------------------------------------------------------
def stage_bias_relu(x: torch.Tensor, sw: StageWeights) -> torch.Tensor:
    """One stage ``relu(round(round(conv2(x, w)) + b))`` for any Co: the
    valid 2^3 conv of ``x`` (B, D, H, W, Ci) with ``sw.w``, its 8 taps x Ci
    products summed in f32 and rounded to bf16 once, the bf16 bias added
    (the sum rounded to bf16), then ReLU; (B, D-1, H-1, W-1, Co) bf16.

    A CPU tensor runs :func:`tail_reference` of the one stage.  A CUDA
    tensor launches the wgmma kernel once over the slices of ``sw``, as the
    operator ``fpl::stage_bias_relu`` (and adds one to
    ``stage_bias_relu.launches``), or raises: ``x`` must be bf16,
    contiguous and on a 16-byte boundary, with Ci a multiple of 8."""
    _check_chain(tuple(x.shape), [sw.w], [sw.b], None)
    if x.device.type == "cpu":
        return tail_reference(x, [(sw.w, sw.b)])
    if x.device.type != "cuda":
        raise ValueError(f"no stage_bias_relu for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    _check_cuda([sw.w, sw.b], x)
    ci, co = x.shape[4], sw.w.shape[4]
    if ci % 8 or co % 8 or x.data_ptr() % 16:
        raise ValueError("stage_bias_relu needs Ci and Co multiples of 8 and "
                         "x on a 16-byte boundary")
    if x.shape[0] == 0:  # a launch with an empty grid is refused
        return x.new_empty((0, *(n - 1 for n in x.shape[1:4]), co))
    out = torch.ops.fpl.stage_bias_relu(x, sw.w32, sw.w16, sw.b, sw.width,
                                        sw.n_tile)
    stage_bias_relu.launches += 1
    return out


def _stage_bias_relu_cuda(x, w32, w16, b, width: int, n_tile: int):
    """``fpl::stage_bias_relu`` on the card: the wgmma kernel's launch over
    ``-(-Co // width)`` slices (the checks are :func:`stage_bias_relu`'s)."""
    from flypylib_tpu_torch.ops._build import load_library

    B, D, H, W, ci = x.shape
    co = b.shape[0]
    out = torch.empty((B, D - 1, H - 1, W - 1, co), dtype=torch.bfloat16,
                      device=x.device)
    bz, by, bx = tail_box((D - 1, H - 1, W - 1))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = load_library().fpl_stage_bias_relu_wgmma(
            x.data_ptr(), None if w32 is None else w32.data_ptr(),
            None if w16 is None else w16.data_ptr(), b.data_ptr(),
            out.data_ptr(), B, D, H, W, ci, co, width, -(-co // width),
            n_tile, bz, by, bx, stream)
    if err != 0:
        raise RuntimeError("stage_bias_relu kernel launch failed: cudaError "
                           f"{err}")
    return out


# The launch is an operator of its own: torch.profiler ties a kernel to the
# operator whose call launched it, and through that operator to the ranges
# open around the call (a module's forward, the tracer's spans).  A ctypes
# launch made outside any operator is tied to none, and its device time is
# missing from every range.
_OPS = torch.library.Library("fpl", "FRAGMENT")
_OPS.define("stage_bias_relu(Tensor x, Tensor? w32, Tensor? w16, Tensor b, "
            "int width, int n_tile) -> Tensor")
_OPS.impl("stage_bias_relu", _stage_bias_relu_cuda, "CUDA")


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
    launches the kernels (and adds one to ``packed_tail.launches``, and one
    per stage to that stage's route in ``packed_tail.routes``) or raises."""
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
    out, routes = _run_chain(x, None, None, ws, bs, logits)
    _count(packed_tail, routes)
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
    out, routes = _run_chain(xa, xb, stage0, ws, bs, logits)
    _count(packed_tail2, routes)
    return out


stage_bias_relu.launches = 0
packed_tail.launches = 0
packed_tail2.launches = 0
packed_tail.routes = dict.fromkeys(TAIL_ROUTES, 0)
packed_tail2.routes = dict.fromkeys(TAIL_ROUTES, 0)
