"""Fused valid dilated 3x3x3 conv + bias + ReLU (NDHWC) — the port of K1.

Counterpart of ``flypylib_tpu/ops/pallas_conv.py``: ``conv3d_bias_relu``
computes one body layer of the baseline ``ConvStack``; with ``relu=False``
it leaves the ReLU out, for a BatchNorm layer's conv (the normalisation
comes between the conv and the ReLU).  On a CUDA tensor it
launches a hand-written kernel (built by ``ops/_build.py`` on first use); on
a CPU tensor it runs the plain version, :func:`conv3d_reference`.  There is
no fallback between the two: a CUDA tensor the kernel cannot take raises.

Which kernel takes a CUDA call is a rule on shape, dtype, alignment and
dilation, decided before the launch (:func:`k1_route`): bf16 with Ci > 1,
Ci and Co multiples of 8 and a 16-byte-aligned ``x`` runs the wgmma/TMA
kernel of ``csrc/conv3d_wgmma.cu`` ("wgmma"); f32 with Ci > 1, Ci a
multiple of 4, a 16-byte-aligned ``x`` and a dilation of at most
``SIMT_MAX_DILATION`` runs the FMA/TMA kernel of ``csrc/conv3d_f32.cu``
("simt"); ``csrc/conv3d_bias_relu.cu`` keeps Ci = 1 ("ci1"), the other bf16
calls ("wmma") and the other f32 calls ("fma").  Every route takes any Co,
and every route but "simt" any dilation, as the reference does: the wgmma
kernel runs a layer wider than its widest N tile as one launch per block of
output channels (:func:`wgmma_chunks`), the others loop over channel blocks
themselves.  The Ci = 1 kernel is handed its output box by :func:`ci1_plan`,
the f32 kernel its box and channel block by :func:`simt_plan`.

Rounding follows the TPU kernel, not Flax: weights and bias are cast to
``x.dtype``, the sum is accumulated in f32, the bias is added in f32, ReLU
is applied (unless ``relu=False``), and the result is rounded to
``x.dtype`` once.

The f32 products that every plain version shares live here too:
:func:`conv3d_f32` and :func:`matmul_f32`, with TF32 off on the card
(:func:`no_tf32`) and oneDNN off for convolutions on the CPU.

Training differentiates K1 through :class:`Conv3dBiasReLU`, an
``autograd.Function`` whose forward is :func:`conv3d_bias_relu` (the kernel
on the card) and whose backward is written out here; the wrapper alone
writes its output through a raw pointer, which autograd cannot see.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
K1_ROUTES = ("wgmma", "wmma", "ci1", "simt", "fma")
WGMMA_N_TILES = (24, 32, 48, 64, 96, 128)  # the kernel's N tiles
WGMMA_KC = 32  # channels per K step of the wgmma kernel (a 64-byte row)
WGMMA_ROWS = 256  # output voxels per block of the wgmma kernel
CI1_VOXELS = 1024  # output voxels per block of the Ci = 1 kernel, at most
CI1_SMEM_FLOATS = 50 * 1024  # f32 values of halo a block of it may stage
SIMT_SLICE = 4     # input channels per slice of the f32 kernel: 16 bytes a voxel
SIMT_VOXELS = 256  # output voxels per block of the f32 kernel, at most
SIMT_WIDEST = 64   # output channels per block of it, at most
SIMT_STAGES = 2    # slices in its shared-memory ring
SIMT_SMEM = 226 * 1024  # dynamic shared memory a block of it may take
SIMT_MAX_DILATION = 7   # the largest dilation whose halo fits its smallest box


def _out_shape(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               dilation: int) -> tuple[int, ...]:
    if x.dim() != 5:
        raise ValueError(f"x must be (B, D, H, W, Ci), got {tuple(x.shape)}")
    B, D, H, W, Ci = x.shape
    if tuple(w.shape[:4]) != (3, 3, 3, Ci) or w.dim() != 5:
        raise ValueError(
            f"w must be (3, 3, 3, {Ci}, Co), got {tuple(w.shape)}"
        )
    Co = w.shape[4]
    if tuple(b.shape) != (Co,):
        raise ValueError(f"b must be ({Co},), got {tuple(b.shape)}")
    d = int(dilation)
    out = (B, D - 2 * d, H - 2 * d, W - 2 * d, Co)
    if min(out[1:4]) <= 0:
        raise ValueError("input smaller than receptive field")
    return out


@contextlib.contextmanager
def no_tf32(device: torch.device):
    """On a CUDA device, cuDNN's and cuBLAS's TF32, which rounds f32 inputs
    to 10 mantissa bits (cuDNN's is on by default), is off for the block."""
    if device.type != "cuda":
        yield
        return
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def conv3d_f32(x: torch.Tensor, w: torch.Tensor, dilation: int = 1,
               padding=0) -> torch.Tensor:
    """Valid conv of NDHWC ``x`` with DHWIO ``w`` (``x`` zero-padded by
    ``padding`` on each side, as ``F.conv3d``'s), both cast to f32 (exact
    from bf16), summed in f32: an NDHWC f32 tensor.

    On the CPU the conv runs with oneDNN off: oneDNN picks its summation
    order by batch and extent, so a tile and the whole volume would round
    differently, while PyTorch's own CPU convolution sums every output voxel
    in one order (tiled == monolithic, bitwise).  The flag is process-wide,
    so this path is not thread-safe: a CPU conv on another thread meanwhile
    also runs without oneDNN.  On CUDA, TF32 is off (:func:`no_tf32`)."""
    xf = x.float().permute(0, 4, 1, 2, 3)                      # NCDHW
    wf = w.float().permute(4, 3, 0, 1, 2)                      # OIDHW
    if x.device.type == "cpu":
        # None leaves oneDNN's other settings as they are
        with torch.backends.mkldnn.flags(enabled=False, deterministic=None,
                                         allow_tf32=None, fp32_precision=None):
            y = F.conv3d(xf, wf, padding=padding, dilation=int(dilation))
    else:
        with no_tf32(x.device):
            y = F.conv3d(xf, wf, padding=padding, dilation=int(dilation))
    return y.permute(0, 2, 3, 4, 1)


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` over the last axis with both cast to f32 (exact from bf16)
    and summed in f32, TF32 off on CUDA: a (..., K) @ w (K, N) -> (..., N).

    On the CPU one output column (the logits) is a row sum of the products:
    BLAS's matrix-vector path sums a row in an order that follows the row
    count, so the logits of a voxel would follow the size of the block it
    was computed in (tiled or sharded against monolithic)."""
    if a.device.type == "cpu" and w.shape[-1] == 1:
        return (a.float() * w.float()[:, 0]).sum(-1, keepdim=True)
    with no_tf32(a.device):
        return torch.matmul(a.float(), w.float())


def conv3d_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     dilation: int = 1, relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: f32 ``F.conv3d`` + f32 bias + ReLU (none with
    ``relu=False``), one rounding to ``x.dtype`` (the rounding point of
    ``pallas_conv.py:100``).

    x (B, D, H, W, Ci), w (3, 3, 3, Ci, Co) DHWIO, b (Co,) ->
    (B, D-2d, H-2d, W-2d, Co) in ``x.dtype``."""
    _out_shape(x, w, b, dilation)
    dt = x.dtype
    y = conv3d_f32(x, w.to(dt), dilation) + b.to(dt).float()
    if relu:
        y = torch.relu(y)
    return y.to(dt).contiguous()


def k1_route(x: torch.Tensor, w: torch.Tensor, dilation: int = 1) -> str:
    """Which of K1's CUDA kernels takes ``x`` (B, D, H, W, Ci) and ``w``
    (3, 3, 3, Ci, Co) at ``dilation``: "ci1" for Ci = 1; for bf16, "wgmma"
    with Ci and Co multiples of 8 and ``x`` on a 16-byte boundary (the TMA
    tensor map's rules; the weights are repacked, so their alignment does
    not matter), else "wmma"; for f32, "simt" with Ci a multiple of 4 (16
    bytes a voxel's slice), ``x`` on a 16-byte boundary and a dilation of at
    most SIMT_MAX_DILATION (a halo that fits shared memory), else "fma"."""
    ci, co = x.shape[-1], w.shape[-1]
    if ci == 1:
        return "ci1"
    aligned = x.data_ptr() % 16 == 0
    if x.dtype != torch.bfloat16:
        if (ci % SIMT_SLICE == 0 and aligned
                and int(dilation) <= SIMT_MAX_DILATION):
            return "simt"
        return "fma"
    if ci % 8 == 0 and co % 8 == 0 and aligned:
        return "wgmma"
    return "wmma"


def wgmma_tile(co: int) -> int:
    """The wgmma kernel's N tile for ``co`` output channels: the smallest
    that holds Co."""
    n_tile = next((n for n in WGMMA_N_TILES if n >= co), None)
    if n_tile is None:
        raise ValueError(f"Co must be <= {WGMMA_N_TILES[-1]}, got {co}")
    return n_tile


def wgmma_chunks(co: int, widest: int = WGMMA_N_TILES[-1],
                 unit: int = 8) -> list[tuple[int, int]]:
    """The blocks of output channels ``(first, count)`` a kernel whose
    widest block is ``widest`` runs ``co`` channels in, one launch each (by
    default K1's wgmma kernel and its widest N tile): one block up to
    ``widest``; above it the fewest blocks, of equal width rounded up to a
    multiple of ``unit`` (Co = 192 runs as 96 + 96, not 128 + 64)."""
    n = -(-co // widest)
    width = -(-co // (unit * n)) * unit
    return [(c0, min(width, co - c0)) for c0 in range(0, co, width)]


@functools.lru_cache(maxsize=256)
def wgmma_box(out_dhw: tuple[int, int, int], rows: int = WGMMA_ROWS,
              halo: int = 2) -> tuple[int, int, int]:
    """The output box (bz, by, bx) of one block, bz*by*bx <= ``rows``: the
    box that covers ``out_dhw`` in the fewest blocks (the masked ragged
    edge is the least work), and of those the most compact one (the least
    halo, so the taps' loads overlap most in L2).  ``halo`` is what the
    taps reach past the box on each axis: 2 for K1's 3^3 conv (at d = 1),
    1 for a 2^3 stage."""
    best = None  # rows <= 256, so no box side passes TMA's limit of 256
    for bz in range(1, rows + 1):
        for by in range(1, rows // bz + 1):
            box = (bz, by, rows // (bz * by))
            tiles = 1
            for e, s in zip(out_dhw, box):
                tiles *= -(-e // s)
            key = (tiles, (bz + halo) * (by + halo) * (box[2] + halo))
            if best is None or key < best[0]:
                best = (key, box)
    return best[1]


@functools.lru_cache(maxsize=256)
def ci1_plan(out_dhw: tuple[int, int, int],
             dilation: int) -> tuple[int, int, int, bool]:
    """What the Ci = 1 kernel is handed for an output of ``out_dhw`` voxels:
    the output box (bz, by, bx) of one block, no side past the output's and
    bz*by*bx <= CI1_VOXELS (four voxels a thread), bx at least a warp's 32
    voxels (or the whole row), so that a warp's loads and stores run along
    x; of those the box that covers the output in the fewest blocks, then
    the one with the smallest input halo (bz+2d)(by+2d)(bx+2d); and whether that halo fits the shared memory the
    block stages it in (else the kernel reads the input through L1)."""
    d = int(dilation)
    Do, Ho, Wo = out_dhw
    best = None
    for bz in range(1, min(Do, CI1_VOXELS) + 1):
        for by in range(1, min(Ho, CI1_VOXELS // bz) + 1):
            bx = min(Wo, CI1_VOXELS // (bz * by))
            if bx < min(Wo, 32):
                break
            tiles = -(-Do // bz) * -(-Ho // by) * -(-Wo // bx)
            key = (tiles, (bz + 2 * d) * (by + 2 * d) * (bx + 2 * d))
            if best is None or key < best[0]:
                best = (key, (bz, by, bx))
    (_, halo), box = best
    return (*box, halo <= CI1_SMEM_FLOATS)


def simt_width(co: int, widest: int = SIMT_WIDEST) -> int:
    """The output channels one block of the f32 kernel owns: the first of
    :func:`wgmma_chunks`' blocks at a widest block of ``widest`` (K1's
    SIMT_WIDEST by default), rounded up to a multiple of 8 (a warp's
    group); the last block may be narrower."""
    return -(-wgmma_chunks(co, widest)[0][1] // 8) * 8


def simt_smem_bytes(box: tuple[int, int, int], dilation: int, width: int,
                    taps: int = 3, stages: int = SIMT_STAGES) -> int:
    """Dynamic shared memory of one block of the f32 kernel: ``stages``
    stages, each the box's halo of one slice (16 bytes a voxel, ``taps - 1``
    dilations past the box on each axis) and the slice's weights for
    ``taps``^3 taps and ``width`` channels, each part starting on 1024
    bytes, plus 1024 bytes to align the first (as ``csrc/conv3d_f32.cu``
    lays them out)."""
    def kb(n):  # n rounded up to 1024
        return -(-n // 1024) * 1024

    r = (taps - 1) * int(dilation)
    halo = math.prod(b + r for b in box) * 4 * SIMT_SLICE
    weights = taps ** 3 * width * SIMT_SLICE * 4
    return stages * kb(kb(halo) + weights) + 1024


@functools.lru_cache(maxsize=256)
def simt_plan(out_dhw: tuple[int, int, int], dilation: int, co: int,
              taps: int = 3, stages: int = SIMT_STAGES,
              widest: int = SIMT_WIDEST) -> tuple[int, int, int, int, int]:
    """What the f32 kernel is handed for an output of ``out_dhw`` voxels and
    ``co`` channels at ``dilation``: ``(bz, by, bx, width, smem bytes)``;
    ``taps`` a side, ``stages`` in the ring and the ``widest`` channel block
    are K1's by default (a tail stage: 2 taps at d = 1 and
    ``ops/tail.py``'s TAIL_SIMT_STAGES and TAIL_SIMT_WIDEST).

    The box holds at most SIMT_VOXELS voxels, bz and by no more than the
    output's, and bx a multiple of 8 up to the output's row rounded up to 8
    (the whole row where it is shorter than 8): a quarter-warp's eight lanes
    then read eight neighbouring 16-byte records of one halo row, in eight
    different banks.  Its halo (``taps - 1`` dilations past the box) fits
    TMA's box (at most 256 on each axis) and a block's shared memory
    (:func:`simt_smem_bytes` <= SIMT_SMEM).  Of those boxes, the one that
    covers the output in the fewest blocks (the masked ragged edge is the
    least work), then the one with the smallest halo.  ``width`` is
    :func:`simt_width` at ``widest``.  Raises ValueError when no box
    fits."""
    r = (taps - 1) * int(dilation)
    width = simt_width(co, widest)
    Do, Ho, Wo = out_dhw
    widths = [Wo] if Wo < 8 else list(range(8, -(-Wo // 8) * 8 + 1, 8))
    best = None
    for bz in range(1, min(Do, SIMT_VOXELS) + 1):
        for by in range(1, min(Ho, SIMT_VOXELS // bz) + 1):
            for bx in widths:
                box = (bz, by, bx)
                if (bz * by * bx > SIMT_VOXELS
                        or max(box) + r > 256
                        or simt_smem_bytes(box, dilation, width, taps,
                                           stages) > SIMT_SMEM):
                    break  # the widths run upward
                tiles = -(-Do // bz) * -(-Ho // by) * -(-Wo // bx)
                key = (tiles, math.prod(b + r for b in box))
                if best is None or key < best[0]:
                    best = (key, box)
    if best is None:
        raise ValueError(f"no box of the f32 kernel fits dilation {dilation}")
    box = best[1]
    return (*box, width, simt_smem_bytes(box, dilation, width, taps, stages))


def simt_weights(w: torch.Tensor, width: int) -> torch.Tensor:
    """The weight image the f32 kernel copies one slice at a time, for ``w``
    (T, T, T, Ci, Co) (T = 3 for K1, 2 for a tail stage):
    ``img[cb, s, tap, g, c, k] = w[tap, 4 s + c, cb * width + 8 g + k]``,
    tap = T^2 tz + T ty + tx, zero where that channel is past Co; shape
    (ceil(Co / width), Ci / 4, T^3, width / 8, 4, 8), f32, contiguous.  A
    slice's taps are one contiguous run, and so are a tap's 4 x 8 weights
    of one consumer warp's group of 8 output channels."""
    taps, ci, co = w.shape[0] ** 3, w.shape[3], w.shape[4]
    n_cb = -(-co // width)
    wp = torch.zeros((taps, ci, n_cb * width), dtype=torch.float32,
                     device=w.device)
    wp[..., :co] = w.reshape(taps, ci, co)
    return (wp.view(taps, ci // SIMT_SLICE, SIMT_SLICE, n_cb, width // 8, 8)
            .permute(3, 1, 0, 4, 2, 5).contiguous())


def wgmma_slices(ci: int) -> tuple[int, int | None]:
    """(number of 32-channel slices, first channel of the 16-channel slice
    or None) of the wgmma kernel's K steps per tap for ``ci`` input
    channels: Ci // 32 slices of 32; a rest of 1-16 channels in one
    16-channel slice ending at channel Ci (so it reaches past Ci only if
    Ci < 16); a rest of 17-31 in one more 32-channel slice."""
    n_full, rest = divmod(ci, WGMMA_KC)
    if rest == 0:
        return n_full, None
    if rest <= WGMMA_KC // 2:
        return n_full, max(ci - WGMMA_KC // 2, 0)
    return n_full + 1, None


def wgmma_weights(w: torch.Tensor,
                  n_tile: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The weight images the wgmma kernel loads, one (n_tile, 32 or 16)
    slice per K step (:func:`wgmma_slices`), tap = 9 tz + 3 ty + tx:

    - ``w32[tap, s, o, c] = w[tap, 32 s + c, o]`` for the 32-channel slices,
      shape (27, n_full, n_tile, 32);
    - ``w16[tap, o, c] = w[tap, c0 + c, o]`` for the 16-channel slice that
      starts at channel c0, shape (27, n_tile, 16), or None when there is
      none; zero for a channel a 32-channel slice already holds;

    zero past Ci and where o >= Co; bf16, contiguous.  Each slice is
    K-major, 64 (or 32) bytes per output channel, which the TMA load
    swizzles as the kernel's wgmma descriptor expects."""
    return weight_images(w.reshape(27, w.shape[3], w.shape[4]), n_tile)


def weight_images(w: torch.Tensor,
                  n_tile: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`wgmma_weights` for ``w`` (taps, Ci, Co) with any number of
    taps (27 for K1's 3^3 conv, 8 for the decoder tail's 2^3 stages):
    ``(w32 (taps, n_full, n_tile, 32), w16 (taps, n_tile, 16) or None)``."""
    taps, ci, co = w.shape
    n_full, c0 = wgmma_slices(ci)
    wk = w.to(torch.bfloat16).transpose(1, 2)  # K-major
    k = min(ci, n_full * WGMMA_KC)
    w32 = torch.zeros((taps, n_tile, n_full * WGMMA_KC), dtype=torch.bfloat16,
                      device=w.device)
    w32[:, :co, :k] = wk[:, :, :k]
    w32 = w32.view(taps, n_tile, n_full, WGMMA_KC).transpose(1, 2).contiguous()
    if c0 is None:
        return w32, None
    w16 = torch.zeros((taps, n_tile, WGMMA_KC // 2), dtype=torch.bfloat16,
                      device=w.device)
    lo = n_full * WGMMA_KC  # channels the 32-channel slices hold
    w16[:, :co, lo - c0:ci - c0] = wk[:, :, lo:ci]
    return w32, w16


def conv3d_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     dilation: int = 1, relu: bool = True) -> torch.Tensor:
    """Fused valid conv3d (3x3x3, dilated) + bias + ReLU (no ReLU with
    ``relu=False``, on every route).

    x: (B, D, H, W, Ci) bf16 or f32; w: (3, 3, 3, Ci, Co); b: (Co,).
    Returns (B, D-2d, H-2d, W-2d, Co) in ``x.dtype``.  A CPU tensor runs
    :func:`conv3d_reference`; a CUDA tensor launches the kernel that
    :func:`k1_route` names (and adds one to ``conv3d_bias_relu.launches``
    and to that route's ``conv3d_bias_relu.routes``) or raises."""
    if x.device.type == "cpu":
        return conv3d_reference(x, w, b, dilation, relu)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3d_bias_relu for device {x.device}")
    shape = _out_shape(x, w, b, dilation)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.device != x.device or b.device != x.device:
        raise ValueError("x, w and b must be on the same device")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NDHWC)")
    if int(dilation) < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")

    from flypylib_tpu_torch.ops._build import load_library

    lib = load_library()
    route = k1_route(x, w, dilation)
    bc = b.to(x.dtype).contiguous()
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:  # B == 0: a launch with an empty grid is refused
        return out
    B, D, H, W, Ci = x.shape
    Co, d, act = shape[4], int(dilation), int(bool(relu))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "wgmma":
            bz, by, bx = wgmma_box(shape[1:4])
            for c0, cn in wgmma_chunks(Co):
                n_tile = wgmma_tile(cn)
                w32, w16 = wgmma_weights(w[..., c0:c0 + cn], n_tile)
                err = lib.fpl_conv3d_wgmma(
                    x.data_ptr(), w32.data_ptr() if w32.numel() else None,
                    w16.data_ptr() if w16 is not None else None,
                    bc[c0:].data_ptr(), out[..., c0:].data_ptr(), B, D, H, W,
                    Ci, cn, Co, d, n_tile, bz, by, bx, act, stream)
                if err != 0:
                    break
        elif route == "simt":
            bz, by, bx, width, _ = simt_plan(shape[1:4], d, Co)
            img = simt_weights(w, width)
            err = lib.fpl_conv3d_f32(
                x.data_ptr(), img.data_ptr(), bc.data_ptr(), out.data_ptr(),
                B, D, H, W, Ci, Co, d, width, bz, by, bx, act, stream)
        elif route == "ci1":
            wc = w.to(x.dtype).contiguous()
            bz, by, bx, staged = ci1_plan(shape[1:4], d)
            err = lib.fpl_conv3d_ci1(
                x.data_ptr(), wc.data_ptr(), bc.data_ptr(), out.data_ptr(),
                B, D, H, W, Co, d, bz, by, bx, int(staged),
                _DTYPE_CODES[x.dtype], act, stream)
        else:
            wc = w.to(x.dtype).contiguous()
            err = lib.fpl_conv3d_bias_relu(
                x.data_ptr(), wc.data_ptr(), bc.data_ptr(), out.data_ptr(),
                B, D, H, W, Ci, Co, d, _DTYPE_CODES[x.dtype], act, stream)
    if err != 0:
        raise RuntimeError(f"conv3d_bias_relu kernel launch failed ({route} "
                           f"route): cudaError {err}")
    conv3d_bias_relu.launches += 1
    conv3d_bias_relu.routes[route] += 1
    return out


conv3d_bias_relu.launches = 0
conv3d_bias_relu.routes = dict.fromkeys(K1_ROUTES, 0)


class Conv3dBiasReLU(torch.autograd.Function):
    """:func:`conv3d_bias_relu` with a gradient (``apply(x, w, b, dilation,
    relu=True)``).

    Forward: the kernel on a CUDA tensor, :func:`conv3d_reference` on a CPU
    one; it saves ``x``, ``w`` and the output ``y``.  Backward, with ``g =
    dy * (y > 0)`` (ReLU'(0) = 0, as JAX's; ``g = dy`` with ``relu=False``,
    whose output is the conv itself): ``db = sum g`` in
    f32, ``dw`` and ``dx`` by PyTorch's convolution gradients
    (``torch.nn.grad.conv3d_weight`` / ``conv3d_input``, NCDHW, TF32 off)
    of the model-dtype values, summed in f32 and rounded to the model dtype
    once: a cuDNN conv in that dtype on the card, an f32 conv on the CPU
    (as every plain version here), ``dx`` only when ``x`` needs one (a
    model's first layer's input does not).  The reference's plain stack
    differentiates XLA convolutions, and no Pallas kernel of it has a
    backward, so there is no backward kernel to port: the library's conv
    gradients are the counterpart of XLA's.  The weight and bias gradients
    are those of the parameters before their cast to ``x.dtype``."""

    @staticmethod
    def forward(ctx, x, w, b, dilation, relu=True):
        y = conv3d_bias_relu(x, w, b, dilation, relu)
        ctx.save_for_backward(x, w, y)
        ctx.dilation = int(dilation)
        ctx.relu = bool(relu)
        ctx.b_dtype = b.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        d, dt = ctx.dilation, x.dtype
        g = dy * (y > 0) if ctx.relu else dy
        db = g.float().sum(dim=(0, 1, 2, 3)).to(ctx.b_dtype)
        # the conv operands: the model-dtype values, as f32 on the CPU
        ct = dt if x.device.type == "cuda" else torch.float32
        xn = x.to(ct).permute(0, 4, 1, 2, 3)              # NCDHW
        gn = g.to(dt).to(ct).permute(0, 4, 1, 2, 3)
        wn = w.to(dt).to(ct).permute(4, 3, 0, 1, 2)      # OIDHW
        dx = None
        with no_tf32(x.device):
            dw = torch.nn.grad.conv3d_weight(xn, wn.shape, gn, dilation=d)
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv3d_input(xn.shape, wn, gn, dilation=d)
                dx = dx.to(dt).permute(0, 2, 3, 4, 1)
        dw = dw.to(dt).permute(2, 3, 4, 1, 0).to(w.dtype)  # DHWIO
        return dx, dw, db, None, None
