"""Fused valid dilated 3x3x3 conv + bias + ReLU (NDHWC) — the port of K1.

Counterpart of ``flypylib_tpu/ops/pallas_conv.py``: ``conv3d_bias_relu``
computes one body layer of the baseline ``ConvStack``.  On a CUDA tensor it
launches the hand-written kernel in ``csrc/conv3d_bias_relu.cu`` (built by
``ops/_build.py`` on first use); on a CPU tensor it runs the plain version,
:func:`conv3d_reference`.  There is no fallback between the two: a CUDA
tensor the kernel cannot take raises.

Rounding follows the TPU kernel, not Flax: weights and bias are cast to
``x.dtype``, the sum is accumulated in f32, the bias is added in f32, ReLU
is applied, and the result is rounded to ``x.dtype`` once.

The f32 products that every plain version shares live here too:
:func:`conv3d_f32` and :func:`matmul_f32`, with TF32 off on the card
(:func:`no_tf32`) and oneDNN off for convolutions on the CPU.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CO = 128
DILATIONS = (1, 2, 4)


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


def conv3d_f32(x: torch.Tensor, w: torch.Tensor,
               dilation: int = 1) -> torch.Tensor:
    """Valid conv of NDHWC ``x`` with DHWIO ``w``, both cast to f32 (exact
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
            y = F.conv3d(xf, wf, dilation=int(dilation))
    else:
        with no_tf32(x.device):
            y = F.conv3d(xf, wf, dilation=int(dilation))
    return y.permute(0, 2, 3, 4, 1)


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` over the last axis with both cast to f32 (exact from bf16)
    and summed in f32, TF32 off on CUDA: a (..., K) @ w (K, N) -> (..., N)."""
    with no_tf32(a.device):
        return torch.matmul(a.float(), w.float())


def conv3d_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch version: f32 ``F.conv3d`` + f32 bias + ReLU, one
    rounding to ``x.dtype`` (the rounding point of ``pallas_conv.py:100``).

    x (B, D, H, W, Ci), w (3, 3, 3, Ci, Co) DHWIO, b (Co,) ->
    (B, D-2d, H-2d, W-2d, Co) in ``x.dtype``."""
    _out_shape(x, w, b, dilation)
    dt = x.dtype
    y = conv3d_f32(x, w.to(dt), dilation)
    y = torch.relu(y + b.to(dt).float())
    return y.to(dt).contiguous()


def conv3d_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     dilation: int = 1) -> torch.Tensor:
    """Fused valid conv3d (3x3x3, dilated) + bias + ReLU.

    x: (B, D, H, W, Ci) bf16 or f32; w: (3, 3, 3, Ci, Co); b: (Co,).
    Returns (B, D-2d, H-2d, W-2d, Co) in ``x.dtype``.  A CPU tensor runs
    :func:`conv3d_reference`; a CUDA tensor launches the kernel (and adds
    one to ``conv3d_bias_relu.launches``) or raises."""
    if x.device.type == "cpu":
        return conv3d_reference(x, w, b, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3d_bias_relu for device {x.device}")
    shape = _out_shape(x, w, b, dilation)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.device != x.device or b.device != x.device:
        raise ValueError("x, w and b must be on the same device")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NDHWC)")
    if int(dilation) not in DILATIONS:
        raise ValueError(f"dilation must be one of {DILATIONS}, got {dilation}")
    if shape[4] > MAX_CO:
        raise ValueError(f"Co must be <= {MAX_CO}, got {shape[4]}")

    from flypylib_tpu_torch.ops._build import load_library

    lib = load_library()
    wc = w.to(x.dtype).contiguous()
    bc = b.to(x.dtype).contiguous()
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:  # B == 0: a launch with an empty grid is refused
        return out
    B, D, H, W, Ci = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fpl_conv3d_bias_relu(
            x.data_ptr(), wc.data_ptr(), bc.data_ptr(), out.data_ptr(),
            B, D, H, W, Ci, shape[4], int(dilation), _DTYPE_CODES[x.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3d_bias_relu kernel launch failed: cudaError {err}")
    conv3d_bias_relu.launches += 1
    return out


conv3d_bias_relu.launches = 0
