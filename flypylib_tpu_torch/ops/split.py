"""The packed ConvStack's stage-A -> stage-B parity relayout — the port of K5.

Counterpart of ``flypylib_tpu/ops/pallas_split.py``: ``(B, d, h, w, 8c) ->
(8B, d, h, w, c)`` with the new batch index ``b * 8 + parity``, a bit-exact
copy.  On a CUDA tensor :func:`parity_split_kernel` launches the
hand-written kernel in ``csrc/parity_split.cu`` (built by ``ops/_build.py``
on first use); on a CPU tensor it runs the plain version,
:func:`parity_split_reference`, the reference's ``parity_split_xla``.
There is no fallback between the two: a CUDA tensor the kernel cannot take
raises.  ``ops.packed_conv.parity_batch`` is its caller.

The reference's four TPU variants (``variant=``) are one kernel here.
"""

from __future__ import annotations

import torch

_DTYPES = (torch.float32, torch.bfloat16)


def _split_shape(x: torch.Tensor) -> tuple[int, ...]:
    if x.dim() != 5:
        raise ValueError(f"x must be (B, d, h, w, 8c), got {tuple(x.shape)}")
    b, d, h, w, c8 = x.shape
    if c8 % 8:
        raise ValueError(f"channels must be a multiple of 8, got {c8}")
    return 8 * b, d, h, w, c8 // 8


def parity_split_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x.reshape(b, d, h, w, 8, c).permute(0, 4, 1, 2, 3,
    5).reshape(8b, d, h, w, c)`` (``pallas_split.py:191-196``)."""
    b8, d, h, w, c = _split_shape(x)
    y = x.reshape(b8 // 8, d, h, w, 8, c).permute(0, 4, 1, 2, 3, 5)
    return y.reshape(b8, d, h, w, c)


def parity_split_kernel(x: torch.Tensor) -> torch.Tensor:
    """(B, d, h, w, 8c) -> (8B, d, h, w, c), batch-major and parity-minor.

    A CPU tensor runs :func:`parity_split_reference`; a CUDA tensor
    (float32 or bfloat16, contiguous) launches the kernel as the operator
    ``fpl::parity_split`` (and adds one to ``parity_split_kernel.launches``)
    or raises."""
    shape = _split_shape(x)
    if x.device.type == "cpu":
        return parity_split_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"no parity_split_kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NDHWC)")
    if 0 in shape:  # a launch with an empty grid is refused
        return torch.empty(shape, dtype=x.dtype, device=x.device)
    out = torch.ops.fpl.parity_split(x)
    parity_split_kernel.launches += 1
    return out


def _parity_split_cuda(x: torch.Tensor) -> torch.Tensor:
    """``fpl::parity_split`` on the card: the kernel's launch (the checks
    are :func:`parity_split_kernel`'s)."""
    from flypylib_tpu_torch.ops._build import load_library

    out = torch.empty(_split_shape(x), dtype=x.dtype, device=x.device)
    b, d, h, w, c8 = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = load_library().fpl_parity_split(
            x.data_ptr(), out.data_ptr(), b, d, h, w, c8 // 8,
            x.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"parity_split kernel launch failed: cudaError {err}")
    return out


# The launch is an operator of its own, so that torch.profiler ties the
# kernel to the ranges open around the call (``ops/tail.py`` says why)
_OPS = torch.library.Library("fpl", "FRAGMENT")
_OPS.define("parity_split(Tensor x) -> Tensor")
_OPS.impl("parity_split", _parity_split_cuda, "CUDA")


parity_split_kernel.launches = 0
