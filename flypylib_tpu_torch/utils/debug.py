"""Debug toggles: NaN/Inf checks on every op.

Counterpart of ``flypylib_tpu/utils/debug.py``.  ``enable_nan_checks``,
``disable_nan_checks`` and the ``nan_checks()`` context make every PyTorch
op that returns a floating tensor holding a NaN (and, with ``infs``, an
Inf) raise ``FloatingPointError`` naming the op, as ``jax_debug_nans`` /
``jax_debug_infs`` do for the reference.  The check is a
``torch.overrides.TorchFunctionMode`` that looks at each op's outputs, so
on a card every op synchronises: a debugging tool, not a production mode.
Functions that return uninitialised memory (``empty``, ``empty_like``, ...)
are not checked.  Hand-written kernels write through raw pointers, outside
PyTorch's dispatch, so their outputs are checked when the next op reads
them.

The reference's ``eager_mode`` (``jax.disable_jit``) and
``log_recompiles`` (``jax_log_compiles``) have nothing to act on here: the
port runs eagerly and compiles nothing at run time but its kernels, which
``ops/_build.py`` builds once and caches by source hash.
"""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode


def _bad(t: torch.Tensor, infs: bool) -> str | None:
    if not (isinstance(t, torch.Tensor) and t.is_floating_point()) or not t.numel():
        return None
    if bool(torch.isnan(t).any()):
        return "NaN"
    if infs and bool(torch.isinf(t).any()):
        return "Inf"
    return None


class NanCheckMode(TorchFunctionMode):
    """Raise ``FloatingPointError`` when an op's output holds a NaN (or,
    with ``infs``, an Inf)."""

    def __init__(self, infs: bool = True):
        super().__init__()
        self.infs = infs

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", str(func))
        if "empty" in name:
            return out
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            what = _bad(t, self.infs)
            if what is not None:
                raise FloatingPointError(f"{what} in the output of {name}")
        return out


_active: list[NanCheckMode] = []  # the mode enable_nan_checks entered


def enable_nan_checks(infs: bool = True) -> None:
    """Check every op's outputs from now on (until :func:`disable_nan_checks`)."""
    if _active:
        return
    mode = NanCheckMode(infs)
    mode.__enter__()
    _active.append(mode)


def disable_nan_checks() -> None:
    """Stop the checks :func:`enable_nan_checks` started."""
    while _active:
        _active.pop().__exit__(None, None, None)


@contextlib.contextmanager
def nan_checks():
    """Context manager form of NaN/Inf checking."""
    enable_nan_checks()
    try:
        yield
    finally:
        disable_nan_checks()
