"""Runtime guards under ``FASTMATCH_CHECKIFY``.

Port of ``fastmatch_tpu/utils/guards.py``. The JAX package wraps a call in
``jax.experimental.checkify`` (index, float and user checks); PyTorch has no
such transform, so the same meaning is written in PyTorch's idiom:

- ``checked(fn, bounds)``: before the call, every index input that
  ``bounds`` names is checked against its bound (on the card an
  out-of-range index would be a device-side assert that poisons the CUDA
  context, so it is caught before any launch); during the call, every
  PyTorch operator's output is checked for NaN (``debug_nans``, checkify's
  float checks); after it, every floating tensor of the output must be
  finite. A failed check raises with its message (``IndexError``,
  ``FloatingPointError``). Each check reads a flag back from the device:
  a debugging mode.
- ``maybe_checked(fn, bounds)``: ``checked`` when the flag is set, else
  ``fn`` itself, so the production path pays nothing.
- ``debug_nans()``: a ``TorchDispatchMode`` that raises at the first
  operator whose output holds a NaN, naming the operator (the JAX
  package's scoped ``jax_debug_nans``).
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def checkify_enabled() -> bool:
    return os.environ.get("FASTMATCH_CHECKIFY", "") not in ("", "0")


def _check_indices(checks):
    for name, idx, n in checks:
        if idx.numel() == 0:
            continue
        lo, hi = torch.aminmax(idx)
        lo, hi = int(lo), int(hi)
        if lo < 0 or hi >= n:
            raise IndexError(f"out-of-bounds index: {name} spans [{lo}, {hi}], "
                             f"bound [0, {n})")


def _check_finite(out, name: str):
    for leaf in tree_leaves(out):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and not bool(torch.isfinite(leaf).all())):
            raise FloatingPointError(f"non-finite value in the output of {name}")


def checked(fn, bounds=None):
    """``fn`` with its index inputs checked before the call, NaNs caught at
    the operator that makes them, and its floating outputs checked after
    it. ``bounds(*args, **kwargs)`` returns the index checks, ``(name,
    index tensor, bound)`` each: every index must lie in ``[0, bound)``."""
    name = getattr(fn, "__name__", repr(fn))

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if bounds is not None:
            _check_indices(bounds(*args, **kwargs))
        with debug_nans():
            out = fn(*args, **kwargs)
        _check_finite(out, name)
        return out

    return wrapper


def maybe_checked(fn, bounds=None):
    """``checked(fn, bounds)`` when FASTMATCH_CHECKIFY is set, else ``fn``
    unchanged."""
    return checked(fn, bounds) if checkify_enabled() else fn


# Allocations return uninitialised memory, which may hold NaN bit patterns.
_UNINITIALISED = {"empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided"}


class _NanMode(TorchDispatchMode):
    """Raises at the first operator that produces a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALISED:
            return out
        for leaf in tree_leaves(out):
            if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                    and bool(torch.isnan(leaf).any())):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN detection: any operator that produces a NaN inside the
    scope raises, naming the operator."""
    if not enable:
        yield
        return
    with _NanMode():
        yield
