"""Deterministic sorted segment sum (K4) and sorted row gather (K5).

Port of ``fastmatch_tpu/kernels/segment_ops.py``:

- ``sorted_segment_sum``: ``out[s] = sum of vals rows with seg == s`` for
  ``seg`` sorted ascending. On a CUDA tensor it launches
  ``csrc/segment_sum.cu`` (fp32, fixed summation order, no float atomics:
  two runs are bit-identical); on a CPU tensor it takes
  ``segment_sum_plain``. Keys outside [0, n_segments) are dropped, as
  ``jax.ops.segment_sum`` drops them.
- ``sorted_gather_rows``: ``out[o] = table[seg[o]]``, the reverse direction.
  On a CUDA tensor it launches ``csrc/gather_rows.cu`` (an exact copy; the
  TPU kernel's bf16 hi/lo product is a TPU workaround), on a CPU tensor it
  takes ``gather_rows_plain``. Keys outside [0, rows) give zero rows, as
  the TPU kernel's one-hot product does. Sorted keys are what the BA tables
  give it; any order gives the same result.
"""

from __future__ import annotations

import ctypes

import torch

from fastmatch_tpu_torch.kernels import _build

MAX_COLS = 256  # one column per thread of a 256-thread block
# Both C entry points: (pointer, pointer, int, int, int, pointer, stream).
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def segment_sum_plain(vals: torch.Tensor, seg: torch.Tensor, n_segments: int):
    """Plain PyTorch version (any key order): (O, ...) -> (n_segments, ...)."""
    valid = (seg >= 0) & (seg < n_segments)
    idx = torch.where(valid, seg, n_segments).long()
    out = torch.zeros((n_segments + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(0, idx, vals)
    return out[:n_segments]


def sorted_segment_sum(vals: torch.Tensor, seg: torch.Tensor, n_segments: int):
    """Kernel entry: (O, D) float32 rows, (O,) int32 keys sorted ascending
    -> (n_segments, D) float32."""
    if vals.device.type == "cpu":
        return segment_sum_plain(vals, seg, n_segments)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    if (vals.dtype != torch.float32 or vals.dim() != 2 or not vals.is_contiguous()
            or vals.shape[1] > MAX_COLS):
        raise ValueError(f"vals must be contiguous (O, D<={MAX_COLS}) float32, "
                         f"got {vals.dtype} {tuple(vals.shape)}")
    if (seg.dtype != torch.int32 or tuple(seg.shape) != (vals.shape[0],)
            or not seg.is_contiguous() or seg.device != vals.device):
        raise ValueError("seg must be contiguous (O,) int32 on the vals' device")
    O, D = vals.shape
    out = torch.empty((n_segments, D), dtype=torch.float32, device=vals.device)
    fn = _build.entry("segment_sum", "fm_sorted_segment_sum", _ARGTYPES)
    P = _build.ptr
    rc = fn(P(vals), P(seg), O, D, n_segments, P(out), _build.stream_of(vals))
    _build.check(rc, "sorted_segment_sum")
    sorted_segment_sum.launches += 1
    return out


sorted_segment_sum.launches = 0


def gather_rows_plain(table: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, D) table, (O,) keys -> (O, D)."""
    n = table.shape[0]
    inside = (seg >= 0) & (seg < n)
    rows = table[torch.where(inside, seg, 0).long()]
    return torch.where(inside[:, None], rows, torch.zeros((), dtype=table.dtype,
                                                          device=table.device))


def sorted_gather_rows(table: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Kernel entry: (N, D) float32 table, (O,) int32 keys (sorted
    ascending on the BA path) -> (O, D) float32."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, seg)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be contiguous (N, D) float32, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if (seg.dtype != torch.int32 or seg.dim() != 1 or not seg.is_contiguous()
            or seg.device != table.device):
        raise ValueError("seg must be contiguous (O,) int32 on the table's device")
    N, D = table.shape
    O = seg.shape[0]
    out = torch.empty((O, D), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    fn = _build.entry("gather_rows", "fm_gather_rows", _ARGTYPES)
    P = _build.ptr
    rc = fn(P(table), P(seg), O, N, D, P(out), _build.stream_of(table))
    _build.check(rc, "sorted_gather_rows")
    sorted_gather_rows.launches += 1
    return out


sorted_gather_rows.launches = 0
