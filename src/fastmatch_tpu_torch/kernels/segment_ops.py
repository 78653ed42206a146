"""Deterministic sorted segment sum (K4) and sorted row gather (K5).

Port of ``fastmatch_tpu/kernels/segment_ops.py``:

- ``sorted_segment_sum``: ``out[s] = sum of vals rows with seg == s`` for
  ``seg`` sorted ascending. On a CUDA tensor it launches
  ``csrc/segment_sum.cu`` (fp32, fixed summation order, no float atomics:
  two runs are bit-identical); on a CPU tensor it takes
  ``segment_sum_plain``. Keys outside [0, n_segments) are dropped, as
  ``jax.ops.segment_sum`` drops them. The kernel reads the segment offsets
  (``segment_offsets``) instead of the keys; the JAX package likewise
  builds its tile table outside the ``pallas_call``. A caller that sums by
  the same keys many times (BA, once per solve) builds them once and passes
  them with the longest segment's length, which picks the kernel's variant.
- ``sorted_gather_rows``: ``out[o] = table[seg[o]]``, the reverse direction.
  On a CUDA tensor it launches ``csrc/gather_rows.cu`` (an exact copy; the
  TPU kernel's bf16 hi/lo product is a TPU workaround), on a CPU tensor it
  takes ``gather_rows_plain``. Keys outside [0, rows) give zero rows, as
  the TPU kernel's one-hot product does. Sorted keys are what the BA tables
  give it; any order gives the same result.

Both wrappers are called thousands of times per BA solve at a few us of
device work each, so their host path is kept to the checks, one output
allocation (none for a gather given ``out``), the raw stream handle and
one ctypes call.
"""

from __future__ import annotations

import ctypes

import torch

from fastmatch_tpu_torch.kernels import _build

MAX_COLS = 256  # widest row the segment sum takes (half its long-variant block)
# Longest segment the segment sum's one-thread-per-(segment, column) variant
# takes; longer ones take a block per segment (csrc/segment_sum.cu).
SHORT_MAX_LEN = 64
_F32, _I32 = torch.float32, torch.int32
# Both C entry points: (pointer, pointer, int, int, int, pointer, stream):
# fm_sorted_segment_sum(vals, off, n, D, long_segments, out, stream) and
# fm_gather_rows(table, seg, O, n_rows, D, out, stream).
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def segment_sum_plain(vals: torch.Tensor, seg: torch.Tensor, n_segments: int):
    """Plain PyTorch version (any key order): (O, ...) -> (n_segments, ...)."""
    valid = (seg >= 0) & (seg < n_segments)
    idx = torch.where(valid, seg, n_segments).long()
    out = torch.zeros((n_segments + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(0, idx, vals)
    return out[:n_segments]


def segment_offsets(seg: torch.Tensor, n_segments: int) -> torch.Tensor:
    """(n_segments + 1,) int32 offsets of sorted int32 keys: ``off[s]`` is
    the first row whose key is >= s, so segment s is rows
    ``off[s]:off[s + 1]`` and rows outside ``off[0]:off[n]`` are out of
    range. Plain PyTorch on either device: set-up, built once per solve."""
    bounds = torch.arange(n_segments + 1, dtype=seg.dtype, device=seg.device)
    return torch.searchsorted(seg, bounds, out_int32=True)


def segment_lengths(offsets: torch.Tensor) -> torch.Tensor:
    """Rows per segment, from ``segment_offsets``."""
    return offsets[1:] - offsets[:-1]


def _sum_args(vals, seg, n_segments, offsets, max_len):
    """Validate a CUDA call of ``sorted_segment_sum``; build the offsets and
    the longest length where the caller gave none (one readback)."""
    if vals.dtype != _F32 or vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError(f"vals must be contiguous (O, D) float32, got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    O, D = vals.shape
    if D > MAX_COLS or n_segments * D >= 2 ** 31:
        raise ValueError(f"segment sum of {n_segments} x {D} is outside the kernel's "
                         f"range (D <= {MAX_COLS}, n * D < 2^31)")
    dev = vals.get_device()
    if offsets is None:
        if (seg.dtype != _I32 or seg.dim() != 1 or seg.shape[0] != O
                or not seg.is_contiguous() or seg.get_device() != dev):
            raise ValueError("seg must be contiguous (O,) int32 on the vals' device")
        offsets = segment_offsets(seg, n_segments)
    if (offsets.dtype != _I32 or offsets.dim() != 1 or offsets.shape[0] != n_segments + 1
            or not offsets.is_contiguous() or offsets.get_device() != dev):
        raise ValueError("offsets must be contiguous (n_segments + 1,) int32 on the "
                         "vals' device")
    if max_len is None:
        max_len = int(segment_lengths(offsets).max()) if n_segments else 0
    return D, offsets, max_len > SHORT_MAX_LEN


def sorted_segment_sum(vals: torch.Tensor, seg: torch.Tensor, n_segments: int,
                       offsets: torch.Tensor | None = None, max_len: int | None = None):
    """Kernel entry: (O, D) float32 rows, (O,) int32 keys sorted ascending
    -> (n_segments, D) float32. ``offsets`` (``segment_offsets(seg,
    n_segments)``) and ``max_len`` (the longest segment's row count) are
    built here when not given; on the card the kernel reads only
    ``offsets``, so given ones must be those of ``seg``."""
    if not vals.is_cuda:
        if vals.device.type == "cpu":
            return segment_sum_plain(vals, seg, n_segments)
        raise ValueError(f"unsupported device {vals.device}")
    D, offsets, long_segments = _sum_args(vals, seg, n_segments, offsets, max_len)
    out = vals.new_empty((n_segments, D))
    if out.numel() == 0:
        return out
    fn = _build.entry("segment_sum", "fm_sorted_segment_sum", _ARGTYPES)
    rc = fn(vals.data_ptr(), offsets.data_ptr(), n_segments, D, long_segments,
            out.data_ptr(), _build.stream_of(vals))
    _build.check(rc, "sorted_segment_sum")
    sorted_segment_sum.launches += 1
    sorted_segment_sum.by_variant["long" if long_segments else "short"] += 1
    return out


sorted_segment_sum.launches = 0
sorted_segment_sum.by_variant = {"short": 0, "long": 0}


def gather_rows_plain(table: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, D) table, (O,) keys -> (O, D)."""
    n = table.shape[0]
    inside = (seg >= 0) & (seg < n)
    rows = table[torch.where(inside, seg, 0).long()]
    return torch.where(inside[:, None], rows, torch.zeros((), dtype=table.dtype,
                                                          device=table.device))


def _gather_args(table, seg):
    """Validate a CUDA call of ``sorted_gather_rows``: (N, D, O)."""
    if table.dtype != _F32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be contiguous (N, D) float32, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if (seg.dtype != _I32 or seg.dim() != 1 or not seg.is_contiguous()
            or seg.get_device() != table.get_device()):
        raise ValueError("seg must be contiguous (O,) int32 on the table's device")
    N, D = table.shape
    return N, D, seg.shape[0]


def sorted_gather_rows(table: torch.Tensor, seg: torch.Tensor,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel entry: (N, D) float32 table, (O,) int32 keys (sorted
    ascending on the BA path) -> (O, D) float32. ``out``, an (O, D) float32
    buffer on the table's device, receives the rows in place of a new
    tensor and is returned (BA passes one per solve: each of its gathers is
    consumed before the next)."""
    if not table.is_cuda:
        if table.device.type == "cpu":
            rows = gather_rows_plain(table, seg)
            return rows if out is None else out.copy_(rows)
        raise ValueError(f"unsupported device {table.device}")
    N, D, O = _gather_args(table, seg)
    if out is None:
        out = table.new_empty((O, D))
    elif (out.dtype != _F32 or out.shape != (O, D) or not out.is_contiguous()
          or out.get_device() != table.get_device()):
        raise ValueError(f"out must be a contiguous ({O}, {D}) float32 buffer on the "
                         "table's device")
    if O == 0 or D == 0:
        return out
    fn = _build.entry("gather_rows", "fm_gather_rows", _ARGTYPES)
    rc = fn(table.data_ptr(), seg.data_ptr(), O, N, D, out.data_ptr(),
            _build.stream_of(table))
    _build.check(rc, "sorted_gather_rows")
    sorted_gather_rows.launches += 1
    return out


sorted_gather_rows.launches = 0
