"""Deterministic sorted segment sum (K4).

Port of ``fastmatch_tpu/kernels/segment_ops.py:sorted_segment_sum``:
``out[s] = sum of vals rows with seg == s`` for ``seg`` sorted ascending.
On a CUDA tensor it launches ``csrc/segment_sum.cu`` (fp32, fixed summation
order, no float atomics: two runs are bit-identical); on a CPU tensor it
takes ``segment_sum_plain``. Keys outside [0, n_segments) are dropped, as
``jax.ops.segment_sum`` drops them. ``sorted_gather_rows`` (K5) waits.
"""

from __future__ import annotations

import ctypes

import torch

from fastmatch_tpu_torch.kernels import _build

MAX_COLS = 256  # one column per thread of a 256-thread block


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
    fn = _build.load("segment_sum").fm_sorted_segment_sum
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p]
    P = _build.ptr
    rc = fn(P(vals), P(seg), O, D, n_segments, P(out), _build.stream_of(vals))
    _build.check(rc, "sorted_segment_sum")
    sorted_segment_sum.launches += 1
    return out


sorted_segment_sum.launches = 0
