"""Fused distance + top-2 + column-argmin (K2) and the fused matcher.

Port of ``fastmatch_tpu/kernels/distance_topk.py``. ``distance_topk`` is the
kernel wrapper: on a CUDA tensor it launches ``csrc/distance_topk.cu`` (one
launch for any bank size: the TPU kernel's 4096-row limit and chunked merge
were a VMEM artifact), on a CPU tensor it takes ``distance_topk_plain``,
the same function in plain PyTorch. ``match_pair_fused`` adds the ratio test
and the mutual check, as ``_match_pair_pallas_jit`` does. Any depth that is
a multiple of 32 runs on the card: past 256 the tile engine streams the
query tile in depth chunks (``csrc/match_tile.cuh``, "Depth").

Semantics (decision-identical to ``matching/matcher.match_pair_plain``):
rows are ordered by ``-2 a.b + |b|^2(masked)`` and columns by
``-2 a.b + |a|^2(masked)``, masked entries carry ``BIG``, and ties go to the
lowest index in both reductions.
"""

from __future__ import annotations

import ctypes

import torch

from fastmatch_tpu_torch.core.containers import Descriptors, Matches
from fastmatch_tpu_torch.kernels import _build
from fastmatch_tpu_torch.matching.matcher import BIG, ratio_sq

_BQ = 128         # query rows per block (csrc/match_tile.cuh)
_BN = 128         # bank rows per tile
# Blocks of each mode that share one SM (shared memory and registers at
# D = 128): the split plan fills the card once with them.
_BLOCKS_PER_SM = {False: 1, True: 2}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 9
_SM_COUNT: dict = {}


def sm_count(dev: torch.device) -> int:
    """The SMs of a CUDA device, read once per device."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    n = _SM_COUNT.get(idx)
    if n is None:
        n = _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def split_plan(pairs: int, n: int, m: int, slots: int):
    """(splits, cols_per_split) of banks of ``m`` rows for ``pairs`` pairs
    of ``n`` queries, a block per 128 queries: as many bank splits as keep
    the grid within ``slots`` concurrent blocks, each a whole number of
    128-row tiles, with no empty split."""
    tiles = -(-m // _BN)
    splits = max(1, min(tiles, slots // (pairs * -(-n // _BQ))))
    per = -(-tiles // splits)
    return -(-tiles // per), per * _BN


def plain_top2(srow: torch.Tensor):
    """(v1, i1, v2) over the last axis with the lowest index winning ties,
    as the kernels (K1, K2) reduce: min, then the lowest index attaining it."""
    m = srow.shape[-1]
    col = torch.arange(m, device=srow.device)
    v1 = srow.min(dim=-1, keepdim=True).values
    i1 = torch.where(srow == v1, col, m).min(dim=-1, keepdim=True).values
    v2 = torch.where(col == i1, BIG, srow).min(dim=-1, keepdim=True).values
    return v1[..., 0], i1[..., 0], v2[..., 0]


def distance_topk_plain(a, b, b2m, a2m, fast: bool = False):
    """Plain PyTorch version of the kernel: (idx1, d1, d2nd, nnb)."""
    if fast:
        a = a.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
    neg2 = -2.0 * (a @ b.T)
    v1, i1, v2 = plain_top2(neg2 + b2m[None, :])
    d1 = torch.clamp(v1 + a2m, min=0.0)
    d2 = torch.clamp(v2 + a2m, min=0.0)
    scol = neg2 + a2m[:, None]
    cm = scol.min(dim=0, keepdim=True).values
    row = torch.arange(a.shape[0], device=a.device)[:, None]
    nnb = torch.where(scol == cm, row, a.shape[0]).min(dim=0).values
    return i1.to(torch.int32), d1, d2, nnb.to(torch.int32)


def order_key(v: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """The kernels' 64-bit column key as a signed int64 with the same order:
    (order-preserving float bits, then the row). ``-0`` keys as ``+0``."""
    u = (v + 0.0).view(torch.int32)
    sk = torch.where(u < 0, -1 - (u & 0x7FFFFFFF), u).to(torch.int64)
    return sk * (1 << 32) + row.to(torch.int64)


def merge_top2(v1, i1, v2, ov1, oi1, ov2):
    """The kernels' merge of two (v1, i1, v2) summaries, elementwise: the
    lower v1 wins, an equal v1 goes to the lower index."""
    take = (ov1 < v1) | ((ov1 == v1) & (oi1 < i1))
    v2 = torch.where(take, torch.minimum(ov2, v1), torch.minimum(v2, ov1))
    return torch.where(take, ov1, v1), torch.where(take, oi1, i1), v2


def distance_topk_split_plain(a, b, b2m, a2m, cols_per_split: int, fast: bool = False):
    """The kernel's own reduction order in plain PyTorch: the row top-2 of
    each bank range of ``cols_per_split`` rows (a split), merged in split
    order with ``merge_top2``, and each column's minimum ``order_key`` over
    the queries. Returns what ``distance_topk_plain`` returns; the two
    agree exactly."""
    if fast:
        a = a.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
    neg2 = -2.0 * (a @ b.T)
    n, m = neg2.shape
    v1 = i1 = v2 = None
    for c0 in range(0, m, cols_per_split):
        sv1, si1, sv2 = plain_top2(neg2[:, c0:c0 + cols_per_split]
                                   + b2m[None, c0:c0 + cols_per_split])
        if v1 is None:
            v1, i1, v2 = sv1, si1 + c0, sv2
        else:
            v1, i1, v2 = merge_top2(v1, i1, v2, sv1, si1 + c0, sv2)
    d1 = torch.clamp(v1 + a2m, min=0.0)
    d2 = torch.clamp(v2 + a2m, min=0.0)
    row = torch.arange(n, device=a.device)[:, None].expand(n, m)
    nnb = order_key(neg2 + a2m[:, None], row).min(dim=0).values & 0xFFFFFFFF
    return i1.to(torch.int32), d1, d2, nnb.to(torch.int32)


def _check_inputs(a, b, b2m, a2m):
    n, d = a.shape
    m, d2 = b.shape
    if d != d2 or d % 32 or d == 0:
        raise ValueError(f"descriptor dims must match and be a positive multiple of 32; "
                         f"got {d}/{d2}")
    for name, t, shape in (("a", a, (n, d)), ("b", b, (m, d)), ("b2m", b2m, (m,)),
                           ("a2m", a2m, (n,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != a.device or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous on {a.device}")
    if n == 0 or m == 0:
        raise ValueError("empty query set or bank")


def distance_topk(a, b, b2m, a2m, fast: bool = False):
    """Kernel entry. a (N, D), b (M, D) float32; b2m (M,), a2m (N,) masked
    squared norms (+BIG where dead). Returns (idx1 (N,) int32, d1 (N,),
    d2nd (N,), nnb (M,) int32)."""
    if a.device.type == "cpu":
        return distance_topk_plain(a, b, b2m, a2m, fast)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    _check_inputs(a, b, b2m, a2m)
    fn = _build.entry("distance_topk", "fm_distance_topk", _ARGTYPES)
    n, d = a.shape
    m = b.shape[0]
    splits, width = split_plan(1, n, m, sm_count(a.device) * _BLOCKS_PER_SM[fast])
    if fast:  # the kernel reads bf16 rows: the same rounding as on load
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    # One allocation: the column keys (8-byte aligned first), the four
    # outputs, then the (splits, n) partials.
    buf = torch.empty(2 * m + 3 * n + m + 3 * splits * n, dtype=torch.float32, device=a.device)
    _, idx1, d1, d2, nnb, _ = buf.split((2 * m, n, n, n, m, 3 * splits * n))
    base = buf.data_ptr()
    part = base + 4 * (3 * m + 3 * n)
    P = _build.ptr
    rc = fn(P(a), P(b), P(b2m), P(a2m), n, m, d, int(fast), splits, width,
            part, part + 4 * splits * n, part + 8 * splits * n, base,
            P(idx1), P(d1), P(d2), P(nnb), _build.stream_of(a))
    _build.check(rc, "distance_topk")
    distance_topk.launches += 1
    return idx1.view(torch.int32), d1, d2, nnb.view(torch.int32)


distance_topk.launches = 0


def match_pair_fused(desc_a: Descriptors, desc_b: Descriptors, ratio: float = 0.8,
                     cross_check: bool = True, precision: str = "exact") -> Matches:
    """Fused-kernel matcher (the port of ``match_pair_pallas``):
    decision-identical to ``match_pair_plain`` in exact mode; ``"fast"``
    feeds the product in bf16 with fp32 accumulation."""
    if precision not in ("exact", "fast"):
        raise ValueError(f"precision must be 'exact' or 'fast', got {precision!r}")
    a = desc_a.data.float().contiguous()
    b = desc_b.data.float().contiguous()
    n = a.shape[0]
    a2 = (a * a).sum(-1)
    b2 = (b * b).sum(-1)
    a2m = torch.where(desc_a.mask, a2, BIG).contiguous()
    b2m = torch.where(desc_b.mask, b2, BIG).contiguous()
    idx1, d1, d2nd, nnb = distance_topk(a, b, b2m, a2m, fast=precision == "fast")
    ok = desc_a.mask & (d1 < ratio_sq(ratio) * d2nd) & (d2nd < BIG)
    if cross_check:
        mutual = nnb[idx1.long()] == torch.arange(n, dtype=torch.int32, device=a.device)
        ok = ok & mutual
    return Matches(idx=idx1, dist=torch.where(ok, d1, BIG), valid=ok)
