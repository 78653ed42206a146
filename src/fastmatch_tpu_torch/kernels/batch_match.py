"""Batched fused matcher (K1): B pairs, top-2, ratio and mutual check.

Port of ``fastmatch_tpu/kernels/batch_match.py``. ``match_batch_fused`` is
the kernel wrapper: on CUDA tensors it launches ``csrc/batch_match.cu`` (the
whole batch in one launch, then one small finalize launch), on CPU tensors
it takes ``match_batch_fused_plain``, the same function in plain PyTorch.

Semantics, per pair (decision-identical to ``matcher.match_pair_plain``):

- rows: ``srow = -2 a.b + |b|^2`` (``BIG`` on dead bank rows), top-2 with the
  lowest index winning ties, ``d = max(v + |a|^2, 0)``, ratio test
  ``d1 < r^2 d2`` and ``d2 < BIG``, dead queries (``|a|^2 = BIG``) invalid;
- exact mode (fp32): the mutual check is the per-bank-row argmin of
  ``-2 a.b + |a|^2`` over queries, lowest query winning ties;
- fast mode (bf16 operands, fp32 sums): the mutual check is by value,
  ``v1 + |a|^2 <= min over queries of (srow + |a|^2)`` in that bank row;
- binary mode: packed words, the dot product of the +-1 vectors, with
  ``const_sq_norm = n_bits``; distances come out as ``4 * hamming``.

``-2`` is folded into the query operand (exact: a power of two), and the
fast path casts to bf16 once, before the kernel, as the TPU wrapper does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fastmatch_tpu_torch.core.containers import Descriptors, Matches, unpack_bits_signed
from fastmatch_tpu_torch.kernels import _build
from fastmatch_tpu_torch.kernels.distance_topk import plain_top2, sm_count, split_plan
from fastmatch_tpu_torch.matching.matcher import BIG

# The JAX package's dispatch limit (its VMEM-resident layout): match_batch
# sends larger banks to the per-pair path, so both packages decide alike.
MAX_RESIDENT_M = 4096
# Packed words per binary row the kernel takes: the +-1 dot product stays
# an exact float below 2^22 (csrc/match_tile.cuh). Float rows of any depth
# that is a multiple of 128 run (past 256, the engine's depth loop).
MAX_WORDS = 1 << 16
# Blocks of each mode (exact, fast, binary) that share one SM at config 2's
# widths: the split plan fills the card once with them.
_BLOCKS_PER_SM = (1, 2, 2)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10)


def _prepare(desc_a: Descriptors, desc_b: Descriptors, ratio, fast, const_sq_norm, binary):
    """The JAX wrapper's checks and prologue: (op_a, op_b, a2m, b2m, r2,
    (a2, b2)), the last the unmasked squared norms ((B, N), (B, M), or one
    0-dim constant)."""
    a, b = desc_a.data, desc_b.data
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"expected (B, N, D) and (B, M, D) descriptors, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    B, n, d = a.shape
    _, m, d2 = b.shape
    if binary:
        if (a.dtype != torch.int32 or b.dtype != torch.int32 or const_sq_norm is None
                or not fast):
            raise ValueError("binary=True needs packed (int32-held uint32) data, "
                             "const_sq_norm, and fast=True")
        if d * 32 % 128 != 0 or d != d2 or d > MAX_WORDS:
            raise ValueError(f"packed width {d}/{d2} must match, unpack to a multiple "
                             f"of 128 bits and be <= {MAX_WORDS} words")
    elif d != d2 or d % 128 != 0:
        raise ValueError(f"descriptor dim must match and be a multiple of 128, got {d}/{d2}")
    if m > MAX_RESIDENT_M:
        raise ValueError(f"M={m} exceeds the resident limit {MAX_RESIDENT_M}; use the "
                         "per-pair path (matching.match_batch)")
    if n == 0 or m == 0:
        raise ValueError("empty query set or bank")
    if const_sq_norm is None:
        a, b = a.float(), b.float()
        a2, b2 = (a * a).sum(-1), (b * b).sum(-1)
    else:
        if not fast:
            a, b = a.float(), b.float()
        # A fill, not a copy from the host: no wait for the stream.
        a2 = b2 = torch.full((), float(np.float32(const_sq_norm)), device=a.device)
    a2m = torch.where(desc_a.mask, a2, BIG).contiguous()
    b2m = torch.where(desc_b.mask, b2, BIG).contiguous()
    r2 = float(np.float32(ratio) * np.float32(ratio))
    if binary:
        op_a, op_b = a, b
    else:
        op_a, op_b = -2.0 * a, b
        if fast:
            op_a, op_b = op_a.to(torch.bfloat16), op_b.to(torch.bfloat16)
    return op_a.contiguous(), op_b.contiguous(), a2m, b2m, r2, (a2, b2)


def unpack_pm1(words: torch.Tensor) -> torch.Tensor:
    """The binary kernel's unpack: (..., W) packed words (int32-held) ->
    (..., 32 W) int8 of +-1, bit k of word w at depth 32 w + k (1 -> +1,
    0 -> -1)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return (2 * bits - 1).to(torch.int8).reshape(*words.shape[:-1], -1)


def binary_neg2_plain(op_a: torch.Tensor, op_b: torch.Tensor) -> torch.Tensor:
    """-2 times the +-1 dot products of packed rows, as the binary kernel
    forms them: int8 +-1 operands, int32 sums. Equals 4 * hamming -
    2 * n_bits exactly."""
    a = unpack_pm1(op_a).to(torch.int32)
    b = unpack_pm1(op_b).to(torch.int32)
    return -2 * (a @ b.transpose(-1, -2))


def _plain(op_a, op_b, a2m, b2m, r2, mask_a, mask_b, cross_check, fast, binary) -> Matches:
    if binary:
        a = unpack_bits_signed(op_a, mask_a)
        b = unpack_bits_signed(op_b, mask_b)
        neg2 = -2.0 * (a @ b.transpose(-1, -2))
    else:
        neg2 = op_a.float() @ op_b.float().transpose(-1, -2)
    n = neg2.shape[1]
    srow = neg2 + b2m[:, None, :]
    v1, i1, v2 = plain_top2(srow)
    d1 = torch.clamp(v1 + a2m, min=0.0)
    d2 = torch.clamp(v2 + a2m, min=0.0)
    ok = (a2m < BIG) & (d1 < r2 * d2) & (d2 < BIG)
    if cross_check:
        qidx = torch.arange(n, device=neg2.device)
        if fast:
            colv = (srow + a2m[:, :, None]).min(dim=1).values          # (B, M)
            mutual = (v1 + a2m) <= torch.gather(colv, 1, i1)
        else:
            scol = neg2 + a2m[:, :, None]
            cm = scol.min(dim=1, keepdim=True).values
            coli = torch.where(scol == cm, qidx[None, :, None], n).min(dim=1).values
            mutual = torch.gather(coli, 1, i1) == qidx
        ok = ok & mutual
    return Matches(idx=i1.to(torch.int32), dist=torch.where(ok, d1, BIG), valid=ok)


def match_batch_fused_plain(desc_a: Descriptors, desc_b: Descriptors, ratio=0.8,
                            cross_check: bool = True, fast: bool = False,
                            const_sq_norm: float | None = None,
                            binary: bool = False) -> Matches:
    """Plain PyTorch version of the kernel: batched Matches (B, N)."""
    op_a, op_b, a2m, b2m, r2, _ = _prepare(desc_a, desc_b, ratio, fast, const_sq_norm, binary)
    return _plain(op_a, op_b, a2m, b2m, r2, desc_a.mask, desc_b.mask, cross_check,
                  fast, binary)


def match_batch_fused(desc_a: Descriptors, desc_b: Descriptors, ratio=0.8,
                      cross_check: bool = True, fast: bool = False,
                      const_sq_norm: float | None = None,
                      binary: bool = False) -> Matches:
    """Kernel entry. desc_a (B, N, D) / desc_b (B, M, D) with (B, N) / (B, M)
    masks; float32 data, or packed int32 words with ``binary=True`` (which
    needs ``fast=True`` and ``const_sq_norm=32*W``). Returns Matches (B, N)."""
    op_a, op_b, a2m, b2m, r2, norms = _prepare(desc_a, desc_b, ratio, fast, const_sq_norm,
                                               binary)
    dev = op_a.device
    if dev.type == "cpu":
        return _plain(op_a, op_b, a2m, b2m, r2, desc_a.mask, desc_b.mask, cross_check,
                      fast, binary)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("b", op_b), ("a2m", a2m), ("b2m", b2m)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
    B, n, d = op_a.shape
    m = op_b.shape[1]
    fn = _build.entry("batch_match", "fm_batch_match", _ARGTYPES)
    mode = 2 if binary else 1 if fast else 0  # csrc/batch_match.cu: fm_batch_match
    splits, width = split_plan(B, n, m, sm_count(dev) * _BLOCKS_PER_SM[mode])
    # One allocation: the column keys (8-byte aligned first), the (splits,
    # B, n) partials, idx and dist; valid is its own bool tensor.
    keys = 2 * B * m if cross_check else 2
    buf = torch.empty(keys + 3 * splits * B * n + 2 * B * n, dtype=torch.float32, device=dev)
    idx, dist = buf[keys + 3 * splits * B * n:].view(2, B, n)
    valid = torch.empty((B, n), dtype=torch.bool, device=dev)
    # The kernel skips dead bank tiles where the unmasked norms bound its
    # candidates there to exactly BIG (csrc/match_tile.cuh); a constant
    # norm (binary) passes as null.
    a2raw, b2raw = (t.data_ptr() if t.dim() else None for t in norms)
    base = buf.data_ptr()
    part = base + 4 * keys
    P = _build.ptr
    rc = fn(P(op_a), P(op_b), P(a2m), P(b2m), B, n, m, d, mode, int(cross_check), r2, splits,
            width, a2raw, b2raw, part, part + 4 * splits * B * n, part + 8 * splits * B * n,
            base, P(idx), P(dist), P(valid), _build.stream_of(op_a))
    _build.check(rc, "match_batch_fused")
    match_batch_fused.launches += 1
    return Matches(idx=idx.view(torch.int32), dist=dist, valid=valid)


match_batch_fused.launches = 0
