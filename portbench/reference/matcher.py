"""Plain batched matcher: distance, top-2, ratio test and mutual check.

Plain PyTorch, independent of the port. It takes the descriptors and masks
the benchmark made, never anything the port derived from them, and works
out what ``match_batch`` must answer for them.

Semantics (a frozen copy of the port's documented rules, ``match_batch``
in ``matching/matcher.py`` and ``kernels/batch_match.py``):

- squared L2 distances; rows ranked by ``srow = -2 a.b + |b|^2`` with
  ``BIG`` on dead bank rows; the two smallest, the lower index winning ties;
- ``d = max(v + |a|^2, 0)``; a live query passes the ratio test when
  ``d1 < r^2 d2`` and ``d2 < BIG``, with ``r^2`` rounded as float32 rounds it;
- exact precision: the mutual check holds when the query is the first
  argmin of ``-2 a.b + |a|^2`` over live queries in its match's bank row;
- fast precision: the operands ``-2 a`` and ``b`` are rounded to bfloat16
  (the norms stay those of the float32 rows), and the mutual check is by
  value: ``d1 <= min over queries of (srow + |a|^2)`` in that bank row.

The reference computes in float64, so it is exact to well below the
float32 rounding of the port; where the two differ, the port's float32
sums sit on a knife edge (a near tie or a ratio at the threshold).

``operands`` rounds the operands once more before the products and runs the
rest in float32: the lower-precision controls put in the port's place
(``"tf32"``: TF32 for the exact mode, whose configuration states float32
with TF32 off; ``"fp8"``: float8 e4m3 for the fast mode's bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

BIG = float(np.float32(3.0e38))


def ratio_sq(ratio: float) -> float:
    return float(np.float32(ratio) * np.float32(ratio))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties away),
    as the tensor cores read a float32 operand with TF32 on."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_operands(x: torch.Tensor, how: str | None) -> torch.Tensor:
    if how is None:
        return x
    if how == "tf32":
        return tf32_round(x)
    if how == "fp8":
        return x.to(torch.float8_e4m3fn).float()
    raise ValueError(f"unknown operand rounding {how!r}")


def _top2(srow: torch.Tensor):
    """(v1, i1, v2) of each row: the smallest value, its first index, and
    the smallest of the rest."""
    i1 = srow.argmin(dim=-1)
    v1 = srow.gather(-1, i1[..., None])[..., 0]
    rest = srow.scatter(-1, i1[..., None], float("inf"))
    return v1, i1, rest.min(dim=-1).values


# A decision is the reference's to make only where no float32 rounding
# could turn it: where the gap it rests on is wider than the forward error
# of a float32 squared distance between unit rows (128 products and the two
# norms, each within 2^-24 of its sum: under 8e-6), with room.
MARGIN = 1e-5


def match_chunk(a, b, mask_a, mask_b, ratio=0.8, cross_check=True, fast=False,
                operands=None, dtype=torch.float64):
    """Reference answers of a few pairs: a (B, N, D), b (B, M, D) float32,
    masks (B, N), (B, M). Returns (idx (B, N) int64, valid (B, N) bool,
    d1 (B, N) in ``dtype``, idx_sure, valid_sure): the last two say where
    the top-1 index and the verdict rest on a gap wider than ``MARGIN``."""
    a, b = a.float(), b.float()
    a2 = (a.to(dtype) ** 2).sum(-1)
    b2 = (b.to(dtype) ** 2).sum(-1)
    a2m = torch.where(mask_a, a2, torch.full_like(a2, BIG))
    op_a, op_b = -2.0 * a, b
    if fast:
        op_a, op_b = op_a.to(torch.bfloat16).float(), op_b.to(torch.bfloat16).float()
    op_a, op_b = _round_operands(op_a, operands), _round_operands(op_b, operands)
    neg2 = op_a.to(dtype) @ op_b.to(dtype).transpose(-1, -2)
    srow = torch.where(mask_b[:, None, :], neg2 + b2[:, None, :],
                       torch.full_like(neg2, BIG))
    v1, i1, v2 = _top2(srow)
    d1 = torch.clamp(v1 + a2m, min=0.0)
    d2 = torch.clamp(v2 + a2m, min=0.0)
    r2 = ratio_sq(ratio)
    passes = mask_a & (d1 < r2 * d2) & (d2 < BIG)
    idx_sure = (v2 - v1) > MARGIN
    ratio_sure = (d1 - r2 * d2).abs() > MARGIN
    valid, valid_sure = passes, ratio_sure
    if cross_check:
        # A query's value in its match's bank row against the best of the
        # other queries there (exact: -2 a.b + |a|^2, lowest query winning
        # ties; fast: by value, srow + |a|^2; both order alike).
        col = srow + a2m[:, :, None]
        top = col.topk(2, dim=1, largest=False)
        n = col.shape[1]
        qidx = torch.arange(n, device=col.device)
        own = (v1 + a2m)
        best = torch.gather(top.values[:, 0], 1, i1)
        second = torch.gather(top.values[:, 1], 1, i1)
        if fast:
            mutual = own <= best
        else:
            scol = neg2 + a2m[:, :, None]
            cm = scol.min(dim=1, keepdim=True).values
            coli = torch.where(scol == cm, qidx[None, :, None], n).min(dim=1).values
            mutual = torch.gather(coli, 1, i1) == qidx
        margin = torch.where(own <= best, second - own, own - best)
        mutual_sure = margin > MARGIN
        valid = passes & mutual
        valid_sure = ((ratio_sure & mutual_sure) | (ratio_sure & ~passes)
                      | (mutual_sure & ~mutual))
    return i1, valid, d1, idx_sure, valid_sure


def match_reference(a, b, mask_a, mask_b, ratio=0.8, cross_check=True, fast=False,
                    operands=None, dtype=torch.float64, chunk=8):
    """``match_chunk`` over the batch in chunks of ``chunk`` pairs, so that
    the (chunk, N, M) distance blocks fit beside the port's inputs."""
    outs = [match_chunk(a[i:i + chunk], b[i:i + chunk], mask_a[i:i + chunk],
                        mask_b[i:i + chunk], ratio, cross_check, fast, operands, dtype)
            for i in range(0, a.shape[0], chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def compare(idx, valid, dist, ref, mask_a):
    """(decisions off, largest distance gap) of one batch of answers
    against the reference's: a live query is off where its top-1 index or
    its verdict differs from one the reference is sure of, a dead query
    where it is reported valid; the gap is the largest |dist - d1| over the
    matches both report alike."""
    r_idx, r_valid, r_d1, idx_sure, valid_sure = ref
    idx = idx.to(r_idx.device).long()
    valid = valid.to(r_valid.device)
    dist = dist.to(r_d1.device).to(r_d1.dtype)
    off = ((mask_a & ((idx_sure & (idx != r_idx)) | (valid_sure & (valid != r_valid))))
           | (~mask_a & valid))
    both = valid & r_valid & (idx == r_idx)
    gap = torch.where(both, (dist - r_d1).abs(), torch.zeros_like(r_d1))
    return int(off.sum()), float(gap.max()) if gap.numel() else 0.0
