"""Hamming-distance matching for packed binary descriptors (ORB/rBRIEF).

Port of ``fastmatch_tpu/matching/hamming.py``. A packed n-bit descriptor
unpacks to a {-1, +1}^n vector ``s`` with ``|s_a - s_b|^2 = 4 hamming(a, b)``,
so the squared-L2 matchers apply unchanged, and exactly: the +-1 values and
every dot product (integers in [-n, n]) are exact in bf16 operands with fp32
sums, and distances are multiples of 4, so the lowest-index tie-break of
the L2 kernels is the popcount matcher's.

- ``match_pair_hamming_plain`` (popcount of xor, the anchor) and
  ``hamming_distance_matrix``;
- ``match_pair_hamming``: "mxu" runs the per-pair kernel K2 in fast mode on
  the +-1 vectors, "mxu_jnp" the plain L2 matcher on them;
- ``match_batch_hamming``: "mxu" runs the batched kernel K1 in binary mode
  on the packed words (``const_sq_norm = n_bits``), or a loop of K2 for
  banks above ``MAX_RESIDENT_M`` rows.

The Lowe ratio is the linear one used for binary matching
(``h1 < ratio * h2``); the L2 matchers compare ``d1 < r^2 d2`` on d = 4h, so
the wrappers pass ``_ratio_sqrt(ratio)``.
"""

from __future__ import annotations

import numpy as np
import torch

from fastmatch_tpu_torch.core.containers import (BinaryDescriptors, Descriptors, Matches,
                                                 unpack_bits_signed)
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.matching.matcher import BIG, match_pair, stack_matches

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in an int64 tensor (SWAR)."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance_matrix(a_packed: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distances between packed rows, popcount(xor):
    (N, W), (M, W) packed words -> (N, M) int32."""
    a = a_packed.to(torch.int64)
    b = b_packed.to(torch.int64)
    h = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64, device=a.device)
    for w in range(a.shape[1]):  # one word at a time: (N, M) temporaries only
        h += _popcount32(a[:, None, w] ^ b[None, :, w])
    return h.to(torch.int32)


def match_pair_hamming_plain(desc_a: BinaryDescriptors, desc_b: BinaryDescriptors,
                             ratio: float = 0.8, cross_check: bool = True) -> Matches:
    """Popcount reference matcher (the Hamming anchor): top-2, linear ratio
    and mutual check with the masking and lowest-index tie-breaks of
    ``match_pair_plain``; distances are Hamming counts (float32)."""
    h = hamming_distance_matrix(desc_a.packed, desc_b.packed).float()
    hm = torch.where(desc_b.mask[None, :], h, BIG)
    s, idx = torch.sort(hm, dim=1, stable=True)
    idx1 = idx[:, 0]
    d1, d2nd = s[:, 0], s[:, 1]
    r = torch.tensor(ratio, dtype=torch.float32, device=h.device)
    ok = desc_a.mask & (d1 < r * d2nd) & (d2nd < BIG)
    if cross_check:
        hcol = torch.where(desc_a.mask[:, None], h, BIG)
        cm = hcol.min(dim=0, keepdim=True).values
        row = torch.arange(h.shape[0], device=h.device)[:, None]
        nn_b = torch.where(hcol == cm, row, h.shape[0]).min(dim=0).values
        ok = ok & (nn_b[idx1] == torch.arange(h.shape[0], device=h.device))
    return Matches(idx=idx1.to(torch.int32), dist=torch.where(ok, d1, BIG), valid=ok)


def _as_signed(desc: BinaryDescriptors) -> Descriptors:
    return Descriptors(data=unpack_bits_signed(desc.packed, desc.mask), mask=desc.mask)


def _ratio_sqrt(ratio: float) -> float:
    """f32 r with fl32(r * r) == fl32(ratio), if one exists near sqrt(ratio).

    Hamming distances are integers, so boundary cases (h1/h2 == ratio) are
    common; a threshold off by one ulp would flip them against the popcount
    anchor, and the power-of-two scale d = 4h keeps the comparison exact."""
    c32 = np.float32(ratio)
    r = np.float32(np.sqrt(float(c32)))
    for cand in (r, np.nextafter(r, np.float32(0.0)), np.nextafter(r, np.float32(2.0))):
        if np.float32(cand * cand) == c32:
            return float(cand)
    return float(r)  # no exact representative: ~1 ulp threshold skew


def _quarter(m: Matches) -> Matches:
    return m._replace(dist=torch.where(m.valid, m.dist * 0.25, BIG))


def _to(desc: BinaryDescriptors, dev) -> BinaryDescriptors:
    return BinaryDescriptors(desc.packed.to(dev), desc.mask.to(dev))


def match_pair_hamming(desc_a: BinaryDescriptors, desc_b: BinaryDescriptors,
                       ratio: float = 0.8, cross_check: bool = True, backend: str = "auto",
                       device=None) -> Matches:
    """Match packed binary descriptors on ``device`` (``cuda`` unless
    ``device="cpu"``); distances are Hamming counts.

    backend: "popcount" (the anchor), "mxu" (+-1 vectors through the
    per-pair kernel K2 in fast mode, exact), "mxu_jnp" (+-1 vectors through
    the plain L2 matcher, the JAX package's name), or "auto" (mxu on cuda,
    popcount on cpu). ``ratio`` is the linear Hamming ratio."""
    dev = resolve_device(device)
    desc_a, desc_b = _to(desc_a, dev), _to(desc_b, dev)
    if backend == "auto":
        backend = "mxu" if dev.type == "cuda" else "popcount"
    if backend == "popcount":
        return match_pair_hamming_plain(desc_a, desc_b, ratio=ratio, cross_check=cross_check)
    if backend in ("mxu", "mxu_jnp"):
        return _quarter(match_pair(_as_signed(desc_a), _as_signed(desc_b),
                                   ratio=_ratio_sqrt(ratio), cross_check=cross_check,
                                   backend="kernel" if backend == "mxu" else "plain",
                                   precision="fast", device=dev))
    raise ValueError(f"unknown backend {backend!r}")


def match_batch_hamming(desc_a: BinaryDescriptors, desc_b: BinaryDescriptors,
                        ratio: float = 0.8, cross_check: bool = True,
                        backend: str = "auto", device=None) -> Matches:
    """Batched binary matcher: containers carry a leading (B, C, ...) axis.

    backend: "mxu" (banks of at most ``MAX_RESIDENT_M`` rows: the batched
    kernel K1 on the packed words in one launch; larger banks: a loop of
    K2), "mxu_jnp" (a loop of the +-1 plain route of ``match_pair_hamming``),
    "popcount" (a loop of the anchor), or "auto" (mxu on cuda, popcount on
    cpu; the JAX package's default is "popcount")."""
    from fastmatch_tpu_torch.kernels.batch_match import MAX_RESIDENT_M, match_batch_fused

    dev = resolve_device(device)
    desc_a, desc_b = _to(desc_a, dev), _to(desc_b, dev)
    if backend == "auto":
        backend = "mxu" if dev.type == "cuda" else "popcount"
    if backend == "mxu_jnp":
        pairs = zip(desc_a.packed, desc_a.mask, desc_b.packed, desc_b.mask)
        return stack_matches(
            match_pair_hamming(BinaryDescriptors(pa, ma), BinaryDescriptors(pb, mb),
                               ratio=ratio, cross_check=cross_check, backend="mxu_jnp",
                               device=dev)
            for pa, ma, pb, mb in pairs)
    if backend == "mxu":
        if desc_b.packed.shape[-2] <= MAX_RESIDENT_M:
            m = match_batch_fused(
                Descriptors(data=desc_a.packed, mask=desc_a.mask),
                Descriptors(data=desc_b.packed, mask=desc_b.mask),
                ratio=_ratio_sqrt(ratio), cross_check=cross_check, fast=True,
                const_sq_norm=float(desc_a.n_bits), binary=True)
            return _quarter(m)
        pairs = zip(desc_a.packed, desc_a.mask, desc_b.packed, desc_b.mask)
        return stack_matches(
            match_pair_hamming(BinaryDescriptors(pa, ma), BinaryDescriptors(pb, mb),
                               ratio=ratio, cross_check=cross_check, backend="mxu",
                               device=dev)
            for pa, ma, pb, mb in pairs)
    if backend == "popcount":
        pairs = zip(desc_a.packed, desc_a.mask, desc_b.packed, desc_b.mask)
        return stack_matches(
            match_pair_hamming_plain(BinaryDescriptors(pa, ma), BinaryDescriptors(pb, mb),
                                     ratio=ratio, cross_check=cross_check)
            for pa, ma, pb, mb in pairs)
    raise ValueError(f"unknown backend {backend!r}")
