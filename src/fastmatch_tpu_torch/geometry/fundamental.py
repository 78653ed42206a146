"""Uncalibrated two-view geometry: the fundamental matrix.

Port of ``fastmatch_tpu/geometry/fundamental.py``: the normalized 8-point
solver, the 7-point minimal solver (the rank-2 cubic solved in closed
form, batched: K samples give 3K candidates scored in one pass), RANSAC
over 7-point samples with an iterated weighted 8-point refit, and
``fundamental_from_essential``. As in ``ransac.py``, sampling and the rest
(``_ransac_fundamental_from_samples``) are split, so tests can feed the
JAX package's indices.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from fastmatch_tpu_torch.core.batched_linalg import smallest_eigvecs, svd3
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.geometry.epipolar import _homog, sampson_error
from fastmatch_tpu_torch.geometry.homography import _normalize_points
from fastmatch_tpu_torch.geometry.ransac import _sample_minimal_sets, argmax_first


def _constraint_rows(x1, x2, w=None):
    """(..., P, 9) epipolar constraint rows vec(h2 h1^T) . vec(F) = 0."""
    h1 = _homog(x1)
    h2 = _homog(x2)
    A = (h2[..., :, None] * h1[..., None, :]).reshape(*x1.shape[:-1], 9)
    return A if w is None else A * w[..., None]


def eight_point_fundamental(x1: torch.Tensor, x2: torch.Tensor, w=None):
    """F from >= 8 correspondences (Hartley-normalized 8-point, rank-2
    projection in the normalized frame, unit Frobenius norm); x1, x2
    (..., P, 2) pixels, optional weights w (..., P)."""
    x1n, T1 = _normalize_points(x1, w)
    x2n, T2 = _normalize_points(x2, w)
    A = _constraint_rows(x1n, x2n, w)
    ATA = torch.einsum("...pi,...pj->...ij", A, A)
    f = smallest_eigvecs(ATA)[..., :, 0]
    Fn = f.reshape(*f.shape[:-1], 3, 3)
    U, S, Vt = svd3(Fn)
    S2 = S * torch.tensor([1.0, 1.0, 0.0], dtype=S.dtype, device=S.device)
    Fn = U @ (S2[..., :, None] * Vt)
    F = T2.transpose(-2, -1) @ Fn @ T1
    nrm = torch.linalg.vector_norm(F, dim=(-2, -1), keepdim=True)
    return F / torch.clamp(nrm, min=1e-12)


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _cbrt(x):
    return torch.sign(x) * x.abs() ** (1.0 / 3.0)


def _cubic_roots(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d, batched: (roots (..., 3),
    valid (..., 3)). Three real roots (discriminant <= 0) by the
    trigonometric method, one by Cardano; near-zero leading coefficients
    fall back to the quadratic and linear roots, the rest masked. All
    branches are ``torch.where``."""
    eps = 1e-12
    one = torch.ones_like(a)
    a_deg = a.abs() < eps
    a_s = torch.where(a_deg, one, a)
    p = (3.0 * a_s * c - b * b) / (3.0 * a_s * a_s)
    q = (2.0 * b ** 3 - 9.0 * a_s * b * c + 27.0 * a_s * a_s * d) / (27.0 * a_s ** 3)
    shift = -b / (3.0 * a_s)
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    three_real = disc <= 0

    p_neg = torch.clamp(p, max=-eps)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    arg = torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    k = torch.arange(3, dtype=a.dtype, device=a.device)
    tri = m[..., None] * torch.cos(theta[..., None] - 2.0 * math.pi * k / 3.0)

    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    single = (_cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq))[..., None] * torch.ones_like(k)

    cub_roots = torch.where(three_real[..., None], tri, single) + shift[..., None]
    cub_valid = torch.cat([torch.ones_like(three_real[..., None]),
                           three_real[..., None].expand(three_real.shape + (2,))], dim=-1)

    b_deg = b.abs() < eps
    b_s = torch.where(b_deg, one, b)
    qd = c * c - 4.0 * b_s * d
    sqd = torch.sqrt(torch.clamp(qd, min=0.0))
    zero = torch.zeros_like(c)
    quad = torch.stack([(-c + sqd) / (2.0 * b_s), (-c - sqd) / (2.0 * b_s), zero], dim=-1)
    quad_valid = torch.stack([qd >= 0, qd >= 0, torch.zeros_like(b_deg)], dim=-1)

    c_deg = c.abs() < eps
    c_s = torch.where(c_deg, one, c)
    lin = torch.stack([-d / c_s, zero, zero], dim=-1)
    lin_valid = torch.stack([~c_deg, torch.zeros_like(c_deg), torch.zeros_like(c_deg)], dim=-1)

    roots = torch.where(a_deg[..., None], torch.where(b_deg[..., None], lin, quad), cub_roots)
    valid = torch.where(a_deg[..., None], torch.where(b_deg[..., None], lin_valid, quad_valid),
                        cub_valid)
    return roots, valid


def seven_point_fundamental(x1: torch.Tensor, x2: torch.Tensor):
    """7-point minimal solver: x1, x2 (..., 7, 2) -> (Fs (..., 3, 3, 3),
    valid (..., 3)), one candidate per real root of the rank-2 cubic
    det(l F1 + (1 - l) F2) = 0; invalid slots hold garbage."""
    x1n, T1 = _normalize_points(x1)
    x2n, T2 = _normalize_points(x2)
    A = _constraint_rows(x1n, x2n)
    ATA = torch.einsum("...pi,...pj->...ij", A, A)
    vecs = smallest_eigvecs(ATA, k=2)
    F1 = vecs[..., :, 0].reshape(*x1.shape[:-2], 3, 3)
    F2 = vecs[..., :, 1].reshape(*x1.shape[:-2], 3, 3)
    # The cubic's coefficients from its values at l = 0, 1, 2, -1.
    d0 = _det3(F2)
    d1 = _det3(F1)
    d2 = _det3(2.0 * F1 - F2)
    dm1 = _det3(2.0 * F2 - F1)
    s = d1 - d0
    b = (s + (dm1 - d0)) / 2.0
    a = (d2 - d0 - 4.0 * b - 2.0 * (s - b)) / 6.0
    c = s - a - b
    lam, valid = _cubic_roots(a, b, c, d0)
    Fn = (lam[..., None, None] * F1[..., None, :, :]
          + (1.0 - lam[..., None, None]) * F2[..., None, :, :])
    F = T2.transpose(-2, -1)[..., None, :, :] @ Fn @ T1[..., None, :, :]
    nrm = torch.linalg.vector_norm(F, dim=(-2, -1), keepdim=True)
    return F / torch.clamp(nrm, min=1e-12), valid


class FundamentalResult(NamedTuple):
    F: torch.Tensor          # (3, 3) refined fundamental (h2^T F h1 = 0)
    inliers: torch.Tensor    # (P,) bool
    n_inliers: torch.Tensor  # scalar int
    ok: torch.Tensor         # scalar bool


def _ransac_fundamental_from_samples(idx, x1, x2, mask, thr, min_inliers):
    Fs, valid = seven_point_fundamental(x1[idx], x2[idx])
    Fs, valid = Fs.reshape(-1, 3, 3), valid.reshape(-1)
    errs = sampson_error(Fs, x1[None], x2[None])
    inl = (errs < thr) & mask[None, :] & valid[:, None]
    best = argmax_first(inl.sum(1))
    F, inliers = Fs[best], inl[best]
    # Iterated weighted 8-point refit, kept only when support does not drop.
    for _ in range(3):
        F1 = eight_point_fundamental(x1, x2, w=inliers.float())
        inl1 = (sampson_error(F1, x1, x2) < thr) & mask
        better = inl1.sum() >= inliers.sum()
        F = torch.where(better, F1, F)
        inliers = torch.where(better, inl1, inliers)
    n_in = inliers.sum()
    return FundamentalResult(F=F, inliers=inliers, n_inliers=n_in, ok=n_in >= min_inliers)


def ransac_fundamental(x1, x2, mask, thr: float = 2.0, n_hyp: int = 512,
                       min_inliers: int = 15, generator: torch.Generator | None = None,
                       device=None) -> FundamentalResult:
    """Robust F from pixel correspondences x1, x2 (P, 2) with validity
    mask (P,) on ``device`` (``cuda`` unless ``device="cpu"``) through
    7-point samples; ``thr`` is the squared Sampson threshold in pixels^2."""
    dev = resolve_device(device)
    x1, x2, mask = x1.to(dev), x2.to(dev), mask.to(dev)
    p_count = mask.shape[0]
    if p_count < 7:
        return FundamentalResult(F=torch.zeros((3, 3), device=dev),
                                 inliers=torch.zeros(p_count, dtype=torch.bool, device=dev),
                                 n_inliers=torch.tensor(0, device=dev),
                                 ok=torch.tensor(False, device=dev))
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    idx = _sample_minimal_sets(generator, mask, n_hyp, 7)
    return _ransac_fundamental_from_samples(idx, x1, x2, mask, thr, min_inliers)


def fundamental_from_essential(E: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor):
    """F = K2^-T E K1^-1."""
    return torch.linalg.inv(K2).transpose(-2, -1) @ E @ torch.linalg.inv(K1)
