"""Planar homography: normalized DLT, transfer error, batched RANSAC,
decomposition, and the two-view H-vs-E model selection.

Port of ``fastmatch_tpu/geometry/homography.py``; like ``ransac.py`` each
estimator takes its minimal-sample indices from ``_sample_minimal_sets`` and
does the rest in a private ``*_from_samples`` function.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from fastmatch_tpu_torch.core.batched_linalg import smallest_eigvecs, svd3
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.geometry.epipolar import _homog, triangulate_midpoint
from fastmatch_tpu_torch.geometry.ransac import (
    _ransac_essential_from_samples,
    _sample_minimal_sets,
    argmax_first,
)


def _normalize_points(x: torch.Tensor, w=None):
    """Hartley normalization: (xn, T) with the (weighted) centroid at the
    origin and mean distance sqrt(2); T (..., 3, 3)."""
    if w is None:
        mean = x.mean(dim=-2)
        d = torch.linalg.vector_norm(x - mean[..., None, :], dim=-1)
        scale = math.sqrt(2.0) / torch.clamp(d.mean(dim=-1), min=1e-12)
    else:
        wsum = torch.clamp(w.sum(-1), min=1e-12)
        mean = (x * w[..., None]).sum(-2) / wsum[..., None]
        d = torch.linalg.vector_norm(x - mean[..., None, :], dim=-1)
        scale = math.sqrt(2.0) / torch.clamp((d * w).sum(-1) / wsum, min=1e-12)
    xn = (x - mean[..., None, :]) * scale[..., None, None]
    z = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack([torch.stack([scale, z, -scale * mean[..., 0]], -1),
                     torch.stack([z, scale, -scale * mean[..., 1]], -1),
                     torch.stack([z, z, one], -1)], -2)
    return xn, T


def _adjugate3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 adjugate (the scale-free inverse)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)


def dlt_homography(x1: torch.Tensor, x2: torch.Tensor, w=None):
    """Homography from >= 4 correspondences (x2 ~ H x1), least squares,
    unit Frobenius norm with H[2,2] >= 0."""
    x1n, T1 = _normalize_points(x1, w)
    x2n, T2 = _normalize_points(x2, w)
    h1 = _homog(x1n)
    u = x2n[..., 0]
    v = x2n[..., 1]
    zero3 = torch.zeros_like(h1)
    r1 = torch.cat([zero3, -h1, v[..., None] * h1], dim=-1)
    r2 = torch.cat([h1, zero3, -u[..., None] * h1], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    if w is not None:
        A = A * torch.cat([w, w], dim=-1)[..., None]
    ATA = torch.einsum("...pi,...pj->...ij", A, A)
    hvec = smallest_eigvecs(ATA)[..., :, 0]
    Hn = hvec.reshape(*hvec.shape[:-1], 3, 3)
    H = _adjugate3(T2) @ Hn @ T1
    nrm = torch.linalg.vector_norm(H, dim=(-2, -1), keepdim=True)
    H = H / torch.clamp(nrm, min=1e-12)
    return H * torch.where(H[..., 2:3, 2:3] < 0, -1.0, 1.0)


def symmetric_transfer_error(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """d(x2, H x1)^2 + d(x1, H^-1 x2)^2 per point; transfers near the plane
    at infinity get a huge (1e12), not NaN, error."""
    h1 = _homog(x1)
    h2 = _homog(x2)
    f = torch.einsum("...ij,...pj->...pi", H, h1)
    b = torch.einsum("...ij,...pj->...pi", _adjugate3(H), h2)
    fz = f[..., 2]
    bz = b[..., 2]
    big = torch.tensor(1e12, dtype=torch.float32, device=H.device)
    fok = fz.abs() > 1e-12
    bok = bz.abs() > 1e-12
    ef = torch.where(fok, ((f[..., :2] / torch.where(fok, fz, 1.0)[..., None]
                            - x2) ** 2).sum(-1), big)
    eb = torch.where(bok, ((b[..., :2] / torch.where(bok, bz, 1.0)[..., None]
                            - x1) ** 2).sum(-1), big)
    return ef + eb


class HomographyResult(NamedTuple):
    H: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    score: torch.Tensor
    ok: torch.Tensor


def _ransac_homography_from_samples(idx, x1, x2, mask, thr, min_inliers):
    Hs = dlt_homography(x1[idx], x2[idx])
    errs = symmetric_transfer_error(Hs, x1[None], x2[None])
    inl = (errs < thr) & mask[None, :]
    best = argmax_first(inl.sum(1))
    H, inliers = Hs[best], inl[best]
    err = symmetric_transfer_error(H, x1, x2)
    for _ in range(3):
        H1 = dlt_homography(x1, x2, w=inliers.float())
        err1 = symmetric_transfer_error(H1, x1, x2)
        inl1 = (err1 < thr) & mask
        better = inl1.sum() >= inliers.sum()
        H = torch.where(better, H1, H)
        inliers = torch.where(better, inl1, inliers)
        err = torch.where(better, err1, err)
    n_in = inliers.sum()
    score = torch.where(inliers, thr - torch.clamp(err, max=thr), 0.0).sum()
    return HomographyResult(H=H, inliers=inliers, n_inliers=n_in, score=score,
                            ok=n_in >= min_inliers)


def ransac_homography(x1, x2, mask, thr: float = 2e-4, n_hyp: int = 512,
                      min_inliers: int = 12, generator=None, device=None):
    """Robust homography from normalized correspondences (P, 2) on
    ``device``; ``thr`` is the squared symmetric-transfer threshold."""
    dev = resolve_device(device)
    x1, x2, mask = x1.to(dev), x2.to(dev), mask.to(dev)
    if mask.shape[0] < 4:
        return HomographyResult(
            H=torch.eye(3, device=dev),
            inliers=torch.zeros(mask.shape[0], dtype=torch.bool, device=dev),
            n_inliers=torch.tensor(0, device=dev), score=torch.tensor(0.0, device=dev),
            ok=torch.tensor(False, device=dev))
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    idx = _sample_minimal_sets(generator, mask, n_hyp, 4)
    return _ransac_homography_from_samples(idx, x1, x2, mask, thr, min_inliers)


def fix_homography_sign(H, x1, x2, inliers):
    """Scale-sign gauge: h2^T H h1 > 0 for physical correspondences."""
    h1 = _homog(x1)
    h2 = _homog(x2)
    dots = torch.einsum("...pi,...ij,...pj->...p", h2, H, h1)
    vote = torch.where(inliers, torch.sign(dots), 0.0).sum(-1)
    return H * torch.where(vote < 0, -1.0, 1.0)[..., None, None]


def decompose_homography(H: torch.Tensor):
    """H -> eight (R, t, n) candidates (Faugeras-Lustman): the d' > 0
    family first, then d' < 0; near-pure rotations collapse to the polar
    rotation with t = 0."""
    U, S, Vt = svd3(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    s1 = S[..., 0] / S[..., 1]
    s3 = S[..., 2] / S[..., 1]
    den = torch.clamp(s1 ** 2 - s3 ** 2, min=1e-12)
    a = torch.sqrt(torch.clamp(s1 ** 2 - 1.0, min=0.0) / den)
    b = torch.sqrt(torch.clamp(1.0 - s3 ** 2, min=0.0) / den)

    def family(sign_d):
        if sign_d > 0:
            sin_t = (s1 - s3) * a * b
            cos_t = s1 * b ** 2 + s3 * a ** 2
            t_par = s1 - s3
        else:
            sin_t = (s1 + s3) * a * b
            cos_t = s3 * a ** 2 - s1 * b ** 2
            t_par = s1 + s3
        Rs, ts, ns = [], [], []
        for e1 in (1.0, -1.0):
            st = e1 * sin_t
            zs = torch.zeros_like(st)
            os_ = torch.ones_like(st)
            n_p = torch.stack([e1 * a, torch.zeros_like(a), b], -1)
            if sign_d > 0:
                Rp = torch.stack([torch.stack([cos_t, zs, -st], -1),
                                  torch.stack([zs, os_, zs], -1),
                                  torch.stack([st, zs, cos_t], -1)], -2)
                tp = t_par[..., None] * torch.stack([e1 * a, torch.zeros_like(a), -b], -1)
            else:
                Rp = torch.stack([torch.stack([cos_t, zs, st], -1),
                                  torch.stack([zs, -os_, zs], -1),
                                  torch.stack([st, zs, -cos_t], -1)], -2)
                tp = t_par[..., None] * torch.stack([e1 * a, torch.zeros_like(a), b], -1)
            for flip in (1.0, -1.0):
                Rs.append(s[..., None, None] * (U @ Rp @ Vt))
                ts.append(torch.einsum("...ij,...j->...i", U, flip * tp))
                ns.append(torch.einsum("...ji,...j->...i", Vt, flip * n_p))
        return Rs, ts, ns

    Rp, tp, npos = family(+1)
    Rn, tn, nneg = family(-1)
    Rs = torch.stack(Rp + Rn, dim=-3)
    ts = torch.stack(tp + tn, dim=-2)
    ns = torch.stack(npos + nneg, dim=-2)
    deg = (s1 - s3) < 1e-6
    R_polar = s[..., None, None] * (U @ Vt)
    Rs = torch.where(deg[..., None, None, None], R_polar[..., None, :, :], Rs)
    ts = torch.where(deg[..., None, None], torch.zeros_like(ts), ts)
    return Rs, ts, ns


def cheirality_vote(Rs, ts, ns, x1, x2, inliers):
    """Index of the (R, t, n) candidate with the most inliers at positive
    depth in both views and in front of the plane, and the votes (C,)."""
    d1, d2 = triangulate_midpoint(Rs, ts, x1[None], x2[None])
    h1 = _homog(x1)
    front = torch.einsum("pj,cj->cp", h1, ns) > 0
    votes = ((d1 > 0) & (d2 > 0) & front & inliers[None, :]).sum(1)
    return argmax_first(votes), votes


class TwoViewModel(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    used_homography: torch.Tensor
    ok: torch.Tensor
    R_alt: torch.Tensor
    t_alt: torch.Tensor
    ambiguous: torch.Tensor


def _select_two_view_model_from_samples(idx_e, idx_h, x1, x2, mask, thr,
                                        min_inliers, h_bias=0.82):
    re_ = _ransac_essential_from_samples(idx_e, x1, x2, mask, thr, min_inliers)
    rh = _ransac_homography_from_samples(idx_h, x1, x2, mask, 2.0 * thr, min_inliers)
    Hfix = fix_homography_sign(rh.H, x1, x2, rh.inliers)
    Rs, ts, ns = decompose_homography(Hfix)
    bi, votes = cheirality_vote(Rs, ts, ns, x1, x2, rh.inliers)
    h_pose_ok = votes[bi] > 0.6 * torch.clamp(rh.n_inliers, min=1)
    tH = ts[bi]
    tH_n = tH / torch.clamp(torch.linalg.vector_norm(tH), min=1e-12)
    same_R = (Rs - Rs[bi][None]).abs().amax(dim=(-2, -1)) < 1e-3
    votes_alt = torch.where(same_R, -1, votes)
    ai = argmax_first(votes_alt)
    tA = ts[ai]
    tA_n = tA / torch.clamp(torch.linalg.vector_norm(tA), min=1e-12)
    ambiguous = votes_alt[ai] >= 0.75 * torch.clamp(votes[bi], min=1)
    use_h = rh.ok & h_pose_ok & ((~re_.ok) | (rh.n_inliers >= h_bias * re_.n_inliers))
    return TwoViewModel(
        R=torch.where(use_h, Rs[bi], re_.R),
        t=torch.where(use_h, tH_n, re_.t),
        inliers=torch.where(use_h, rh.inliers, re_.inliers),
        n_inliers=torch.where(use_h, rh.n_inliers, re_.n_inliers),
        used_homography=use_h,
        ok=torch.where(use_h, rh.ok, re_.ok),
        R_alt=Rs[ai], t_alt=tA_n, ambiguous=use_h & ambiguous)


def select_two_view_model(x1, x2, mask, thr: float = 1e-4, n_hyp: int = 512,
                          min_inliers: int = 15, h_bias: float = 0.82,
                          generator=None, device=None) -> TwoViewModel:
    """Two-view bootstrap with H-vs-E model selection on ``device``: the
    homography pose wins when its support reaches ``h_bias`` of the
    essential's (planar scenes, near-pure rotation)."""
    dev = resolve_device(device)
    x1, x2, mask = x1.to(dev), x2.to(dev), mask.to(dev)
    if mask.shape[0] < 8:
        raise ValueError("select_two_view_model needs at least 8 candidates")
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    idx_e = _sample_minimal_sets(generator, mask, n_hyp, 8)
    idx_h = _sample_minimal_sets(generator, mask, n_hyp, 4)
    return _select_two_view_model_from_samples(idx_e, idx_h, x1, x2, mask, thr,
                                               min_inliers, h_bias)


def homography_from_pose(R, t, n, d):
    """H ~ R + t n^T / d for the plane n . X = d in camera 1."""
    return R + torch.einsum("...i,...j->...ij", t, n) / d
