"""PnP: camera pose from 3D-2D correspondences.

Port of ``fastmatch_tpu/geometry/pnp.py``: DLT and plane-homography minimal
solvers raced in one hypothesis bank, then iterated Gauss-Newton refits on
SE3. Sampling is split from scoring as in ``ransac.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fastmatch_tpu_torch.core.batched_linalg import (
    _orth_complement, polar3, smallest_eigvecs)
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.core.lie import SE3, hat
from fastmatch_tpu_torch.geometry.homography import dlt_homography
from fastmatch_tpu_torch.geometry.ransac import _sample_minimal_sets, argmax_first, take


def _project(p):
    z = p[..., 2:3]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return p[..., :2] / z


def pnp_dlt(X: torch.Tensor, x: torch.Tensor, w=None) -> SE3:
    """DLT pose fit: X (..., P, 3) world points, x (..., P, 2) normalized
    observations, optional weights (..., P); x ~ project(R X + t)."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    zeros = torch.zeros_like(Xh)
    u = x[..., 0:1]
    v = x[..., 1:2]
    r1 = torch.cat([Xh, zeros, -u * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    A = torch.cat([r1, r2], dim=-2)
    ATA = torch.einsum("...pi,...pj->...ij", A, A)
    p = smallest_eigvecs(ATA)[..., :, 0]
    P34 = p.reshape(*p.shape[:-1], 3, 4)
    M = P34[..., :, :3]
    scale = torch.linalg.det(M).abs().pow(1.0 / 3.0)
    scale = torch.where(scale < 1e-12, torch.ones_like(scale), scale)
    P34 = P34 / scale[..., None, None]
    if w is None:
        centroid = X.mean(dim=-2)
    else:
        wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        centroid = (X * w[..., None]).sum(-2) / wsum
    ch = torch.cat([centroid, torch.ones_like(centroid[..., :1])], dim=-1)
    z_c = torch.einsum("...ij,...j->...i", P34, ch)[..., 2]
    P34 = P34 * torch.where(z_c < 0, -1.0, 1.0)[..., None, None]
    R = polar3(P34[..., :, :3])
    return SE3(R, P34[..., :, 3])


def pnp_planar(X: torch.Tensor, x: torch.Tensor) -> SE3:
    """Pose from (near-)coplanar correspondences via a plane-to-image
    homography (IPPE-style); X (..., P, 3), x (..., P, 2)."""
    c = X.mean(dim=-2)
    Xc = X - c[..., None, :]
    cov = torch.einsum("...pi,...pj->...ij", Xc, Xc)
    w = smallest_eigvecs(cov)[..., :, 0]
    u = _orth_complement(w)
    v = torch.linalg.cross(w, u, dim=-1)
    p2 = torch.stack([torch.einsum("...pi,...i->...p", Xc, u),
                      torch.einsum("...pi,...i->...p", Xc, v)], dim=-1)
    H = dlt_homography(p2, x)
    H = H * torch.where(H[..., 2, 2] < 0, -1.0, 1.0)[..., None, None]
    h1 = H[..., :, 0]
    h2 = H[..., :, 1]
    s = 2.0 / torch.clamp(torch.linalg.vector_norm(h1, dim=-1)
                          + torch.linalg.vector_norm(h2, dim=-1), min=1e-12)
    r1 = h1 * s[..., None]
    r2 = h2 * s[..., None]
    Rp = polar3(torch.stack([r1, r2, torch.linalg.cross(r1, r2, dim=-1)], dim=-1))
    B = torch.stack([u, v, w], dim=-1)
    R = Rp @ B.transpose(-2, -1)
    t = H[..., :, 2] * s[..., None] - torch.einsum("...ij,...j->...i", R, c)
    return SE3(R, t)


def refine_pose_gn(pose: SE3, X: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                   iters: int = 5, damping: float = 1e-6) -> SE3:
    """Fixed-iteration Gauss-Newton on SE3 minimizing weighted reprojection."""
    R, t = pose
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device).expand(X.shape[0], 3, 3)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        p = torch.einsum("ij,pj->pi", R, X) + t
        z = torch.where(p[:, 2].abs() < 1e-9, torch.full_like(p[:, 2], 1e-9), p[:, 2])
        res = _project(p) - x
        iz = 1.0 / z
        zero = torch.zeros_like(iz)
        Jp = torch.stack([torch.stack([iz, zero, -p[:, 0] * iz * iz], -1),
                          torch.stack([zero, iz, -p[:, 1] * iz * iz], -1)], -2)
        J = Jp @ torch.cat([eye3, -hat(p)], dim=-1)
        wv = w[:, None, None]
        H = torch.einsum("pki,pkj->ij", J * wv, J) + damping * eye6
        g = torch.einsum("pki,pk->i", J * wv, res)
        # solve_ex: no singularity check, which would read back (H is damped).
        delta = -torch.linalg.solve_ex(H, g)[0]
        R, t = SE3.exp(delta).compose(SE3(R, t))
    return SE3(R, t)


class PnPResult(NamedTuple):
    pose: SE3
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _ransac_pnp_from_samples(idx6, idx4, X, x, mask, thr, min_inliers):
    poses6 = pnp_dlt(X[idx6], x[idx6])
    poses4 = pnp_planar(X[idx4], x[idx4])
    Rs = torch.cat([poses6.R, poses4.R], dim=0)
    ts = torch.cat([poses6.t, poses4.t], dim=0)

    def score(R, t):
        p = torch.einsum("...ij,pj->...pi", R, X) + t[..., None, :]
        err = ((_project(p) - x) ** 2).sum(-1)
        return (err < thr) & (p[..., 2] > 0) & mask

    inl = score(Rs, ts)
    best = argmax_first(inl.sum(1))
    pose = SE3(take(Rs, best), take(ts, best))
    inliers = take(inl, best)
    for _ in range(2):
        cand = refine_pose_gn(pose, X, x, inliers.float(), iters=8)
        cand_inl = score(cand.R, cand.t)
        better = cand_inl.sum() >= inliers.sum()
        pose = SE3(torch.where(better, cand.R, pose.R), torch.where(better, cand.t, pose.t))
        inliers = torch.where(better, cand_inl, inliers)
    n = inliers.sum()
    return PnPResult(pose=pose, inliers=inliers, n_inliers=n, ok=n >= min_inliers)


def ransac_pnp(X, x, mask, thr: float = 1e-4, n_hyp: int = 256,
               min_inliers: int = 10, generator=None, device=None) -> PnPResult:
    """RANSAC PnP on (P, 3)/(P, 2) correspondences with validity mask on
    ``device``: n_hyp // 2 six-point DLT and the rest four-point planar
    hypotheses, scored together. ``thr`` is the squared reprojection
    threshold in normalized coordinates."""
    dev = resolve_device(device)
    X, x, mask = X.to(dev), x.to(dev), mask.to(dev)
    p_count = mask.shape[0]
    if p_count < 6:
        return PnPResult(pose=SE3(torch.eye(3, device=dev), torch.zeros(3, device=dev)),
                         inliers=torch.zeros(p_count, dtype=torch.bool, device=dev),
                         n_inliers=torch.tensor(0, device=dev),
                         ok=torch.tensor(False, device=dev))
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    idx6 = _sample_minimal_sets(generator, mask, n_hyp // 2, 6)
    idx4 = _sample_minimal_sets(generator, mask, n_hyp - n_hyp // 2, 4)
    return _ransac_pnp_from_samples(idx6, idx4, X, x, mask, thr, min_inliers)
