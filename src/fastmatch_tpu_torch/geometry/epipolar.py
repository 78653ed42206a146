"""Two-view epipolar geometry: 8-point essential, Sampson error,
decomposition, midpoint depths, and E from a pose.

Port of ``fastmatch_tpu/geometry/epipolar.py``; batched over leading axes,
inputs in normalized image coordinates.
"""

from __future__ import annotations

import torch

from fastmatch_tpu_torch.core.batched_linalg import smallest_eigvecs, svd3
from fastmatch_tpu_torch.core.lie import hat


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def eight_point_essential(x1: torch.Tensor, x2: torch.Tensor, w=None):
    """Essential matrix from >= 8 normalized correspondences (least
    squares); x1, x2 (..., P, 2), optional weights w (..., P). Returns
    (..., 3, 3) E with singular values projected to (1, 1, 0)."""
    h1 = _homog(x1)
    h2 = _homog(x2)
    A = (h2[..., :, None] * h1[..., None, :]).reshape(*x1.shape[:-1], 9)
    if w is not None:
        A = A * w[..., None]
    ATA = torch.einsum("...pi,...pj->...ij", A, A)
    e = smallest_eigvecs(ATA)[..., :, 0]
    E = e.reshape(*e.shape[:-1], 3, 3)
    U, S, Vt = svd3(E)
    one = torch.ones_like(S[..., 0])
    S_proj = torch.stack([one, one, torch.zeros_like(one)], dim=-1)
    return U @ (S_proj[..., :, None] * Vt)


def sampson_error(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """First-order geometric (Sampson) error, (..., P) given (..., 3, 3) E."""
    h1 = _homog(x1)
    h2 = _homog(x2)
    Ex1 = torch.einsum("...ij,...pj->...pi", E, h1)
    Etx2 = torch.einsum("...ji,...pj->...pi", E, h2)
    num = torch.einsum("...pi,...pi->...p", h2, Ex1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def decompose_essential(E: torch.Tensor):
    """E -> four (R, t) candidates (x2 = R x1 + t), |t| = 1: returns
    (Rs (..., 4, 3, 3), ts (..., 4, 3))."""
    U, _, Vt = svd3(E)
    detU = torch.linalg.det(U)[..., None, None]
    detV = torch.linalg.det(Vt)[..., None, None]
    U = U * torch.cat([torch.ones_like(U[..., :2]),
                       torch.sign(detU) * torch.ones_like(U[..., 2:])], dim=-1)
    Vt = Vt * torch.cat([torch.ones_like(Vt[..., :2, :]),
                         torch.sign(detV) * torch.ones_like(Vt[..., 2:, :])], dim=-2)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    return Rs, ts


def triangulate_midpoint(R, t, x1, x2):
    """Depths (d1, d2), each (..., P), minimizing |d1 R r1 + t - d2 r2| for
    rays r1 = h(x1), r2 = h(x2) (2x2 normal equations)."""
    r1 = _homog(x1)
    r2 = _homog(x2)
    Rr1 = torch.einsum("...ij,...pj->...pi", R, r1)
    a = (Rr1 * Rr1).sum(-1)
    b = -(Rr1 * r2).sum(-1)
    c = (r2 * r2).sum(-1)
    tb = t[..., None, :].expand(Rr1.shape)
    e1 = -(Rr1 * tb).sum(-1)
    e2 = (r2 * tb).sum(-1)
    det = a * c - b * b
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    d1 = (e1 * c - b * e2) / det
    d2 = (a * e2 - b * e1) / det
    return d1, d2


def essential_from_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]x R for the relative pose x2 = R x1 + t."""
    return hat(t) @ R
