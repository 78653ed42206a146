"""Multi-view DLT triangulation, batched over points and views.

Port of ``fastmatch_tpu/geometry/triangulation.py``.
"""

from __future__ import annotations

import torch

from fastmatch_tpu_torch.core.batched_linalg import smallest_eigvecs


def triangulate_dlt(R, t, x, mask=None, eps: float = 1e-12):
    """R (V, 3, 3), t (V, 3) world->camera per view; x (V, P, 2) normalized
    observations; mask (V, P) visibility. Returns (points (P, 3), ok (P,))
    from the smallest eigenvector of each point's stacked 4x4 normal matrix."""
    P34 = torch.cat([R, t[..., None]], dim=-1)
    p1 = P34[:, 0, :][:, None, :]
    p2 = P34[:, 1, :][:, None, :]
    p3 = P34[:, 2, :][:, None, :]
    r1 = x[..., 0:1] * p3 - p1
    r2 = x[..., 1:2] * p3 - p2
    if mask is not None:
        w = mask.float()[..., None]
        r1 = r1 * w
        r2 = r2 * w
    A = torch.cat([r1, r2], dim=0)
    ATA = torch.einsum("vpi,vpj->pij", A, A)
    h = smallest_eigvecs(ATA)[..., :, 0]
    wcomp = h[..., 3]
    ok = wcomp.abs() > eps
    pts = h[..., :3] / torch.where(ok, wcomp, 1.0)[..., None]
    if mask is not None:
        ok = ok & (mask.sum(0) >= 2)
    return pts, ok
