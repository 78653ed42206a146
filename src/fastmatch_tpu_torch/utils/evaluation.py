"""Trajectory ATE after sim(3) (Umeyama) alignment.

Port of ``fastmatch_tpu/utils/evaluation.py``'s ``align_umeyama`` and
``ate_rmse``: monocular reconstructions are defined up to a similarity, so
camera centres are aligned to ground truth before the RMSE. The match
precision/recall harness waits.
"""

from __future__ import annotations

import torch


def align_umeyama(X: torch.Tensor, Y: torch.Tensor):
    """Least-squares similarity (s, R, t) minimizing |s R X + t - Y| for
    (N, 3) point sets X (estimated) and Y (ground truth)."""
    X = torch.as_tensor(X, dtype=torch.float32)
    Y = torch.as_tensor(Y, dtype=torch.float32, device=X.device)
    mx = X.mean(0)
    my = Y.mean(0)
    C = (Y - my).T @ (X - mx) / X.shape[0]
    U, D, Vt = torch.linalg.svd(C)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    diag = torch.ones(3, device=X.device)
    diag[2] = torch.where(det < 0, -1.0, 1.0)
    R = U @ torch.diag(diag) @ Vt
    var_x = ((X - mx) ** 2).sum(-1).mean()
    s = (D * diag).sum() / torch.clamp(var_x, min=1e-12)
    t = my - s * R @ mx
    return s, R, t


def ate_rmse(est_centers, gt_centers) -> torch.Tensor:
    """RMSE of (N, 3) camera centres after sim(3) alignment."""
    est = torch.as_tensor(est_centers, dtype=torch.float32)
    gt = torch.as_tensor(gt_centers, dtype=torch.float32, device=est.device)
    s, R, t = align_umeyama(est, gt)
    aligned = s * est @ R.T + t
    return torch.sqrt(((aligned - gt) ** 2).sum(-1).mean())
