"""Trajectory ATE after sim(3) (Umeyama) alignment, and matcher agreement.

Port of ``fastmatch_tpu/utils/evaluation.py``'s ``align_umeyama``,
``ate_rmse`` and ``match_agreement``: monocular reconstructions are defined
up to a similarity, so camera centres are aligned to ground truth before
the RMSE. The match precision/recall harness waits.
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


def match_agreement(idx_a, valid_a, idx_b, valid_b, mask=None) -> torch.Tensor:
    """Fraction of query slots where two matchers made the same decision
    (the >= 99% gate between backends): both invalid counts as agreement,
    both valid requires equal indices. ``mask`` restricts the average to
    live query slots."""
    both_valid = valid_a & valid_b
    agree = torch.where(both_valid, idx_a == idx_b, ~(valid_a ^ valid_b)).float()
    if mask is None:
        return agree.mean()
    w = mask.float()
    return (agree * w).sum() / torch.clamp(w.sum(), min=1.0)
