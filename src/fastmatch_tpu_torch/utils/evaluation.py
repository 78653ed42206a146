"""Evaluation: trajectory ATE and RPE after sim(3) (Umeyama) alignment,
match precision/recall against a ground-truth homography, and matcher
agreement.

Port of ``fastmatch_tpu/utils/evaluation.py``: monocular reconstructions
are defined up to a similarity, so camera centres are aligned to ground
truth before the RMSE. A predicted match a_i -> b_j is correct when the
ground-truth homography carries a_i to within ``tol`` pixels of b_j;
recall counts the A-keypoints that have a ground-truth counterpart among
the detected B-keypoints.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def align_umeyama(X: torch.Tensor, Y: torch.Tensor, mask=None, with_scale: bool = True):
    """Least-squares similarity (s, R, t) minimizing |s R X + t - Y| for
    (N, 3) point sets X (estimated) and Y (ground truth). ``mask`` (N,)
    restricts the fit to its True rows (the JAX package's weighted form);
    ``with_scale=False`` fixes s = 1."""
    X = torch.as_tensor(X, dtype=torch.float32)
    Y = torch.as_tensor(Y, dtype=torch.float32, device=X.device)
    if mask is None:
        mx = X.mean(0)
        my = Y.mean(0)
        C = (Y - my).T @ (X - mx) / X.shape[0]
        var_x = ((X - mx) ** 2).sum(-1).mean()
    else:
        w = torch.as_tensor(mask, device=X.device).to(torch.float32)
        wsum = torch.clamp(w.sum(), min=1e-9)
        mx = (X * w[:, None]).sum(0) / wsum
        my = (Y * w[:, None]).sum(0) / wsum
        C = ((Y - my) * w[:, None]).T @ (X - mx) / wsum
        var_x = (((X - mx) ** 2).sum(-1) * w).sum() / wsum
    U, D, Vt = torch.linalg.svd(C)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    diag = torch.ones(3, device=X.device)
    diag[2] = torch.where(det < 0, -1.0, 1.0)
    R = U @ torch.diag(diag) @ Vt
    if with_scale:
        s = (D * diag).sum() / torch.clamp(var_x, min=1e-12)
    else:
        s = torch.ones((), device=X.device)
    t = my - s * R @ mx
    return s, R, t


def ate_rmse(est_centers, gt_centers, mask=None) -> torch.Tensor:
    """RMSE of (N, 3) camera centres after sim(3) alignment. ``mask`` (N,)
    restricts the alignment and the mean to its True rows."""
    est = torch.as_tensor(est_centers, dtype=torch.float32)
    gt = torch.as_tensor(gt_centers, dtype=torch.float32, device=est.device)
    s, R, t = align_umeyama(est, gt, mask)
    aligned = s * est @ R.T + t
    err2 = ((aligned - gt) ** 2).sum(-1)
    if mask is None:
        return torch.sqrt(err2.mean())
    w = torch.as_tensor(mask, device=est.device).to(torch.float32)
    return torch.sqrt((err2 * w).sum() / torch.clamp(w.sum(), min=1e-9))


def rpe_trans(est_centers, gt_centers, delta: int = 1):
    """Translational relative-pose error at frame distance ``delta`` after
    sim(3) alignment: e_i = |(c[i+d] - c[i]) - (g[i+d] - g[i])|; returns
    (rmse, median), the median of an even count the mean of its middle
    two, as ``jnp.median``. Raises ValueError unless 0 < delta < N."""
    est = torch.as_tensor(est_centers, dtype=torch.float32)
    gt = torch.as_tensor(gt_centers, dtype=torch.float32, device=est.device)
    n = int(est.shape[0])
    if not 0 < delta < n:
        raise ValueError(f"rpe delta must be in [1, {n - 1}] for a {n}-frame "
                         f"trajectory; got {delta}")
    s, R, t = align_umeyama(est, gt)
    a = s * est @ R.T + t
    err = torch.linalg.vector_norm((a[delta:] - a[:-delta]) - (gt[delta:] - gt[:-delta]),
                                   dim=-1)
    return torch.sqrt((err ** 2).mean()), torch.quantile(err, 0.5)


class MatchEval(NamedTuple):
    """Per-pair match quality against a ground-truth homography: precision
    (correct / predicted) and recall (correct / A-keypoints with a
    ground-truth counterpart), NaN where the denominator is 0, and the
    int32 counts."""

    precision: torch.Tensor
    recall: torch.Tensor
    n_correct: torch.Tensor
    n_predicted: torch.Tensor
    n_gt: torch.Tensor


def project_homography(H: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Apply a 3x3 homography to (N, 2) pixel coordinates."""
    p = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1) @ H.T
    w = p[..., 2:3]
    return p[..., :2] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)


def match_precision_recall(xy_a, mask_a, xy_b, mask_b, match_idx, match_valid, H_ab,
                           tol: float = 3.0) -> MatchEval:
    """Score the matches of A against B (``Matches`` fields) with the
    ground-truth homography A -> B: a match is correct iff
    |H_ab xy_a[i] - xy_b[idx[i]]| <= tol px; an A-keypoint has ground truth
    iff some live B-keypoint lies within tol of its projection."""
    proj = project_homography(H_ab, xy_a)
    err = torch.linalg.vector_norm(proj - xy_b[match_idx.long()], dim=-1)
    correct = match_valid & mask_a & (err <= tol)
    d2 = ((proj[:, None, :] - xy_b[None, :, :]) ** 2).sum(-1)
    d2 = torch.where(mask_b[None, :], d2, torch.full_like(d2, float("inf")))
    has_gt = mask_a & (d2.min(dim=1).values <= tol * tol)
    n_correct = correct.sum().to(torch.int32)
    n_pred = (match_valid & mask_a).sum().to(torch.int32)
    n_gt = has_gt.sum().to(torch.int32)
    nan = torch.tensor(float("nan"), device=proj.device)
    precision = torch.where(n_pred > 0, n_correct / torch.clamp(n_pred, min=1), nan)
    recall = torch.where(n_gt > 0, n_correct / torch.clamp(n_gt, min=1), nan)
    return MatchEval(precision, recall, n_correct, n_pred, n_gt)


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
