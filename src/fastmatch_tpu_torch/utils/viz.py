"""Match and trajectory figures: host matplotlib on computed arrays.

Port of ``fastmatch_tpu/utils/viz.py``. Everything here is host
post-processing: device work ends at the matcher and pipeline outputs,
figures are rendered with the Agg backend (no display), and nothing on the
compute path imports this module. matplotlib is imported lazily, when a
figure is asked for; where it is missing, the call raises an ``ImportError``
that names the package and the CLI options that need it.
"""

from __future__ import annotations

import numpy as np


def _mpl():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "matplotlib is not installed: the figures of utils/viz.py (slam --plot, "
            "evaluate --plot-dir) need it") from e

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def draw_matches(img_a, xy_a, img_b, xy_b, idx, valid, path,
                 H_ab=None, tol: float = 3.0, max_lines: int = 300):
    """Side-by-side match visualization.

    img_a/img_b: (H, W) grayscale float arrays. xy_a (Na, 2) keypoints of
    the query image, xy_b (Nb, 2) of the bank image; idx/valid: Matches
    fields (idx[i] = matched keypoint in b for query i). If the ground
    truth homography ``H_ab`` is given, lines are colored by reprojection
    correctness (<= tol px); otherwise all lines are one color. At most
    ``max_lines`` matches are drawn (first by index). Writes ``path``.
    Returns (n_drawn, n_correct_or_None)."""
    plt = _mpl()
    a = np.asarray(img_a, np.float32)
    b = np.asarray(img_b, np.float32)
    xy_a = np.asarray(xy_a)
    xy_b = np.asarray(xy_b)
    idx = np.asarray(idx)
    valid = np.asarray(valid).astype(bool)
    ha, wa = a.shape[:2]
    hb, wb = b.shape[:2]
    H = max(ha, hb)
    canvas = np.zeros((H, wa + wb), np.float32)
    canvas[:ha, :wa] = a
    canvas[:hb, wa:] = b

    q = np.where(valid)[0][:max_lines]
    pa = xy_a[q]
    pb = xy_b[idx[q]] + [wa, 0]
    correct = None
    if H_ab is not None and len(q):
        Hm = np.asarray(H_ab, np.float64)
        ph = np.concatenate([xy_a[q], np.ones((len(q), 1))], 1) @ Hm.T
        proj = ph[:, :2] / np.maximum(np.abs(ph[:, 2:3]), 1e-12) * np.sign(
            ph[:, 2:3])
        correct = np.linalg.norm(proj - xy_b[idx[q]], axis=1) <= tol

    fig, ax = plt.subplots(figsize=(12, 6 * H / (wa + wb) + 1))
    ax.imshow(canvas, cmap="gray", interpolation="nearest")
    if len(q):
        if correct is None:
            segs = np.stack([pa, pb], axis=1)
            colors = ["#2a7fff"] * len(q)
        else:
            segs = np.stack([pa, pb], axis=1)
            colors = ["#2ca02c" if c else "#d62728" for c in correct]
        from matplotlib.collections import LineCollection

        ax.add_collection(LineCollection(segs, colors=colors,
                                         linewidths=0.6, alpha=0.8))
        ax.scatter(pa[:, 0], pa[:, 1], s=3, c="#ffdd57", zorder=3)
        ax.scatter(pb[:, 0], pb[:, 1], s=3, c="#ffdd57", zorder=3)
    n_corr = int(correct.sum()) if correct is not None else None
    title = f"{len(q)} matches"
    if correct is not None:
        title += f" — {n_corr} correct (tol {tol:g} px)"
    ax.set_title(title)
    ax.set_axis_off()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return len(q), n_corr


def plot_trajectory(est_centers, path, gt_centers=None, frame_mask=None,
                    align: bool = True):
    """Top-down (x, z) trajectory plot; optionally aligned to GT with the
    same Umeyama alignment ATE uses, so the plot matches the metric.
    Writes ``path``; returns the ATE when GT is given (else None)."""
    plt = _mpl()
    est = np.asarray(est_centers, np.float64)
    if frame_mask is not None:
        est = est[np.asarray(frame_mask).astype(bool)]
    ate = None
    fig, ax = plt.subplots(figsize=(6, 6))
    if gt_centers is not None:
        import torch

        from fastmatch_tpu_torch.utils.evaluation import align_umeyama, ate_rmse

        gt = np.asarray(gt_centers, np.float64)
        if frame_mask is not None:
            gt = gt[np.asarray(frame_mask).astype(bool)]
        est_t = torch.from_numpy(est.astype(np.float32))
        gt_t = torch.from_numpy(gt.astype(np.float32))
        ate = float(ate_rmse(est_t, gt_t))
        if align:
            # Same sim(3) alignment ate_rmse applies, so the drawn error
            # whiskers visualize exactly the reported metric.
            s, R, t = align_umeyama(est_t, gt_t)
            est = float(s) * est @ R.numpy().T + t.numpy()
        ax.plot(gt[:, 0], gt[:, 2], "-", c="#888", lw=1.5, label="GT")
        for e, g in zip(est[::2], gt[::2]):
            ax.plot([e[0], g[0]], [e[2], g[2]], c="#d62728", lw=0.5,
                    alpha=0.5)
    ax.plot(est[:, 0], est[:, 2], "-", c="#2a7fff", lw=1.5, label="estimate")
    ax.scatter(est[:1, 0], est[:1, 2], c="#2ca02c", s=30, zorder=3,
               label="start")
    ax.set_aspect("equal")
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.legend(loc="best", fontsize=8)
    ax.set_title(f"trajectory{f' — ATE {ate:.4f}' if ate is not None else ''}")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return ate


def plot_match_stats(results, path):
    """Per-pair precision/recall bars from ``evaluate_pairs`` results
    (list of dicts with pair/precision/recall). Writes ``path``."""
    plt = _mpl()
    names = [r["pair"] for r in results]
    prec = [r["precision"] for r in results]
    rec = [r["recall"] for r in results]
    x = np.arange(len(names))
    fig, ax = plt.subplots(figsize=(max(6, 0.5 * len(names) + 2), 4))
    ax.bar(x - 0.2, prec, width=0.4, label="precision", color="#2a7fff")
    ax.bar(x + 0.2, rec, width=0.4, label="recall", color="#ff9f40")
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=45, ha="right", fontsize=7)
    ax.set_ylim(0, 1.05)
    ax.legend(fontsize=8)
    ax.set_title("match precision / recall per pair")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
