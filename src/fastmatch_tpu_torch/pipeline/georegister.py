"""Georegistration: pin a monocular map to GPS (or any absolute camera
positions).

Port of ``fastmatch_tpu/pipeline/georegister.py``. Monocular output lives
in an arbitrary sim(3) gauge; GPS gives camera centres in a metric world
frame. Three stages:

1. **sim(3) alignment**: trimmed Umeyama over the measured frames (two
   trim rounds at 3x the median residual, so one gross outlier cannot bend
   the transform), applied to the whole map (``apply_sim3``).
2. **GPS-anchored pose-graph refinement**: odometry edges of the aligned
   trajectory plus position priors at the measured frames
   (``posegraph/pgo.with_position_priors``; PGO's sums go through K4), a
   robust prior kernel as the outlier defence, no fixed poses.
3. **Anchored global BA** (K4, K5): the GPS frames fixed hold the absolute
   frame.

CLI: ``slam/reconstruct ... --gps gps.npz [--gps-weight W --gps-delta D]``,
the npz holding ``frames`` (sequence indices) and ``xyz`` ((K, 3) world
camera centres).
"""

from __future__ import annotations

import numpy as np
import torch

from fastmatch_tpu_torch.core.lie import SE3
from fastmatch_tpu_torch.utils.evaluation import align_umeyama


def apply_sim3(rec, s: float, R: np.ndarray, t: np.ndarray) -> None:
    """In-place similarity transform of a Reconstruction: world points
    X' = s R X + t; poses R_i' = R_i R^T, t_i' = s t_i - R_i R^T t (camera
    coordinates rescale by s: x_cam' = s x_cam). Float64 on the host."""
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    live = rec.pose_mask
    RiRT = np.einsum("fij,kj->fik", rec.R[live].astype(np.float64), R)
    rec.t[live] = (s * rec.t[live].astype(np.float64)
                   - np.einsum("fij,j->fi", RiRT, t)).astype(np.float32)
    rec.R[live] = RiRT.astype(np.float32)
    pm = rec.pt_mask
    rec.points[pm] = (s * rec.points[pm].astype(np.float64) @ R.T + t).astype(np.float32)


def trimmed_umeyama(X: np.ndarray, Y: np.ndarray, rounds: int = 3):
    """(s, R, t, aligned X, inlier mask) of a sim(3) fit of X onto Y,
    refit without the points beyond 3x the median residual until the set
    stops changing (or would drop below 3 points)."""
    mask = np.ones(X.shape[0], bool)
    Xt = torch.from_numpy(np.asarray(X, np.float32))
    Yt = torch.from_numpy(np.asarray(Y, np.float32))
    for _ in range(rounds):
        s, Rs, ts = align_umeyama(Xt, Yt, mask=torch.from_numpy(mask))
        s, Rs, ts = float(s), Rs.numpy(), ts.numpy()
        aligned = s * X @ Rs.T + ts
        res = np.linalg.norm(aligned - Y, axis=-1)
        new_mask = res <= max(3.0 * np.median(res[mask]), 1e-9)
        if new_mask.sum() < 3 or new_mask.all() or (new_mask == mask).all():
            break
        mask = new_mask
    return s, Rs, ts, aligned, mask


def georegister(rec, gps_frames, gps_xyz, cfg, weight: float = 10.0,
                prior_delta: float | None = None, pgo_iters: int = 40, frame_seq=None,
                metrics=None) -> dict:
    """Pin ``rec`` (modified in place, solved on ``rec.device``) to GPS
    camera-centre measurements. ``gps_frames``: the sequence indices of the
    measurements; ``frame_seq``: the map's frame id -> sequence index
    (``SlamResult.frame_seq``; identity when empty). Measurements of
    untracked frames are dropped. Returns a summary (RMSE before and after,
    the fixes used)."""
    from fastmatch_tpu_torch.ba.lm import ba_solve
    from fastmatch_tpu_torch.pipeline.tracker import compact_obs
    from fastmatch_tpu_torch.posegraph.pgo import PoseGraph, pgo_solve, with_position_priors

    dev = rec.device
    gps_frames = np.asarray(gps_frames, np.int64)
    gps_xyz = np.asarray(gps_xyz, np.float32)
    if frame_seq:
        fid_of = {fi: fid for fid, fi in enumerate(frame_seq)}
        keep = np.array([fi in fid_of for fi in gps_frames], bool)
        fids = np.array([fid_of[fi] for fi in gps_frames[keep]], np.int64)
    else:
        keep = gps_frames < rec.n_frames
        fids = gps_frames[keep]
    gps_xyz = gps_xyz[keep]
    if fids.size < 3:
        raise ValueError(f"georegister needs >= 3 GPS fixes on tracked frames, got {fids.size}")

    def centers():
        return -np.einsum("fji,fj->fi", rec.R[fids], rec.t[fids])

    # 1. sim(3) alignment (rigid + scale: what the SE(3) pose graph cannot).
    s, Ra, ta, _, _ = trimmed_umeyama(centers(), gps_xyz)
    apply_sim3(rec, s, Ra, ta)
    rmse_aligned = float(np.sqrt(np.mean(np.sum((centers() - gps_xyz) ** 2, -1))))

    # 2. GPS-anchored pose-graph refinement over the aligned trajectory.
    def tens(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    n = rec.R.shape[0]
    live_ids = np.nonzero(rec.pose_mask)[0]
    ei, ej = live_ids[1:], live_ids[:-1]
    Ti = SE3(tens(rec.R[ei]), tens(rec.t[ei]))
    Tj = SE3(tens(rec.R[ej]), tens(rec.t[ej]))
    g = PoseGraph(
        poses=SE3(tens(rec.R), tens(rec.t)),
        edge_i=tens(ei, torch.int64), edge_j=tens(ej, torch.int64),
        Z=Ti.compose(Tj.inverse()),
        edge_weight=torch.ones(ei.shape[0], device=dev),
        pose_mask=tens(rec.pose_mask, torch.bool),
        fixed=torch.zeros(n, dtype=torch.bool, device=dev),
    )
    g = with_position_priors(g, fids, gps_xyz, weight * np.ones(fids.shape[0], np.float32))
    res = pgo_solve(g, max_iters=pgo_iters, prior_delta=prior_delta,
                    kernel="geman" if prior_delta else "huber", device=dev)
    rec.R = res.poses.R.cpu().numpy().copy()
    rec.t = res.poses.t.cpu().numpy().copy()

    # 3. Anchored global BA (the GPS frames fixed hold the absolute frame).
    fixed = np.zeros(n, bool)
    fixed[fids] = True
    prob = rec.ba_problem()._replace(fixed_cams=tens(fixed & rec.pose_mask, torch.bool))
    prob = compact_obs(prob, int(rec.obs_mask.sum()))
    ba = ba_solve(prob, device=dev, max_iters=cfg.ba.max_iters, pcg_iters=cfg.ba.pcg_iters,
                  huber_delta_static=cfg.ba.huber_px / float(rec.camera.fx))
    rec.R = ba.poses.R.cpu().numpy().copy()
    rec.t = ba.poses.t.cpu().numpy().copy()
    rec.points = ba.points.cpu().numpy().copy()

    rmse_final = float(np.sqrt(np.mean(np.sum((centers() - gps_xyz) ** 2, -1))))
    summary = {"n_gps": int(fids.size), "scale": float(s),
               "rmse_aligned": round(rmse_aligned, 6), "rmse_final": round(rmse_final, 6),
               "pgo_iters": int(res.iters)}
    if metrics:
        metrics.log("georegister", **summary)
    return summary
