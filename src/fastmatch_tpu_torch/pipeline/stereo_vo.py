"""Metric stereo visual odometry: KLT tracking and stereo-lifted landmarks.

Port of ``fastmatch_tpu/pipeline/stereo_vo.py``, for rectified left/right
streams. Every keyframe lifts its corners to metric 3D through the dense
matcher (``dense/stereo.py``, Z = fx * baseline / disparity), so frame 0 is
already a map and every PnP is metric:

- frame 0 and keyframes: Shi-Tomasi corners into free slots, one
  ``stereo_disparity`` sweep of the pair, the disparity sampled at the
  corners on the device, the survivors lifted to world by the current pose;
- every frame: pyramidal LK (K3 on the card) tracks the live slots and
  RANSAC PnP against their landmarks poses the frame (a failure keeps the
  previous pose, flagged);
- keyframe trigger: live tracks below ``kf_tracked_frac`` of the capacity;
- observations are recorded at keyframes; a final BA (K4, K5) polishes the
  map with the first two poses fixed, which keeps the metric gauge.

PnP draws come from ``tracker.frame_generator(seed, frame, 0)``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from fastmatch_tpu_torch.core.camera import Pinhole, normalize_np
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.dense.stereo import StereoConfig, stereo_disparity
from fastmatch_tpu_torch.features.klt import (KLTConfig, build_pyramid, shi_tomasi,
                                              track_pyramids)
from fastmatch_tpu_torch.pipeline.config import PipelineConfig
from fastmatch_tpu_torch.pipeline.reconstruct import Reconstruction
from fastmatch_tpu_torch.pipeline.tracker import frame_generator
from fastmatch_tpu_torch.pipeline.vo import PNP, _Clock, pnp_live


@dataclass(frozen=True)
class StereoVOConfig:
    capacity: int = 512          # track slots
    kf_tracked_frac: float = 0.6  # replenish when live < frac * capacity
    pnp_min_inliers: int = 12
    min_disp: float = 1.0        # px; rejects far/invalid lifts
    max_depth: float = 200.0     # metric gate on lifted points
    replenish_radius: float = 8.0
    ba_final: bool = True
    klt: KLTConfig = field(default_factory=KLTConfig)
    stereo: StereoConfig = field(default_factory=StereoConfig)


def stereo_visual_odometry(left_images, right_images, camera: Pinhole, baseline: float,
                           cfg: PipelineConfig = PipelineConfig(),
                           vo: StereoVOConfig = StereoVOConfig(), metrics=None,
                           seed: int = 0, device=None) -> Reconstruction:
    """Run metric stereo VO over rectified (left, right) grayscale pairs on
    ``device`` (``cuda`` unless ``device="cpu"``).

    ``left_images`` / ``right_images``: equal-length sequences of (H, W)
    float [0,1] frames. Returns a Reconstruction with every frame posed in
    the metric frame of camera 0 (world = first left camera)."""
    dev = resolve_device(device)
    C = vo.capacity
    rec = Reconstruction(cfg=cfg, camera=camera, device=dev)
    clock = _Clock(rec)
    thr_n = float(np.float32((cfg.ransac.thr_px / float(camera.fx)) ** 2))
    fx, cx, cy = float(camera.fx), float(camera.cx), float(camera.cy)
    fy = float(camera.fy)

    pos = np.zeros((C, 2), np.float32)
    alive = np.zeros(C, bool)
    lid = -np.ones(C, np.int64)
    prev_pyr = None
    stats = rec.frame_stats

    def lift_keyframe(f, left, right):
        """Detect into free slots, stereo-lift the landmark-less ones."""
        t0 = time.perf_counter()
        kps = shi_tomasi(left, capacity=C, device=dev)
        cand = kps.xy.cpu().numpy()
        cmask = kps.mask.cpu().numpy().copy()
        clock.add("detect", t0)
        if alive.any():
            d2 = ((cand[:, None, :] - pos[None, alive, :]) ** 2).sum(-1)
            cmask &= d2.min(axis=1) > vo.replenish_radius ** 2
        free = np.where(~alive)[0]
        take = np.where(cmask)[0][: len(free)]
        sl = free[: len(take)]
        pos[sl] = cand[take]
        alive[sl] = True
        lid[sl] = -1

        disp, dvalid = stereo_disparity(left, right, vo.stereo, dev)
        h, w = disp.shape
        sel = np.where(alive & (lid < 0))[0]
        if sel.size == 0:
            return 0
        u = np.clip(np.round(pos[sel, 0]).astype(np.int64), 0, w - 1)
        v = np.clip(np.round(pos[sel, 1]).astype(np.int64), 0, h - 1)
        flat = torch.from_numpy(v * w + u).to(dev)
        d = disp.reshape(-1)[flat].cpu().numpy()
        ok = dvalid.reshape(-1)[flat].cpu().numpy() & (d > vo.min_disp)
        Z = fx * baseline / np.maximum(d, 1e-6)
        ok &= (Z > 0) & (Z < vo.max_depth)
        sel, Z = sel[ok], Z[ok]
        if sel.size == 0:
            return 0
        xn = (pos[sel, 0] - cx) / fx
        yn = (pos[sel, 1] - cy) / fy
        Xc = np.stack([xn * Z, yn * Z, Z], axis=1).astype(np.float32)
        Xw = (Xc - rec.t[f]) @ rec.R[f]          # world = R^T (x_cam - t)
        if rec.n_points + sel.size > rec.pt_mask.shape[0]:
            keep = np.arange(sel.size) < rec.pt_mask.shape[0] - rec.n_points
            sel, Xw = sel[keep], Xw[keep]
        if sel.size == 0:
            return 0
        ids = rec.add_points(Xw, np.zeros((sel.size, rec.pt_desc.shape[1]), np.float32))
        lid[sel] = ids
        return int(sel.size)

    def add_kf_observations(f):
        sel = np.where(alive & (lid >= 0))[0]
        if len(sel) and rec.n_obs + len(sel) <= rec.obs_mask.shape[0]:
            rec.add_observations(f, lid[sel].astype(np.int32), normalize_np(pos[sel], camera))

    def image(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    n_kfs = 0
    for f, (left, right) in enumerate(zip(left_images, right_images)):
        t0 = time.perf_counter()
        left = image(left)
        pyr = build_pyramid(left, vo.klt, dev)
        if f == 0:
            clock.add("klt", t0)
            rec.pose_mask[0] = True
            rec.n_frames = 1
            n_lift = lift_keyframe(0, left, image(right))
            add_kf_observations(0)
            n_kfs = 1
            prev_pyr = pyr
            stats.append(dict(frame=0, tracked=int(alive.sum()), kf=True, lifted=n_lift))
            if metrics:
                metrics.log("stereo_vo_frame", **stats[-1])
            continue

        new_pts, status, _ = track_pyramids(prev_pyr, pyr, torch.from_numpy(pos),
                                            torch.from_numpy(alive), vo.klt, dev)
        pos[:] = new_pts.cpu().numpy()
        alive &= status.cpu().numpy()
        clock.add("klt", t0)
        prev_pyr = pyr
        rec.n_frames = f + 1
        fstat = dict(frame=f, tracked=int(alive.sum()), kf=False)

        sel = np.where(alive & (lid >= 0))[0]
        ok = False
        if len(sel) >= 6:
            t0 = time.perf_counter()
            ok, n_in, R, t = pnp_live(rec.points[lid[sel]], normalize_np(pos[sel], camera),
                                      thr_n, cfg.ransac.n_hyp, vo.pnp_min_inliers,
                                      frame_generator(seed, f, PNP, device=dev), dev)
            rec.stage_seconds["ransac_pnp"] += time.perf_counter() - t0
            fstat["pnp_inliers"] = n_in
        if ok:
            rec.R[f], rec.t[f] = R, t
            rec.pose_mask[f] = True
        else:
            # Flagged constant-position fallback (the previous frame is
            # posed by induction); the tracks stay live and the keyframe
            # trigger below lifts again at the fallback pose.
            rec.R[f] = rec.R[f - 1]
            rec.t[f] = rec.t[f - 1]
            rec.pose_mask[f] = True
            fstat["pnp_failed"] = True

        if int(alive.sum()) < vo.kf_tracked_frac * C:
            n_lift = lift_keyframe(f, left, image(right))
            add_kf_observations(f)
            n_kfs += 1
            fstat.update(kf=True, lifted=n_lift)
        stats.append(fstat)
        if metrics:
            metrics.log("stereo_vo_frame", **fstat)

    if vo.ba_final and rec.n_obs > 0 and rec.n_frames >= 3:
        c0, c1 = rec.run_ba()
        stats.append(dict(frame=-1, ba_cost0=c0, ba_cost=c1, n_kfs=n_kfs))
    return rec
