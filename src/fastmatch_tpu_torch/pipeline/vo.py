"""KLT visual odometry: flow-tracked landmarks and PnP, no descriptors.

Port of ``fastmatch_tpu/pipeline/vo.py``, the host engine. Shi-Tomasi
corners tracked by pyramidal LK (``features/klt.py``, K3 on the card) are
the data association of video-rate sequences. A frame costs one KLT step
and one RANSAC PnP on the device; map growth (triangulation, corner
replenishment, BA with K4 and K5) happens on keyframes only. Returns the
``Reconstruction`` container of the other engines.

- Track slots have a fixed capacity; dead slots are refilled on keyframes
  only, so slot-to-landmark bindings hold between keyframes.
- Bootstrap: the first frame whose root tracks' median flow exceeds
  ``bootstrap_px`` seeds the map (essential RANSAC and two-view DLT); the
  frames before it are posed afterwards by PnP against the seeded map.
- A frame whose PnP fails keeps the previous pose (flagged
  ``pnp_failed`` in ``frame_stats``) and the tracker keeps running.

RANSAC gets the live correspondences with an all-True mask (the JAX
package pads to a bucket for its compiles). Draws come from
``tracker.frame_generator(seed, frame, purpose)``: purpose 0 is frame f's
PnP, 1 its retroactive PnP, 2 the two-view bootstrap at f; so the draws
differ from the JAX package's, and the runs are compared on outcomes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from fastmatch_tpu_torch.core.camera import Pinhole, normalize_np
from fastmatch_tpu_torch.core.device import as_f32, resolve_device
from fastmatch_tpu_torch.features.klt import (KLTConfig, build_pyramid, shi_tomasi,
                                              track_pyramids)
from fastmatch_tpu_torch.geometry.pnp import ransac_pnp
from fastmatch_tpu_torch.geometry.ransac import ransac_essential
from fastmatch_tpu_torch.geometry.triangulation import triangulate_dlt
from fastmatch_tpu_torch.pipeline.config import PipelineConfig
from fastmatch_tpu_torch.pipeline.reconstruct import Reconstruction
from fastmatch_tpu_torch.pipeline.tracker import frame_generator

# Frame-generator purposes (``frame_generator(seed, frame, purpose)``).
PNP, RETRO_PNP, BOOTSTRAP = 0, 1, 2
# The VO engines' stages, beside reconstruct's in ``stage_seconds``: KLT
# tracking, corner detection, and the scan engine's loop but its BAs.
VO_STAGES = ("klt", "detect", "track")


@dataclass(frozen=True)
class VOConfig:
    capacity: int = 512          # track slots
    bootstrap_px: float = 20.0   # median flow to attempt two-view seeding
    min_parallax_px: float = 8.0 # first-obs parallax before triangulating
    kf_px: float = 12.0          # median flow from last keyframe -> new kf
    kf_min_tracked: int = 150    # ... or tracked landmarks drop below this
    pnp_min_inliers: int = 12
    ba_every_kfs: int = 4        # global BA cadence, in keyframes
    replenish_radius: float = 8.0  # keep new corners this far from live ones
    klt: KLTConfig = KLTConfig()


class _Clock:
    """Host seconds per stage, added to ``rec.stage_seconds``."""

    def __init__(self, rec: Reconstruction):
        self.s = rec.stage_seconds
        for k in VO_STAGES:
            self.s.setdefault(k, 0.0)

    def add(self, stage: str, t0: float):
        self.s[stage] += time.perf_counter() - t0


def pnp_live(X: np.ndarray, xn: np.ndarray, thr_n: float, n_hyp: int, min_inliers: int,
             generator: torch.Generator, dev):
    """RANSAC PnP on the live 2D-3D rows, all-True mask: (ok, n_inliers,
    R, t) on the host, from one readback."""
    res = ransac_pnp(as_f32(X, dev), as_f32(xn, dev), torch.ones(len(X), dtype=torch.bool,
                                                              device=dev),
                     thr=thr_n, n_hyp=n_hyp, min_inliers=min_inliers, generator=generator,
                     device=dev)
    row = torch.cat([res.ok.reshape(1).double(), res.n_inliers.reshape(1).double(),
                     res.pose.R.reshape(-1).double(), res.pose.t.double()]).cpu().numpy()
    return bool(row[0]), int(row[1]), row[2:11].reshape(3, 3).astype(np.float32), \
        row[11:14].astype(np.float32)


def triangulate_two(R2: np.ndarray, t2: np.ndarray, x2: np.ndarray, dev):
    """Two-view DLT of (2, P, 2) normalized rows with cheirality in both
    views: (points (P, 3), ok (P,)) on the host."""
    pts, ok = triangulate_dlt(as_f32(R2, dev), as_f32(t2, dev), as_f32(x2, dev))
    pts, ok = pts.cpu().numpy(), ok.cpu().numpy().copy()
    for Rf, tf in zip(R2, t2):
        ok &= (pts @ Rf.T + tf)[:, 2] > 1e-3
    return pts, ok


def visual_odometry(images, camera: Pinhole, cfg: PipelineConfig = PipelineConfig(),
                    vo: VOConfig = VOConfig(), metrics=None, seed: int = 0,
                    device=None) -> Reconstruction:
    """Run KLT visual odometry over a grayscale image sequence on ``device``
    (``cuda`` unless ``device="cpu"``).

    images: iterable of (H, W) float [0,1] frames, consumed strictly in
    order. Returns a Reconstruction with every frame posed (bootstrap pair
    gauge: |t| = 1)."""
    dev = resolve_device(device)
    C = vo.capacity
    rec = Reconstruction(cfg=cfg, camera=camera, device=dev)
    clock = _Clock(rec)
    thr_n = float(np.float32((cfg.ransac.thr_px / float(camera.fx)) ** 2))

    pos = np.zeros((C, 2), np.float32)      # current track positions
    alive = np.zeros(C, bool)
    lid = -np.ones(C, np.int64)             # landmark id per slot (-1: none)
    first_frame = np.zeros(C, np.int32)     # frame where this track started
    first_pos = np.zeros((C, 2), np.float32)
    kf_pos = np.zeros((C, 2), np.float32)   # positions at the last keyframe

    booted = False
    history = []                            # pre-bootstrap (pos, alive) per frame
    prev_pyr = None
    last_ba_kf = 0
    n_kfs = 0
    stats = rec.frame_stats

    def detect_into_free_slots(img, f):
        t0 = time.perf_counter()
        kps = shi_tomasi(img, capacity=C, device=dev)
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
        first_frame[sl] = f
        first_pos[sl] = cand[take]

    def pnp_frame(f, p_slots, a_slots, purpose):
        """Pose frame f from its tracked landmarks; returns (ok, inliers)."""
        sel = np.where(a_slots & (lid >= 0))[0]
        if len(sel) < 6:
            return False, 0
        t0 = time.perf_counter()
        ok, n_in, R, t = pnp_live(rec.points[lid[sel]], normalize_np(p_slots[sel], camera),
                                  thr_n, cfg.ransac.n_hyp, vo.pnp_min_inliers,
                                  frame_generator(seed, f, purpose, device=dev), dev)
        rec.stage_seconds["ransac_pnp"] += time.perf_counter() - t0
        if not ok:
            return False, n_in
        rec.R[f], rec.t[f] = R, t
        rec.pose_mask[f] = True
        return True, n_in

    def triangulate_new(f):
        """Two-view DLT for landmark-less tracks with enough parallax, one
        solve per origin frame."""
        sel = np.where(alive & (lid < 0) & (first_frame < f)
                       & rec.pose_mask[np.clip(first_frame, 0, None)])[0]
        if len(sel) == 0:
            return 0
        par = np.linalg.norm(pos[sel] - first_pos[sel], axis=1)
        sel = sel[par > vo.min_parallax_px]
        if len(sel) == 0:
            return 0
        added = 0
        for f0 in np.unique(first_frame[sel]):
            s = sel[first_frame[sel] == f0]
            t0 = time.perf_counter()
            pts, ok = triangulate_two(
                np.stack([rec.R[f0], rec.R[f]]), np.stack([rec.t[f0], rec.t[f]]),
                np.stack([normalize_np(first_pos[s], camera), normalize_np(pos[s], camera)]),
                dev)
            rec.stage_seconds["triangulate"] += time.perf_counter() - t0
            if rec.n_points + int(ok.sum()) > rec.pt_mask.shape[0]:
                ok &= np.cumsum(ok) <= rec.pt_mask.shape[0] - rec.n_points
            s, pts = s[ok], pts[ok]
            if len(s) == 0:
                continue
            ids = rec.add_points(pts, np.zeros((len(s), rec.pt_desc.shape[1]), np.float32))
            lid[s] = ids
            rec.add_observations(int(f0), ids, normalize_np(first_pos[s], camera))
            added += len(s)
        return added

    def add_kf_observations(f):
        sel = np.where(alive & (lid >= 0))[0]
        if len(sel) and rec.n_obs + len(sel) <= rec.obs_mask.shape[0]:
            rec.add_observations(f, lid[sel].astype(np.int32), normalize_np(pos[sel], camera))

    for f, img in enumerate(images):
        t0 = time.perf_counter()
        img = torch.from_numpy(np.array(img, dtype=np.float32)).to(dev)
        pyr = build_pyramid(img, vo.klt, dev)
        if f == 0:
            clock.add("klt", t0)
            detect_into_free_slots(img, 0)
            rec.pose_mask[0] = True
            rec.n_frames = 1
            kf_pos[:] = pos
            history.append((pos.copy(), alive.copy()))
            prev_pyr = pyr
            stats.append(dict(frame=0, tracked=int(alive.sum()), kf=True))
            continue

        new_pts, status, _ = track_pyramids(prev_pyr, pyr, torch.from_numpy(pos),
                                            torch.from_numpy(alive), vo.klt, dev)
        pos = new_pts.cpu().numpy().copy()
        alive = alive & status.cpu().numpy()
        clock.add("klt", t0)
        prev_pyr = pyr
        rec.n_frames = f + 1
        fstat = dict(frame=f, tracked=int(alive.sum()), kf=False)

        if not booted:
            history.append((pos.copy(), alive.copy()))
            root = alive & (first_frame == 0)
            flow = (np.linalg.norm(pos[root] - first_pos[root], axis=1)
                    if root.any() else np.zeros(1))
            if np.median(flow) > vo.bootstrap_px and root.sum() >= 16:
                sel = np.where(root)[0]
                t0 = time.perf_counter()
                res = ransac_essential(
                    as_f32(normalize_np(first_pos[sel], camera), dev),
                    as_f32(normalize_np(pos[sel], camera), dev),
                    torch.ones(len(sel), dtype=torch.bool, device=dev), thr=thr_n,
                    n_hyp=cfg.ransac.n_hyp, min_inliers=cfg.ransac.min_inliers,
                    generator=frame_generator(seed, f, BOOTSTRAP, device=dev), device=dev)
                ok = bool(res.ok)
                rec.stage_seconds["ransac_pnp"] += time.perf_counter() - t0
                if ok:
                    rec.R[f] = res.R.cpu().numpy()
                    rec.t[f] = res.t.cpu().numpy()
                    rec.pose_mask[f] = True
                    booted = True
                    triangulate_new(f)
                    add_kf_observations(f)
                    # Retroactive poses for the skipped frames; a failed one
                    # gets the main loop's flagged constant-position fallback
                    # (the previous frame is posed by induction from frame 0).
                    for fi in range(1, f):
                        p_h, a_h = history[fi]
                        ok_r, _ = pnp_frame(fi, p_h, a_h, RETRO_PNP)
                        if not ok_r:
                            rec.R[fi] = rec.R[fi - 1]
                            rec.t[fi] = rec.t[fi - 1]
                            rec.pose_mask[fi] = True
                            stats[fi]["pnp_failed"] = True
                    kf_pos[:] = pos
                    n_kfs = 2
                    fstat.update(kf=True, booted=True, points=int(rec.n_points))
                    cost0, cost = rec.run_ba(free_second_cam=True)
                    fstat.update(ba_cost0=cost0, ba_cost=cost)
            stats.append(fstat)
            continue

        ok, n_in = pnp_frame(f, pos, alive, PNP)
        fstat["pnp_inliers"] = n_in
        if not ok:
            # Constant-position fallback; flagged, not fatal.
            rec.R[f] = rec.R[f - 1]
            rec.t[f] = rec.t[f - 1]
            rec.pose_mask[f] = True
            fstat["pnp_failed"] = True

        kf_flow = np.linalg.norm(pos[alive] - kf_pos[alive], axis=1)
        n_tracked_lms = int((alive & (lid >= 0)).sum())
        if (np.median(kf_flow) > vo.kf_px if kf_flow.size else True) \
                or n_tracked_lms < vo.kf_min_tracked:
            fstat["kf"] = True
            n_kfs += 1
            fstat["new_points"] = triangulate_new(f)
            add_kf_observations(f)
            detect_into_free_slots(img, f)
            kf_pos[:] = pos
            if n_kfs - last_ba_kf >= vo.ba_every_kfs:
                cost0, cost = rec.run_ba()
                fstat.update(ba_cost0=cost0, ba_cost=cost)
                last_ba_kf = n_kfs
        if metrics is not None:
            metrics.log("vo_frame", **{k: v for k, v in fstat.items()
                                       if not isinstance(v, bool)})
        stats.append(fstat)

    if not booted:
        raise RuntimeError(
            "VO never bootstrapped: sequence has too little parallax "
            f"(needs median flow > {vo.bootstrap_px} px from frame 0)")
    return rec
