"""Device-resident KLT visual odometry: the sequence after the bootstrap as
one loop over a state that stays on the device.

Port of ``fastmatch_tpu/pipeline/vo_scan.py``. The JAX package runs the
post-bootstrap sequence as one ``lax.scan`` with the keyframe work and the
interval BA under two ``lax.cond``s; eager PyTorch has neither, so
``_scan_frame`` is a step of a Python loop that keeps the scan's policy:

- a frame builds its pyramid, tracks (K3: ``1 + levels`` launches), runs
  RANSAC PnP against the slots' landmarks (a failure keeps the previous
  pose, flagged) and decides on the device whether it is a keyframe and
  whether the interval BA is due; the two flags come back in ONE readback
  a frame, and the host skips the keyframe work and the BA on the frames
  that need neither, as the ``lax.cond``s do. A non-keyframe writes only
  its pose row and the slots; the map is left bit-equal;
- the keyframe work (``_keyframe_work``) triangulates every ripened slot
  against its own origin frame (``_triangulate_pairwise``), appends the
  observations (``tracker._append_rows``) and refills free slots with
  Shi-Tomasi corners, all without a readback;
- the interval BA (``_run_interval_ba``: the gauge pair fixed, the table
  compacted by ``tracker.compact_obs_local``) runs K4 and K5;
- per-frame ``VOScanInfo`` rows stay on the device and come back in one
  transfer at the end.

The bootstrap (``_fast_bootstrap``) is the JAX package's: tracking in
chunks of ``_BOOT_CHUNK`` frames with one readback a chunk, the two-view
seed on the host, and the retroactive PnP of the skipped frames read back
together. Draws come from ``tracker.frame_generator(seed, frame,
purpose)`` (0: a frame's PnP, 1: its retroactive PnP, 2: the bootstrap), a
pure function of its arguments, so two runs are bit-identical.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from fastmatch_tpu_torch.ba.lm import ba_solve
from fastmatch_tpu_torch.ba.problem import BAProblem, Observations
from fastmatch_tpu_torch.core.batched_linalg import smallest_eigvecs
from fastmatch_tpu_torch.core.camera import Pinhole, normalize_np, normalize_pixels
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.core.lie import SE3
from fastmatch_tpu_torch.features.klt import (KLTConfig, build_pyramid, shi_tomasi,
                                              track_pyramids)
from fastmatch_tpu_torch.geometry.pnp import ransac_pnp
from fastmatch_tpu_torch.geometry.ransac import ransac_essential, take
from fastmatch_tpu_torch.pipeline.config import PipelineConfig
from fastmatch_tpu_torch.pipeline.reconstruct import Reconstruction
from fastmatch_tpu_torch.pipeline.tracker import (_append_rows, _put, compact_obs_local,
                                                  frame_generator)
from fastmatch_tpu_torch.pipeline.vo import (BOOTSTRAP, PNP, RETRO_PNP, VOConfig, _Clock,
                                             triangulate_two)


@dataclasses.dataclass(frozen=True)
class VOScanStatic:
    """The scan engine's configuration."""

    cap: int = 512
    max_frames: int = 64
    max_points: int = 8192
    max_obs: int = 65536
    n_hyp: int = 512
    pnp_min_inliers: int = 12
    kf_px: float = 12.0
    kf_min_tracked: int = 150
    min_parallax_px: float = 8.0
    replenish_radius: float = 8.0
    ba_every_kfs: int = 4
    ba_max_iters: int = 6
    ba_pcg_iters: int = 16
    ba_obs_cap: int = 8192       # compact_obs_local bucket; 0 = full table
    huber_delta: float = 0.004   # huber_px / fx
    cam_model: str = "pinhole"
    klt: KLTConfig = KLTConfig()


class VOScanState(NamedTuple):
    """Fixed-capacity device state: track slots and map."""

    # Track slots (capacity C)
    pos: torch.Tensor          # (C, 2) current pixel positions
    alive: torch.Tensor        # (C,) bool
    lid: torch.Tensor          # (C,) i32 landmark id or -1
    first_frame: torch.Tensor  # (C,) i32 frame where the track started
    first_pos: torch.Tensor    # (C, 2) pixel position at first_frame
    kf_pos: torch.Tensor       # (C, 2) positions at the last keyframe
    # Map (capacities F, P, O; the schema of pipeline/tracker.py)
    R: torch.Tensor            # (F, 3, 3) world->cam
    t: torch.Tensor            # (F, 3)
    pose_mask: torch.Tensor    # (F,) bool
    points: torch.Tensor       # (P, 3)
    pt_mask: torch.Tensor      # (P,) bool
    obs_cam: torch.Tensor      # (O,) i32
    obs_pt: torch.Tensor       # (O,) i32
    obs_uv: torch.Tensor       # (O, 2) normalized coords
    obs_mask: torch.Tensor     # (O,) bool
    n_points: torch.Tensor     # i32
    n_obs: torch.Tensor        # i32
    n_kfs: torch.Tensor        # i32
    last_ba_kf: torch.Tensor   # i32
    prev_pyr: tuple            # previous frame's pyramid (levels)
    cam: torch.Tensor          # (9,) packed intrinsics


class VOScanInfo(NamedTuple):
    """Per-frame outcome (read back once a sequence)."""

    tracked: torch.Tensor      # i32 live tracks after KLT
    pnp_ok: torch.Tensor       # bool
    n_inliers: torch.Tensor    # i32
    is_kf: torch.Tensor        # bool
    n_new_points: torch.Tensor # i32
    n_points: torch.Tensor     # i32
    n_obs: torch.Tensor        # i32
    ba_cost: torch.Tensor      # f32 (interval BA final cost; -1 if no BA)
    overflow: torch.Tensor     # bool


def _masked_median(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``np.median`` over the masked subset (the average of the two middle
    values of an even count), +inf when the subset is empty: the host
    engine's keyframe trigger."""
    s = torch.sort(torch.where(mask, vals, torch.full_like(vals, float("inf")))).values
    n = mask.sum(dtype=torch.int64)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = 0.5 * (take(s, lo) + take(s, hi))
    return torch.where(n > 0, med, torch.full_like(med, float("inf")))


def _triangulate_pairwise(R0, t0, x0, R1, t1, x1):
    """Two-view DLT with a different first view per point.

    R0: (C, 3, 3), t0: (C, 3), x0/x1: (C, 2) normalized; R1/t1: the shared
    second view. The normal matrix of ``triangulate_dlt`` (rows x*P3 - P1,
    y*P3 - P2 a view) with the view axis unrolled. Returns (points (C, 3),
    ok (C,))."""
    P0 = torch.cat([R0, t0[..., None]], dim=-1)               # (C, 3, 4)
    P1 = torch.cat([R1, t1[:, None]], dim=-1)                 # (3, 4)
    rows = [x0[:, 0:1] * P0[:, 2] - P0[:, 0],
            x0[:, 1:2] * P0[:, 2] - P0[:, 1],
            x1[:, 0:1] * P1[2][None] - P1[0][None],
            x1[:, 1:2] * P1[2][None] - P1[1][None]]
    A = torch.stack(rows, dim=1)                              # (C, 4, 4)
    ATA = torch.einsum("cri,crj->cij", A, A)
    h = smallest_eigvecs(ATA)[..., :, 0]                      # (C, 4)
    w = h[..., 3]
    ok = w.abs() > 1e-12
    pts = h[..., :3] / torch.where(ok, w, torch.ones_like(w))[..., None]
    return pts, ok


def _run_interval_ba(state: VOScanState, cfg: VOScanStatic):
    """Global-map BA in the loop (gauge cameras 0 and 1 fixed), the table
    compacted to ``ba_obs_cap`` rows (the newest win on overflow). Returns
    (state, cost)."""
    dev = state.R.device
    idx = torch.arange(state.pose_mask.shape[0], dtype=torch.int32, device=dev)
    prob = BAProblem(
        poses=SE3(state.R, state.t), points=state.points,
        obs=Observations(state.obs_cam, state.obs_pt, state.obs_uv, state.obs_mask),
        cam_mask=state.pose_mask, pt_mask=state.pt_mask,
        fixed_cams=state.pose_mask & (idx < 2))
    if cfg.ba_obs_cap > 0:
        prob = compact_obs_local(prob, cfg.ba_obs_cap)
    res = ba_solve(prob, device=dev, max_iters=cfg.ba_max_iters, pcg_iters=cfg.ba_pcg_iters,
                   huber_delta_static=cfg.huber_delta)
    return state._replace(R=res.poses.R, t=res.poses.t, points=res.points), res.cost


def _keyframe_work(state: VOScanState, img, fi, pos, alive, xn, Rf, tf, cfg: VOScanStatic):
    """Triangulate ripened tracks, record observations, replenish corners.
    Returns (state, new points, overflow)."""
    C, P = cfg.cap, cfg.max_points
    dev = pos.device
    lid = state.lid

    # ---- two-view triangulation of landmark-less ripened tracks ----
    ff = torch.clamp(state.first_frame, 0, cfg.max_frames - 1).long()
    par = torch.linalg.vector_norm(pos - state.first_pos, dim=1)
    sel = (alive & (lid < 0) & (state.first_frame < fi) & state.pose_mask[ff]
           & (par > cfg.min_parallax_px))
    x0 = normalize_pixels(state.first_pos, state.cam, cfg.cam_model)
    R0 = state.R[ff]
    t0 = state.t[ff]
    pts, ok3 = _triangulate_pairwise(R0, t0, x0, Rf, tf, xn)
    keep = sel & ok3
    # Cheirality in both views (the host engine's gate).
    z0 = torch.einsum("cij,cj->ci", R0, pts)[:, 2] + t0[:, 2]
    z1 = (pts @ Rf.T + tf)[:, 2]
    keep = keep & (z0 > 1e-3) & (z1 > 1e-3)

    slots_p = state.n_points + torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
    slots_ok = keep & (slots_p < P)
    slots = torch.where(slots_ok, slots_p, torch.full_like(slots_p, P))
    points = _put(state.points, slots, pts)
    pt_mask = _put(state.pt_mask, slots, True)
    total_p = state.n_points + keep.sum(dtype=torch.int32)
    n_points = torch.clamp(total_p, max=P)
    ovf = total_p > P
    lid = torch.where(slots_ok, slots_p, lid)
    n_new = slots_ok.sum(dtype=torch.int32)

    # Observations: the new landmarks in their origin frames, then every
    # tracked landmark (the new ones included) in this keyframe. One append
    # of the two blocks gives the rows, count and overflow of two in turn.
    sel_obs = alive & (lid >= 0)
    fvec = fi.expand(C) if torch.is_tensor(fi) else torch.full((C,), fi, dtype=torch.int32,
                                                               device=dev)
    (obs_cam, obs_pt, obs_uv, obs_mask), n_obs, ovf2 = _append_rows(
        [state.obs_cam, state.obs_pt, state.obs_uv, state.obs_mask],
        torch.cat([slots_ok, sel_obs]),
        [torch.cat([state.first_frame, fvec]),
         torch.cat([torch.where(slots_ok, slots_p, torch.zeros_like(slots_p)),
                    torch.clamp(lid, min=0)]),
         torch.cat([x0, xn]), torch.ones(2 * C, dtype=torch.bool, device=dev)],
        state.n_obs)

    # ---- Shi-Tomasi replenishment into free slots ----
    kps = shi_tomasi(img, capacity=C, device=dev)
    cxy = kps.xy
    d2 = ((cxy[:, None, :] - pos[None, :, :]) ** 2).sum(-1)          # (C, C)
    near = (d2 <= cfg.replenish_radius ** 2) & alive[None, :]
    cmask = kps.mask & ~near.any(dim=1)
    free = ~alive
    # The candidate of rank r (score order, from shi_tomasi's top-k) fills
    # the r-th free slot: the host engine's ``np.where(cmask)[0][:len(free)]``.
    rank_f = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    rank_c = torch.cumsum(cmask.to(torch.int32), 0, dtype=torch.int32) - 1
    n_cand = cmask.sum(dtype=torch.int32)
    ar = torch.arange(C, dtype=torch.int32, device=dev)
    by_rank = _put(torch.zeros(C, dtype=torch.int32, device=dev),
                   torch.where(cmask, rank_c, torch.full_like(rank_c, C)), ar)
    take_ = free & (rank_f < n_cand)
    j = by_rank[torch.clamp(rank_f, 0, C - 1).long()].long()
    pos = torch.where(take_[:, None], cxy[j], pos)
    alive = alive | take_
    lid = torch.where(take_, torch.full_like(lid, -1), lid)
    first_frame = torch.where(take_, fvec, state.first_frame)
    first_pos = torch.where(take_[:, None], cxy[j], state.first_pos)

    state = state._replace(
        pos=pos, alive=alive, lid=lid, first_frame=first_frame, first_pos=first_pos,
        kf_pos=pos, points=points, pt_mask=pt_mask, n_points=n_points,
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=obs_uv, obs_mask=obs_mask, n_obs=n_obs,
        n_kfs=state.n_kfs + 1)
    return state, n_new, ovf | ovf2


def _scan_frame(state: VOScanState, fi: int, img, seed: int, thr_n: float,
                cfg: VOScanStatic, clock=None):
    """One frame of the loop; returns (state, packed VOScanInfo row)."""
    dev = state.R.device
    fi_t = torch.full((), fi, dtype=torch.int32, device=dev)
    pyr = build_pyramid(img, cfg.klt, dev)

    # ---- KLT + PnP ----
    new_pts, status, _ = track_pyramids(state.prev_pyr, pyr, state.pos, state.alive, cfg.klt,
                                        dev)
    pos = new_pts
    alive = state.alive & status
    xn = normalize_pixels(pos, state.cam, cfg.cam_model)
    has_lm = alive & (state.lid >= 0)
    X = state.points[torch.clamp(state.lid, min=0).long()]
    pn = ransac_pnp(X, xn, has_lm, thr=thr_n, n_hyp=cfg.n_hyp,
                    min_inliers=cfg.pnp_min_inliers,
                    generator=frame_generator(seed, fi, PNP, device=dev), device=dev)
    ok = pn.ok
    # The constant-position fallback keeps every frame posed.
    Rf = torch.where(ok, pn.pose.R, state.R[fi - 1])
    tf = torch.where(ok, pn.pose.t, state.t[fi - 1])
    fsel = fi_t.reshape(1)
    state = state._replace(R=_put(state.R, fsel, Rf[None]), t=_put(state.t, fsel, tf[None]),
                           pose_mask=_put(state.pose_mask, fsel, True))

    # ---- keyframe decision (median keyframe flow or the tracked-landmark
    # floor, whatever PnP gave), and whether the interval BA is due ----
    kf_flow = torch.linalg.vector_norm(pos - state.kf_pos, dim=1)
    med = _masked_median(kf_flow, alive)
    n_tracked = has_lm.sum(dtype=torch.int32)
    is_kf = (med > cfg.kf_px) | (n_tracked < cfg.kf_min_tracked)
    do_ba = is_kf & (state.n_kfs + 1 - state.last_ba_kf >= cfg.ba_every_kfs)
    state = state._replace(pos=pos, alive=alive)
    kf, ba = torch.stack([is_kf, do_ba]).tolist()          # the frame's one readback

    n_new = torch.zeros((), dtype=torch.int32, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    ba_cost = torch.full((), -1.0, device=dev)
    if kf:
        state, n_new, ovf = _keyframe_work(state, img, fi_t, pos, alive, xn, Rf, tf, cfg)
    if ba:
        t0 = time.perf_counter()
        state, ba_cost = _run_interval_ba(state, cfg)
        state = state._replace(last_ba_kf=state.n_kfs)
        if clock is not None:
            clock.s["ba"] += time.perf_counter() - t0
    state = state._replace(prev_pyr=tuple(pyr))
    info = VOScanInfo(
        tracked=alive.sum(dtype=torch.int32), pnp_ok=ok, n_inliers=pn.n_inliers, is_kf=is_kf,
        n_new_points=n_new, n_points=state.n_points, n_obs=state.n_obs, ba_cost=ba_cost,
        overflow=ovf)
    return state, torch.stack([f.reshape(()).to(torch.float64) for f in info])


def _static_from_cfg(cfg: PipelineConfig, vo: VOConfig, camera) -> VOScanStatic:
    m, ba = cfg.map, cfg.ba
    model = "fisheye" if getattr(camera, "model", "") == "fisheye" else "pinhole"
    return VOScanStatic(
        cap=vo.capacity, max_frames=m.max_frames, max_points=m.max_points,
        max_obs=m.max_obs, n_hyp=cfg.ransac.n_hyp, pnp_min_inliers=vo.pnp_min_inliers,
        kf_px=vo.kf_px, kf_min_tracked=vo.kf_min_tracked,
        min_parallax_px=vo.min_parallax_px, replenish_radius=vo.replenish_radius,
        ba_every_kfs=vo.ba_every_kfs,
        ba_max_iters=ba.interval_max_iters or ba.max_iters,
        ba_pcg_iters=ba.interval_pcg_iters or ba.pcg_iters,
        ba_obs_cap=ba.local_obs_cap, huber_delta=ba.huber_px / float(camera.fx),
        cam_model=model, klt=vo.klt)


# Pre-boot tracking chunk length (one readback a chunk).
_BOOT_CHUNK = 16


def _boot_track_chunk(prev_pyr, imgs, pos, alive, klt: KLTConfig, dev):
    """KLT-only tracking over a chunk of frames with no readback: returns
    (last pyramid, pos, alive, stacked per-frame positions, stacked alive)."""
    ps, als = [], []
    for img in imgs:
        pyr = build_pyramid(img, klt, dev)
        new, st, _ = track_pyramids(prev_pyr, pyr, pos, alive, klt, dev)
        pos, alive, prev_pyr = new, alive & st, pyr
        ps.append(pos)
        als.append(alive)
    return prev_pyr, pos, alive, torch.stack(ps), torch.stack(als)


def _fast_bootstrap(stack, n, camera, cfg, vo: VOConfig, thr_n, seed, dev):
    """The host engine's two-view bootstrap with batched device work:
    detect at frame 0, track in chunks until the root tracks' median flow
    clears ``bootstrap_px`` with >= 16 survivors, essential RANSAC, DLT with
    cheirality gates, retroactive PnP of the skipped frames (flagged
    constant-position fallback), and the gauge-fixing two-view BA. Returns
    (rec, boot), ``boot`` the loop's initial slot state."""
    C = vo.capacity
    rec = Reconstruction(cfg=cfg, camera=camera, device=dev)
    clock = _Clock(rec)
    stats = rec.frame_stats

    t0 = time.perf_counter()
    kps = shi_tomasi(stack[0], capacity=C, device=dev)
    pos0 = kps.xy.cpu().numpy().copy()
    m0 = kps.mask.cpu().numpy().copy()
    clock.add("detect", t0)
    first_pos = pos0.copy()
    rec.pose_mask[0] = True
    rec.n_frames = 1
    stats.append(dict(frame=0, tracked=int(m0.sum()), kf=True))

    pyr_prev = build_pyramid(stack[0], vo.klt, dev)
    pos_d, alive_d = kps.xy, kps.mask
    hist = {}
    fb = boot_res = boot_stat = None
    for c0 in range(1, n, _BOOT_CHUNK):
        c1 = min(c0 + _BOOT_CHUNK, n)
        t0 = time.perf_counter()
        pyr_prev, pos_d, alive_d, ys_pos, ys_alive = _boot_track_chunk(
            pyr_prev, stack[c0:c1], pos_d, alive_d, vo.klt, dev)
        ys_pos, ys_alive = ys_pos.cpu().numpy(), ys_alive.cpu().numpy()
        clock.add("klt", t0)
        for k, fi in enumerate(range(c0, c1)):
            p_i, a_i = ys_pos[k], ys_alive[k]
            hist[fi] = (p_i, a_i)
            rec.n_frames = fi + 1
            fstat = dict(frame=fi, tracked=int(a_i.sum()), kf=False)
            stats.append(fstat)
            # Pre-boot every live track is a root (no replenishment yet).
            flow = (np.linalg.norm(p_i[a_i] - first_pos[a_i], axis=1)
                    if a_i.any() else np.zeros(1))
            if np.median(flow) > vo.bootstrap_px and a_i.sum() >= 16:
                # Compacted rows, as the host engine gives RANSAC.
                sroot = np.where(a_i)[0]
                t0 = time.perf_counter()
                res = ransac_essential(
                    torch.from_numpy(normalize_np(first_pos[sroot], camera).astype(np.float32)).to(dev),
                    torch.from_numpy(normalize_np(p_i[sroot], camera).astype(np.float32)).to(dev),
                    torch.ones(len(sroot), dtype=torch.bool, device=dev), thr=thr_n,
                    n_hyp=cfg.ransac.n_hyp, min_inliers=cfg.ransac.min_inliers,
                    generator=frame_generator(seed, fi, BOOTSTRAP, device=dev), device=dev)
                ok = bool(res.ok)
                rec.stage_seconds["ransac_pnp"] += time.perf_counter() - t0
                if ok:
                    fb, boot_res, boot_stat = fi, res, fstat
                    break
        if fb is not None:
            break
    if fb is None:
        raise RuntimeError(
            "VO never bootstrapped: sequence has too little parallax "
            f"(needs median flow > {vo.bootstrap_px} px from frame 0)")

    rec.R[fb] = boot_res.R.cpu().numpy()
    rec.t[fb] = boot_res.t.cpu().numpy()
    rec.pose_mask[fb] = True

    # ---- triangulate the root tracks (origin frame 0) ----
    pos_fb, alive_fb = hist[fb]
    par = np.linalg.norm(pos_fb - first_pos, axis=1)
    sel = alive_fb & (par > vo.min_parallax_px)
    x1n = normalize_np(first_pos, camera).astype(np.float32)
    x2n = normalize_np(pos_fb, camera).astype(np.float32)
    t0 = time.perf_counter()
    pts, ok = triangulate_two(np.stack([rec.R[0], rec.R[fb]]), np.stack([rec.t[0], rec.t[fb]]),
                              np.stack([x1n, x2n]), dev)
    rec.stage_seconds["triangulate"] += time.perf_counter() - t0
    ok &= sel
    cap_p = rec.pt_mask.shape[0]
    if int(ok.sum()) > cap_p:
        ok &= np.cumsum(ok) <= cap_p
    lid = -np.ones(C, np.int64)
    sidx = np.where(ok)[0]
    if len(sidx):
        ids = rec.add_points(pts[sidx], np.zeros((len(sidx), rec.pt_desc.shape[1]), np.float32))
        lid[sidx] = ids
        rec.add_observations(0, ids, x1n[sidx])
        sel2 = np.where(alive_fb & (lid >= 0))[0]
        rec.add_observations(fb, lid[sel2].astype(np.int32), x2n[sel2])

    # ---- retroactive PnP of frames 1..fb-1, read back together ----
    if fb > 1 and len(sidx):
        X = np.zeros((C, 3), np.float32)
        X[lid >= 0] = rec.points[lid[lid >= 0]]
        Xd = torch.from_numpy(X).to(dev)
        rows = []
        t0 = time.perf_counter()
        for f in range(1, fb):
            pn = ransac_pnp(
                Xd, torch.from_numpy(normalize_np(hist[f][0], camera).astype(np.float32)).to(dev),
                torch.from_numpy(hist[f][1] & (lid >= 0)).to(dev), thr=thr_n,
                n_hyp=cfg.ransac.n_hyp, min_inliers=vo.pnp_min_inliers,
                generator=frame_generator(seed, f, RETRO_PNP, device=dev), device=dev)
            rows.append(torch.cat([pn.ok.reshape(1).double(), pn.pose.R.reshape(-1).double(),
                                   pn.pose.t.double()]))
        rows = torch.stack(rows).cpu().numpy()
        rec.stage_seconds["ransac_pnp"] += time.perf_counter() - t0
        for f, row in zip(range(1, fb), rows):
            if row[0]:
                rec.R[f] = row[1:10].reshape(3, 3)
                rec.t[f] = row[10:13]
            else:
                # The host engine's flagged constant-position fallback
                # (frame f-1 is posed by induction).
                rec.R[f] = rec.R[f - 1]
                rec.t[f] = rec.t[f - 1]
                stats[f]["pnp_failed"] = True
            rec.pose_mask[f] = True
    elif fb > 1:
        for f in range(1, fb):
            rec.R[f] = rec.R[f - 1]
            rec.t[f] = rec.t[f - 1]
            rec.pose_mask[f] = True
            stats[f]["pnp_failed"] = True

    boot_stat.update(kf=True, booted=True, points=int(rec.n_points))
    cost0, cost = rec.run_ba(free_second_cam=True)
    boot_stat.update(ba_cost0=cost0, ba_cost=cost)
    boot = dict(frame=fb, pos=pos_fb, alive=alive_fb, lid=lid,
                first_frame=np.zeros(C, np.int32), first_pos=first_pos,
                kf_pos=pos_fb.copy(), n_kfs=2)
    return rec, boot


def _initial_state(rec: Reconstruction, boot: dict, prev_pyr, camera, dev) -> VOScanState:
    def t(a, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return x if dtype is None else x.to(dtype)

    def scalar(v):
        return torch.full((), int(v), dtype=torch.int32, device=dev)

    return VOScanState(
        pos=t(boot["pos"], torch.float32), alive=t(boot["alive"]),
        lid=t(boot["lid"], torch.int32), first_frame=t(boot["first_frame"]),
        first_pos=t(boot["first_pos"], torch.float32), kf_pos=t(boot["kf_pos"], torch.float32),
        R=t(rec.R), t=t(rec.t), pose_mask=t(rec.pose_mask), points=t(rec.points),
        pt_mask=t(rec.pt_mask), obs_cam=t(rec.obs_cam), obs_pt=t(rec.obs_pt),
        obs_uv=t(rec.obs_uv), obs_mask=t(rec.obs_mask), n_points=scalar(rec.n_points),
        n_obs=scalar(rec.n_obs), n_kfs=scalar(boot["n_kfs"]), last_ba_kf=scalar(0),
        prev_pyr=tuple(prev_pyr),
        cam=t(np.asarray(camera.intrinsics_vector(), np.float32)))


def visual_odometry_scan(images, camera: Pinhole, cfg: PipelineConfig = PipelineConfig(),
                         vo: VOConfig = VOConfig(), seed: int = 0, metrics=None,
                         device=None) -> Reconstruction:
    """Scan-mode VO on ``device`` (``cuda`` unless ``device="cpu"``): the
    batched bootstrap, then one device-resident pass over the rest.

    ``images``: (F, H, W) [0,1] grayscale stack (list or array; one shape),
    uploaded once. Returns the ``Reconstruction`` of ``visual_odometry``."""
    dev = resolve_device(device)
    images = [np.asarray(im, np.float32) for im in images]
    n = len(images)
    if n < 2:
        raise ValueError("VO needs at least 2 frames")
    if n > cfg.map.max_frames:
        # Pose rows beyond the capacity would be dropped silently.
        raise ValueError(f"sequence has {n} frames but map.max_frames is "
                         f"{cfg.map.max_frames}; raise the capacity")
    tcfg = _static_from_cfg(cfg, vo, camera)
    thr_n = float(np.float32((cfg.ransac.thr_px / float(camera.fx)) ** 2))
    stack = torch.from_numpy(np.stack(images)).to(dev)
    rec, boot = _fast_bootstrap(stack, n, camera, cfg, vo, thr_n, seed, dev)
    clock = _Clock(rec)
    fb = boot["frame"]
    if fb >= n - 1:
        return rec
    state = _initial_state(rec, boot, build_pyramid(stack[fb], vo.klt, dev), camera, dev)
    rows = []
    t0 = time.perf_counter()
    ba0 = rec.stage_seconds["ba"]
    for fi in range(fb + 1, n):
        state, row = _scan_frame(state, fi, stack[fi], seed, thr_n, tcfg, clock)
        rows.append(row)
    infos = torch.stack(rows).cpu().numpy()                  # the one readback of the infos
    # The loop's time but its interval BAs: tracking, PnP, keyframe work.
    clock.s["track"] += time.perf_counter() - t0 - (rec.stage_seconds["ba"] - ba0)
    overflow = infos[:, VOScanInfo._fields.index("overflow")] != 0
    if overflow.any():
        raise RuntimeError(f"map capacity exceeded at frame {fb + 1 + int(np.argmax(overflow))}")
    # Fold the device map back into the host container.
    for name in ("R", "t", "pose_mask", "points", "pt_mask", "obs_cam", "obs_pt", "obs_uv",
                 "obs_mask"):
        setattr(rec, name, getattr(state, name).cpu().numpy().copy())
    rec.n_points, rec.n_obs = torch.stack([state.n_points, state.n_obs]).tolist()
    rec.n_frames = n
    col = {name: infos[:, i] for i, name in enumerate(VOScanInfo._fields)}
    for k, fi in enumerate(range(fb + 1, n)):
        fstat = dict(frame=fi, tracked=int(col["tracked"][k]), kf=bool(col["is_kf"][k]),
                     pnp_inliers=int(col["n_inliers"][k]))
        if not col["pnp_ok"][k]:
            fstat["pnp_failed"] = True
        if col["n_new_points"][k]:
            fstat["new_points"] = int(col["n_new_points"][k])
        if col["ba_cost"][k] >= 0:
            fstat["ba_cost"] = float(np.float32(col["ba_cost"][k]))
        rec.frame_stats.append(fstat)
        if metrics is not None:
            metrics.log("vo_frame", **{k_: v for k_, v in fstat.items()
                                       if not isinstance(v, bool)})
    rec.run_ba()   # final global solve (host-level, compacted to the live rows)
    return rec
