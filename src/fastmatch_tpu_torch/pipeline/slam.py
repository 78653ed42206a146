"""SLAM: local-window tracking, loop closure and pose-graph correction
(BASELINE.json config 4).

Port of ``fastmatch_tpu/pipeline/slam.py`` on the port's incremental-SfM
machinery (``pipeline/reconstruct.py``). Differences from ``reconstruct``:

- **Local mapping**: PnP tracks against the landmarks seen within the last
  ``window`` frames, and periodic BA freezes everything outside the window.
- **Loop closure**: the current frame's descriptors query the stacked bank
  of every frame older than ``loop_gap`` (the fused matcher, K2 on the
  card), valid matches vote for their frame, and a candidate with enough
  votes is verified by PnP against its own landmarks.
- **Correction**: verified closures and the odometry edges recorded at
  tracking time form a pose graph, solved with the Geman-McClure kernel
  (``posegraph/pgo.py``), after which the map is bundle-adjusted globally.

The retrieval bank stays on the device: one preallocated (max_frames x
capacity, D) buffer filled as frames arrive, of which the matcher gets the
first n_old x capacity rows, where the JAX package concatenates the old
frames' descriptors on the host every frame. The matcher sees the same
inputs, so the decisions are the same.

RANSAC draws come from ``torch.Generator``s (``reconstruct._Run``), so a run
agrees with the JAX package's in its outcomes, not in its bits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from fastmatch_tpu_torch.ba.lm import ba_solve
from fastmatch_tpu_torch.core.camera import Pinhole, normalize_np
from fastmatch_tpu_torch.core.containers import Descriptors
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.core.lie import SE3
from fastmatch_tpu_torch.geometry.ransac import ransac_essential
from fastmatch_tpu_torch.matching.matcher import match_pair
from fastmatch_tpu_torch.pipeline.config import PipelineConfig
from fastmatch_tpu_torch.pipeline.reconstruct import (
    Reconstruction,
    _known_in_map,
    _match,
    _ransac_pnp,
    _Run,
    _triangulate_two_view,
)
from fastmatch_tpu_torch.pipeline.tracker import compact_obs
from fastmatch_tpu_torch.posegraph.pgo import PoseGraph, pgo_solve


@dataclass(frozen=True)
class SlamConfig:
    window: int = 8               # local-map frame window for tracking/BA
    loop_gap: int = 12            # min frame separation for a loop candidate
    loop_min_votes: int = 25      # descriptor-match votes to consider a loop
    loop_kernel_delta: float = 0.1  # geman kernel width for PGO
    pgo_iters: int = 40
    # Keyframe selection: a frame becomes a keyframe (adds observations
    # and landmarks) when tracking falls below ``kf_tracked_thresh`` PnP
    # inliers or ``kf_max_gap`` frames passed since the last one; 0 makes
    # every frame a keyframe.
    kf_tracked_thresh: int = 0
    kf_max_gap: int = 5
    # Covisibility-gated local BA of the JAX package's device engine; kept
    # for the configuration's fields (this host engine does not read it).
    ba_covis_thresh: int = 0


@dataclass
class SlamResult:
    rec: Reconstruction
    loop_edges: list = field(default_factory=list)   # (frame, candidate, Z R, Z t)
    pgo_runs: int = 0
    odo_edges: list = field(default_factory=list)    # (i, j, Z R, Z t)
    # State frame id -> input sequence index; the JAX package's host path
    # leaves it empty (every frame is accepted or the run raises).
    frame_seq: list = field(default_factory=list)


def _relative(Ra, ta, Rb, tb):
    """Z = T_a T_b^-1 in float32 numpy."""
    R = (Ra @ Rb.T).astype(np.float32)
    return R, (ta - R @ tb).astype(np.float32)


class _Bank:
    """The retrieval bank on the run's device: frame k's descriptors at rows
    k * per .. (k + 1) * per - 1, written as the frame arrives."""

    def __init__(self, run: _Run, n_frames: int, per: int, dim: int):
        self.per = per
        self.desc = torch.zeros((n_frames * per, dim), dtype=torch.float32, device=run.device)
        self.mask = torch.zeros(n_frames * per, dtype=torch.bool, device=run.device)

    def put(self, k: int, desc: torch.Tensor, mask: torch.Tensor):
        self.desc[k * self.per:(k + 1) * self.per] = desc
        self.mask[k * self.per:(k + 1) * self.per] = mask

    def first(self, n_old: int) -> Descriptors:
        return Descriptors(self.desc[:n_old * self.per], self.mask[:n_old * self.per])


def _loop_votes(run: _Run, desc: Descriptors, bank: _Bank, n_old: int, cfg) -> np.ndarray | None:
    """Frame votes of the current frame's descriptors against the bank of
    the first ``n_old`` frames: valid matches (ratio test and cross-check)
    counted per frame; None when no match is valid."""
    m = match_pair(desc, bank.first(n_old), ratio=cfg.matching.ratio,
                   cross_check=cfg.matching.cross_check, backend=cfg.matching.backend,
                   precision=cfg.matching.precision, device=run.device)
    src = (m.idx[m.valid].long() // bank.per).cpu().numpy()
    return np.bincount(src, minlength=n_old) if len(src) else None


def _loop_candidate(votes: np.ndarray, rec: Reconstruction, min_votes: int) -> int:
    """The best-voted of the top 4 frames with at least ``min_votes`` votes
    that carries observations (a keyframe), or -1."""
    obs_cam = rec.obs_cam[: rec.n_obs]
    for c in np.argsort(-votes)[:4]:
        if votes[c] < min_votes:
            break
        if np.any(obs_cam == c):
            return int(c)
    return -1


def slam(features: list, camera: Pinhole, cfg: PipelineConfig = PipelineConfig(),
         scfg: SlamConfig = SlamConfig(), seed: int = 0, metrics=None,
         device=None) -> SlamResult:
    """Run online SLAM over a feature sequence on ``device`` (``cuda``
    unless ``device="cpu"``), in the feature format of ``reconstruct``;
    every frame must share one capacity. Returns the corrected map and the
    loop and odometry bookkeeping. ``metrics``: optional
    ``utils.metrics.MetricsLogger`` ("track" per frame, "loop_closure" per
    closure). Raises RuntimeError when the bootstrap fails or tracking is
    lost."""
    dev = resolve_device(device)
    rec = Reconstruction(cfg=cfg, camera=camera, device=dev)
    out = SlamResult(rec=rec)
    run = _Run(rec, seed)
    thr_n = (cfg.ransac.thr_px / float(camera.fx)) ** 2
    per = features[0][1].shape[0]
    if any(f[1].shape[0] != per for f in features):
        raise ValueError("every frame must share one descriptor capacity")
    kp_landmark = [np.full(f[0].shape[0], -1, np.int64) for f in features]
    pt_last_seen = np.full(rec.pt_mask.shape[0], -(10 ** 9), np.int64)
    bank = _Bank(run, cfg.map.max_frames, per, features[0][1].shape[1])

    def local_pt_mask(f):
        return rec.pt_mask & (pt_last_seen >= f - scfg.window)

    def run_local_ba(f):
        # Freeze cameras outside the window and the first two (gauge).
        t0 = time.perf_counter()
        prob = rec.ba_problem()
        idx = np.arange(rec.pose_mask.shape[0])
        fixed = prob.fixed_cams.cpu().numpy() | (rec.pose_mask & (idx < f - scfg.window))
        prob = prob._replace(fixed_cams=run.tensor(fixed), pt_mask=run.tensor(local_pt_mask(f)))
        res = ba_solve(compact_obs(prob, int(rec.obs_mask.sum())), device=dev,
                       max_iters=cfg.ba.max_iters, pcg_iters=cfg.ba.pcg_iters,
                       huber_delta_static=cfg.ba.huber_px / float(camera.fx))
        rec.R = res.poses.R.cpu().numpy().copy()
        rec.t = res.poses.t.cpu().numpy().copy()
        rec.points = res.points.cpu().numpy().copy()
        run.stage("ba", t0)

    # ---- bootstrap (frames 0, 1): the essential matrix, no H-vs-E ----
    xy0, d0, m0 = features[0]
    xy1, d1, m1 = features[1]
    rec.pose_mask[0] = True
    valid, idx, _ = _match(run, d1, m1, d0, m0, cfg)
    q = np.where(valid)[0]
    tr = idx[q]
    x1n = normalize_np(xy1[q], camera)
    x0n = normalize_np(xy0[tr], camera)
    t0 = time.perf_counter()
    res = ransac_essential(run.tensor(x0n.astype(np.float32)), run.tensor(x1n.astype(np.float32)),
                           run.tensor(np.ones(len(q), bool)), thr=thr_n,
                           n_hyp=cfg.ransac.n_hyp, min_inliers=cfg.ransac.min_inliers,
                           generator=run.split(), device=dev)
    ok = bool(res.ok)
    run.stage("ransac_pnp", t0)
    if not ok:
        raise RuntimeError("SLAM bootstrap failed")
    rec.R[1] = res.R.cpu().numpy()
    rec.t[1] = res.t.cpu().numpy()
    rec.pose_mask[1] = True
    rec.n_frames = 2
    inl = res.inliers.cpu().numpy()[: len(q)]
    pts, keep = _triangulate_two_view(run, rec, 0, 1, x0n[inl], x1n[inl],
                                      cfg.map.min_parallax_deg)
    qi, ti = q[inl][keep], tr[inl][keep]
    ids = rec.add_points(pts[keep], d1[qi])
    rec.add_observations(0, ids, x0n[inl][keep])
    rec.add_observations(1, ids, x1n[inl][keep])
    kp_landmark[1][qi] = ids
    kp_landmark[0][ti] = ids
    pt_last_seen[ids] = 1
    # Refine the two-view seed at once (as reconstruct does): every later
    # PnP localizes against this map.
    if cfg.ba.interval:
        rec.run_ba(free_second_cam=True)
    out.odo_edges.append((1, 0, *_relative(rec.R[1], rec.t[1], rec.R[0], rec.t[0])))
    for k in (0, 1):
        bank.put(k, run.tensor(features[k][1]), run.tensor(features[k][2]))

    # ---- main loop ----
    last_kf = 1
    for f in range(2, len(features)):
        xyf, df, mf = features[f]
        df_dev, mf_dev = run.tensor(df), run.tensor(mf)
        bank.put(f, df_dev, mf_dev)
        # Track against the local map only.
        valid, idx, _ = _match(run, df, mf, rec.pt_desc, local_pt_mask(f), cfg)
        q = np.where(valid)[0]
        lm = idx[q]
        xfn = normalize_np(xyf[q], camera)
        need = max(cfg.ransac.min_inliers // 2, 6)
        ok, n_in, Rf, tf, inl = _ransac_pnp(run, rec.points[lm], xfn, thr_n,
                                            n_hyp=max(cfg.ransac.n_hyp // 2, 64),
                                            min_inliers=need)
        if not ok:
            raise RuntimeError(f"SLAM tracking lost at frame {f} ({n_in} inliers of "
                               f"{len(q)} matches, need {need})")
        prevR, prevt = rec.R[f - 1].copy(), rec.t[f - 1].copy()
        rec.R[f] = Rf
        rec.t[f] = tf
        rec.pose_mask[f] = True
        rec.n_frames = f + 1
        inl = inl[: len(q)]
        is_kf = (scfg.kf_tracked_thresh <= 0 or int(inl.sum()) < scfg.kf_tracked_thresh
                 or (f - last_kf) >= scfg.kf_max_gap)
        if is_kf:
            last_kf = f
            rec.add_observations(f, lm[inl], xfn[inl])
        # Tracking associations are recorded for every frame: the next
        # keyframe must not re-triangulate this frame's tracked keypoints.
        kp_landmark[f][q[inl]] = lm[inl]
        pt_last_seen[lm[inl]] = f
        # Odometry edge recorded at tracking time: Z = T_f T_{f-1}^-1.
        out.odo_edges.append((f, f - 1, *_relative(rec.R[f], rec.t[f], prevR, prevt)))
        if metrics:
            metrics.log("track", frame=f, n_candidates=len(q), n_inliers=int(inl.sum()),
                        keyframe=bool(is_kf), n_points=int(rec.pt_mask.sum()))

        # New landmarks against the previous frame (keyframes only).
        xyp, dp, mp = features[f - 1]
        free_prev = mp & (kp_landmark[f - 1] < 0)
        free_cur = mf.copy()
        free_cur[q[inl]] = False
        if is_kf:
            # Keypoints near any mapped landmark descriptor are
            # re-observations, not new landmarks (MapConfig.dedup_desc_d2).
            free_cur &= ~_known_in_map(run, df, free_cur, rec, cfg)
            valid2, idx2, _ = _match(run, df, free_cur, dp, free_prev, cfg)
            q2 = np.where(valid2 & (kp_landmark[f] < 0))[0]
        else:
            q2 = idx2 = np.zeros(0, np.int64)
        t2 = idx2[q2]
        if len(q2):
            xcn = normalize_np(xyf[q2], camera)
            xpn = normalize_np(xyp[t2], camera)
            pts, keep = _triangulate_two_view(run, rec, f - 1, f, xpn, xcn,
                                              cfg.map.min_parallax_deg)
            for (R_, t_), xn in (((rec.R[f - 1], rec.t[f - 1]), xpn),
                                 ((rec.R[f], rec.t[f]), xcn)):
                p = pts @ R_.T + t_
                zp = np.maximum(p[:, 2:3], 1e-9)
                keep &= np.sum((p[:, :2] / zp - xn) ** 2, -1) < thr_n
            if keep.any():
                ids = rec.add_points(pts[keep], df[q2[keep]])
                rec.add_observations(f - 1, ids, xpn[keep])
                rec.add_observations(f, ids, xcn[keep])
                kp_landmark[f][q2[keep]] = ids
                kp_landmark[f - 1][t2[keep]] = ids
                pt_last_seen[ids] = f

        # ---- loop closure: retrieval by frame votes, PnP verification ----
        closed = False
        n_old = f - scfg.loop_gap
        if n_old >= 1:
            t0 = time.perf_counter()
            votes = _loop_votes(run, Descriptors(df_dev, mf_dev), bank, n_old, cfg)
            cand = -1 if votes is None else _loop_candidate(votes, rec, scfg.loop_min_votes)
            run.stage("loop", t0)
            if cand >= 0:
                obs_of_c = rec.obs_cam[: rec.n_obs] == cand
                lm_c = np.unique(rec.obs_pt[: rec.n_obs][obs_of_c])
                lm_c = lm_c[rec.pt_mask[lm_c]]
                if len(lm_c) >= 12:
                    in_c = np.isin(np.arange(rec.pt_mask.shape[0]), lm_c) & rec.pt_mask
                    v4, i4, _ = _match(run, df, mf, rec.pt_desc, in_c, cfg)
                    q4 = np.where(v4)[0]
                    if len(q4) >= 12:
                        ok, n_in, Rl, tl, _ = _ransac_pnp(
                            run, rec.points[i4[q4]], normalize_np(xyf[q4], camera), thr_n,
                            n_hyp=256, min_inliers=10)
                        if ok:
                            out.loop_edges.append(
                                (f, cand, *_relative(Rl, tl, rec.R[cand], rec.t[cand])))
                            if metrics:
                                metrics.log("loop_closure", frame=f, candidate=cand,
                                            inliers=n_in)
                            _run_pgo_and_refine(rec, out, f, scfg, cfg, camera)
                            closed = True
        if cfg.ba.interval and (f % cfg.ba.interval == 0) and not closed:
            run_local_ba(f)

    rec.run_ba()
    return out


def _run_pgo_and_refine(rec: Reconstruction, out: SlamResult, f, scfg: SlamConfig, cfg,
                        camera):
    """Build the pose graph from the recorded odometry and loop edges (loop
    edges weigh 2), solve it on the map's device, write the poses back, then
    bundle-adjust globally."""
    t0 = time.perf_counter()
    edges = [(e, 1.0) for e in out.odo_edges] + [(e, 2.0) for e in out.loop_edges]
    fixed = np.zeros(rec.pose_mask.shape[0], bool)
    fixed[0] = True

    def tens(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(rec.device)
        return t if dtype is None else t.to(dtype)

    g = PoseGraph(
        poses=SE3(tens(rec.R), tens(rec.t)),
        edge_i=tens(np.array([e[0] for e, _ in edges], np.int64)),
        edge_j=tens(np.array([e[1] for e, _ in edges], np.int64)),
        Z=SE3(tens(np.stack([e[2] for e, _ in edges]), torch.float32),
              tens(np.stack([e[3] for e, _ in edges]), torch.float32)),
        edge_weight=tens(np.array([w for _, w in edges], np.float32)),
        pose_mask=tens(rec.pose_mask),
        fixed=tens(fixed & rec.pose_mask),
    )
    res = pgo_solve(g, max_iters=scfg.pgo_iters, huber_delta_static=scfg.loop_kernel_delta,
                    kernel="geman", device=rec.device)
    rec.R = res.poses.R.cpu().numpy().copy()
    rec.t = res.poses.t.cpu().numpy().copy()
    out.pgo_runs += 1
    rec.stage_seconds["pgo"] += time.perf_counter() - t0
    rec.run_ba()
