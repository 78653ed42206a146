"""Incremental SfM pipeline (BASELINE.json config 3) on PyTorch.

Port of ``fastmatch_tpu/pipeline/reconstruct.py``: a host-side orchestrator
owns a fixed-capacity map (numpy bookkeeping) and dispatches the heavy
stages to the device: detection (``features/``), matching (the K2 kernel),
RANSAC pose (``geometry/``) and Schur-reduced LM refinement (``ba/``, the K4
kernel).

Flow per sequence:
  frame 0      : detect, anchor pose = identity
  frame 1      : match vs frame 0 -> H-vs-E model selection -> triangulate
                 (scale gauge: |t| = 1) -> BA with camera 1 free
  frame f >= 2 : match vs the landmark descriptor bank -> RANSAC PnP ->
                 new-landmark triangulation vs frame f-1 (parallax-gated)
  every N      : bundle-adjust all live cameras/points (first two fixed)

Randomness: where the JAX package splits a ``PRNGKey`` the port draws a
fresh ``torch.Generator`` (on the run's device) from one CPU generator
seeded with ``seed``; the two packages' draws differ, so only the
statistics of a run are comparable, not its bits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from fastmatch_tpu_torch.ba.lm import ba_solve
from fastmatch_tpu_torch.ba.problem import BAProblem, Observations
from fastmatch_tpu_torch.core.camera import Pinhole, normalize_np
from fastmatch_tpu_torch.core.containers import Descriptors
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.features.sift import detect_and_describe
from fastmatch_tpu_torch.core.lie import SE3
from fastmatch_tpu_torch.geometry.homography import select_two_view_model
from fastmatch_tpu_torch.geometry.pnp import ransac_pnp
from fastmatch_tpu_torch.geometry.ransac import ransac_essential
from fastmatch_tpu_torch.geometry.triangulation import triangulate_dlt
from fastmatch_tpu_torch.matching.matcher import match_pair
from fastmatch_tpu_torch.pipeline.config import PipelineConfig
from fastmatch_tpu_torch.pipeline.tracker import compact_obs

# "loop" (loop retrieval) and "pgo" (pose-graph solves) are SLAM's stages.
STAGES = ("sift", "match", "ransac_pnp", "triangulate", "ba", "loop", "pgo")


@dataclass
class Reconstruction:
    """Host-side map state + trajectory output. ``stage_seconds`` holds the
    host wall time spent in each of ``STAGES``; every stage ends in a
    readback to the host, so the device work is inside its stage's time."""

    cfg: PipelineConfig
    camera: Pinhole
    device: torch.device = torch.device("cpu")
    R: np.ndarray = None          # (F_cap, 3, 3) world->cam
    t: np.ndarray = None          # (F_cap, 3)
    pose_mask: np.ndarray = None  # (F_cap,)
    points: np.ndarray = None     # (P_cap, 3)
    pt_mask: np.ndarray = None
    pt_desc: np.ndarray = None    # (P_cap, desc_dim) landmark descriptor bank
    obs_cam: np.ndarray = None
    obs_pt: np.ndarray = None
    obs_uv: np.ndarray = None
    obs_mask: np.ndarray = None
    n_frames: int = 0
    n_points: int = 0
    n_obs: int = 0
    frame_stats: list = field(default_factory=list)
    stage_seconds: dict = field(default_factory=lambda: dict.fromkeys(STAGES, 0.0))

    def __post_init__(self):
        m = self.cfg.map
        self.R = np.tile(np.eye(3, dtype=np.float32), (m.max_frames, 1, 1))
        self.t = np.zeros((m.max_frames, 3), np.float32)
        self.pose_mask = np.zeros(m.max_frames, bool)
        self.points = np.zeros((m.max_points, 3), np.float32)
        self.pt_mask = np.zeros(m.max_points, bool)
        self.pt_desc = np.zeros((m.max_points, m.desc_dim), np.float32)
        self.obs_cam = np.zeros(m.max_obs, np.int32)
        self.obs_pt = np.zeros(m.max_obs, np.int32)
        self.obs_uv = np.zeros((m.max_obs, 2), np.float32)
        self.obs_mask = np.zeros(m.max_obs, bool)

    # -- helpers ----------------------------------------------------------
    def camera_centers(self) -> np.ndarray:
        live = self.pose_mask
        return -np.einsum("fji,fj->fi", self.R[live], self.t[live])

    def add_observations(self, cam: int, pt_ids: np.ndarray, uv: np.ndarray):
        k = len(pt_ids)
        if k == 0:
            return
        s = self.n_obs
        if s + k > self.obs_mask.shape[0]:
            raise RuntimeError("observation capacity exceeded")
        self.obs_cam[s:s + k] = cam
        self.obs_pt[s:s + k] = pt_ids
        self.obs_uv[s:s + k] = uv
        self.obs_mask[s:s + k] = True
        self.n_obs += k

    def add_points(self, xyz: np.ndarray, desc: np.ndarray) -> np.ndarray:
        k = xyz.shape[0]
        s = self.n_points
        if s + k > self.pt_mask.shape[0]:
            raise RuntimeError("point capacity exceeded")
        ids = np.arange(s, s + k, dtype=np.int32)
        self.points[ids] = xyz
        self.pt_desc[ids] = desc
        self.pt_mask[ids] = True
        self.n_points += k
        return ids

    def ba_problem(self) -> BAProblem:
        fixed = np.zeros_like(self.pose_mask)
        fixed[:2] = True

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return BAProblem(
            poses=SE3(dev(self.R), dev(self.t)),
            points=dev(self.points),
            obs=Observations(dev(self.obs_cam), dev(self.obs_pt), dev(self.obs_uv),
                             dev(self.obs_mask)),
            cam_mask=dev(self.pose_mask),
            pt_mask=dev(self.pt_mask),
            fixed_cams=dev(fixed & self.pose_mask),
        )

    def run_ba(self, free_second_cam: bool = False):
        """Global BA; returns (cost0, cost). ``free_second_cam`` is for the
        two-view seed refit: camera 0 alone fixes the frame, camera 1 moves,
        and |t1| is renormalized to 1 afterwards (the JAX package measured
        that a frozen bootstrap pose starves frame-2 PnP on planar scenes)."""
        t0 = time.perf_counter()
        cfg = self.cfg.ba
        thr = cfg.huber_px / float(self.camera.fx)
        prob = self.ba_problem()
        if free_second_cam:
            fixed = np.zeros_like(self.pose_mask)
            fixed[:1] = True
            prob = prob._replace(
                fixed_cams=torch.from_numpy(fixed & self.pose_mask).to(self.device))
        # Compact the observation table to exactly its live rows: BA cost
        # scales with the table size. The JAX package pads to a power-of-two
        # bucket to bound its compiles; eager PyTorch has no per-shape
        # compile, and dead rows (keyed to point 0 and camera 0) would form
        # one long segment that K4 sums serially.
        prob = compact_obs(prob, int(self.obs_mask.sum()))
        res = ba_solve(prob, device=self.device, max_iters=cfg.max_iters,
                       pcg_iters=cfg.pcg_iters, huber_delta_static=thr)
        self.R = res.poses.R.cpu().numpy().copy()
        self.t = res.poses.t.cpu().numpy().copy()
        self.points = res.points.cpu().numpy().copy()
        if free_second_cam:
            # Restore the monocular scale gauge |t1| = 1.
            s = float(np.linalg.norm(self.t[1]))
            if s > 1e-9:
                self.t[self.pose_mask] /= s
                self.points[self.pt_mask] /= s
        self.stage_seconds["ba"] += time.perf_counter() - t0
        return float(res.cost0), float(res.cost)


class _Run:
    """Per-run context: device, generators and stage clocks."""

    def __init__(self, rec: Reconstruction, seed: int):
        self.rec = rec
        self.device = rec.device
        self._master = torch.Generator().manual_seed(seed)

    def split(self) -> torch.Generator:
        """A fresh generator on the run's device (the JAX package's
        ``jax.random.split``)."""
        s = int(torch.randint(0, 2 ** 62, (1,), generator=self._master))
        return torch.Generator(self.device).manual_seed(s)

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def stage(self, name: str, t0: float):
        self.rec.stage_seconds[name] += time.perf_counter() - t0


def _match(run: _Run, desc_a, mask_a, desc_b, mask_b, cfg, ratio=None,
           cross_check=None):
    t0 = time.perf_counter()
    m = match_pair(
        Descriptors(run.tensor(desc_a), run.tensor(mask_a)),
        Descriptors(run.tensor(desc_b), run.tensor(mask_b)),
        ratio=cfg.matching.ratio if ratio is None else ratio,
        cross_check=cfg.matching.cross_check if cross_check is None else cross_check,
        backend=cfg.matching.backend,
        precision=cfg.matching.precision,
        device=run.device,
    )
    valid, idx, dist = (m.valid.cpu().numpy(), m.idx.cpu().numpy(),
                        m.dist.cpu().numpy())
    run.stage("match", t0)
    return valid, idx, dist


def _known_in_map(run: _Run, desc, mask, rec, cfg) -> np.ndarray:
    """Keypoints whose nearest map descriptor is within dedup_desc_d2:
    re-observations of existing landmarks (must not be re-triangulated)."""
    if not rec.pt_mask.any():
        return np.zeros_like(mask)
    valid, _, dist = _match(run, desc, mask, rec.pt_desc, rec.pt_mask, cfg,
                            ratio=1.0, cross_check=False)
    return valid & (dist < cfg.map.dedup_desc_d2)


# The JAX package pads RANSAC inputs to a multiple of 256 on the TPU because
# every new shape costs an XLA compile there. PyTorch runs eagerly, with no
# per-shape compile, so the port hands RANSAC, PnP and triangulation the live
# correspondences and nothing else, with an all-True mask. RANSAC never sees
# a full-capacity mask (the JAX package recorded a 54-degree-off bootstrap
# from that).
def _ransac_pnp(run: _Run, X, x, thr_n, n_hyp, min_inliers):
    t0 = time.perf_counter()
    pn = ransac_pnp(run.tensor(X.astype(np.float32)), run.tensor(x.astype(np.float32)),
                    run.tensor(np.ones(len(X), bool)), thr=thr_n,
                    n_hyp=n_hyp, min_inliers=min_inliers, generator=run.split(),
                    device=run.device)
    out = (bool(pn.ok), int(pn.n_inliers), pn.pose.R.cpu().numpy(),
           pn.pose.t.cpu().numpy(), pn.inliers.cpu().numpy())
    run.stage("ransac_pnp", t0)
    return out


def _triangulate(run: _Run, R, t, x, mask=None):
    t0 = time.perf_counter()
    pts, ok = triangulate_dlt(run.tensor(R), run.tensor(t), run.tensor(x),
                              None if mask is None else run.tensor(mask))
    out = pts.cpu().numpy().copy(), ok.cpu().numpy().copy()
    run.stage("triangulate", t0)
    return out


def _disambiguate_planar_bootstrap(run: _Run, R_cands, inl, x0n, x1n, seed_desc,
                                   features, camera, cfg, thr_n):
    """Resolve the planar two-fold ambiguity with the third view: triangulate
    the seed map under both (R, t) candidates and keep the one whose map
    frame 2 localizes against with more PnP inliers. Returns (R, t)."""
    xy2, d2, m2 = features[2]
    best, best_count = R_cands[0], -1
    for Rc, tc in R_cands:
        R = np.stack([np.eye(3, dtype=np.float32), Rc.astype(np.float32)])
        t = np.stack([np.zeros(3, np.float32), tc.astype(np.float32)])
        x = np.stack([x0n[inl], x1n[inl]]).astype(np.float32)
        pts, okn = _triangulate(run, R, t, x)
        valid, idx, _ = _match(run, d2, m2, seed_desc[inl], okn, cfg)
        q = np.where(valid)[0]
        count = 0
        if len(q) >= 6:
            ok, n_in, *_ = _ransac_pnp(run, pts[idx[q]], normalize_np(xy2[q], camera),
                                       thr_n, n_hyp=128, min_inliers=6)
            count = n_in if ok else 0
        if count > best_count:
            best, best_count = (Rc, tc), count
    return best


def _triangulate_two_view(run: _Run, rec, f1, f2, uv1, uv2, min_parallax_deg):
    """Triangulate normalized correspondences seen by frames f1, f2; returns
    (points (K, 3), keep (K,) bool) with cheirality + parallax gates."""
    R = np.stack([rec.R[f1], rec.R[f2]])
    t = np.stack([rec.t[f1], rec.t[f2]])
    pts, ok = _triangulate(run, R, t, np.stack([uv1, uv2]).astype(np.float32))
    for R_, t_ in ((rec.R[f1], rec.t[f1]), (rec.R[f2], rec.t[f2])):
        z = (pts @ R_.T + t_)[:, 2]
        ok &= z > 1e-3
    c1 = -rec.R[f1].T @ rec.t[f1]
    c2 = -rec.R[f2].T @ rec.t[f2]
    r1 = pts - c1
    r2 = pts - c2
    cosang = np.sum(r1 * r2, -1) / np.maximum(
        np.linalg.norm(r1, axis=-1) * np.linalg.norm(r2, axis=-1), 1e-12)
    ok &= np.degrees(np.arccos(np.clip(cosang, -1, 1))) > min_parallax_deg
    return pts, ok


def detect_features(images, cfg: PipelineConfig, device=None, stage_seconds=None):
    """Per-frame (xy (N, 2), desc (N, 128), mask (N,)) numpy features from
    (H, W) [0, 1] images through ``detect_and_describe`` on ``device``."""
    dev = resolve_device(device)
    features = []
    for img in images:
        t0 = time.perf_counter()
        kps, descs = detect_and_describe(img, cfg.sift, device=dev)
        features.append((kps.xy.cpu().numpy(), descs.data.cpu().numpy(),
                         descs.mask.cpu().numpy()))
        if stage_seconds is not None:
            stage_seconds["sift"] += time.perf_counter() - t0
    return features


def reconstruct(features, camera: Pinhole, cfg: PipelineConfig = PipelineConfig(),
                images=None, seed: int = 0, device=None, metrics=None) -> Reconstruction:
    """Run incremental SfM over a sequence on ``device`` (``cuda`` unless
    ``device="cpu"``).

    features: list of (xy_px (N, 2) f32, desc (N, 128) f32, mask (N,) bool)
    per frame, or None with ``images`` given: detection then runs here
    through ``detect_and_describe``. metrics: optional
    ``utils.metrics.MetricsLogger``, given the JAX package's events: a
    "frame" event per frame from 2 on, and a "ba" event (cost0, cost) per
    bundle adjustment of the loop and at the end (``final=True``).
    """
    dev = resolve_device(device)
    rec = Reconstruction(cfg=cfg, camera=camera, device=dev)
    if features is None:
        features = detect_features(images, cfg, dev, rec.stage_seconds)
    run = _Run(rec, seed)
    thr_n = (cfg.ransac.thr_px / float(camera.fx)) ** 2
    # Per-frame: landmark id per keypoint slot (-1 = none).
    kp_landmark = [np.full(f[0].shape[0], -1, np.int64) for f in features]

    # ---- frame 0 ----
    rec.pose_mask[0] = True
    rec.n_frames = 1
    rec.frame_stats.append({"frame": 0, "n_kp": int(features[0][2].sum())})

    # ---- frame 1: two-view bootstrap ----
    xy0, d0, m0 = features[0]
    xy1, d1, m1 = features[1]
    valid, idx, _ = _match(run, d1, m1, d0, m0, cfg)
    q = np.where(valid)[0]          # keypoints in frame 1
    need = max(8, cfg.ransac.min_inliers)
    if len(q) < need:
        raise RuntimeError(
            f"two-view bootstrap failed: only {len(q)} matches between "
            f"frames 0 and 1 (need >= {need})")
    tr = idx[q]                      # matched keypoints in frame 0
    x1n = normalize_np(xy1[q], camera)
    x0n = normalize_np(xy0[tr], camera)
    t0 = time.perf_counter()
    args = (run.tensor(x0n.astype(np.float32)), run.tensor(x1n.astype(np.float32)),
            run.tensor(np.ones(len(q), bool)))
    kw = dict(thr=thr_n, n_hyp=cfg.ransac.n_hyp, min_inliers=cfg.ransac.min_inliers,
              generator=run.split(), device=dev)
    if cfg.ransac.model_select:
        # H-vs-E selection: a planar scene (or near-pure rotation) leaves the
        # essential solve degenerate while its inlier count stays high.
        res = select_two_view_model(*args, **kw)
        bootstrap_used_h = bool(res.used_homography)
        ambiguous = bool(res.ambiguous)
    else:
        res = ransac_essential(*args, **kw)
        bootstrap_used_h = ambiguous = False
    ok = bool(res.ok)
    R1, t1 = res.R.cpu().numpy(), res.t.cpu().numpy()
    inl = res.inliers.cpu().numpy()
    run.stage("ransac_pnp", t0)
    if not ok:
        raise RuntimeError("two-view bootstrap failed")
    if bootstrap_used_h and ambiguous and len(features) > 2:
        cands = ((R1, t1), (res.R_alt.cpu().numpy(), res.t_alt.cpu().numpy()))
        R1, t1 = _disambiguate_planar_bootstrap(run, cands, inl, x0n, x1n, d1[q],
                                                features, camera, cfg, thr_n)
    rec.R[1] = R1
    rec.t[1] = t1
    rec.pose_mask[1] = True
    rec.n_frames = 2
    pts, keep = _triangulate_two_view(run, rec, 0, 1, x0n[inl], x1n[inl],
                                      cfg.map.min_parallax_deg)
    qi = q[inl][keep]
    ti = tr[inl][keep]
    ids = rec.add_points(pts[keep], d1[qi])
    rec.add_observations(0, ids, x0n[inl][keep])
    rec.add_observations(1, ids, x1n[inl][keep])
    kp_landmark[1][qi] = ids
    kp_landmark[0][ti] = ids
    rec.frame_stats.append({"frame": 1, "n_kp": int(m1.sum()), "n_new_pts": len(ids),
                            "bootstrap_homography": bootstrap_used_h})
    # Refine the two-view seed immediately, camera 1 free (see run_ba).
    if cfg.ba.interval:
        rec.run_ba(free_second_cam=True)

    # ---- frames >= 2 ----
    for f in range(2, len(features)):
        xyf, df, mf = features[f]
        # 2D-3D: match against the landmark descriptor bank.
        valid, idx, _ = _match(run, df, mf, rec.pt_desc, rec.pt_mask, cfg)
        q = np.where(valid)[0]
        lm = idx[q]
        xfn = normalize_np(xyf[q], camera)
        ok, _, Rf, tf, inl = _ransac_pnp(
            run, rec.points[lm], xfn, thr_n, n_hyp=max(cfg.ransac.n_hyp // 2, 64),
            min_inliers=max(cfg.ransac.min_inliers // 2, 6))
        if not ok:
            raise RuntimeError(f"PnP failed at frame {f} ({len(q)} candidates)")
        rec.R[f] = Rf
        rec.t[f] = tf
        rec.pose_mask[f] = True
        rec.n_frames = f + 1
        rec.add_observations(f, lm[inl], xfn[inl])
        kp_landmark[f][q[inl]] = lm[inl]
        # Refresh the bank: a landmark's descriptor tracks its most recent
        # PnP-inlier observation.
        rec.pt_desc[lm[inl]] = df[q[inl]]

        # New landmarks: match vs the previous frame's landmark-free keypoints.
        xyp, dp, mp = features[f - 1]
        free_prev = mp & (kp_landmark[f - 1] < 0)
        free_cur = mf.copy()
        free_cur[q[inl]] = False
        free_cur &= ~_known_in_map(run, df, free_cur, rec, cfg)
        valid2, idx2, _ = _match(run, df, free_cur, dp, free_prev, cfg)
        q2 = np.where(valid2 & (kp_landmark[f] < 0))[0]
        t2 = idx2[q2]
        if len(q2):
            xcn = normalize_np(xyf[q2], camera)
            xpn = normalize_np(xyp[t2], camera)
            pts, keep = _triangulate_two_view(run, rec, f - 1, f, xpn, xcn,
                                              cfg.map.min_parallax_deg)
            # Reprojection gate on both views.
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
        stats = {"frame": f, "n_kp": int(mf.sum()), "n_pnp_inliers": int(inl.sum()),
                 "n_new_pts": int(keep.sum()) if len(q2) else 0}
        rec.frame_stats.append(stats)
        if metrics:
            metrics.log("frame", **stats, n_points=int(rec.pt_mask.sum()))
        if cfg.ba.interval and (f % cfg.ba.interval == 0):
            c0, c1 = rec.run_ba()
            if metrics:
                metrics.log("ba", frame=f, cost0=c0, cost=c1)

    c0, c1 = rec.run_ba()
    if metrics:
        metrics.log("ba", frame=len(features) - 1, cost0=c0, cost=c1, final=True)
    return rec
