"""Device-resident SLAM driver: ``slam`` semantics at one ``track_step`` and
one readback a frame.

Port of ``fastmatch_tpu/pipeline/slam_device.py``. The map stays on the
device for the whole sequence (``pipeline/tracker.TrackState``); per frame
the host issues one ``track_step`` and reads its ``TrackInfo`` back in one
transfer. Everything episodic happens only when that readback says so:

- PnP failure: the same step re-runs on the same frame with
  ``FULL_WINDOW`` (relocalization); tracking is lost only after
  ``reloc_max_failures`` consecutive frames fail that too.
- Loop votes over the threshold: ``loop_verify`` checks the candidate
  geometrically; on success the pose graph is solved (``posegraph/pgo.py``,
  edge lists built on the host) and the corrected poses go back into the
  device state, followed by a full-window BA.
- Every ``ba.interval`` frames: a local BA directly on the device state
  (``ba_problem_from_state``, compacted by ``compact_obs_local``).

``SlamHooks`` keeps the JAX package's three injection points (retrieval
prefetch, BA, after-frame), for the distributed pipeline and checkpoints,
and adds a fourth, ``final_ba``, for the run's last solve (see below).
Randomness is a pure function of (seed, frame, purpose)
(``tracker.frame_generator``), so ``resume=`` continues bit for bit and
the scan engines draw what this one draws.

One difference from the JAX package: the run ends with
``SlamHooks.final_ba``, which by default is ``_final_ba``, the scan
engines' final solve (every camera but the gauge pair and every point
free, the observation table compacted to its live rows, the full
``BAConfig`` budgets), where the JAX driver ends with a ``SlamHooks.ba``
solve over the full window at the interval budgets. So with loop closure
off the port's device and scan engines end with the same solve. A hooks
class that replaces ``ba`` (a sharded solve) replaces ``final_ba`` too.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from fastmatch_tpu_torch.ba.lm import ba_solve
from fastmatch_tpu_torch.core.camera import Pinhole, normalize_np
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.core.lie import SE3
from fastmatch_tpu_torch.geometry.ransac import ransac_essential
from fastmatch_tpu_torch.pipeline.config import PipelineConfig
from fastmatch_tpu_torch.pipeline.reconstruct import (
    Reconstruction, _match, _Run, _triangulate_two_view)
from fastmatch_tpu_torch.pipeline.slam import SlamConfig, SlamResult
from fastmatch_tpu_torch.pipeline.tracker import (
    DESC_DIM,
    FULL_WINDOW,
    TrackerStatic,
    TrackState,
    ba_problem_from_state,
    compact_obs,
    compact_obs_local,
    frame_generator,
    init_state,
    loop_verify,
    normalize_points,
    read_info,
    track_step,
)
from fastmatch_tpu_torch.posegraph.pgo import PoseGraph, pgo_solve

# Host wall time of each engine's stages (``Reconstruction.stage_seconds``
# of the result): every stage ends in a readback, so its device work is
# inside its time.
STAGES = ("bootstrap", "track", "loop", "pgo", "ba")


class _Clock:
    def __init__(self):
        self.seconds = dict.fromkeys(STAGES, 0.0)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        yield
        self.seconds[stage] += time.perf_counter() - t0


def _local_ba(state: TrackState, fid, window, cfg: PipelineConfig, huber: float,
              covis=None, covis_thresh: int = 0) -> TrackState:
    """The interval (and post-closure) BA of both engines: the local
    selection compacted to ``ba.local_obs_cap`` rows, the interval budgets."""
    prob = ba_problem_from_state(state, fid, window, covis=covis, covis_thresh=covis_thresh)
    if cfg.ba.local_obs_cap > 0:
        prob = compact_obs_local(prob, cfg.ba.local_obs_cap)
    res = ba_solve(prob, device=state.R.device,
                   max_iters=cfg.ba.interval_max_iters or cfg.ba.max_iters,
                   pcg_iters=cfg.ba.interval_pcg_iters or cfg.ba.pcg_iters,
                   huber_delta_static=huber)
    return state._replace(R=res.poses.R, t=res.poses.t, points=res.points)


def _final_ba(state: TrackState, cfg: PipelineConfig, huber: float) -> TrackState:
    """Global BA at the end of a run (and after a chunked closure): the
    gauge pair fixed, the table compacted to its live rows (one readback
    of the count; the JAX package pads to ``obs_bucket``), full budgets."""
    prob = ba_problem_from_state(state, state.n_frames, FULL_WINDOW)
    prob = compact_obs(prob, int(state.n_obs))
    res = ba_solve(prob, device=state.R.device, max_iters=cfg.ba.max_iters,
                   pcg_iters=cfg.ba.pcg_iters, huber_delta_static=huber)
    return state._replace(R=res.poses.R, t=res.poses.t, points=res.points)


class SlamHooks:
    """Stage-injection points of the driver loop."""

    def retrieval(self, state: TrackState, desc, mask):
        """The full-bank nearest-landmark match for the NEXT frame,
        dispatched early so that it overlaps this frame's BA; None computes
        it inside ``track_step`` (the single-device fused path)."""
        return None

    def ba(self, state: TrackState, fid, window, cfg, camera,
           covis=None, covis_thresh: int = 0) -> TrackState:
        return _local_ba(state, fid, window, cfg, cfg.ba.huber_px / float(camera.fx),
                         covis, covis_thresh)

    def final_ba(self, state: TrackState, cfg, camera) -> TrackState:
        """The run's last solve, after the last frame (``_final_ba``)."""
        return _final_ba(state, cfg, cfg.ba.huber_px / float(camera.fx))

    def after_frame(self, state: TrackState, fid: int, fi: int, out, book):
        """Called after each accepted frame with the driver's bookkeeping
        dict (the checkpoint hook)."""


def _static_from_cfg(cfg: PipelineConfig, scfg: SlamConfig, cap: int,
                     camera=None) -> TrackerStatic:
    return TrackerStatic(
        cam_model=getattr(camera, "model", "pinhole"),
        cap=cap,
        max_frames=cfg.map.max_frames,
        max_points=cfg.map.max_points,
        max_obs=cfg.map.max_obs,
        ratio=cfg.matching.ratio,
        cross_check=cfg.matching.cross_check,
        backend=cfg.matching.backend,
        precision=cfg.matching.precision,
        n_hyp=max(cfg.ransac.n_hyp // 2, 64),
        min_inliers=max(cfg.ransac.min_inliers // 2, 6),
        min_parallax_deg=cfg.map.min_parallax_deg,
        dedup_desc_d2=cfg.map.dedup_desc_d2,
        loop_gap=scfg.loop_gap,
        kf_tracked_thresh=scfg.kf_tracked_thresh,
        kf_max_gap=scfg.kf_max_gap,
    )


def _capacity(features) -> int:
    """The tracker's keypoint capacity: the largest frame's, rounded up to
    a power of two."""
    cap = max(int(f[0].shape[0]) for f in features)
    return 1 << (cap - 1).bit_length()


def _pad_frame(xy, desc, mask, cap):
    n = xy.shape[0]
    if n == cap:
        return (np.asarray(xy, np.float32), np.asarray(desc, np.float32),
                np.asarray(mask, bool))
    if n > cap:
        raise ValueError(f"frame has {n} keypoint slots > tracker cap {cap}")
    pxy = np.zeros((cap, 2), np.float32)
    pxy[:n] = xy
    pd = np.zeros((cap, DESC_DIM), np.float32)
    pd[:n] = desc
    pm = np.zeros(cap, bool)
    pm[:n] = mask
    return pxy, pd, pm


def _upload(arrays, device):
    """Float32 and bool numpy arrays on ``device`` in one host-to-device
    copy: each copy from host memory synchronizes with the card."""
    flat = np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])
    buf = torch.from_numpy(flat).to(device)
    out = []
    for a, t in zip(arrays, buf.split([a.size for a in arrays])):
        t = t.view(a.shape)
        out.append(t > 0.5 if a.dtype == bool else t)
    return tuple(out)


def _bootstrap_host(features, camera, cfg, scfg, generator, device):
    """Two-view bootstrap of frames 0 and 1 on the host map (runs once):
    the essential matrix from the live matches, triangulation, and the
    seed BA with camera 1 free. Returns (Reconstruction, frame 1's
    keypoint -> landmark ids)."""
    rec = Reconstruction(cfg=cfg, camera=camera, device=device)
    run = _Run(rec, 0)
    thr_n = (cfg.ransac.thr_px / float(camera.fx)) ** 2
    xy0, d0, m0 = features[0]
    xy1, d1, m1 = features[1]
    rec.pose_mask[0] = True
    valid, idx, _ = _match(run, d1, m1, d0, m0, cfg)
    q = np.where(valid)[0]
    tr = idx[q]
    x1n = normalize_np(xy1[q], camera)
    x0n = normalize_np(xy0[tr], camera)
    res = ransac_essential(run.tensor(x0n.astype(np.float32)), run.tensor(x1n.astype(np.float32)),
                           run.tensor(np.ones(len(q), bool)), thr=thr_n,
                           n_hyp=cfg.ransac.n_hyp, min_inliers=cfg.ransac.min_inliers,
                           generator=generator, device=device)
    if not bool(res.ok):
        raise RuntimeError("SLAM bootstrap failed")
    rec.R[1] = res.R.cpu().numpy()
    rec.t[1] = res.t.cpu().numpy()
    rec.pose_mask[1] = True
    rec.n_frames = 2
    inl = res.inliers.cpu().numpy()[: len(q)]
    pts, keep = _triangulate_two_view(run, rec, 0, 1, x0n[inl], x1n[inl],
                                      cfg.map.min_parallax_deg)
    qi = q[inl][keep]
    ids = rec.add_points(pts[keep], d1[qi])
    rec.add_observations(0, ids, x0n[inl][keep])
    rec.add_observations(1, ids, x1n[inl][keep])
    if cfg.ba.interval:
        rec.run_ba(free_second_cam=True)
    kp_lm1 = np.full(features[1][0].shape[0], -1, np.int64)
    kp_lm1[qi] = ids
    return rec, kp_lm1


def _state_from_bootstrap(rec, features, kp_lm1, camera, tcfg: TrackerStatic,
                          device) -> TrackState:
    """The device state of the bootstrap map: its live prefix copied into
    ``init_state``'s empty tensors, frame 1 as the previous-frame context."""
    st = init_state(tcfg, camera, device)
    xy1, d1, m1 = _upload(_pad_frame(*features[1], tcfg.cap), device)
    lm1 = np.full(tcfg.cap, -1, np.int32)
    lm1[: kp_lm1.shape[0]] = kp_lm1
    nP, nO = rec.n_points, rec.n_obs

    def prefix(dst, src, n):
        out = dst.clone()
        out[:n] = torch.from_numpy(np.ascontiguousarray(src[:n])).to(device=device,
                                                                       dtype=dst.dtype)
        return out

    def scalar(v):
        return torch.full((), v, dtype=torch.int32, device=device)

    return st._replace(
        R=prefix(st.R, rec.R, rec.R.shape[0]), t=prefix(st.t, rec.t, rec.t.shape[0]),
        pose_mask=prefix(st.pose_mask, rec.pose_mask, rec.pose_mask.shape[0]),
        points=prefix(st.points, rec.points, nP),
        pt_mask=prefix(st.pt_mask, rec.pt_mask, nP),
        pt_desc=prefix(st.pt_desc, rec.pt_desc, nP),
        pt_last_seen=prefix(st.pt_last_seen, np.ones(nP, np.int32), nP),
        obs_cam=prefix(st.obs_cam, rec.obs_cam, nO),
        obs_pt=prefix(st.obs_pt, rec.obs_pt, nO),
        obs_uv=prefix(st.obs_uv, rec.obs_uv, nO),
        obs_mask=prefix(st.obs_mask, rec.obs_mask, nO),
        n_frames=scalar(2), n_points=scalar(nP), n_obs=scalar(nO), last_kf=scalar(1),
        prev_f=scalar(1), prev_xn=normalize_points(xy1, st.cam, tcfg.cam_model),
        prev_desc=d1, prev_mask=m1, prev_lm=torch.from_numpy(lm1).to(device),
    )


def _rec_from_state(state: TrackState, cfg, camera) -> Reconstruction:
    """The device map as a host Reconstruction."""
    rec = Reconstruction(cfg=cfg, camera=camera, device=state.R.device)
    for name in ("R", "t", "pose_mask", "points", "pt_mask", "pt_desc", "obs_cam", "obs_pt",
                 "obs_uv", "obs_mask"):
        setattr(rec, name, getattr(state, name).cpu().numpy().copy())
    rec.n_frames, rec.n_points, rec.n_obs = (
        torch.stack([state.n_frames, state.n_points, state.n_obs]).tolist())
    return rec


def _run_pgo(state: TrackState, odo_edges, loop_edges, scfg: SlamConfig) -> TrackState:
    """Pose-graph correction from the odometry and loop edges (loop edges
    weigh 2); returns the state with the corrected poses."""
    dev = state.R.device
    edges = [(e, 1.0) for e in odo_edges] + [(e, 2.0) for e in loop_edges]

    def tens(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(device=dev, dtype=dtype)

    fixed = torch.zeros_like(state.pose_mask)
    fixed[0] = True
    g = PoseGraph(
        poses=SE3(state.R, state.t),
        edge_i=tens([e[0] for e, _ in edges], torch.int64),
        edge_j=tens([e[1] for e, _ in edges], torch.int64),
        Z=SE3(tens(np.stack([e[2] for e, _ in edges]), torch.float32),
              tens(np.stack([e[3] for e, _ in edges]), torch.float32)),
        edge_weight=tens([w for _, w in edges], torch.float32),
        pose_mask=state.pose_mask,
        fixed=fixed & state.pose_mask,
    )
    res = pgo_solve(g, max_iters=scfg.pgo_iters, huber_delta_static=scfg.loop_kernel_delta,
                    kernel="geman", device=dev)
    return state._replace(R=res.poses.R, t=res.poses.t)


def _verified_edge(state: TrackState, pl, cand: int):
    """(ok, n_inliers, Z R, Z t) of a loop verification in one readback:
    Z = T_loop T_cand^-1."""
    Zl = pl.pose.compose(SE3(state.R[cand], state.t[cand]).inverse())
    v = torch.cat([pl.ok.reshape(1).double(), pl.n_inliers.reshape(1).double(),
                   Zl.R.reshape(-1).double(), Zl.t.double()]).cpu().numpy()
    return bool(v[0]), int(v[1]), v[2:11].reshape(3, 3).astype(np.float32), \
        v[11:14].astype(np.float32)


def _pose_of(state: TrackState, fid: int):
    """(R, t) of frame ``fid`` as float32 numpy, in one readback."""
    v = torch.cat([state.R[fid].reshape(-1), state.t[fid]]).cpu().numpy()
    return v[:9].reshape(3, 3).copy(), v[9:].copy()


def drive_slam(
    features: list,
    camera: Pinhole,
    cfg: PipelineConfig = PipelineConfig(),
    scfg: SlamConfig = SlamConfig(),
    seed: int = 0,
    metrics=None,
    reloc_max_failures: int = 3,
    hooks: SlamHooks | None = None,
    resume=None,
    device=None,
) -> SlamResult:
    """The driver loop of ``slam_device`` (see the module docstring) on
    ``device`` (``cuda`` unless ``device="cpu"``). ``resume``: a (state,
    book, out) triple to continue from the recorded sequence position;
    per-frame draws depend on (seed, frame) alone, so the continuation is
    bit-identical with the uninterrupted run."""
    dev = resolve_device(device)
    hooks = hooks or SlamHooks()
    clock = _Clock()
    cap = _capacity(features)
    tcfg = _static_from_cfg(cfg, scfg, cap, camera)
    thr_n = float(np.float32((cfg.ransac.thr_px / float(camera.fx)) ** 2))

    if resume is None:
        with clock("bootstrap"):
            rec0, kp_lm1 = _bootstrap_host(features, camera, cfg, scfg,
                                           frame_generator(seed, 1, device=dev), dev)
            state = _state_from_bootstrap(rec0, features, kp_lm1, camera, tcfg, dev)
        out = SlamResult(rec=rec0)
        out.odo_edges.append((1, 0, rec0.R[1].copy(), rec0.t[1].copy()))
        out.frame_seq = [0, 1]
        book = {
            "prev_pose_R": rec0.R[1].copy(), "prev_pose_t": rec0.t[1].copy(),
            "prev_fid": 1, "next_fid": 2, "next_fi": 2,
            "last_closure": -(1 << 30),
        }
    else:
        state, book, out = resume

    window = scfg.window
    prev_pose = (book["prev_pose_R"], book["prev_pose_t"])
    prev_fid = int(book["prev_fid"])
    next_fid = int(book["next_fid"])
    start_fi = int(book["next_fi"])
    last_closure = int(book["last_closure"])
    consec_fail = 0

    frames = {}

    def frame_at(fi):
        if fi not in frames:
            frames.clear()  # keep at most one frame resident
            frames[fi] = _upload(_pad_frame(*features[fi], cap), dev)
        return frames[fi]

    # Retrieval prefetch: the full-bank match of frame fi is dispatched
    # while frame fi-1's BA/PGO runs. It depends only on pt_desc/pt_mask,
    # which change only inside track_step, so it is exactly what the fused
    # path computes.
    mf_next = None
    if start_fi < len(features):
        _, dj0, mj0 = frame_at(start_fi)
        mf_next = hooks.retrieval(state, dj0, mj0)

    for fi in range(start_fi, len(features)):
        xyj, dj, mj = frame_at(fi)
        mf = mf_next
        with clock("track"):
            state, info_dev = track_step(state, xyj, dj, mj,
                                         frame_generator(seed, fi, 0, device=dev),
                                         thr_n, window, tcfg, mf=mf)
            info = read_info(info_dev)  # the frame's one readback
            if not info.ok:
                # Relocalize: the same step against the whole map.
                state, info_dev = track_step(state, xyj, dj, mj,
                                             frame_generator(seed, fi, 1, device=dev),
                                             thr_n, FULL_WINDOW, tcfg, mf=mf)
                info = read_info(info_dev)
                if metrics:
                    metrics.log("relocalize", frame=fi, success=info.ok,
                                n_inliers=int(info.n_inliers))
        # Prefetch the next frame's retrieval against the post-step bank,
        # before any BA or PGO below.
        if fi + 1 < len(features):
            _, nd, nm = frame_at(fi + 1)
            mf_next = hooks.retrieval(state, nd, nm)
        if not info.ok:
            consec_fail += 1
            if consec_fail > reloc_max_failures:
                raise RuntimeError(
                    f"SLAM tracking lost at frame {fi} (relocalization failed {consec_fail} "
                    f"consecutive frames; {int(info.n_inliers)} inliers last attempt)")
            continue
        consec_fail = 0
        if info.overflow:
            raise RuntimeError(
                f"map capacity exceeded at frame {fi} (points {int(info.n_points)}/"
                f"{tcfg.max_points}, obs {int(info.n_obs)}/{tcfg.max_obs})")

        fid = next_fid
        next_fid += 1
        out.frame_seq.append(fi)
        # Odometry edge Z = T_f T_prev^-1, composed on the host.
        ZR = info.R @ prev_pose[0].T
        Zt = info.t - ZR @ prev_pose[1]
        out.odo_edges.append((fid, prev_fid, ZR, Zt))
        prev_pose = (info.R, info.t)
        prev_fid = fid
        if metrics:
            metrics.log("track", frame=fi, frame_id=fid, n_candidates=int(info.n_candidates),
                        n_inliers=int(info.n_inliers), keyframe=info.is_kf,
                        n_points=int(info.n_points))

        # ---- loop closure, with a loop_gap cooldown after each closure ----
        closed = False
        if info.votes[0] >= scfg.loop_min_votes and fid - last_closure >= scfg.loop_gap:
            cand = int(info.cands[0])
            with clock("loop"):
                pl, _ = loop_verify(state, xyj, dj, mj, cand,
                                    frame_generator(seed, fi, 2, device=dev), thr_n, tcfg)
                ok, n_in, ZR, Zt = _verified_edge(state, pl, cand)
            if ok:
                out.loop_edges.append((fid, cand, ZR, Zt))
                if metrics:
                    metrics.log("loop_closure", frame=fi, candidate=cand, inliers=n_in)
                with clock("pgo"):
                    state = _run_pgo(state, out.odo_edges, out.loop_edges, scfg)
                out.pgo_runs += 1
                with clock("ba"):
                    state = hooks.ba(state, fid, FULL_WINDOW, cfg, camera)
                    prev_pose = _pose_of(state, fid)
                closed = True
                last_closure = fid
        if cfg.ba.interval and fid % cfg.ba.interval == 0 and not closed:
            with clock("ba"):
                state = hooks.ba(state, fid, window, cfg, camera, covis=info_dev.covis,
                                 covis_thresh=scfg.ba_covis_thresh)
                prev_pose = _pose_of(state, fid)

        book.update(prev_pose_R=prev_pose[0], prev_pose_t=prev_pose[1], prev_fid=prev_fid,
                    next_fid=next_fid, next_fi=fi + 1, last_closure=last_closure)
        hooks.after_frame(state, fid, fi, out, book)

    with clock("ba"):
        state = hooks.final_ba(state, cfg, camera)
    out.rec = _rec_from_state(state, cfg, camera)
    out.rec.stage_seconds = clock.seconds
    return out


def slam_device(
    features: list,
    camera: Pinhole,
    cfg: PipelineConfig = PipelineConfig(),
    scfg: SlamConfig = SlamConfig(),
    seed: int = 0,
    metrics=None,
    reloc_max_failures: int = 3,
    device=None,
) -> SlamResult:
    """Device-resident SLAM over a feature sequence on ``device`` (``cuda``
    unless ``device="cpu"``), with the API and result of
    ``pipeline/slam.slam``: one ``track_step`` and one readback a frame.
    ``frame_seq`` maps the result's frame ids to input indices (a frame
    that fails even relocalization is skipped)."""
    return drive_slam(features, camera, cfg, scfg, seed=seed, metrics=metrics,
                      reloc_max_failures=reloc_max_failures, device=device)
