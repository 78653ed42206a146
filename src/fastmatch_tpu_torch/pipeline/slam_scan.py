"""Whole-sequence SLAM with no per-frame host decision but the BA cadence:
the scan engines.

Port of ``fastmatch_tpu/pipeline/slam_scan.py``. The JAX package runs the
sequence as one ``lax.scan`` with interval BA under ``lax.cond``; eager
PyTorch has neither, so ``_run_scan`` is a Python loop over the same
``track_step`` that keeps the scan's policies:

- a failed frame sets the NEXT frame's window to ``FULL_WINDOW`` (carried as
  a device tensor): a step is never re-run, so relocalization happens one
  frame later than in ``slam_device``;
- no loop closure inside the loop;
- interval BA at ``ok & (fid % interval == 0)``, decided from one small
  readback a frame (that flag), since ``ba_solve`` runs on the host's
  control flow;
- the ``TrackInfo``s stay on the device, stacked, and come back once, in
  ``_postprocess`` (once a chunk in ``slam_chunked``).

With loop closure off, ``slam_scan`` makes the decisions of ``slam_device``
on sequences where tracking never fails: the same bootstrap, per-frame
draws, matching, PnP, BA cadence and final BA.

``slam_scan_images`` runs SIFT inside the loop (K3, one launch a frame), so
pixels go to the device once. ``close_loops=True`` adds post-hoc loop
closure from the recorded votes: ``loop_verify`` against the final map, one
pose-graph solve and one global BA. ``slam_chunked`` runs the scan in
``chunk``-frame slices with online loop closure between them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.pipeline.config import PipelineConfig
from fastmatch_tpu_torch.pipeline.slam import SlamConfig, SlamResult
from fastmatch_tpu_torch.pipeline.slam_device import (
    _bootstrap_host,
    _capacity,
    _Clock,
    _final_ba,
    _local_ba,
    _pad_frame,
    _pose_of,
    _rec_from_state,
    _run_pgo,
    _state_from_bootstrap,
    _static_from_cfg,
    _upload,
    _verified_edge,
)
from fastmatch_tpu_torch.pipeline.tracker import (
    FULL_WINDOW,
    frame_generator,
    loop_verify,
    pack_info,
    track_step,
    unpack_info,
)


def _huber(cfg: PipelineConfig) -> float:
    return cfg.ba.huber_px / cfg.ba.fx_hint


def _run_scan(state, frames, seed, thr_n, window0, tcfg, cfg, scfg, clock):
    """The tracking loop over ``frames``, an iterable of (fi, xy, desc,
    mask) on the state's device. ``window0``: the first frame's window
    (``scfg.window``, or ``FULL_WINDOW`` after a chunk that ended in a
    failure). Returns (state, the window carried out, the stacked packed
    TrackInfos on the device)."""
    dev = state.R.device
    interval = int(cfg.ba.interval)
    win = torch.tensor(scfg.window, dtype=torch.int32, device=dev)
    full = torch.tensor(FULL_WINDOW, dtype=torch.int32, device=dev)
    window = torch.as_tensor(window0, dtype=torch.int32).to(dev)
    infos = []
    for fi, xy, d, m in frames:
        with clock("track"):
            state, info = track_step(state, xy, d, m, frame_generator(seed, fi, 0, device=dev),
                                     thr_n, window, tcfg)
            window = torch.where(info.ok, win, full)
            infos.append(pack_info(info))
            fid = state.n_frames - 1
            do_ba = interval > 0 and bool(info.ok & (fid % interval == 0))  # one readback
        if do_ba:
            with clock("ba"):
                state = _local_ba(state, fid, scfg.window, cfg, _huber(cfg), info.covis,
                                  scfg.ba_covis_thresh)
    return state, window, torch.stack(infos)


def _with_fx_hint(cfg: PipelineConfig, fx: float) -> PipelineConfig:
    return dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, fx_hint=fx))


def _setup(features, camera, cfg, scfg, dev):
    """(tracker config, cfg with the camera's fx hint, squared threshold,
    the frames from 2 on stacked on the device)."""
    cap = _capacity(features)
    tcfg = _static_from_cfg(cfg, scfg, cap, camera)
    cfg = _with_fx_hint(cfg, float(camera.fx))
    thr_n = float(np.float32((cfg.ransac.thr_px / float(camera.fx)) ** 2))
    pads = [_pad_frame(*f, cap) for f in features[2:]]
    return tcfg, cfg, thr_n, _upload([np.stack([p[k] for p in pads]) for k in range(3)], dev)


def _stacked(xs, fis):
    for k, fi in enumerate(fis):
        yield fi, xs[0][k], xs[1][k], xs[2][k]


def _bootstrap(features, camera, cfg, scfg, tcfg, seed, dev, clock):
    with clock("bootstrap"):
        rec0, kp_lm1 = _bootstrap_host(features, camera, cfg, scfg,
                                       frame_generator(seed, 1, device=dev), dev)
        return rec0, _state_from_bootstrap(rec0, features, kp_lm1, camera, tcfg, dev)


def slam_scan(
    features: list,
    camera: Pinhole,
    cfg: PipelineConfig = PipelineConfig(),
    scfg: SlamConfig = SlamConfig(),
    seed: int = 0,
    metrics=None,
    close_loops: bool = False,
    device=None,
) -> SlamResult:
    """Offline device-resident SLAM on ``device`` (``cuda`` unless
    ``device="cpu"``): the whole sequence in one loop with no per-frame
    decision but the BA cadence (module docstring). ``close_loops=True``:
    post-hoc loop closure from the votes each frame recorded against the
    map of its time, verified against the final map, absorbed by one
    pose-graph solve and one global BA."""
    dev = resolve_device(device)
    clock = _Clock()
    tcfg, cfg, thr_n, xs = _setup(features, camera, cfg, scfg, dev)
    n = len(features)
    _, state = _bootstrap(features, camera, cfg, scfg, tcfg, seed, dev, clock)
    state, _, infos = _run_scan(state, _stacked(xs, range(2, n)), seed, thr_n, scfg.window,
                                tcfg, cfg, scfg, clock)

    def frame_features(fi):
        return _upload(_pad_frame(*features[fi], tcfg.cap), dev)

    return _postprocess(state, infos, n, frame_features, seed, thr_n, tcfg, cfg, scfg, camera,
                        metrics, close_loops, clock)


def slam_scan_images(
    images,
    camera: Pinhole,
    cfg: PipelineConfig = PipelineConfig(),
    scfg: SlamConfig = SlamConfig(),
    seed: int = 0,
    metrics=None,
    close_loops: bool = False,
    device=None,
) -> SlamResult:
    """Camera to trajectory on ``device``: SIFT (``detect_and_describe``,
    one K3 launch a frame) inside the scan loop, so the (F, H, W) [0, 1]
    grayscale ``images`` go to the device once and no per-frame feature
    transfer exists. The keypoint capacity is ``cfg.sift.capacity`` (a
    power of two). The host bootstraps from frames 0 and 1."""
    from fastmatch_tpu_torch.features.sift import detect_and_describe

    dev = resolve_device(device)
    clock = _Clock()
    images = [np.asarray(im, np.float32) for im in images]
    n = len(images)
    cap = int(cfg.sift.capacity)
    if cap & (cap - 1):
        raise ValueError(f"sift.capacity must be a power of two, got {cap}")
    tcfg = _static_from_cfg(cfg, scfg, cap, camera)
    cfg = _with_fx_hint(cfg, float(camera.fx))
    thr_n = float(np.float32((cfg.ransac.thr_px / float(camera.fx)) ** 2))
    clock.seconds["sift"] = 0.0

    def frame_features(fi, img=None):
        with clock("sift"):
            kp, d = detect_and_describe(images[fi] if img is None else img, cfg.sift,
                                        device=dev)
        return kp.xy, d.data, d.mask

    feats01 = [tuple(v.cpu().numpy() for v in frame_features(fi)) for fi in (0, 1)]
    stack = torch.from_numpy(np.stack(images[2:])).to(dev)
    _, state = _bootstrap(feats01, camera, cfg, scfg, tcfg, seed, dev, clock)
    frames = ((fi, *frame_features(fi, stack[fi - 2])) for fi in range(2, n))
    state, _, infos = _run_scan(state, frames, seed, thr_n, scfg.window, tcfg, cfg, scfg,
                                clock)
    return _postprocess(state, infos, n, frame_features, seed, thr_n, tcfg, cfg, scfg, camera,
                        metrics, close_loops, clock)


def _postprocess(state, infos, n, frame_features, seed, thr_n, tcfg, cfg, scfg, camera,
                 metrics, close_loops, clock):
    with clock("ba"):
        state = _final_ba(state, cfg, _huber(cfg))
    rows = [unpack_info(r) for r in infos.cpu().numpy()]  # the one readback of the infos
    ok = np.array([r.ok for r in rows], bool)
    over = [r.overflow for r in rows]
    if any(over):
        raise RuntimeError(f"map capacity exceeded at frame {2 + over.index(True)}")
    if metrics:
        for k, fi in enumerate(range(2, n)):
            metrics.log("track", frame=fi, ok=bool(ok[k]), n_inliers=int(rows[k].n_inliers),
                        n_points=int(rows[k].n_points))
    out = SlamResult(rec=_rec_from_state(state, cfg, camera))
    out.frame_seq = [0, 1] + [fi for k, fi in enumerate(range(2, n)) if ok[k]]
    n_fail = int((~ok).sum())
    if n_fail and metrics:
        metrics.log("scan_summary", failed_frames=n_fail)
    if close_loops:
        state = _close_loops_posthoc(state, rows, ok, frame_features, seed, thr_n, tcfg, cfg,
                                     scfg, out, metrics, clock)
        if out.loop_edges:
            out.rec = _rec_from_state(state, cfg, camera)
    out.rec.stage_seconds = clock.seconds
    return out


def _close_loops_posthoc(state, rows, ok, frame_features, seed, thr_n, tcfg, cfg, scfg, out,
                         metrics, clock):
    """Verify the scan's recorded loop candidates against the final map,
    then one PGO and one global BA over the corrected chain."""
    dev = state.R.device
    fids = 1 + np.cumsum(ok)  # the frame id each scan step assigned
    last_closure = -(1 << 30)
    for k, r in enumerate(rows):
        if not ok[k]:
            continue
        fid = int(fids[k])
        if r.votes[0] < scfg.loop_min_votes or fid - last_closure < scfg.loop_gap:
            continue
        fi = 2 + k
        cand = int(r.cands[0])
        xy, d, m = frame_features(fi)
        with clock("loop"):
            pl, _ = loop_verify(state, xy, d, m, cand, frame_generator(seed, fi, 2, device=dev),
                                thr_n, tcfg)
            verified, n_in, ZR, Zt = _verified_edge(state, pl, cand)
        if not verified:
            continue
        out.loop_edges.append((fid, cand, ZR, Zt))
        last_closure = fid
        if metrics:
            metrics.log("loop_closure", frame=fi, candidate=cand, inliers=n_in, posthoc=True)
    if not out.loop_edges:
        return state
    # The odometry chain from the scan's own (BA-refined) trajectory.
    R = state.R.cpu().numpy()
    t = state.t.cpu().numpy()
    odo = []
    for i in range(1, int(state.n_frames)):
        ZR = R[i] @ R[i - 1].T
        odo.append((i, i - 1, ZR, t[i] - ZR @ t[i - 1]))
    with clock("pgo"):
        state = _run_pgo(state, odo, out.loop_edges, scfg)
    out.pgo_runs += 1
    with clock("ba"):
        return _final_ba(state, cfg, _huber(cfg))


def slam_chunked(
    features: list,
    camera: Pinhole,
    cfg: PipelineConfig = PipelineConfig(),
    scfg: SlamConfig = SlamConfig(),
    chunk: int = 16,
    seed: int = 0,
    metrics=None,
    reloc_max_failures: int = 3,
    device=None,
) -> SlamResult:
    """Near-online SLAM on ``device``: the scan loop over ``chunk``-frame
    slices (the same per-frame draws and BA cadence, the window carried
    across slices, so with no closure the result is bit-identical to
    ``slam_scan``'s), each slice's TrackInfos read back once, and after
    each slice ``drive_slam``'s verify -> pose graph -> global BA episode
    on its frames' recorded votes, with the same loop_gap cooldown: a
    closure is corrected at most ``chunk - 1`` frames late. Failure policy
    is the scan's; the run raises after ``reloc_max_failures`` consecutive
    failed frames."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    dev = resolve_device(device)
    clock = _Clock()
    tcfg, cfg, thr_n, xs = _setup(features, camera, cfg, scfg, dev)
    n = len(features)
    rec0, state = _bootstrap(features, camera, cfg, scfg, tcfg, seed, dev, clock)

    out = SlamResult(rec=rec0)
    out.odo_edges.append((1, 0, rec0.R[1].copy(), rec0.t[1].copy()))
    out.frame_seq = [0, 1]
    next_fid, prev_fid = 2, 1
    prev_pose = (rec0.R[1].copy(), rec0.t[1].copy())
    last_closure = -(1 << 30)
    consec_fail = 0
    window = scfg.window

    for c0 in range(2, n, chunk):
        c1 = min(c0 + chunk, n)
        part = tuple(a[c0 - 2:c1 - 2] for a in xs)
        state, window, infos = _run_scan(state, _stacked(part, range(c0, c1)), seed, thr_n,
                                         window, tcfg, cfg, scfg, clock)
        rows = [unpack_info(r) for r in infos.cpu().numpy()]  # one readback a chunk
        fid_of = {}
        for k, fi in enumerate(range(c0, c1)):
            r = rows[k]
            if r.overflow:
                raise RuntimeError(f"map capacity exceeded at frame {fi}")
            if not r.ok:
                consec_fail += 1
                if metrics:
                    metrics.log("track", frame=fi, ok=False, n_inliers=int(r.n_inliers))
                if consec_fail > reloc_max_failures:
                    raise RuntimeError(f"SLAM tracking lost at frame {fi} "
                                       f"({consec_fail} consecutive failures)")
                continue
            consec_fail = 0
            fid = next_fid
            next_fid += 1
            fid_of[k] = fid
            out.frame_seq.append(fi)
            ZR = r.R @ prev_pose[0].T
            out.odo_edges.append((fid, prev_fid, ZR, r.t - ZR @ prev_pose[1]))
            prev_pose = (r.R, r.t)
            prev_fid = fid
            if metrics:
                metrics.log("track", frame=fi, frame_id=fid, ok=True,
                            n_inliers=int(r.n_inliers), n_points=int(r.n_points))

        # ---- the loop-closure episode of drive_slam, on the votes the
        #      slice's frames recorded against the map of their time ----
        closed = False
        for k, fi in enumerate(range(c0, c1)):
            if k not in fid_of:
                continue
            fid = fid_of[k]
            r = rows[k]
            if r.votes[0] < scfg.loop_min_votes or fid - last_closure < scfg.loop_gap:
                continue
            cand = int(r.cands[0])
            with clock("loop"):
                pl, _ = loop_verify(state, xs[0][fi - 2], xs[1][fi - 2], xs[2][fi - 2], cand,
                                    frame_generator(seed, fi, 2, device=dev), thr_n, tcfg)
                verified, n_in, ZR, Zt = _verified_edge(state, pl, cand)
            if not verified:
                continue
            out.loop_edges.append((fid, cand, ZR, Zt))
            last_closure = fid
            closed = True
            if metrics:
                metrics.log("loop_closure", frame=fi, candidate=cand, inliers=n_in,
                            chunked=True)
        if closed:
            with clock("pgo"):
                state = _run_pgo(state, out.odo_edges, out.loop_edges, scfg)
            out.pgo_runs += 1
            with clock("ba"):
                state = _final_ba(state, cfg, _huber(cfg))
                # Re-anchor the odometry on the corrected pose so that the
                # next slice's first edge does not carry the correction.
                prev_pose = _pose_of(state, prev_fid)

    with clock("ba"):
        state = _final_ba(state, cfg, _huber(cfg))
    out.rec = _rec_from_state(state, cfg, camera)
    out.rec.stage_seconds = clock.seconds
    return out
