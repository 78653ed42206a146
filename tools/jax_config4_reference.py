"""JAX-on-CPU reference figures for ``chip_smoke.py``'s config-4 phases.

Runs the JAX package, pinned to the CPU, on the same inputs as the port's
config-4 phases:

- the 500-keyframe pose graph (``chip_smoke.config4_pose_graph``, the graph
  of ``benchmarks/pgo_bench.py`` rebuilt in numpy): ``pgo_solve`` dense
  (``max_iters=30, kernel="geman", huber_delta_static=0.5``), the same with
  ``solver="pcg"``, and ``pgo_solve_hierarchical``; cost0, cost, iterations
  and the ATE of the camera centres against the ground truth (and the
  drifted start's);
- SLAM on the out-and-back orbit (``chip_smoke.render_config4_scene``):
  SIFT features of every rendered 640x480 frame (default ``SIFTConfig``),
  computed once, then each engine of ``--engine`` (a comma list of
  ``host``, the host engine ``slam``; ``device``, ``slam_device``;
  ``scan``, ``slam_scan(close_loops=True)``; ``chunked``,
  ``slam_chunked(chunk=16)``) with the default ``SlamConfig`` and
  ``MapConfig.max_frames`` >= the frame count (the next power of two);
  frames tracked, loop edges (as frame id, candidate), ``pgo_runs``, points,
  observations and the ATE of the tracked frames' centres, for each seed of
  ``--seed`` (a comma list; the engines' RANSAC draws depend on it). For
  ``device`` also ``ate_final_full``: the ATE had the run ended with the
  scan engines' final solve (``slam_scan._final_ba``: full ``BAConfig``
  budgets) in place of the driver's ``SlamHooks.ba`` at the interval
  budgets, from the same pre-final state.

Each part prints one JSON line; progress goes to stderr.

    python tools/jax_config4_reference.py [--frames N] [--engine host,device,scan,chunked]
        [--seed 0,1,2] [--skip-pgo] [--skip-slam]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")


class _Progress:
    """A metrics sink that prints the SLAM events to stderr."""

    def log(self, event, **fields):
        print(event, json.dumps(fields), file=sys.stderr, flush=True)


def _centers(R, t):
    import numpy as np

    return -np.einsum("fji,fj->fi", np.asarray(R, np.float64), np.asarray(t, np.float64))


def pgo_reference():
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import CONFIG4_PGO, config4_pose_graph
    from fastmatch_tpu.core.lie import SE3
    from fastmatch_tpu.posegraph.pgo import PoseGraph, pgo_solve, pgo_solve_hierarchical
    from fastmatch_tpu.utils.evaluation import ate_rmse

    a = config4_pose_graph()
    g = PoseGraph(poses=SE3(jnp.asarray(a["R"]), jnp.asarray(a["t"])),
                  edge_i=jnp.asarray(a["edge_i"]), edge_j=jnp.asarray(a["edge_j"]),
                  Z=SE3(jnp.asarray(a["ZR"]), jnp.asarray(a["Zt"])),
                  edge_weight=jnp.asarray(a["edge_weight"]),
                  pose_mask=jnp.asarray(a["pose_mask"]), fixed=jnp.asarray(a["fixed"]))
    gt = jnp.asarray(_centers(a["R_gt"], a["t_gt"]).astype(np.float32))

    def ate(R, t):
        return float(ate_rmse(jnp.asarray(_centers(R, t).astype(np.float32)), gt))

    out = dict(graph=CONFIG4_PGO, edges=int(a["edge_i"].shape[0]),
               ate_start=ate(a["R"], a["t"]), device="cpu (JAX reference)")
    kw = dict(kernel="geman", huber_delta_static=0.5)
    solves = (("dense", lambda: pgo_solve(g, max_iters=30, **kw)),
              ("pcg", lambda: pgo_solve(g, max_iters=30, solver="pcg", **kw)),
              ("hierarchical", lambda: pgo_solve_hierarchical(g, **kw)))
    for name, fn in solves:
        res = fn()
        np.asarray(res.poses.t)
        t0 = time.perf_counter()
        res = fn()
        np.asarray(res.poses.t)
        out[name] = dict(cost0=float(res.cost0), cost=float(res.cost), iters=int(res.iters),
                         ate=ate(res.poses.R, res.poses.t),
                         seconds_per_solve=time.perf_counter() - t0)
        print(name, json.dumps(out[name]), file=sys.stderr, flush=True)
    print(json.dumps({"pgo": out}), flush=True)


ENGINES = ("host", "device", "scan", "chunked")


def _final_both_hooks():
    """``SlamHooks`` that also solve the driver's last BA as the scan engines
    do, keeping the result in ``.full``."""
    from fastmatch_tpu.pipeline.slam_device import SlamHooks
    from fastmatch_tpu.pipeline.slam_scan import _final_ba, _with_fx_hint
    from fastmatch_tpu.pipeline.tracker import FULL_WINDOW

    class FinalBoth(SlamHooks):
        full = None

        def ba(self, state, fid, window, cfg, camera, covis=None, covis_thresh=0):
            if int(window) == FULL_WINDOW and int(fid) == int(state.n_frames):
                self.full = _final_ba(state, _with_fx_hint(cfg, float(camera.fx)))
            return super().ba(state, fid, window, cfg, camera, covis, covis_thresh)

    return FinalBoth()


def _run_engine(engine, feats, cam, cfg, scfg, seed, hooks=None):
    from fastmatch_tpu.pipeline.slam import slam
    from fastmatch_tpu.pipeline.slam_device import drive_slam
    from fastmatch_tpu.pipeline.slam_scan import slam_chunked, slam_scan

    kw = dict(seed=seed, metrics=_Progress())
    if engine == "host":
        return slam(feats, cam, cfg, scfg, **kw)
    if engine == "device":
        return drive_slam(feats, cam, cfg, scfg, hooks=hooks, **kw)
    if engine == "scan":
        return slam_scan(feats, cam, cfg, scfg, close_loops=True, **kw)
    return slam_chunked(feats, cam, cfg, scfg, chunk=16, **kw)


def slam_reference(n_frames, engines, seeds):
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import CONFIG4_SCENE, render_config4_scene
    from fastmatch_tpu.core.camera import Pinhole
    from fastmatch_tpu.features.sift import SIFTConfig, detect_and_describe
    from fastmatch_tpu.pipeline.config import MapConfig, PipelineConfig
    from fastmatch_tpu.pipeline.slam import SlamConfig
    from fastmatch_tpu.pipeline.slam_device import _rec_from_state
    from fastmatch_tpu.utils.evaluation import ate_rmse

    t0 = time.perf_counter()
    scene, views = render_config4_scene(n_frames)
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats = []
    for img in views:
        kps, descs = detect_and_describe(jnp.asarray(img), SIFTConfig())
        feats.append((np.array(kps.xy), np.array(descs.data), np.array(descs.mask)))
    sift_s = time.perf_counter() - t0
    print("features", json.dumps(dict(frames=len(feats), seconds=sift_s)), file=sys.stderr,
          flush=True)
    cfg = PipelineConfig(map=MapConfig(max_frames=max(64, 1 << (n_frames - 1).bit_length())))
    cam = Pinhole.from_K(scene.K)
    for engine in engines:
        for seed in seeds:
            hooks = _final_both_hooks() if engine == "device" else None
            t0 = time.perf_counter()
            out = _run_engine(engine, feats, cam, cfg, SlamConfig(), seed, hooks)
            secs = time.perf_counter() - t0
            rec = out.rec
            n = rec.n_frames
            seq = np.asarray(out.frame_seq) if out.frame_seq else np.arange(n)
            gt = jnp.asarray(_centers(scene.R[seq], scene.t[seq]))
            ate = float(ate_rmse(jnp.asarray(rec.camera_centers()), gt))
            extra = {}
            if hooks is not None and hooks.full is not None:
                full = _rec_from_state(hooks.full, cfg, cam)
                extra["ate_final_full"] = float(ate_rmse(jnp.asarray(full.camera_centers()), gt))
            print(json.dumps({"slam": dict(
                engine=engine, seed=seed, scene=CONFIG4_SCENE, frames_asked=n_frames,
                frames_tracked=n, max_frames=cfg.map.max_frames, ate=ate, **extra,
                loop_edges=[[int(e[0]), int(e[1])] for e in out.loop_edges],
                pgo_runs=out.pgo_runs, odo_edges=len(out.odo_edges),
                n_points=int(rec.pt_mask.sum()), n_obs=rec.n_obs, render_seconds=render_s,
                sift_seconds=sift_s, slam_seconds=secs, device="cpu (JAX reference)")}),
                flush=True)


def main(argv=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from chip_smoke import CONFIG4_SCENE

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=CONFIG4_SCENE["n_frames"])
    ap.add_argument("--skip-pgo", action="store_true")
    ap.add_argument("--skip-slam", action="store_true")
    ap.add_argument("--engine", default="host",
                    help="comma list of " + ", ".join(ENGINES))
    ap.add_argument("--seed", default="0", help="comma list of seeds for the SLAM engines")
    args = ap.parse_args(argv)
    engines = args.engine.split(",")
    seeds = [int(x) for x in args.seed.split(",")]
    if any(e not in ENGINES for e in engines):
        ap.error(f"--engine: each of {engines} must be one of {ENGINES}")
    if not args.skip_pgo:
        pgo_reference()
    if not args.skip_slam:
        slam_reference(args.frames, engines, seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
