"""JAX-on-CPU reference figures for ``chip_smoke.py``'s config-4 phases.

Runs the JAX package, pinned to the CPU, on the same inputs as the port's
config-4 phases:

- the 500-keyframe pose graph (``chip_smoke.config4_pose_graph``, the graph
  of ``benchmarks/pgo_bench.py`` rebuilt in numpy): ``pgo_solve`` dense
  (``max_iters=30, kernel="geman", huber_delta_static=0.5``), the same with
  ``solver="pcg"``, and ``pgo_solve_hierarchical``; cost0, cost, iterations
  and the ATE of the camera centres against the ground truth (and the
  drifted start's);
- ``slam`` on the out-and-back orbit (``chip_smoke.render_config4_scene``):
  SIFT features of every rendered 640x480 frame (default ``SIFTConfig``),
  default ``SlamConfig``, ``MapConfig.max_frames`` >= the frame count;
  frames tracked, loop edges, ``pgo_runs`` and the ATE.

Each part prints one JSON line; progress goes to stderr.

    python tools/jax_config4_reference.py [--frames N] [--skip-pgo] [--skip-slam]
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


def slam_reference(n_frames):
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import CONFIG4_SCENE, render_config4_scene
    from fastmatch_tpu.core.camera import Pinhole
    from fastmatch_tpu.features.sift import SIFTConfig, detect_and_describe
    from fastmatch_tpu.pipeline.config import MapConfig, PipelineConfig
    from fastmatch_tpu.pipeline.slam import SlamConfig, slam
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
    cfg = PipelineConfig(map=MapConfig(max_frames=max(64, n_frames)))
    t0 = time.perf_counter()
    out = slam(feats, Pinhole.from_K(scene.K), cfg, SlamConfig(), metrics=_Progress())
    secs = time.perf_counter() - t0
    rec = out.rec
    n = rec.n_frames
    gt = _centers(scene.R[:n], scene.t[:n])
    ate = float(ate_rmse(jnp.asarray(rec.camera_centers()), jnp.asarray(gt)))
    print(json.dumps({"slam": dict(
        scene=CONFIG4_SCENE, frames_asked=n_frames, frames_tracked=n, ate=ate,
        loop_edges=[[int(e[0]), int(e[1])] for e in out.loop_edges], pgo_runs=out.pgo_runs,
        odo_edges=len(out.odo_edges), n_points=int(rec.pt_mask.sum()), n_obs=rec.n_obs,
        render_seconds=render_s, sift_seconds=sift_s, slam_seconds=secs,
        device="cpu (JAX reference)")}), flush=True)


def main(argv=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from chip_smoke import CONFIG4_SCENE

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=CONFIG4_SCENE["n_frames"])
    ap.add_argument("--skip-pgo", action="store_true")
    ap.add_argument("--skip-slam", action="store_true")
    args = ap.parse_args(argv)
    if not args.skip_pgo:
        pgo_reference()
    if not args.skip_slam:
        slam_reference(args.frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
