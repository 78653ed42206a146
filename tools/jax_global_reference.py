"""JAX-on-CPU reference figures for ``chip_smoke.py``'s ``global_sfm_selfcal``
phase.

Renders the smoke scene (``chip_smoke.SMOKE_SCENE``, 50 frames at 640x480),
runs the JAX package's ``global_reconstruct(images=...)`` with the default
``PipelineConfig`` and window 8 on the CPU, and ``self_calibrate`` on the
scene's ground-truth map observed through a camera with fx and fy x 1.06
(``chip_smoke.selfcal_inputs``; 3 rounds, fx and fy free). Prints one JSON
line for ``chip_smoke.JAX_GLOBAL``: frames, ATE after sim(3) alignment,
view-graph edges, tracks, points, observations and BA costs of the global
run, and the refined intrinsics vector and history of the calibration.
About 10 minutes on a CPU.

``--fixtures`` instead runs ``global_reconstruct`` on the fixture of the
port's CPU tests (``tests/global_sfm_fixtures.py``: tests/test_global_sfm.py's
10-frame scene, ~90 s) and prints the ``JAX`` dict recorded there.

    python tools/jax_global_reference.py [--frames N] [--window 8] [--seed 0]
    python tools/jax_global_reference.py --fixtures
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def selfcal(scene):
    import numpy as np

    from chip_smoke import SELFCAL_ROUNDS, selfcal_inputs
    from fastmatch_tpu.ba.calibrate import param_indices, self_calibrate
    from fastmatch_tpu.core.camera import Pinhole
    from fastmatch_tpu.pipeline.config import PipelineConfig
    from fastmatch_tpu.pipeline.reconstruct import Reconstruction

    R, t, X, obs_f, obs_p, obs_uv, true, wrong = selfcal_inputs(scene)
    cam = Pinhole(*wrong)
    cfg = PipelineConfig()
    rec = Reconstruction(cfg=cfg, camera=cam)
    F = R.shape[0]
    rec.R[:F], rec.t[:F], rec.pose_mask[:F], rec.n_frames = R, t, True, F
    rec.add_points(X, np.zeros((X.shape[0], cfg.map.desc_dim), np.float32))
    for f in range(F):
        sel = obs_f == f
        rec.add_observations(f, obs_p[sel], obs_uv[sel])
    t0 = time.perf_counter()
    cam2, hist = self_calibrate(rec, cam, cfg, rounds=SELFCAL_ROUNDS,
                                free=param_indices("pinhole", ("fx", "fy")))
    vec = np.asarray(cam2.intrinsics_vector(), np.float64)
    centers = -np.einsum("fji,fj->fi", rec.R[:F], rec.t[:F])
    return dict(vec=[float(v) for v in vec], history=[[float(a), float(b)] for a, b in hist],
                fx_err0=abs(wrong[0] - float(true[0])), fx_err=abs(vec[0] - float(true[0])),
                n_obs=int(rec.n_obs), n_points=int(X.shape[0]),
                centers_finite=bool(np.isfinite(centers).all()),
                seconds=time.perf_counter() - t0)


@contextlib.contextmanager
def _bounded_compile_cache(every: int = 32):
    """The JAX package's ``ransac_essential`` compiles again for most view-graph
    pairs on a CPU, and each compiled program keeps its code mapped: over
    the 50 frames' ~360 pairs the process runs out of memory maps. Clearing
    JAX's caches every ``every`` RANSAC calls frees them (compilation is
    deterministic, so the results do not change)."""
    import jax

    from fastmatch_tpu.pipeline import global_sfm

    ransac = global_sfm.ransac_essential
    calls = [0]

    def clearing(*a, **kw):
        calls[0] += 1
        if calls[0] % every == 0:
            jax.clear_caches()
        return ransac(*a, **kw)

    global_sfm.ransac_essential = clearing
    try:
        yield
    finally:
        global_sfm.ransac_essential = ransac


def fixture_figures() -> dict:
    """The JAX package's figures on tests/global_sfm_fixtures.py's fixture."""
    import jax.numpy as jnp

    import global_sfm_fixtures as fx
    from fastmatch_tpu.core.camera import Pinhole
    from fastmatch_tpu.pipeline import global_sfm
    from fastmatch_tpu.utils.evaluation import ate_rmse

    scene, feats = fx.scene_and_features()
    graphs = []
    build = global_sfm.build_view_graph

    def keep_graph(*a, **kw):
        out = build(*a, **kw)
        graphs.append(out[0])
        return out

    global_sfm.build_view_graph = keep_graph
    try:
        rec = global_sfm.global_reconstruct(feats, Pinhole.from_K(scene.K),
                                            fx.pipeline_config("fastmatch_tpu"),
                                            window=fx.WINDOW)
    finally:
        global_sfm.build_view_graph = build
    ate = ate_rmse(jnp.asarray(rec.camera_centers()), jnp.asarray(fx.gt_centers(scene)))
    return fx.summary(rec, graphs[0], ate)


def main(argv=None) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import SMOKE_SCENE, render_smoke_scene
    from fastmatch_tpu.core.camera import Pinhole
    from fastmatch_tpu.pipeline.config import PipelineConfig
    from fastmatch_tpu.pipeline.global_sfm import global_reconstruct
    from fastmatch_tpu.utils.evaluation import ate_rmse

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=SMOKE_SCENE["n_frames"])
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0, help="global_reconstruct's RANSAC seed")
    ap.add_argument("--fixtures", action="store_true",
                    help="print tests/global_sfm_fixtures.py's JAX dict")
    args = ap.parse_args(argv)
    if args.fixtures:
        import pprint

        print("JAX = " + pprint.pformat(fixture_figures(), width=100, compact=True))
        return 0

    scene, views = render_smoke_scene(args.frames)
    out = {"scene": SMOKE_SCENE, "frames_asked": args.frames, "window": args.window,
           "seed": args.seed, "device": "cpu (JAX reference)"}
    out["selfcal"] = selfcal(scene)
    print(json.dumps(out), flush=True)
    t0 = time.perf_counter()
    with _bounded_compile_cache():
        rec = global_reconstruct(None, Pinhole.from_K(scene.K), PipelineConfig(),
                                 images=views, window=args.window, seed=args.seed)
    n = rec.n_frames
    gt = -np.einsum("fji,fj->fi", scene.R[:n], scene.t[:n])
    st = rec.frame_stats[-1]
    out["global"] = dict(
        frames=n, ate=float(ate_rmse(jnp.asarray(rec.camera_centers()), jnp.asarray(gt))),
        edges=int(st["edges"]), tracks=int(st["tracks"]), n_points=int(rec.pt_mask.sum()),
        n_obs=int(rec.n_obs), ba_cost0=float(st["ba_cost0"]), ba_cost=float(st["ba_cost"]),
        seconds=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
