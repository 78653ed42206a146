"""JAX-on-CPU reference figures for the port's VO paths.

Runs the JAX package, pinned to the CPU, on the inputs of ``chip_smoke.py``'s
``vo_paths`` phase (default) or of the port's VO tests (``--fixtures``).

Default: ``chip_smoke.render_vo_scene`` (the config-3 smoke scene, 640x480,
and the rig's right frames at ``VO_BASELINE``), at ``--frames`` frames
(``MapConfig.max_frames`` the next power of two >= 64), default
``PipelineConfig``, ``VOConfig`` and ``StereoVOConfig``; for each seed of
``--seed``: ``visual_odometry`` (the JAX package seeds it with
``PRNGKey(0)``; the seed is added to that key), ``visual_odometry_scan(seed=
s)`` and ``stereo_visual_odometry`` (seeded as the host engine): frames
posed, flagged fallbacks, keyframes, points, observations, the sim(3) ATE
(of all frames, and ``ate_from_boot`` of the frames from the mono engines'
boot frame on), the Umeyama scale and the rigid ATE (``--engine`` picks
the engines, a comma list of host, scan, stereo; the dense figures need
host). Then, once: the ``stereo_disparity``
valid fraction of frame 0's rectified pair, ``rectify_pair`` +
``stereo_disparity`` on the unrectified pair (0, 6) of the left frames at
their true relative pose, and ``densify`` over the host engine's seed-0
trajectory (its frames, poses and points).

``--fixtures``: the figures of ``tests/vo_fixtures.py`` (the port's VO
tests' scenes and the JSON of each of ``vo_fixtures.cli_cases``' commands
through the JAX package's CLI), as one JSON object for ``vo_fixtures.JAX``.

Each part prints one JSON line; progress goes to stderr.

    python tools/jax_vo_reference.py [--frames 50] [--seed 0,1,2] [--engine host,scan,stereo]
    python tools/jax_vo_reference.py --fixtures
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def err(*a):
    print(*a, file=sys.stderr, flush=True)


@contextlib.contextmanager
def seeded(seed: int):
    """The JAX package's host VO engines draw from ``PRNGKey(0)``: offset
    every key they make by ``seed``."""
    import jax

    orig = jax.random.PRNGKey
    jax.random.PRNGKey = lambda s, *a, **k: orig(s + seed, *a, **k)
    try:
        yield
    finally:
        jax.random.PRNGKey = orig


def smoke(n_frames, seeds, engines):
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import VO_BASELINE, render_vo_scene
    from fastmatch_tpu.core.camera import Pinhole
    from fastmatch_tpu.dense.densify import densify
    from fastmatch_tpu.dense.stereo import rectify_pair, stereo_disparity
    from fastmatch_tpu.pipeline.config import MapConfig, PipelineConfig
    from fastmatch_tpu.pipeline.stereo_vo import StereoVOConfig, stereo_visual_odometry
    from fastmatch_tpu.pipeline.vo import VOConfig, visual_odometry
    from fastmatch_tpu.pipeline.vo_scan import visual_odometry_scan
    from vo_fixtures import ate, centers, summary

    t0 = time.perf_counter()
    scene, left, right = render_vo_scene(n_frames)
    err("render", time.perf_counter() - t0)
    cfg = PipelineConfig(map=MapConfig(max_frames=max(64, 1 << (n_frames - 1).bit_length())))
    cam = Pinhole.from_K(scene.K)
    gt = centers(scene.R[:n_frames], scene.t[:n_frames])
    base = dict(frames=n_frames, baseline=VO_BASELINE, max_frames=cfg.map.max_frames,
                device="cpu (JAX reference)")
    host0 = None
    runs = (("host", lambda s: visual_odometry(left, cam, cfg, VOConfig()), True),
            ("scan", lambda s: visual_odometry_scan(left, cam, cfg, VOConfig(), seed=s), False),
            ("stereo", lambda s: stereo_visual_odometry(left, right, cam, VO_BASELINE, cfg,
                                                        StereoVOConfig()), True))
    for name, fn, needs_patch in runs:
        if name not in engines:
            continue
        for seed in seeds:
            t0 = time.perf_counter()
            with seeded(seed) if needs_patch else contextlib.nullcontext():
                rec = fn(seed)
            out = dict(engine=name, seed=seed, seconds=time.perf_counter() - t0,
                       **summary(rec, gt), **base)
            if out["boot"]:
                fb, F = out["boot"][0], rec.n_frames
                out["ate_from_boot"] = ate(centers(rec.R[fb:F], rec.t[fb:F]), gt[fb:F])
            print(json.dumps({"vo": out}), flush=True)
            if name == "host" and seed == seeds[0]:
                host0 = rec
    if host0 is None:
        return
    disp, valid = stereo_disparity(jnp.asarray(left[0]), jnp.asarray(right[0]))
    out = dict(rectified_pair_valid_frac=float(np.asarray(valid).mean()))
    R_ab = scene.R[6] @ scene.R[0].T
    ra, rb, info = rectify_pair(jnp.asarray(left[0]), jnp.asarray(left[6]), scene.K, R_ab,
                                scene.t[6] - R_ab @ scene.t[0])
    _, v2 = stereo_disparity(ra, rb)
    out["unrectified_pair_0_6_valid_frac"] = float(np.asarray(v2).mean())
    F = host0.n_frames
    t0 = time.perf_counter()
    pts, _, rep = densify(left[:F], host0.R[:F], host0.t[:F], scene.K,
                          sparse_points=host0.points[host0.pt_mask])
    out["densify_host_seed0"] = dict(rep, seconds=time.perf_counter() - t0)
    print(json.dumps({"dense": dict(out, **base)}), flush=True)


def _cli(argv):
    from fastmatch_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def fixtures():
    import types

    import numpy as np

    import fastmatch_tpu.pipeline.vo as jvo
    from fastmatch_tpu.core.camera import Pinhole
    from fastmatch_tpu.features.klt import KLTConfig
    from fastmatch_tpu.pipeline.stereo_vo import StereoVOConfig, stereo_visual_odometry
    from fastmatch_tpu.pipeline.vo_scan import visual_odometry_scan
    import vo_fixtures as fx

    out = {}
    scene, views = fx.vo_scene()
    cam = Pinhole.from_K(scene.K)
    cfg = fx.pipeline_config("fastmatch_tpu", fx.SMALL_CFG)
    vo = jvo.VOConfig(**fx.VO_CFG)
    gt = fx.centers(scene.R, scene.t)
    keep = np.ones(len(views), bool)
    keep[13:17] = False
    occ = fx.occluded(views)
    for name, fn, k in (
            ("host", lambda: jvo.visual_odometry(views, cam, cfg, vo), None),
            ("host_occluded", lambda: jvo.visual_odometry(occ, cam, cfg, vo), keep),
            ("scan", lambda: visual_odometry_scan(views, cam, cfg, vo), None),
            ("scan_occluded", lambda: visual_odometry_scan(occ, cam, cfg, vo), keep)):
        t0 = time.perf_counter()
        out[name] = dict(fx.summary(fn(), gt, k), seconds=time.perf_counter() - t0)
        err(name, json.dumps(out[name]))
    real = jvo.ransac_pnp
    jvo.ransac_pnp = lambda *a, **k: types.SimpleNamespace(ok=False, n_inliers=0)
    try:
        out["host_retro_fail"] = fx.summary(jvo.visual_odometry(views[:10], cam, cfg, vo))
    finally:
        jvo.ransac_pnp = real
    err("host_retro_fail", json.dumps(out["host_retro_fail"]))

    sscene, left, right = fx.stereo_seq()
    scfg = fx.pipeline_config("fastmatch_tpu", fx.STEREO_CFG)
    sgt = fx.centers(sscene.R, sscene.t)
    t0 = time.perf_counter()
    rec = stereo_visual_odometry(left, right, cam, fx.STEREO_BASELINE, scfg,
                                 StereoVOConfig(klt=KLTConfig(levels=4)))
    out["stereo"] = dict(fx.summary(rec, sgt), seconds=time.perf_counter() - t0)
    flat = [np.full_like(x, 0.35) for x in left[:6]]
    rec = stereo_visual_odometry(left[:6], flat, cam, fx.STEREO_BASELINE, scfg, StereoVOConfig())
    out["stereo_textureless"] = fx.summary(rec)
    err("stereo", json.dumps(out["stereo"]), json.dumps(out["stereo_textureless"]))

    with tempfile.TemporaryDirectory() as tmp:
        cli = {}
        for name, argv in fx.cli_cases(Path(tmp)).items():
            t0 = time.perf_counter()
            rep = _cli(argv)
            rep.pop("out", None)
            cli[name] = rep
            err("cli", name, json.dumps(rep), time.perf_counter() - t0)
        out["cli"] = cli
    print(json.dumps(out), flush=True)


def main(argv=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--seed", default="0,1,2", help="comma list of seeds")
    ap.add_argument("--engine", default="host,scan,stereo")
    ap.add_argument("--fixtures", action="store_true")
    args = ap.parse_args(argv)
    if args.fixtures:
        fixtures()
    else:
        smoke(args.frames, [int(x) for x in args.seed.split(",")], args.engine.split(","))
    return 0


if __name__ == "__main__":
    sys.exit(main())
