"""The port's self-calibration (``fastmatch_tpu_torch/ba/calibrate.py``)
beside the JAX package's, on the CPU: tests/test_calibrate.py's six tests on
the same seeded scenes.

- ``refine_intrinsics``' vector within rtol 1e-4 of the JAX package's, with
  the same iteration count, and frozen entries bit-equal to the start;
- the reduce hook: two observation halves refined on two gloo ranks, their
  partial cost sums and counts and normal equations summed by the hook (an
  all-reduce), give the unsplit result within 1e-5 (what the JAX package's
  observation-sharded ``psum`` test checks);
- ``calibrate_map``'s history within rtol 1e-3 of the JAX package's;
- ``self_calibrate`` on the wrong-intrinsics Reconstruction cuts the fx
  error by more than 3x, as the JAX package's does;
- ``reconstruct --selfcal 3`` through the port's CLI on features seen
  through an unmodelled lens (the JAX package's ``slow`` CLI test, on the
  port alone).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmatch_tpu.ba import calibrate as jcal
from fastmatch_tpu.core import camera as jcam
from synth import SyntheticScene
from test_calibrate import VEC_TRUE, _scene_obs

from fastmatch_tpu_torch.ba import calibrate as tcal
from fastmatch_tpu_torch.core import camera as tcam

torch.set_num_threads(1)


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _obs(seed):
    """tests/test_calibrate.py's scene: JAX arrays and the port's tensors."""
    j = _scene_obs(np.random.default_rng(seed), VEC_TRUE)
    return j, _t(*j[:7])


def test_refine_recovers_intrinsics():
    (R, t, X, oc, op, uv, m, _), port = _obs(0)
    vec0 = VEC_TRUE * np.array([1.06, 0.95, 1.0, 1.0, 0.0, 0.0, 1.0, 1.0, 1.0], np.float32)
    vec0[2:4] += [8.0, -6.0]
    ref = jcal.refine_intrinsics(R, t, X, oc, op, uv, m, jnp.asarray(vec0), model="pinhole")
    res = tcal.refine_intrinsics(*port, torch.from_numpy(vec0), model="pinhole")
    assert isinstance(res, tcal.CalibResult)
    v = res.vec.numpy()
    np.testing.assert_allclose(v, np.asarray(ref.vec), rtol=1e-4, atol=1e-6)
    assert res.iters == int(ref.iters)
    # tests/test_calibrate.py's gates on the port's result.
    assert np.allclose(v[:4], VEC_TRUE[:4], rtol=2e-4)
    assert abs(v[4] - VEC_TRUE[4]) < 2e-3
    assert abs(v[5] - VEC_TRUE[5]) < 5e-3
    assert float(res.cost) < 1e-3
    assert float(res.cost) < float(res.cost0)
    assert float(res.cost0) == pytest.approx(float(ref.cost0), rel=1e-4)


def test_refine_respects_free_mask():
    (R, t, X, oc, op, uv, m, _), port = _obs(1)
    vec0 = VEC_TRUE.copy()
    vec0[0] *= 1.05
    vec0[2] += 11.0  # cx also wrong, but frozen below
    free = tcal.param_indices("pinhole", ("fx",))
    assert free == jcal.param_indices("pinhole", ("fx",))
    ref = jcal.refine_intrinsics(R, t, X, oc, op, uv, m, jnp.asarray(vec0), model="pinhole",
                                 free=free)
    res = tcal.refine_intrinsics(*port, torch.from_numpy(vec0), model="pinhole", free=free)
    v = res.vec.numpy()
    assert np.array_equal(v[1:], vec0[1:])      # frozen entries bit-identical
    assert abs(v[0] - VEC_TRUE[0]) < abs(vec0[0] - VEC_TRUE[0])
    np.testing.assert_allclose(v, np.asarray(ref.vec), rtol=1e-4)
    assert res.iters == int(ref.iters)


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def test_refine_reduce_hook_parity():
    """Two observation halves on two gloo ranks, the hook an all-reduce ==
    the unsplit refinement (the JAX package's
    test_refine_sharded_psum_parity)."""
    import torch.multiprocessing as mp

    import calibrate_ranks

    _, (R, t, X, oc, op, uv, m) = _obs(2)
    vec0 = torch.from_numpy(VEC_TRUE * np.float32(1.03))
    ref = tcal.refine_intrinsics(R, t, X, oc, op, uv, m, vec0, model="pinhole", max_iters=6)
    O = oc.shape[0]
    shards = [(R, t, X, oc[s], op[s], uv[s], m[s]) for s in (slice(0, O // 2), slice(O // 2, O))]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    addr = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=calibrate_ranks.rank_main, args=(r, 2, addr, shards, vec0, out))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = out.get(timeout=120)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    assert np.array_equal(got[0], got[1])       # every rank holds the same bits
    np.testing.assert_allclose(got[0, :9], ref.vec.numpy(), rtol=1e-5)
    assert got[0, 10] == ref.iters
    assert got[0, 9] == pytest.approx(float(ref.cost), rel=1e-5, abs=1e-9)


def test_calibrate_map_alternation_improves():
    rng = np.random.default_rng(3)
    R, t, X, oc, op, uv, m, scene = _scene_obs(rng, VEC_TRUE)
    vec0 = VEC_TRUE.copy()
    vec0[0] *= 1.05
    vec0[1] *= 1.05
    Xp = X + 0.01 * rng.standard_normal(X.shape).astype(np.float32)
    C = R.shape[0]
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    free = jcal.param_indices("pinhole", ("fx", "fy"))
    kw = dict(model="pinhole", free=free, rounds=3,
              ba_kwargs=dict(max_iters=8, pcg_iters=30, huber_delta_static=2.0 / 520.0))
    masks = (np.ones(C, bool), np.ones(X.shape[0], bool), fixed)
    vj, *_, hist_j = jcal.calibrate_map(R, t, Xp, oc, op, uv, m,
                                        *(jnp.asarray(a) for a in masks), vec0, **kw)
    vt, R2, t2, X2, hist_t = tcal.calibrate_map(*_t(R, t, Xp, oc, op, uv, m, *masks), vec0,
                                                device="cpu", **kw)
    np.testing.assert_allclose(np.asarray(hist_t), np.asarray(hist_j), rtol=1e-3)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-4)
    v = vt.numpy()
    assert abs(v[0] - VEC_TRUE[0]) < abs(vec0[0] - VEC_TRUE[0]) / 3
    assert hist_t[-1][0] < hist_t[0][0] * 1.01
    assert X2.shape == Xp.shape and torch.isfinite(X2).all()


def _wrong_intrinsics_reconstruction(pkg_camera, Reconstruction, cfg, normalize):
    """tests/test_calibrate.py:test_self_calibrate_reconstruction's map:
    the true structure, observations normalized with fx, fy x 1.06."""
    rng = np.random.default_rng(4)
    scene = SyntheticScene(rng, n_points=160, n_frames=8, span=1.0)
    vec_true = pkg_camera.Pinhole.from_K(scene.K).intrinsics_vector()
    wrong = pkg_camera.Pinhole(fx=float(vec_true[0]) * 1.06, fy=float(vec_true[1]) * 1.06,
                               cx=float(vec_true[2]), cy=float(vec_true[3]))
    rec = Reconstruction(cfg=cfg, camera=wrong)
    F = scene.R.shape[0]
    rec.R[:F] = scene.R
    rec.t[:F] = scene.t
    rec.pose_mask[:F] = True
    rec.n_frames = F
    vis_any = scene.visible.any(axis=0)
    ids = rec.add_points(scene.points[vis_any].astype(np.float32),
                         np.zeros((int(vis_any.sum()), 128), np.float32))
    remap = -np.ones(scene.points.shape[0], np.int64)
    remap[np.nonzero(vis_any)[0]] = ids
    for f in range(F):
        p = np.nonzero(scene.visible[f])[0]
        uv_n = normalize(scene.pixels[f, p].astype(np.float32), wrong.intrinsics_vector())
        rec.add_observations(f, remap[p].astype(np.int32), uv_n)
    return rec, wrong, vec_true


def test_self_calibrate_reconstruction():
    from fastmatch_tpu.pipeline import config as jconf
    from fastmatch_tpu.pipeline.reconstruct import Reconstruction as JRec

    from fastmatch_tpu_torch.pipeline import config as tconf
    from fastmatch_tpu_torch.pipeline.reconstruct import Reconstruction as TRec

    jcfg = jconf.PipelineConfig(map=jconf.MapConfig(max_frames=16, max_points=512,
                                                    max_obs=4096))
    tcfg = tconf.PipelineConfig(map=tconf.MapConfig(max_frames=16, max_points=512,
                                                    max_obs=4096))
    jrec, jwrong, vec_true = _wrong_intrinsics_reconstruction(
        jcam, JRec, jcfg,
        lambda px, v: np.asarray(jcam.normalize_pixels(jnp.asarray(px), jnp.asarray(v))))
    trec, twrong, _ = _wrong_intrinsics_reconstruction(
        tcam, lambda cfg, camera: TRec(cfg=cfg, camera=camera), tcfg,
        lambda px, v: tcam.normalize_pixels(torch.from_numpy(px), torch.from_numpy(v)).numpy())
    assert np.array_equal(trec.obs_uv, jrec.obs_uv)
    free = tcal.param_indices("pinhole", ("fx", "fy"))
    jcam2, jhist = jcal.self_calibrate(jrec, jwrong, jcfg, rounds=3, free=free)
    tcam2, thist = tcal.self_calibrate(trec, twrong, tcfg, rounds=3, free=free)
    assert isinstance(tcam2, tcam.Pinhole)
    err0 = abs(float(twrong.fx) - float(vec_true[0]))
    assert abs(float(tcam2.fx) - float(vec_true[0])) < err0 / 3
    assert thist[-1][0] < thist[0][0] * 1.01
    np.testing.assert_allclose(np.asarray(tcam2), np.asarray(jcam2), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(thist), np.asarray(jhist), rtol=1e-3, atol=1e-9)
    # The map was refit in place: poses, points and observations moved.
    np.testing.assert_allclose(trec.obs_uv[:trec.n_obs], jrec.obs_uv[:jrec.n_obs], atol=1e-5)


def test_cli_reconstruct_selfcal(tmp_path):
    """``reconstruct --selfcal 3`` through the port's CLI: features seen
    through an unmodelled lens (k1 = -0.10) pull k1 the right way
    (tests/test_calibrate.py's slow CLI test, on the port)."""
    import contextlib
    import io
    import json

    from test_pipeline import synthetic_features

    from fastmatch_tpu_torch.cli import main

    rng = np.random.default_rng(5)
    scene = SyntheticScene(rng, n_points=250, n_frames=12, span=1.0)
    vec_true = np.array([500.0, 500.0, 320.0, 240.0, -0.10, 0, 0, 0, 0], np.float32)
    cam3 = np.einsum("fij,pj->fpi", scene.R, scene.points) + scene.t[:, None, :]
    xn = cam3[..., :2] / np.clip(cam3[..., 2:3], 1e-9, None)
    scene.pixels = tcam.project_pixels(torch.from_numpy(xn.astype(np.float32)),
                                       torch.from_numpy(vec_true)).numpy()
    z = cam3[..., 2]
    uv = scene.pixels
    scene.visible = ((z > 0.1) & (uv[..., 0] >= 0) & (uv[..., 0] < 640)
                     & (uv[..., 1] >= 0) & (uv[..., 1] < 480))
    feats = synthetic_features(rng, scene)
    npz = {"n_frames": len(feats), "image_size": np.array([640, 480])}
    for i, (xy, d, m) in enumerate(feats):
        npz[f"xy_{i}"], npz[f"desc_{i}"], npz[f"mask_{i}"] = xy, d, m
    inp = tmp_path / "feats.npz"
    np.savez(inp, **npz)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--device", "cpu", "--set", "ba.interval=4", "--set", "ba.max_iters=8",
              "--set", "ba.pcg_iters=30", "--set", "map.max_frames=16",
              "--set", "map.max_points=4096", "--set", "map.max_obs=32768",
              "reconstruct", str(inp), "--focal", "500", "--selfcal", "3"])
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    sc = rep["selfcal"]
    assert set(sc) == {"fx", "fy", "cx", "cy", "dist", "mean_px2"}
    assert sc["dist"][0] < -0.005, rep      # k1 moved toward -0.10
    assert abs(sc["fx"] - 500.0) < 15.0, rep
    assert sc["mean_px2"] < 1.0, rep
