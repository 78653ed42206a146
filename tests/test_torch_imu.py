"""The port's IMU preintegration and visual-inertial alignment
(fastmatch_tpu_torch/sensors/imu.py, CPU) against the JAX package's on
tests/test_imu.py's analytic circle and random sample runs.

Tolerance: rtol 1e-4 (atol 1e-5 on entries near 0) on every
preintegrated quantity and bias Jacobian and on the scale; 1e-4 of the
vector's norm on the gravity and velocities of ``vi_align`` (the float32
normal-equation solve leaves ~2e-5 m/s^2 of noise in gravity's horizontal
components, ~1e-3 of 9.81) and on the map ``apply_vi_alignment`` writes.
Both packages integrate in float32, in the same order.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fastmatch_tpu.sensors import imu as jimu

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.sensors import imu as timu

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import imu_circle  # noqa: E402  (numpy only)

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def _close(t, j, **kw):
    np.testing.assert_allclose(t.cpu().numpy() if torch.is_tensor(t) else t, np.asarray(j),
                               **(kw or TOL))


def _runs(rng, n=64, live=40):
    gyro = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    accel = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    dts = np.full(n, 0.01, np.float32)
    mask = np.zeros(n, bool)
    mask[:live] = True
    return gyro, accel, dts, mask


def test_preintegrate_with_bias_jacobians():
    rng = np.random.default_rng(0)
    gyro, accel, dts, _ = _runs(rng)
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.1, 0.0, -0.05], np.float32)
    j = jimu.preintegrate(jnp.asarray(gyro), jnp.asarray(accel), jnp.asarray(dts),
                          bias_g=jnp.asarray(bg), bias_a=jnp.asarray(ba))
    t = timu.preintegrate(gyro, accel, dts, bias_g=bg, bias_a=ba, device="cpu")
    for name in timu.ImuPreintegration._fields:
        _close(getattr(t, name), getattr(j, name))


def test_mask_padding_is_a_noop():
    rng = np.random.default_rng(1)
    gyro, accel, dts, mask = _runs(rng)
    t_m = timu.preintegrate(gyro, accel, dts, mask=mask, device="cpu")
    t_t = timu.preintegrate(gyro[:40], accel[:40], dts[:40], device="cpu")
    j_m = jimu.preintegrate(jnp.asarray(gyro), jnp.asarray(accel), jnp.asarray(dts),
                            mask=jnp.asarray(mask))
    for name in timu.ImuPreintegration._fields:
        _close(getattr(t_m, name), getattr(t_t, name), rtol=0, atol=1e-6)
        _close(getattr(t_m, name), getattr(j_m, name))
    assert float(t_m.dt) == pytest.approx(0.4, rel=1e-5)


def _circle_pres(traj, imu):
    F = traj["R"].shape[0]
    per = len(imu["dt"]) // (F - 1)
    shape = (F - 1, per)
    return (imu["gyro"].reshape(*shape, 3), imu["accel"].reshape(*shape, 3),
            imu["dt"].reshape(shape))


def test_batched_preintegrate_and_vi_align_vs_jax():
    traj, imu, p_true = imu_circle(s_true=3.7)
    g, a, d = _circle_pres(traj, imu)
    jp = jax.vmap(jimu.preintegrate)(jnp.asarray(g), jnp.asarray(a), jnp.asarray(d))
    tp = timu.preintegrate(g, a, d, device="cpu")
    for name in timu.ImuPreintegration._fields:
        _close(getattr(tp, name), getattr(jp, name))
    R_wb = traj["R"].transpose(0, 2, 1).copy()
    C = -np.einsum("fji,fj->fi", traj["R"], traj["t"]).astype(np.float32)
    js, jg, jv, jr = jimu.vi_align(jnp.asarray(R_wb), jnp.asarray(C), jp)
    ts, tg, tv, tr = timu.vi_align(R_wb, C, tp)
    assert float(ts) == pytest.approx(float(js), rel=1e-4)
    assert float(ts) == pytest.approx(3.7, rel=0.02)
    _close(tg, jg, rtol=0, atol=1e-4 * 9.81)
    _close(tv, jv, rtol=0, atol=1e-4 * float(np.abs(np.asarray(jv)).max()))
    # The JAX package's own preintegrations through the port's solve.
    ts2, tg2, _, _ = timu.vi_align(R_wb, C, interop.imu_preintegration_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu"))
    assert float(ts2) == pytest.approx(float(js), rel=1e-4)
    _close(tg2, jg, rtol=0, atol=1e-4 * 9.81)
    # predict through the first interval
    Rj, pj, vj = timu.predict(R_wb[0], C[0], np.asarray(jv[0]),
                              timu.ImuPreintegration(*(f[0] for f in tp)), np.asarray(jg))
    jR, jpp, jvv = jimu.predict(jnp.asarray(R_wb[0]), jnp.asarray(C[0]), jv[0],
                                jax.tree.map(lambda x: x[0], jp), jg)
    _close(Rj, jR)
    _close(pj, jpp, rtol=0, atol=1e-4 * float(np.abs(np.asarray(jpp)).max()))
    _close(vj, jvv, rtol=0, atol=1e-4 * float(np.abs(np.asarray(jvv)).max()))


def test_apply_vi_alignment_vs_jax():
    from fastmatch_tpu.core.camera import Pinhole as JPinhole
    from fastmatch_tpu.pipeline.config import MapConfig, PipelineConfig
    from fastmatch_tpu.pipeline.reconstruct import Reconstruction as JRec

    from fastmatch_tpu_torch.core.camera import Pinhole

    traj, imu, _ = imu_circle(s_true=2.6)
    g, a, d = _circle_pres(traj, imu)
    F = traj["R"].shape[0]
    pts = np.random.default_rng(0).normal(0, 1.0, (30, 3)).astype(np.float32)
    cfg = PipelineConfig(map=MapConfig(max_frames=16, max_points=64, max_obs=256))
    jrec = JRec(cfg=cfg, camera=JPinhole.from_K(np.eye(3, dtype=np.float32) * 300))
    jrec.R[:F], jrec.t[:F] = traj["R"], traj["t"]
    jrec.pose_mask[:F] = True
    jrec.n_frames = F
    jrec.add_points(pts, np.zeros((30, 128), np.float32))
    trec = interop.reconstruction_from_numpy(interop.reconstruction_to_numpy(jrec),
                                             interop.config_from(cfg),
                                             Pinhole.from_K(np.eye(3, dtype=np.float32) * 300),
                                             device="cpu")
    jrep = jimu.apply_vi_alignment(jrec, jax.vmap(jimu.preintegrate)(
        jnp.asarray(g), jnp.asarray(a), jnp.asarray(d)))
    trep = timu.apply_vi_alignment(trec, timu.preintegrate(g, a, d, device="cpu"))
    assert trep["scale"] == pytest.approx(jrep["scale"], rel=1e-4)
    assert trep["scale"] == pytest.approx(2.6, rel=0.02)
    np.testing.assert_allclose(trep["gravity"], jrep["gravity"], rtol=0, atol=1e-4 * 9.81)
    for name in ("R", "t", "points"):
        np.testing.assert_allclose(getattr(trec, name), getattr(jrec, name), rtol=1e-4,
                                   atol=1e-4)


def test_entry_point_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        timu.preintegrate(np.zeros((4, 3)), np.zeros((4, 3)), np.zeros(4))
