"""The port's host VO engine (fastmatch_tpu_torch/pipeline/vo.py, CPU)
beside the JAX package's on tests/test_vo.py's 24-frame 320x240 orbit.

The JAX figures are ``vo_fixtures.JAX`` (its first run compiles for ~150 s
on an 8-core CPU); ``test_jax_figures_live`` re-derives them and is ``slow``.
Gates, as tests/test_vo.py's and against the JAX run: every frame posed in
both, no PnP fallback, keyframes within 1 of the JAX run's, points within
10%, the sim(3) ATE < 0.3 (the JAX test's gate) and at most 2x the JAX
run's (RANSAC draws differ between the packages, ROADMAP's parity contract).
"""

import numpy as np
import pytest
import torch

import vo_fixtures as fx
from vo_fixtures import JAX

from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import vo as tvo

torch.set_num_threads(1)

SCENE, VIEWS = fx.vo_scene()
GT = fx.centers(SCENE.R, SCENE.t)
KEEP = np.ones(len(VIEWS), bool)
KEEP[13:17] = False


def _run(views, **kw):
    return tvo.visual_odometry(views, Pinhole.from_K(SCENE.K),
                               fx.pipeline_config("fastmatch_tpu_torch", fx.SMALL_CFG),
                               tvo.VOConfig(**fx.VO_CFG), device="cpu", **kw)


@pytest.fixture(scope="module")
def port_run():
    return fx.summary(_run(VIEWS), GT)


def test_sequence_beside_jax(port_run):
    t, j = port_run, JAX["host"]
    assert t["n_frames"] == j["n_frames"] == t["posed"] == j["posed"] == len(VIEWS)
    assert t["pnp_failed"] == j["pnp_failed"] == []
    assert abs(t["keyframes"] - j["keyframes"]) <= 1
    assert abs(t["n_points"] - j["n_points"]) <= 0.1 * j["n_points"]
    assert t["ate"] < 0.3 and t["ate"] <= 2.0 * j["ate"]


def test_retroactive_pnp_failure_falls_back(monkeypatch):
    """Every PnP failing: each pre-bootstrap frame gets the flagged
    constant-position fallback, as in the JAX package (no identity-pose
    holes)."""
    monkeypatch.setattr(tvo, "pnp_live", lambda *a, **k: (False, 0, None, None))
    rec = _run(VIEWS[:10])
    t, j = fx.summary(rec), JAX["host_retro_fail"]
    assert t["n_frames"] == t["posed"] == 10
    assert t["boot"] == j["boot"]
    assert t["pnp_failed"] == j["pnp_failed"]
    assert all(s.get("pnp_failed") for s in rec.frame_stats if s["frame"] not in (0, *t["boot"]))


def test_recovers_through_brief_occlusion():
    """A blanked frame: tracking dies there, the fallback holds, later
    keyframes replenish; the tail tracks the ground truth (ATE < 0.6 off the
    blanked span, the JAX test's gate), as the JAX run does."""
    t = fx.summary(_run(fx.occluded(VIEWS)), GT, KEEP)
    j = JAX["host_occluded"]
    assert t["n_frames"] == t["posed"] == len(VIEWS)
    assert 14 in t["pnp_failed"] and 14 in j["pnp_failed"]
    assert t["ate"] < 0.6 and j["ate"] < 0.6


def test_two_runs_bit_identical():
    a, b = _run(VIEWS[:9]), _run(VIEWS[:9])
    for name in ("R", "t", "points", "obs_uv", "obs_pt"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_entry_point_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvo.visual_odometry(VIEWS[:3], Pinhole.from_K(SCENE.K))


@pytest.mark.slow
def test_jax_figures_live():
    """The JAX package's run on this fixture still gives ``JAX["host"]``."""
    from fastmatch_tpu.core.camera import Pinhole as JPinhole
    from fastmatch_tpu.pipeline.vo import VOConfig, visual_odometry

    rec = visual_odometry(VIEWS, JPinhole.from_K(SCENE.K),
                          fx.pipeline_config("fastmatch_tpu", fx.SMALL_CFG),
                          VOConfig(**fx.VO_CFG))
    got = fx.summary(rec, GT)
    want = JAX["host"]
    for k in ("n_frames", "posed", "pnp_failed", "keyframes", "n_points", "n_obs", "boot"):
        assert got[k] == want[k], k
    assert got["ate"] == pytest.approx(want["ate"], rel=1e-3)
