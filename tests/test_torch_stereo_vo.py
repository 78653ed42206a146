"""The port's metric stereo VO (fastmatch_tpu_torch/pipeline/stereo_vo.py,
CPU) beside the JAX package's on tests/test_stereo_vo.py's 28-frame
rectified sequence (KLT at 4 levels, as that test runs it).

The fixture is marginal in both packages: every frame is a keyframe, PnP
inliers fall from ~230 to under 20 after frame 15, and the outcome moves
with the RANSAC draws. The JAX package's own figures over seeds 0-4 (its
``PRNGKey`` offset, on a CPU): flagged fallbacks 2 / 6 / 3 / 5 / 3, Umeyama
scale 1.0069 / 1.0173 / 1.0421 / 1.0237 / 1.0106, rigid ATE 0.017-0.046; so
its test's gate (scale within 0.03, at most 3 fallbacks) holds at seed 0
only. Gates here:

- the port's engine fed the JAX package's disparity maps meets that gate
  as the JAX run does: every frame posed, at most 3 fallbacks, scale within
  0.03 of 1, rigid ATE < 0.15 (measured 3, 1.0282, 0.0336);
- the port end to end: every frame posed, at most 6 fallbacks (the JAX
  package's most over seeds 0-4), rigid ATE < 0.15, scale within 0.08 of
  1, points within 5% of the JAX run's (measured 4, 1.0649, 0.0672, 3458
  against 3389; over seeds 0-2 the port gives 4 / 4 / 6 fallbacks and
  scale 1.0649 / 0.9983 / 1.0396). Its own disparities differ from the JAX
  package's next to flat background (tests/test_torch_stereo.py), which
  moves this marginal run; on chip_smoke.py's 640x480 sequence the port
  meets the 0.03 and 3-fallback gates;
- a textureless right stream: no lift, every later frame a flagged
  fallback, no crash, as in the JAX package.
"""

import importlib

import numpy as np
import pytest
import torch

import vo_fixtures as fx
from vo_fixtures import JAX

from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.features.klt import KLTConfig
from fastmatch_tpu_torch.pipeline import stereo_vo as tsvo

torch.set_num_threads(1)

SCENE, LEFT, RIGHT = fx.stereo_seq()
GT = fx.centers(SCENE.R, SCENE.t)
CAM = Pinhole.from_K(SCENE.K)
CFG = fx.pipeline_config("fastmatch_tpu_torch", fx.STEREO_CFG)


def _run(left, right, vo=tsvo.StereoVOConfig(klt=KLTConfig(levels=4))):
    return tsvo.stereo_visual_odometry(left, right, CAM, fx.STEREO_BASELINE, CFG, vo,
                                       device="cpu")


def _gates(s, n, scale_tol, max_fallbacks=3):
    assert s["n_frames"] == s["posed"] == n
    assert len(s["pnp_failed"]) <= max_fallbacks
    assert abs(s["scale"] - 1.0) < scale_tol
    assert s["ate_rigid"] < 0.15


def test_metric_trajectory_beside_jax():
    s, j = fx.summary(_run(LEFT, RIGHT), GT), JAX["stereo"]
    _gates(j, len(LEFT), 0.03)
    _gates(s, len(LEFT), 0.08, max_fallbacks=6)
    assert abs(s["n_points"] - j["n_points"]) <= 0.05 * j["n_points"]
    assert s["keyframes"] == j["keyframes"]


def test_engine_on_jax_disparities_meets_the_jax_gate(monkeypatch):
    jstereo = importlib.import_module("fastmatch_tpu.dense.stereo")
    import jax.numpy as jnp

    def jax_disparity(left, right, cfg, device):
        d, v = jstereo.stereo_disparity(jnp.asarray(left.numpy()), jnp.asarray(right.numpy()),
                                        jstereo.StereoConfig(*cfg))
        return torch.from_numpy(np.array(d)), torch.from_numpy(np.array(v))

    monkeypatch.setattr(tsvo, "stereo_disparity", jax_disparity)
    _gates(fx.summary(_run(LEFT, RIGHT), GT), len(LEFT), 0.03)


def test_textureless_right_degrades_gracefully():
    flat = [np.full_like(x, 0.35) for x in LEFT[:6]]
    s = fx.summary(_run(LEFT[:6], flat, tsvo.StereoVOConfig()))
    j = JAX["stereo_textureless"]
    assert s["n_frames"] == s["posed"] == 6
    assert s["pnp_failed"] == j["pnp_failed"] == [1, 2, 3, 4, 5]
    assert s["n_points"] == j["n_points"] == 0


def test_entry_point_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsvo.stereo_visual_odometry(LEFT[:2], RIGHT[:2], CAM, 0.1)


@pytest.mark.slow
def test_jax_figures_live():
    """The JAX package's run on this fixture still gives ``JAX["stereo"]``."""
    from fastmatch_tpu.core.camera import Pinhole as JPinhole
    from fastmatch_tpu.features.klt import KLTConfig as JKLT
    from fastmatch_tpu.pipeline.stereo_vo import StereoVOConfig, stereo_visual_odometry

    rec = stereo_visual_odometry(LEFT, RIGHT, JPinhole.from_K(SCENE.K), fx.STEREO_BASELINE,
                                 fx.pipeline_config("fastmatch_tpu", fx.STEREO_CFG),
                                 StereoVOConfig(klt=JKLT(levels=4)))
    got, want = fx.summary(rec, GT), JAX["stereo"]
    for k in ("n_frames", "posed", "pnp_failed", "keyframes", "n_points", "n_obs"):
        assert got[k] == want[k], k
    assert got["scale"] == pytest.approx(want["scale"], rel=1e-3)
