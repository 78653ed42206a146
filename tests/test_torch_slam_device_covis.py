"""Covisibility BA in the port's device engine (CPU) against the JAX
package's ``slam_device`` on the same features: tests/test_tracker.py's
oscillating 24-frame trajectory (three sweeps over one arc, 0.8 px noise,
window 3, interval 3, closure off, ``ba_covis_thresh=12``). The frames
covisible with the current one are temporally far, so in both packages the
interval BAs free more cameras than the 3-frame window: each BA's free set
is held against the window's own on the same state.

This fixture is chaotic in the RANSAC draws in both packages: which frames
fail, and the ATE, change with the seed (seeds 0-2, the JAX package's
covisibility ATE 0.124 / 0.129 / 0.090, the port's 0.333 / 0.158 / 0.113,
and 21-24 frames tracked in each; my CPU runs). So the port is held to the
JAX run within that spread: frames tracked within 2 of the JAX run's, the
ATE under the top of the JAX package's range over seeds 0-9 (0.36) and
within COVIS_ATE_FACTOR of the JAX run's. The covisibility solve itself is
held to the JAX package's from one state in test_torch_tracker.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fastmatch_tpu.core.camera import Pinhole as JPinhole
from fastmatch_tpu.pipeline import slam_device as jsd
from fastmatch_tpu.pipeline import tracker as jtr
from fastmatch_tpu.pipeline.config import BAConfig, MapConfig, PipelineConfig
from fastmatch_tpu.pipeline.slam import SlamConfig
from test_slam import CircleScene, features_of
from slam_fixtures import _ate, centres_gt

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import slam_device as tsd
from fastmatch_tpu_torch.pipeline import tracker as ttr

torch.set_num_threads(1)

# The spread above: the port's ATE was up to 2.7x the JAX run's on one seed.
COVIS_ATE_FACTOR = 3.0
WINDOW = 3


def _free(prob):
    return int(np.asarray(prob.cam_mask & ~prob.fixed_cams).sum())


class _JaxFree(jsd.SlamHooks):
    """Records (free cameras, free cameras of the window alone) of every
    interval BA."""

    def __init__(self):
        self.free = []

    def ba(self, state, fid, window, cfg, camera, covis=None, covis_thresh=0):
        if covis is not None:
            self.free.append((_free(jtr.ba_problem_from_state(state, fid, window, covis=covis,
                                                              covis_thresh=covis_thresh)),
                              _free(jtr.ba_problem_from_state(state, fid, window))))
        return super().ba(state, fid, window, cfg, camera, covis, covis_thresh)


class _PortFree(tsd.SlamHooks):
    def __init__(self):
        self.free = []

    def ba(self, state, fid, window, cfg, camera, covis=None, covis_thresh=0):
        if covis is not None:
            self.free.append((_free(ttr.ba_problem_from_state(state, fid, window, covis=covis,
                                                              covis_thresh=covis_thresh)),
                              _free(ttr.ba_problem_from_state(state, fid, window))))
        return super().ba(state, fid, window, cfg, camera, covis, covis_thresh)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(2)
    n_frames = 24
    angles = 0.9 * np.sin(np.linspace(0, 3 * np.pi, n_frames))
    scene = CircleScene(rng, n_points=300, n_frames=n_frames, angles=angles)
    feats = features_of(rng, scene, noise_px=0.8)
    cfg = PipelineConfig(ba=BAConfig(interval=3, max_iters=8, pcg_iters=30),
                         map=MapConfig(max_frames=32, max_points=4096, max_obs=32768))
    scfg = dataclasses.replace(SlamConfig(window=WINDOW, loop_gap=10 ** 6,
                                          loop_min_votes=10 ** 9), ba_covis_thresh=12)
    jhooks, thooks = _JaxFree(), _PortFree()
    ref = jsd.drive_slam(feats, JPinhole.from_K(scene.K), cfg, scfg, hooks=jhooks)
    out = tsd.drive_slam(feats, Pinhole.from_K(scene.K), interop.config_from(cfg), scfg,
                         hooks=thooks, device="cpu")
    return dict(out=out, ref=ref, gt=centres_gt(scene), jfree=jhooks.free, free=thooks.free)


def test_covis_ba_on_oscillation(runs):
    """Both packages' interval BAs free the co-observing old frames: more
    cameras than the window's own selection frees on the same state, and
    more than the window's WINDOW + 1 frames."""
    for free in (runs["free"], runs["jfree"]):
        assert free and all(c >= w for c, w in free)
        assert any(c > w for c, w in free)
        assert max(c for c, _ in free) > WINDOW + 1 >= max(w for _, w in free)


def test_covis_frames_as_jax(runs):
    out, ref = runs["out"], runs["ref"]
    assert ref.rec.n_frames >= 20  # the JAX package tracks 21 of the 24 frames
    assert abs(out.rec.n_frames - ref.rec.n_frames) <= 2
    assert out.frame_seq[:2] == [0, 1] and out.frame_seq == sorted(out.frame_seq)
    assert not out.loop_edges and not ref.loop_edges


def test_covis_ate_as_jax(runs):
    ate, ref_ate = _ate(runs["out"], runs["gt"]), _ate(runs["ref"], runs["gt"])
    assert np.isfinite(runs["out"].rec.camera_centers()).all()
    assert ate < 0.36, f"ATE {ate:.4f}"
    assert ate <= COVIS_ATE_FACTOR * ref_ate, f"ATE {ate:.4f}, JAX {ref_ate:.4f}"
