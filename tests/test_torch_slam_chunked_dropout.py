"""Relocalization across a slice boundary in the port's chunked engine
(``slam_chunked``, CPU), against the JAX package's ``slam_chunked`` on the
same features: tests/test_slam_scan.py's 20-frame CircleScene with closure
off and frames 10 and 11 wrecked, chunk 5, so the slices are [2..6],
[7..11], [12..16], [17..19] and the failure ends the second one. The full
window carried across the boundary lets frame 12 relocalize. Held to the
JAX run's outcome: the same frames tracked (to frame 19), the same
keyframe count, observations within 5%, and the ATE under the JAX test's
bound (0.3) and within ATE_FACTOR of the JAX run's.
"""

import numpy as np
import pytest
import torch

from fastmatch_tpu.core.camera import Pinhole as JPinhole
from fastmatch_tpu.pipeline.config import BAConfig, MapConfig, PipelineConfig
from fastmatch_tpu.pipeline.slam import SlamConfig
from fastmatch_tpu.pipeline.slam_scan import slam_chunked as jslam_chunked
from test_slam import CircleScene, features_of
from slam_fixtures import assert_ate_as_jax, assert_map_as_jax, centres_gt, figures, wreck

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline.slam_scan import slam_chunked

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    scene = CircleScene(rng, n_points=300, n_frames=20)
    feats = wreck(features_of(rng, scene), (10, 11))
    cfg = PipelineConfig(ba=BAConfig(interval=5, max_iters=8, pcg_iters=30),
                         map=MapConfig(max_frames=32, max_points=4096, max_obs=32768))
    scfg = SlamConfig(window=6, loop_gap=10 ** 6, loop_min_votes=10 ** 9)
    gt = centres_gt(scene)
    ref = figures(jslam_chunked(feats, JPinhole.from_K(scene.K), cfg, scfg, chunk=5), gt)
    out = slam_chunked(feats, Pinhole.from_K(scene.K), interop.config_from(cfg), scfg, chunk=5,
                       device="cpu")
    return dict(out=out, ref=ref, gt=gt)


def test_chunked_dropout_across_boundary(runs):
    out, ref = runs["out"], runs["ref"]
    assert 10 not in out.frame_seq and 11 not in out.frame_seq
    assert out.frame_seq == ref["frame_seq"]
    assert out.frame_seq[-1] == 19
    assert not out.loop_edges and out.pgo_runs == ref["pgo_runs"] == 0


def test_chunked_dropout_map_as_jax(runs):
    assert_map_as_jax(runs["out"], runs["ref"])


def test_chunked_dropout_ate_as_jax(runs):
    assert_ate_as_jax(runs["out"], runs["ref"], runs["gt"], bound=0.3)
