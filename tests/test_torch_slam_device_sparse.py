"""Sparse keyframing in the port's device engine (CPU) against the JAX
package's ``slam_device`` on the same features: tests/test_tracker.py's
26-frame CircleScene with ``kf_tracked_thresh=60, kf_max_gap=4``, so a
well-tracked frame adds no observations and no landmarks. Held to the JAX
run's outcome: every frame tracked, the same keyframe count (at most 0.55 of
the frames, the JAX test's bound against its dense run, where every frame
is a keyframe), observations within 5%, the same loop edges and PGO runs,
and the ATE under the JAX test's bound (0.35) and within ATE_FACTOR of the
JAX run's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fastmatch_tpu.core.camera import Pinhole as JPinhole
from fastmatch_tpu.pipeline.config import BAConfig, MapConfig, PipelineConfig
from fastmatch_tpu.pipeline.slam import SlamConfig
from fastmatch_tpu.pipeline.slam_device import slam_device as jslam_device
from test_slam import CircleScene, features_of
from slam_fixtures import (assert_ate_as_jax, assert_loops_as_jax, assert_map_as_jax,
                           centres_gt, figures, keyframes)

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import slam_device as tsd

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    scene = CircleScene(rng, n_points=300, n_frames=26)
    feats = features_of(rng, scene)
    cfg = PipelineConfig(ba=BAConfig(interval=5, max_iters=8, pcg_iters=30),
                         map=MapConfig(max_frames=32, max_points=4096, max_obs=32768))
    scfg = dataclasses.replace(SlamConfig(window=6, loop_gap=10, loop_min_votes=20),
                               kf_tracked_thresh=60, kf_max_gap=4)
    gt = centres_gt(scene)
    ref = figures(jslam_device(feats, JPinhole.from_K(scene.K), cfg, scfg), gt)
    out = tsd.slam_device(feats, Pinhole.from_K(scene.K), interop.config_from(cfg), scfg,
                          device="cpu")
    return dict(out=out, ref=ref, gt=gt)


def test_sparse_keyframe_selection(runs):
    out, ref = runs["out"], runs["ref"]
    assert out.rec.n_frames == 26, "sparse keyframing lost tracking"
    assert out.frame_seq == ref["frame_seq"] == list(range(26))
    assert keyframes(out.rec) <= 0.55 * 26


def test_sparse_map_as_jax(runs):
    assert_map_as_jax(runs["out"], runs["ref"])


def test_sparse_loops_as_jax(runs):
    assert_loops_as_jax(runs["out"], runs["ref"])


def test_sparse_ate_as_jax(runs):
    assert_ate_as_jax(runs["out"], runs["ref"], runs["gt"], bound=0.35)
