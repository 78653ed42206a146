"""Relocalization in the port's device engine (CPU) against the JAX
package's ``slam_device`` on the same features: tests/test_tracker.py's
26-frame CircleScene with frames 12 and 13 wrecked (5 live keypoints each,
so PnP starves even against the whole map). Both packages skip the two
frames and relocalize the later ones; the port is held to the JAX run's
outcome: the same frames tracked, the same loop edges and PGO runs, the
same keyframe count, observations within 5%, and the ATE under the JAX
test's bound (0.3) and within ATE_FACTOR of the JAX run's.
"""

import numpy as np
import pytest
import torch

from fastmatch_tpu.core.camera import Pinhole as JPinhole
from fastmatch_tpu.pipeline.config import BAConfig, MapConfig, PipelineConfig
from fastmatch_tpu.pipeline.slam import SlamConfig
from fastmatch_tpu.pipeline.slam_device import slam_device as jslam_device
from test_slam import CircleScene, features_of
from test_torch_slam_device import (assert_ate_as_jax, assert_loops_as_jax, assert_map_as_jax,
                                    centres_gt, wreck)

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import slam_device as tsd

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    scene = CircleScene(rng, n_points=300, n_frames=26)
    feats = wreck(features_of(rng, scene), (12, 13))
    cfg = PipelineConfig(ba=BAConfig(interval=5, max_iters=8, pcg_iters=30),
                         map=MapConfig(max_frames=32, max_points=4096, max_obs=32768))
    scfg = SlamConfig(window=6, loop_gap=10, loop_min_votes=20)
    ref = jslam_device(feats, JPinhole.from_K(scene.K), cfg, scfg, reloc_max_failures=3)
    out = tsd.slam_device(feats, Pinhole.from_K(scene.K), interop.config_from(cfg), scfg,
                          reloc_max_failures=3, device="cpu")
    return dict(out=out, ref=ref, gt=centres_gt(scene))


def test_relocalization_recovers_from_dropout(runs):
    out, ref = runs["out"], runs["ref"]
    assert 12 not in out.frame_seq and 13 not in out.frame_seq
    assert out.frame_seq == ref.frame_seq
    assert out.frame_seq[-1] == 25
    assert out.rec.n_frames == ref.rec.n_frames >= 22


def test_dropout_loops_as_jax(runs):
    assert_loops_as_jax(runs["out"], runs["ref"])
    assert runs["out"].pgo_runs >= 1


def test_dropout_map_as_jax(runs):
    assert_map_as_jax(runs["out"], runs["ref"])


def test_dropout_ate_as_jax(runs):
    assert_ate_as_jax(runs["out"], runs["ref"], runs["gt"], bound=0.3)
