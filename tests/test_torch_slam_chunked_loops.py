"""The port's chunked engine (``slam_chunked``, CPU) with loop closure,
against the JAX package's ``slam_chunked`` on the same features:
tests/test_slam_scan.py's seed-1 26-frame CircleScene, chunk 6, so closures
are verified between slices. Held to the JAX run's outcome: every frame
tracked, the same loop edges (at least one, each at least ``loop_gap``
frames long) and PGO runs, the same keyframe count, observations within 5%,
and the ATE under the JAX test's bound (0.3) and within ATE_FACTOR of the
JAX run's. (Its bit parity with ``slam_scan`` is in test_torch_slam_scan.py.)
"""

import numpy as np
import pytest
import torch

from fastmatch_tpu.core.camera import Pinhole as JPinhole
from fastmatch_tpu.pipeline.config import BAConfig, MapConfig, PipelineConfig
from fastmatch_tpu.pipeline.slam import SlamConfig
from fastmatch_tpu.pipeline.slam_scan import slam_chunked as jslam_chunked
from test_slam import CircleScene, features_of
from test_torch_slam_device import (assert_ate_as_jax, assert_loops_as_jax, assert_map_as_jax,
                                    centres_gt)

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline.slam_scan import slam_chunked

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(1)
    scene = CircleScene(rng, n_points=300, n_frames=26)
    feats = features_of(rng, scene)
    cfg = PipelineConfig(ba=BAConfig(interval=5, max_iters=8, pcg_iters=30),
                         map=MapConfig(max_frames=32, max_points=4096, max_obs=32768))
    scfg = SlamConfig(window=6, loop_gap=10, loop_min_votes=20)
    ref = jslam_chunked(feats, JPinhole.from_K(scene.K), cfg, scfg, chunk=6)
    out = slam_chunked(feats, Pinhole.from_K(scene.K), interop.config_from(cfg), scfg, chunk=6,
                       device="cpu")
    return dict(out=out, ref=ref, gt=centres_gt(scene))


def test_chunked_closes_loops(runs):
    out, ref = runs["out"], runs["ref"]
    assert out.frame_seq == ref.frame_seq == list(range(26))
    assert len(out.loop_edges) >= 1 and out.pgo_runs >= 1
    assert all(f - c >= 10 for f, c, *_ in out.loop_edges)
    assert_loops_as_jax(out, ref)


def test_chunked_loops_map_as_jax(runs):
    assert_map_as_jax(runs["out"], runs["ref"])


def test_chunked_loops_ate_as_jax(runs):
    assert_ate_as_jax(runs["out"], runs["ref"], runs["gt"], bound=0.3)
