"""Relocalization in the port's device engine (CPU) against the JAX
package's ``slam_device`` on the same features: tests/test_tracker.py's
26-frame CircleScene with frames 12 and 13 wrecked (5 live keypoints each,
so PnP starves even against the whole map). Both packages skip the two
frames and relocalize the later ones; the port is held to the JAX run's
outcome: the same frames tracked, the same loop edges and PGO runs, the
same keyframe count, observations within 5%, and the ATE under the JAX
test's bound (0.3) and within ATE_FACTOR of the JAX run's. The JAX run's
figures are recorded (``slam_fixtures.JAX``); ``test_jax_figures_live``
re-derives them and is ``slow``.
"""

import pytest
import torch

import slam_fixtures as fx
from slam_fixtures import assert_ate_as_jax, assert_loops_as_jax, assert_map_as_jax

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import slam_device as tsd

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    feats, K, cfg, scfg, kw, gt = fx.case("device_dropout")
    out = tsd.slam_device(feats, Pinhole.from_K(K), interop.config_from(cfg), scfg, **kw,
                          device="cpu")
    return dict(out=out, ref=fx.JAX["device_dropout"], gt=gt)


def test_relocalization_recovers_from_dropout(runs):
    out, ref = runs["out"], runs["ref"]
    assert 12 not in out.frame_seq and 13 not in out.frame_seq
    assert out.frame_seq == ref["frame_seq"]
    assert out.frame_seq[-1] == 25
    assert out.rec.n_frames == ref["n_frames"] >= 22


def test_dropout_loops_as_jax(runs):
    assert_loops_as_jax(runs["out"], runs["ref"])
    assert runs["out"].pgo_runs >= 1


def test_dropout_map_as_jax(runs):
    assert_map_as_jax(runs["out"], runs["ref"])


def test_dropout_ate_as_jax(runs):
    assert_ate_as_jax(runs["out"], runs["ref"], runs["gt"], bound=0.3)


@pytest.mark.slow
def test_jax_figures_live():
    """The JAX package's run on this fixture still gives ``JAX["device_dropout"]``."""
    fx.assert_figures_equal(fx.jax_figures("device_dropout"), fx.JAX["device_dropout"])
