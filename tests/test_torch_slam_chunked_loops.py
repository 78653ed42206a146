"""The port's chunked engine (``slam_chunked``, CPU) with loop closure,
against the JAX package's ``slam_chunked`` on the same features:
tests/test_slam_scan.py's seed-1 26-frame CircleScene, chunk 6, so closures
are verified between slices. Held to the JAX run's outcome: every frame
tracked, the same loop edges (at least one, each at least ``loop_gap``
frames long) and PGO runs, the same keyframe count, observations within 5%,
and the ATE under the JAX test's bound (0.3) and within ATE_FACTOR of the
JAX run's. The JAX run's figures are recorded (``slam_fixtures.JAX``, its
first run compiles for ~58 s); ``test_jax_figures_live`` re-derives them and
is ``slow``. (Its bit parity with ``slam_scan`` is in test_torch_slam_scan.py.)
"""

import pytest
import torch

import slam_fixtures as fx
from slam_fixtures import assert_ate_as_jax, assert_loops_as_jax, assert_map_as_jax

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline.slam_scan import slam_chunked

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    feats, K, cfg, scfg, kw, gt = fx.case("chunked_loops")
    out = slam_chunked(feats, Pinhole.from_K(K), interop.config_from(cfg), scfg, **kw,
                       device="cpu")
    return dict(out=out, ref=fx.JAX["chunked_loops"], gt=gt)


def test_chunked_closes_loops(runs):
    out, ref = runs["out"], runs["ref"]
    assert out.frame_seq == ref["frame_seq"] == list(range(26))
    assert len(out.loop_edges) >= 1 and out.pgo_runs >= 1
    assert all(f - c >= 10 for f, c, *_ in out.loop_edges)
    assert_loops_as_jax(out, ref)


def test_chunked_loops_map_as_jax(runs):
    assert_map_as_jax(runs["out"], runs["ref"])


def test_chunked_loops_ate_as_jax(runs):
    assert_ate_as_jax(runs["out"], runs["ref"], runs["gt"], bound=0.3)


@pytest.mark.slow
def test_jax_figures_live():
    """The JAX package's run on this fixture still gives ``JAX["chunked_loops"]``."""
    fx.assert_figures_equal(fx.jax_figures("chunked_loops"), fx.JAX["chunked_loops"])
