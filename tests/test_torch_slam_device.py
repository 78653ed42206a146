"""The port's device-resident SLAM engine (fastmatch_tpu_torch.pipeline.
slam_device, CPU) against the JAX package's ``slam_device`` on the same
features: tests/test_tracker.py's 26-frame CircleScene (300 points,
capacity 512, BAConfig(interval=5, max_iters=8, pcg_iters=30),
MapConfig(max_frames=32, max_points=4096, max_obs=32768), SlamConfig(
window=6, loop_gap=10, loop_min_votes=20)).

RANSAC draws differ between the packages, so the runs are compared by
outcome: every frame tracked in the same order, the same loop edges and
PGO runs, points within 2% and observations within 5% of the JAX run's,
and the ATE under the JAX test's bound (0.25) and within ATE_FACTOR of the
JAX run's. The JAX run's figures are recorded (``slam_fixtures.JAX``, its
first run compiles for ~45 s); ``test_jax_figures_live`` re-derives them
and is ``slow``. Besides: one TrackInfo readback a frame (the counterpart of
test_tracker.py's readback test; its compile-count test has none, eager
PyTorch does not compile). The engine's policies, each beside the JAX
engine on the same features, are in test_torch_slam_device_dropout.py,
_sparse.py and _covis.py; ``resume=`` in _policies.py.
"""

import numpy as np
import pytest
import torch

import slam_fixtures as fx
from slam_fixtures import ATE_FACTOR, _ate

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import slam_device as tsd

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    feats, K, cfg, scfg, _, gt = fx.case("device")
    tcfg, cam = interop.config_from(cfg), Pinhole.from_K(K)
    reads = []
    real = tsd.read_info
    tsd.read_info = lambda info: reads.append(1) or real(info)
    try:
        out = tsd.slam_device(feats, cam, tcfg, scfg, device="cpu")
    finally:
        tsd.read_info = real
    return dict(ref=fx.JAX["device"], out=out, reads=len(reads), gt=gt)


def test_every_frame_tracked_as_jax(runs):
    out, ref = runs["out"], runs["ref"]
    assert out.rec.n_frames == ref["n_frames"] == 26
    assert out.rec.pose_mask[:26].all() and not out.rec.pose_mask[26:].any()
    assert out.frame_seq == ref["frame_seq"] == list(range(26))
    assert len(out.odo_edges) == ref["odo_edges"] == 25
    assert np.isfinite(out.rec.camera_centers()).all()


def test_loop_closures_as_jax(runs):
    out, ref = runs["out"], runs["ref"]
    assert len(out.loop_edges) >= 1
    assert [list(e[:2]) for e in out.loop_edges] == ref["loop_edges"]
    assert all(f - c >= 10 for f, c, *_ in out.loop_edges)
    assert out.pgo_runs == ref["pgo_runs"] >= 1


def test_map_size_as_jax(runs):
    out, ref = runs["out"], runs["ref"]
    n_pts, ref_pts = int(out.rec.pt_mask.sum()), ref["n_points"]
    assert abs(n_pts - ref_pts) <= 0.02 * ref_pts
    assert abs(out.rec.n_obs - ref["n_obs"]) <= 0.05 * ref["n_obs"]
    assert out.rec.n_points == n_pts


def test_final_ate_as_jax(runs):
    ate, ref_ate = _ate(runs["out"], runs["gt"]), runs["ref"]["ate"]
    assert ate < 0.25, f"ATE {ate:.4f}"
    assert ate <= ATE_FACTOR * ref_ate, f"ATE {ate:.4f}, JAX {ref_ate:.4f}"


def test_one_readback_per_frame(runs):
    """Every tracked frame came back as one ``read_info`` (no frame needed
    relocalization here): 24 frames after the bootstrap pair."""
    assert runs["reads"] == 24
    assert set(runs["out"].rec.stage_seconds) >= {"bootstrap", "track", "loop", "pgo", "ba"}


@pytest.mark.slow
def test_jax_figures_live():
    """The JAX package's run on this fixture still gives ``JAX["device"]``."""
    fx.assert_figures_equal(fx.jax_figures("device"), fx.JAX["device"])
