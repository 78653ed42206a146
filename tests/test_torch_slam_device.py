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
JAX run's. Besides: one TrackInfo readback a frame (the counterpart of
test_tracker.py's readback test; its compile-count test has none, eager
PyTorch does not compile). The engine's policies, each beside the JAX
engine on the same features, are in test_torch_slam_device_dropout.py,
_sparse.py and _covis.py; ``resume=`` in _policies.py.
"""

import numpy as np
import pytest
import torch

from fastmatch_tpu.core.camera import Pinhole as JPinhole
from fastmatch_tpu.pipeline.config import BAConfig, MapConfig, PipelineConfig
from fastmatch_tpu.pipeline.slam import SlamConfig
from fastmatch_tpu.pipeline.slam_device import slam_device as jslam_device
from test_slam import CircleScene, features_of

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import slam_device as tsd
from fastmatch_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)

# The port's ATE may exceed the JAX run's by this factor (measured on the
# CPU: 0.0090 against 0.0044 here, 0.0096 against 0.0047 with frames 12-13
# wrecked, 0.041 against 0.025 with sparse keyframes; the runs differ in
# their RANSAC draws).
ATE_FACTOR = 4.0


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    scene = CircleScene(rng, n_points=300, n_frames=26)
    feats = features_of(rng, scene)
    cfg = PipelineConfig(ba=BAConfig(interval=5, max_iters=8, pcg_iters=30),
                         map=MapConfig(max_frames=32, max_points=4096, max_obs=32768))
    scfg = SlamConfig(window=6, loop_gap=10, loop_min_votes=20)
    ref = jslam_device(feats, JPinhole.from_K(scene.K), cfg, scfg)
    tcfg, cam = interop.config_from(cfg), Pinhole.from_K(scene.K)
    reads = []
    real = tsd.read_info
    tsd.read_info = lambda info: reads.append(1) or real(info)
    try:
        out = tsd.slam_device(feats, cam, tcfg, scfg, device="cpu")
    finally:
        tsd.read_info = real
    gt = -np.einsum("fji,fj->fi", scene.R, scene.t)
    return dict(ref=ref, out=out, reads=len(reads), gt=gt)


def _ate(out, gt):
    return float(ate_rmse(out.rec.camera_centers(), gt[np.asarray(out.frame_seq)]))


# Shared by the files that hold the port's engines against the JAX
# package's on one scene each (_dropout, _sparse, _covis, test_torch_slam_
# chunked_*).

def wreck(feats, frames, keep=5):
    """``feats`` with only the first ``keep`` live keypoints of ``frames``
    (PnP starves on them)."""
    feats = list(feats)
    for k in frames:
        xy, d, m = feats[k]
        m2 = m.copy()
        m2[np.where(m2)[0][keep:]] = False
        feats[k] = (xy, d, m2)
    return feats


def centres_gt(scene):
    return -np.einsum("fji,fj->fi", scene.R, scene.t)


def keyframes(rec):
    """The frames that own an observation."""
    return len(np.unique(np.asarray(rec.obs_cam)[np.asarray(rec.obs_mask)]))


def assert_map_as_jax(out, ref, obs_tol=0.05):
    """The same keyframe count, observations within ``obs_tol`` of the JAX
    run's, and the port's point count consistent with its mask."""
    assert keyframes(out.rec) == keyframes(ref.rec)
    assert abs(out.rec.n_obs - ref.rec.n_obs) <= obs_tol * ref.rec.n_obs, (
        f"{out.rec.n_obs} observations, JAX {ref.rec.n_obs}")
    assert out.rec.n_points == int(out.rec.pt_mask.sum())


def assert_loops_as_jax(out, ref):
    assert [e[:2] for e in out.loop_edges] == [e[:2] for e in ref.loop_edges]
    assert out.pgo_runs == ref.pgo_runs


def assert_ate_as_jax(out, ref, gt, bound, factor=ATE_FACTOR):
    ate, ref_ate = _ate(out, gt), _ate(ref, gt)
    assert np.isfinite(out.rec.camera_centers()).all()
    assert ate < bound, f"ATE {ate:.4f}"
    assert ate <= factor * ref_ate, f"ATE {ate:.4f}, JAX {ref_ate:.4f}"


def test_every_frame_tracked_as_jax(runs):
    out, ref = runs["out"], runs["ref"]
    assert out.rec.n_frames == ref.rec.n_frames == 26
    assert out.rec.pose_mask[:26].all() and not out.rec.pose_mask[26:].any()
    assert out.frame_seq == ref.frame_seq == list(range(26))
    assert len(out.odo_edges) == len(ref.odo_edges) == 25
    assert np.isfinite(out.rec.camera_centers()).all()


def test_loop_closures_as_jax(runs):
    out, ref = runs["out"], runs["ref"]
    assert len(out.loop_edges) >= 1
    assert [e[:2] for e in out.loop_edges] == [e[:2] for e in ref.loop_edges]
    assert all(f - c >= 10 for f, c, *_ in out.loop_edges)
    assert out.pgo_runs == ref.pgo_runs >= 1


def test_map_size_as_jax(runs):
    out, ref = runs["out"], runs["ref"]
    n_pts, ref_pts = int(out.rec.pt_mask.sum()), int(ref.rec.pt_mask.sum())
    assert abs(n_pts - ref_pts) <= 0.02 * ref_pts
    assert abs(out.rec.n_obs - ref.rec.n_obs) <= 0.05 * ref.rec.n_obs
    assert out.rec.n_points == n_pts


def test_final_ate_as_jax(runs):
    ate, ref_ate = _ate(runs["out"], runs["gt"]), _ate(runs["ref"], runs["gt"])
    assert ate < 0.25, f"ATE {ate:.4f}"
    assert ate <= ATE_FACTOR * ref_ate, f"ATE {ate:.4f}, JAX {ref_ate:.4f}"


def test_one_readback_per_frame(runs):
    """Every tracked frame came back as one ``read_info`` (no frame needed
    relocalization here): 24 frames after the bootstrap pair."""
    assert runs["reads"] == 24
    assert set(runs["out"].rec.stage_seconds) >= {"bootstrap", "track", "loop", "pgo", "ba"}
