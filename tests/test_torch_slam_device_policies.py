"""The port's device-resident SLAM engine (CPU) through its hooks, on
tests/test_tracker.py's 26-frame CircleScene, port only:

- a run resumed from a mid-sequence snapshot (``drive_slam(resume=...)``)
  ends bit-identical to the uninterrupted run (draws depend on (seed,
  frame) alone);
- the run's last solve goes through ``SlamHooks.final_ba``, once, after
  the last frame.

The engine's policies beside the JAX package's engine are in
test_torch_slam_device_dropout.py, _sparse.py and _covis.py.
"""

import copy

import numpy as np
import pytest
import torch

from test_slam import CircleScene, features_of

from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import slam_device as tsd
from fastmatch_tpu_torch.pipeline.config import BAConfig, MapConfig, PipelineConfig
from fastmatch_tpu_torch.pipeline.slam import SlamConfig

torch.set_num_threads(1)

SNAPSHOT_FID = 12
CFG = PipelineConfig(ba=BAConfig(interval=5, max_iters=8, pcg_iters=30),
                     map=MapConfig(max_frames=32, max_points=4096, max_obs=32768))


class _Snapshot(tsd.SlamHooks):
    """Keeps a copy of (state, book, out) after frame id SNAPSHOT_FID, and
    the frame count of each ``final_ba`` call's state and the last frame id
    seen before it."""

    def __init__(self):
        self.finals = []
        self.last_fid = None

    def after_frame(self, state, fid, fi, out, book):
        self.last_fid = fid
        if fid == SNAPSHOT_FID:
            self.resume = (state._replace(**{k: v.clone() for k, v in state._asdict().items()}),
                           dict(book), copy.deepcopy(out))

    def final_ba(self, state, cfg, camera):
        self.finals.append((int(state.n_frames), self.last_fid))
        return super().final_ba(state, cfg, camera)


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(0)
    scene = CircleScene(rng, n_points=300, n_frames=26)
    feats = features_of(rng, scene)
    scfg = SlamConfig(window=6, loop_gap=10, loop_min_votes=20)
    cam = Pinhole.from_K(scene.K)
    hooks = _Snapshot()
    out = tsd.drive_slam(feats, cam, CFG, scfg, hooks=hooks, device="cpu")
    return dict(feats=feats, scfg=scfg, cam=cam, out=out, snapshot=hooks.resume,
                finals=hooks.finals)


def test_resume_is_bit_identical(dense):
    full = dense["out"]
    out = tsd.drive_slam(dense["feats"], dense["cam"], CFG, dense["scfg"],
                         resume=dense["snapshot"], device="cpu")
    assert out.frame_seq == full.frame_seq
    for name in ("R", "t", "points", "obs_pt", "obs_uv"):
        np.testing.assert_array_equal(getattr(out.rec, name), getattr(full.rec, name),
                                      err_msg=name)
    assert [e[:2] for e in out.loop_edges] == [e[:2] for e in full.loop_edges]
    for a, b in zip(out.odo_edges, full.odo_edges):
        np.testing.assert_array_equal(a[2], b[2])
    assert out.pgo_runs == full.pgo_runs


def test_final_ba_goes_through_hooks(dense):
    """One ``final_ba`` call, on the state after the last frame (26 frames,
    the last frame id 25), whose result is the run's map: the default hook
    is the solve the undecorated engine runs, bit for bit."""
    assert dense["finals"] == [(26, 25)]
    plain = tsd.slam_device(dense["feats"], dense["cam"], CFG, dense["scfg"], device="cpu")
    for name in ("R", "t", "points"):
        np.testing.assert_array_equal(getattr(plain.rec, name), getattr(dense["out"].rec, name),
                                      err_msg=name)
