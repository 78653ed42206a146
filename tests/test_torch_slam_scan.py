"""The port's scan engines (fastmatch_tpu_torch.pipeline.slam_scan, CPU)
against its device engine and the JAX package's ``slam_scan``, on
tests/test_slam_scan.py's 20-frame CircleScene with loop closure off
(capacity 512, BAConfig(interval=5, max_iters=8, pcg_iters=30),
MapConfig(max_frames=32, max_points=4096, max_obs=32768), SlamConfig(
window=6, loop_gap=10**6, loop_min_votes=10**9)):

- ``slam_scan`` against ``slam_device`` bit for bit, with the interval
  budgets lifted (where test_slam_scan.py demands bitwise equality of the
  JAX engines) and at the default capped interval budgets (where it
  demands equal decisions and states within 5e-4/5e-3): the port runs one
  eager ``ba_solve`` for both engines, so it holds them bit-identical there
  too;
- ``slam_chunked`` against ``slam_scan`` bit for bit (chunk 7);
- the scan's ATE under the JAX test's bound (0.25) and within ATE_FACTOR of
  the JAX package's ``slam_scan`` on the same features, with the same frames
  tracked.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fastmatch_tpu.core.camera import Pinhole as JPinhole
from fastmatch_tpu.pipeline.config import BAConfig, MapConfig, PipelineConfig
from fastmatch_tpu.pipeline.slam import SlamConfig
from fastmatch_tpu.pipeline.slam_scan import slam_scan as jslam_scan
from test_slam import CircleScene, features_of

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline.slam_device import slam_device
from fastmatch_tpu_torch.pipeline.slam_scan import slam_chunked, slam_scan
from fastmatch_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)

ATE_FACTOR = 4.0


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    scene = CircleScene(rng, n_points=300, n_frames=20)
    feats = features_of(rng, scene)
    cfg = PipelineConfig(ba=BAConfig(interval=5, max_iters=8, pcg_iters=30),
                         map=MapConfig(max_frames=32, max_points=4096, max_obs=32768))
    scfg = SlamConfig(window=6, loop_gap=10 ** 6, loop_min_votes=10 ** 9)
    gt = -np.einsum("fji,fj->fi", scene.R, scene.t)
    return dict(scene=scene, feats=feats, jcfg=cfg, cfg=interop.config_from(cfg), scfg=scfg,
                cam=Pinhole.from_K(scene.K), gt=gt)


@pytest.fixture(scope="module")
def scan(setup):
    s = setup
    return slam_scan(s["feats"], s["cam"], s["cfg"], s["scfg"], device="cpu")


def _uncapped(cfg):
    return dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, interval_max_iters=0,
                                                           interval_pcg_iters=0))


def _same_run(a, b):
    assert a.frame_seq == b.frame_seq
    for name in ("R", "t", "points", "obs_cam", "obs_pt", "obs_uv", "pt_desc"):
        np.testing.assert_array_equal(getattr(a.rec, name), getattr(b.rec, name), err_msg=name)
    assert (a.rec.n_frames, a.rec.n_points, a.rec.n_obs) == (
        b.rec.n_frames, b.rec.n_points, b.rec.n_obs)


@pytest.mark.parametrize("budgets", ["uncapped", "capped"])
def test_matches_slam_device_bitwise(setup, scan, budgets):
    s = setup
    cfg = _uncapped(s["cfg"]) if budgets == "uncapped" else s["cfg"]
    dev = slam_device(s["feats"], s["cam"], cfg, s["scfg"], device="cpu")
    scn = scan if budgets == "capped" else slam_scan(s["feats"], s["cam"], cfg, s["scfg"],
                                                     device="cpu")
    assert scn.frame_seq == list(range(20))
    _same_run(scn, dev)


def test_chunked_matches_scan_bitwise(setup, scan):
    s = setup
    chk = slam_chunked(s["feats"], s["cam"], s["cfg"], s["scfg"], chunk=7, device="cpu")
    _same_run(chk, scan)
    assert chk.loop_edges == [] and chk.pgo_runs == 0


def test_ate_as_jax(setup, scan):
    s = setup
    ref = jslam_scan(s["feats"], JPinhole.from_K(s["scene"].K), s["jcfg"], s["scfg"])
    assert scan.frame_seq == ref.frame_seq
    ate = float(ate_rmse(scan.rec.camera_centers(), s["gt"]))
    ref_ate = float(ate_rmse(ref.rec.camera_centers(), s["gt"]))
    assert ate < 0.25, f"scan ATE {ate:.4f}"
    assert ate <= ATE_FACTOR * ref_ate, f"scan ATE {ate:.4f}, JAX {ref_ate:.4f}"
    assert abs(scan.rec.n_obs - ref.rec.n_obs) <= 0.05 * ref.rec.n_obs
