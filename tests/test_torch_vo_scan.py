"""The port's scan VO engine (fastmatch_tpu_torch/pipeline/vo_scan.py, CPU)
beside the JAX package's on tests/test_vo_scan.py's fixtures.

The JAX figures are ``vo_fixtures.JAX`` (``slow``: ``test_jax_figures_live``
re-derives them). Gates: every frame posed in both and no PnP fallback on
the clean orbit, keyframes within 1, points within 10%, ATE < 0.3 and at
most 2x the JAX run's; the occlusion case's fallback at the blanked frame
and ATE < 0.6 off the blanked span in both; two port runs bit-identical; a
non-keyframe leaves the map bit-equal. Also the VO configurations and the
scan state carried across by ``interop``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import vo_fixtures as fx
from vo_fixtures import JAX

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import vo as tvo
from fastmatch_tpu_torch.pipeline import vo_scan as tscan

torch.set_num_threads(1)

SCENE, VIEWS = fx.vo_scene()
GT = fx.centers(SCENE.R, SCENE.t)
CAM = Pinhole.from_K(SCENE.K)
CFG = fx.pipeline_config("fastmatch_tpu_torch", fx.SMALL_CFG)
VO = tvo.VOConfig(**fx.VO_CFG)


def _run(views):
    return tscan.visual_odometry_scan(views, CAM, CFG, VO, device="cpu")


@pytest.fixture(scope="module")
def port_run():
    return _run(VIEWS)


def test_sequence_beside_jax(port_run):
    t, j = fx.summary(port_run, GT), JAX["scan"]
    assert t["n_frames"] == j["n_frames"] == t["posed"] == j["posed"] == len(VIEWS)
    assert t["pnp_failed"] == j["pnp_failed"] == []
    assert abs(t["keyframes"] - j["keyframes"]) <= 1 and t["keyframes"] >= 3
    assert abs(t["n_points"] - j["n_points"]) <= 0.1 * j["n_points"]
    assert t["ate"] < 0.3 and t["ate"] <= 2.0 * j["ate"]
    assert [s["frame"] for s in port_run.frame_stats] == list(range(len(VIEWS)))


def test_two_runs_bit_identical(port_run):
    again = _run(VIEWS)
    for name in ("R", "t", "points", "obs_cam", "obs_pt", "obs_uv", "obs_mask"):
        np.testing.assert_array_equal(getattr(again, name), getattr(port_run, name))


def test_occlusion_recovery_beside_jax():
    keep = np.ones(len(VIEWS), bool)
    keep[13:17] = False
    t = fx.summary(_run(fx.occluded(VIEWS)), GT, keep)
    j = JAX["scan_occluded"]
    assert t["n_frames"] == t["posed"] == len(VIEWS)
    assert 14 in t["pnp_failed"] and 14 in j["pnp_failed"]
    assert t["ate"] < 0.6 and j["ate"] < 0.6


def test_non_keyframe_leaves_the_map_bit_equal():
    """With a keyframe gate of 15 px of median flow some frames are not
    keyframes; each of those writes its pose row and the slots, nothing else."""
    vo = dataclasses.replace(VO, kf_px=15.0, kf_min_tracked=10)
    dev = torch.device("cpu")
    stack = torch.from_numpy(np.stack(VIEWS[:14]))
    thr = float(np.float32((CFG.ransac.thr_px / float(CAM.fx)) ** 2))
    rec, boot = tscan._fast_bootstrap(stack, 14, CAM, CFG, vo, thr, 0, dev)
    tcfg = tscan._static_from_cfg(CFG, vo, CAM)
    fb = boot["frame"]
    state = tscan._initial_state(rec, boot, tscan.build_pyramid(stack[fb], VO.klt, dev),
                                 CAM, dev)
    # The carried state's numpy round trip is exact.
    back = interop.vo_scan_state_from_numpy(interop.vo_scan_state_to_numpy(state), "cpu")
    for a, b in zip(back, state):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    kinds = []
    map_fields = ("points", "pt_mask", "obs_cam", "obs_pt", "obs_uv", "obs_mask", "n_points",
                  "n_obs", "n_kfs", "last_ba_kf", "kf_pos", "first_frame", "lid")
    for fi in range(fb + 1, 14):
        new, row = tscan._scan_frame(state, fi, stack[fi], 0, thr, tcfg)
        is_kf = bool(row[tscan.VOScanInfo._fields.index("is_kf")])
        kinds.append(is_kf)
        if not is_kf:
            for name in map_fields:
                assert torch.equal(getattr(new, name), getattr(state, name)), name
            assert bool(new.pose_mask[fi]) and not torch.equal(new.pos, state.pos)
        state = new
    assert False in kinds and True in kinds


def test_masked_median_as_numpy():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7, 8):
        v = rng.random(12).astype(np.float32)
        m = np.zeros(12, bool)
        m[rng.permutation(12)[:n]] = True
        got = float(tscan._masked_median(torch.from_numpy(v), torch.from_numpy(m)))
        want = float(np.median(v[m].astype(np.float64).astype(np.float32))) if n else np.inf
        assert got == pytest.approx(want, rel=1e-6) if n else got == want


def test_configs_carried_across():
    from fastmatch_tpu.dense.stereo import StereoConfig
    from fastmatch_tpu.features.klt import KLTConfig
    from fastmatch_tpu.pipeline.stereo_vo import StereoVOConfig
    from fastmatch_tpu.pipeline.vo import VOConfig
    from fastmatch_tpu.pipeline.vo_scan import VOScanStatic

    j = VOConfig(capacity=256, kf_px=9.0, klt=KLTConfig(levels=4, win=9))
    t = interop.vo_config_from(j)
    assert t == tvo.VOConfig(capacity=256, kf_px=9.0, klt=tvo.KLTConfig(levels=4, win=9))
    js = StereoVOConfig(min_disp=2.0, stereo=StereoConfig(max_disp=32))
    ts = interop.stereo_vo_config_from(js)
    assert ts.stereo.max_disp == 32 and ts.min_disp == 2.0 and type(ts.klt) is tvo.KLTConfig
    assert interop.klt_config_from(KLTConfig())._asdict() == KLTConfig()._asdict()
    assert interop.stereo_config_from(StereoConfig())._asdict() == StereoConfig()._asdict()
    st = interop.vo_scan_static_from(VOScanStatic(cap=128, cam_model="fisheye"))
    assert st == tscan.VOScanStatic(cap=128, cam_model="fisheye")


def test_entry_point_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tscan.visual_odometry_scan(VIEWS[:3], CAM, CFG, VO)


@pytest.mark.slow
def test_jax_figures_live():
    """The JAX package's scan engine on this fixture still gives ``JAX["scan"]``."""
    from fastmatch_tpu.core.camera import Pinhole as JPinhole
    from fastmatch_tpu.pipeline.vo import VOConfig
    from fastmatch_tpu.pipeline.vo_scan import visual_odometry_scan

    rec = visual_odometry_scan(VIEWS, JPinhole.from_K(SCENE.K),
                               fx.pipeline_config("fastmatch_tpu", fx.SMALL_CFG),
                               VOConfig(**fx.VO_CFG))
    got, want = fx.summary(rec, GT), JAX["scan"]
    for k in ("n_frames", "posed", "pnp_failed", "keyframes", "n_points", "n_obs", "boot"):
        assert got[k] == want[k], k
    assert got["ate"] == pytest.approx(want["ate"], rel=1e-3)
