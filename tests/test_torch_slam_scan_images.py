"""``slam_scan_images`` of the port (CPU): SIFT inside the scan loop, on
tests/test_slam_scan.py's 6-frame rendered scene (60 points, 480x360,
capacity 512, BAConfig(interval=2, max_iters=8, pcg_iters=30),
MapConfig(max_frames=16, max_points=2048, max_obs=16384), RANSAC
min_inliers 10 and 3 px, ratio 0.85, closure off). The JAX package's test
of it is marked slow (its scan compiles SIFT); the port's holds it to that
test's bounds (every frame tracked, ATE under 0.35) and to the port's own
``slam_scan`` on the same detector's features (``detect_features``), bit
for bit: the loop detects each frame as ``detect_features`` does and then
runs the same steps.
"""

import dataclasses

import numpy as np
import torch

from synth import SyntheticScene, render_scene_views

from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline.config import BAConfig, MapConfig, PipelineConfig
from fastmatch_tpu_torch.pipeline.reconstruct import detect_features
from fastmatch_tpu_torch.pipeline.slam import SlamConfig
from fastmatch_tpu_torch.pipeline.slam_scan import slam_scan, slam_scan_images
from fastmatch_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)


def test_images_in_scan():
    rng = np.random.default_rng(4)
    scene = SyntheticScene(rng, n_points=60, n_frames=6, image_size=(480, 360))
    views = render_scene_views(scene, rng, image_size=(480, 360))
    cfg = PipelineConfig(ba=BAConfig(interval=2, max_iters=8, pcg_iters=30),
                         map=MapConfig(max_frames=16, max_points=2048, max_obs=16384))
    cfg = dataclasses.replace(
        cfg, sift=cfg.sift._replace(capacity=512),
        ransac=dataclasses.replace(cfg.ransac, min_inliers=10, thr_px=3.0),
        matching=dataclasses.replace(cfg.matching, ratio=0.85))
    scfg = SlamConfig(window=8, loop_gap=10 ** 6, loop_min_votes=10 ** 9)
    cam = Pinhole.from_K(scene.K)
    out = slam_scan_images(views, cam, cfg, scfg, device="cpu")
    assert out.rec.n_frames == 6 and out.frame_seq == list(range(6))
    gt = np.einsum("fji,fj->fi", scene.R, -scene.t)
    ate = float(ate_rmse(out.rec.camera_centers(), gt))
    assert ate < 0.35, f"image-scan ATE {ate:.3f}"
    assert out.rec.stage_seconds["sift"] > 0
    ref = slam_scan(detect_features(views, cfg, "cpu"), cam, cfg, scfg, device="cpu")
    assert ref.frame_seq == out.frame_seq
    for name in ("R", "t", "points", "obs_pt", "obs_uv", "pt_desc"):
        np.testing.assert_array_equal(getattr(out.rec, name), getattr(ref.rec, name),
                                      err_msg=name)
