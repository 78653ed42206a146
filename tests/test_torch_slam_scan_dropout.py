"""Relocalization in the port's scan engines (CPU), on tests/test_slam_scan.py's
20-frame CircleScene with loop closure off and frames 10 and 11 wrecked (5
live keypoints each, so PnP starves): the scan skips them (a failed step
leaves the state unchanged) and the NEXT frame tracks against the whole
map, as the JAX package's ``slam_scan`` does on the same features (the
same frames tracked); the run ends at frame 19 with ATE under 0.3, the JAX
test's bound. (``slam_chunked`` across a slice boundary is in
test_torch_slam_chunked_dropout.py.)
"""

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
from fastmatch_tpu_torch.pipeline.slam_scan import slam_scan
from fastmatch_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def wrecked():
    rng = np.random.default_rng(0)
    scene = CircleScene(rng, n_points=300, n_frames=20)
    feats = list(features_of(rng, scene))
    for k in (10, 11):
        xy, d, m = feats[k]
        m2 = m.copy()
        m2[np.where(m2)[0][5:]] = False
        feats[k] = (xy, d, m2)
    cfg = PipelineConfig(ba=BAConfig(interval=5, max_iters=8, pcg_iters=30),
                         map=MapConfig(max_frames=32, max_points=4096, max_obs=32768))
    scfg = SlamConfig(window=6, loop_gap=10 ** 6, loop_min_votes=10 ** 9)
    ref = jslam_scan(feats, JPinhole.from_K(scene.K), cfg, scfg)
    return dict(feats=feats, cfg=interop.config_from(cfg), scfg=scfg, ref=ref,
                cam=Pinhole.from_K(scene.K), gt=-np.einsum("fji,fj->fi", scene.R, scene.t))


def test_dropout_relocalizes_next_frame(wrecked):
    w = wrecked
    out = slam_scan(w["feats"], w["cam"], w["cfg"], w["scfg"], device="cpu")
    assert 10 not in out.frame_seq and 11 not in out.frame_seq
    assert out.frame_seq == w["ref"].frame_seq
    assert out.frame_seq[-1] == 19
    ate = float(ate_rmse(out.rec.camera_centers(), w["gt"][np.asarray(out.frame_seq)]))
    assert ate < 0.3, f"ATE {ate:.4f} after relocalization"
