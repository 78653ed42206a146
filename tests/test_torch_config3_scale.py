"""BASELINE.json config 3 at full size through the port
(``tests/test_pipeline.py::TestConfig3Scale``): a 50-frame sequence of
synthetic features (400 points, a 2.0-radian orbit) through match ->
RANSAC pose -> incremental BA on the CPU, beside the JAX package's
``reconstruct`` on the same features. Gates: the reference's own (all 50
frames, fewer than 600 landmarks: the dedup holds, ATE < 0.1 of a ~7-unit
span) on both packages; RANSAC draws differ, so the two are compared by
those outcomes, not bit for bit. Marked slow as the reference is.
"""

import numpy as np
import pytest
import torch

from fastmatch_tpu.core.camera import Pinhole as JPinhole
from fastmatch_tpu.pipeline import config as jconfig
from fastmatch_tpu.pipeline.reconstruct import reconstruct as j_reconstruct
from synth import SyntheticScene
from test_pipeline import synthetic_features

from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline.config import BAConfig, MapConfig, PipelineConfig
from fastmatch_tpu_torch.pipeline.reconstruct import reconstruct
from fastmatch_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)


@pytest.mark.slow
def test_fifty_frame_sequence():
    rng = np.random.default_rng(0)
    scene = SyntheticScene(rng, n_points=400, n_frames=50, span=2.0)
    feats = synthetic_features(rng, scene, noise_px=0.3)
    kw = dict(ba=dict(interval=5, max_iters=8, pcg_iters=30),
              map=dict(max_frames=64, max_points=16384, max_obs=131072, dedup_desc_d2=0.5))
    cfg = PipelineConfig(ba=BAConfig(**kw["ba"]), map=MapConfig(**kw["map"]))
    jcfg = jconfig.PipelineConfig(ba=jconfig.BAConfig(**kw["ba"]),
                                  map=jconfig.MapConfig(**kw["map"]))
    assert cfg.config_hash() == jcfg.config_hash()
    gt = np.einsum("fji,fj->fi", scene.R, -scene.t)
    rec = reconstruct(feats, Pinhole.from_K(scene.K), cfg, device="cpu")
    jrec = j_reconstruct(feats, JPinhole.from_K(scene.K), jcfg)
    for r in (rec, jrec):
        assert r.n_frames == 50
        assert int(r.pt_mask.sum()) < 600
        assert float(ate_rmse(r.camera_centers(), gt)) < 0.1
