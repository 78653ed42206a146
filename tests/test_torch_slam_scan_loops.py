"""Post-hoc loop closure in the port's scan engine (CPU), on
tests/test_slam_scan.py's 26-frame CircleScene with closure on (capacity
512, BAConfig(interval=5, max_iters=8, pcg_iters=30), MapConfig(
max_frames=32, max_points=4096, max_obs=32768), SlamConfig(window=6,
loop_gap=10, loop_min_votes=20)):

``slam_scan(close_loops=True)``, post-hoc closure from the recorded votes,
against the JAX package's on the same features: the same loop edges, one
PGO run, every frame tracked, the ATE under the JAX test's bound (0.25) and
within ATE_FACTOR of the JAX run's. (``slam_chunked``'s closures are in
test_torch_slam_chunked_loops.py.)
"""

import numpy as np
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

ATE_FACTOR = 4.0
CFG = PipelineConfig(ba=BAConfig(interval=5, max_iters=8, pcg_iters=30),
                     map=MapConfig(max_frames=32, max_points=4096, max_obs=32768))
SCFG = SlamConfig(window=6, loop_gap=10, loop_min_votes=20)


def _circle(seed):
    rng = np.random.default_rng(seed)
    scene = CircleScene(rng, n_points=300, n_frames=26)
    return scene, features_of(rng, scene), -np.einsum("fji,fj->fi", scene.R, scene.t)


def _ate(out, gt):
    return float(ate_rmse(out.rec.camera_centers(), gt[np.asarray(out.frame_seq)]))


def test_posthoc_loop_closure_as_jax():
    scene, feats, gt = _circle(0)
    ref = jslam_scan(feats, JPinhole.from_K(scene.K), CFG, SCFG, close_loops=True)
    out = slam_scan(feats, Pinhole.from_K(scene.K), interop.config_from(CFG), SCFG,
                    close_loops=True, device="cpu")
    assert out.frame_seq == ref.frame_seq == list(range(26))
    assert len(out.loop_edges) >= 1
    assert [e[:2] for e in out.loop_edges] == [e[:2] for e in ref.loop_edges]
    assert all(f - c >= 10 for f, c, *_ in out.loop_edges)
    assert out.pgo_runs == ref.pgo_runs == 1
    ate, ref_ate = _ate(out, gt), _ate(ref, gt)
    assert ate < 0.25, f"post-hoc-closure ATE {ate:.4f}"
    assert ate <= ATE_FACTOR * ref_ate, f"ATE {ate:.4f}, JAX {ref_ate:.4f}"
