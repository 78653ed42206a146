"""The slice as a whole: the port's incremental SfM (fastmatch_tpu_torch,
CPU) on the scenes the JAX package's own pipeline tests use.

- Synthetic features (tests/test_pipeline.py's ``synthetic_features`` and
  small config, the 10-frame 300-point scene of
  ``TestReconstruct::test_sequence_ate``): the port must reach the ATE <
  0.05 and ``n_frames == 10`` the JAX package is held to there. The JAX
  ``reconstruct`` is not re-run here (its XLA compiles alone take over a
  minute on a CPU); the JAX side of the slice is the ``run_ba`` comparison.
- ``Reconstruction.run_ba`` from one map state carried across with
  ``interop``: initial and final costs within rtol 1e-4 of the JAX
  package's (float32 sums in a different order, see test_torch_ba.py).
- ``reconstruct(images=...)`` on 5 rendered 480x360 frames at SIFT capacity
  512, with tests/test_cli_images.py's settings: ATE < 0.35, as there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastmatch_tpu.core.camera import Pinhole as JPinhole
from fastmatch_tpu.pipeline import config as jconfig
from fastmatch_tpu.pipeline.reconstruct import Reconstruction as JReconstruction
from synth import SyntheticScene, render_scene_views
from test_pipeline import synthetic_features

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import config as tconfig
from fastmatch_tpu_torch.pipeline.reconstruct import STAGES, reconstruct
from fastmatch_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)


def jax_small_cfg():
    return jconfig.PipelineConfig(
        ba=jconfig.BAConfig(interval=4, max_iters=10, pcg_iters=30),
        map=jconfig.MapConfig(max_frames=16, max_points=2048, max_obs=16384),
    )


def gt_centers(scene):
    return -np.einsum("fji,fj->fi", scene.R, scene.t)


def test_config_hash_matches_jax():
    assert tconfig.PipelineConfig().config_hash() == jconfig.PipelineConfig().config_hash()
    j = jax_small_cfg()
    assert interop.config_from(j).config_hash() == j.config_hash()
    # The backend name is carried as it is (the port takes the JAX names),
    # so the carried config keeps its hash.
    j = jconfig.PipelineConfig(matching=jconfig.MatchingConfig(backend="jnp", ratio=0.7))
    assert interop.config_from(j).matching == tconfig.MatchingConfig(backend="jnp", ratio=0.7)
    assert interop.config_from(j).config_hash() == j.config_hash()


def test_sequence_ate_synthetic_features(rng):
    scene = SyntheticScene(rng, n_points=300, n_frames=10)
    feats = synthetic_features(rng, scene, noise_px=0.3)
    cam = Pinhole.from_K(scene.K)
    rec = reconstruct(feats, cam, interop.config_from(jax_small_cfg()), device="cpu")
    assert rec.n_frames == 10
    assert rec.pose_mask[:10].all()
    ate = float(ate_rmse(rec.camera_centers(), gt_centers(scene)[:10]))
    assert ate < 0.05, f"ATE {ate:.4f}"
    assert set(rec.stage_seconds) == set(STAGES)
    assert rec.stage_seconds["match"] > 0 and rec.stage_seconds["ba"] > 0


def _map_state(seed=5, n_frames=6, n_points=200, perturb=0.02):
    """A JAX Reconstruction holding a perturbed map of a synthetic scene:
    every visible (frame, point) pair observed, noisy normalized uv."""
    rng = np.random.default_rng(seed)
    scene = SyntheticScene(rng, n_points=n_points, n_frames=n_frames, noise_px=0.3)
    cfg = jax_small_cfg()
    cam = JPinhole.from_K(scene.K)
    rec = JReconstruction(cfg=cfg, camera=cam)
    rec.R[:n_frames] = scene.R
    rec.t[:n_frames] = scene.t
    rec.t[2:n_frames] += perturb * rng.standard_normal((n_frames - 2, 3))
    rec.pose_mask[:n_frames] = True
    rec.n_frames = n_frames
    seen = scene.visible.sum(0) >= 2
    X = scene.points[seen] + perturb * rng.standard_normal((seen.sum(), 3))
    ids = rec.add_points(X.astype(np.float32), np.zeros((seen.sum(), 128), np.float32))
    for f in range(n_frames):
        vis = scene.visible[f][seen]
        uv = (scene.pixels[f][seen][vis] - scene.K[:2, 2]) / scene.K[0, 0]
        rec.add_observations(f, ids[vis], uv.astype(np.float32))
    return rec, scene


def test_map_state_round_trip():
    jrec, scene = _map_state()
    state = interop.reconstruction_to_numpy(jrec)
    trec = interop.reconstruction_from_numpy(state, interop.config_from(jrec.cfg),
                                             Pinhole.from_K(scene.K), device="cpu")
    back = interop.reconstruction_to_numpy(trec)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)
        if isinstance(v, np.ndarray):
            assert back[k].dtype == getattr(jrec, k).dtype


@pytest.mark.parametrize("free_second_cam", [False, True])
def test_run_ba_vs_jax(free_second_cam):
    jrec, scene = _map_state()
    trec = interop.reconstruction_from_numpy(interop.reconstruction_to_numpy(jrec),
                                             interop.config_from(jrec.cfg),
                                             Pinhole.from_K(scene.K), device="cpu")
    jc0, jc1 = jrec.run_ba(free_second_cam=free_second_cam)
    tc0, tc1 = trec.run_ba(free_second_cam=free_second_cam)
    np.testing.assert_allclose(tc0, jc0, rtol=1e-4)
    np.testing.assert_allclose(tc1, jc1, rtol=1e-4, atol=1e-4 * jc0)
    assert tc1 < 0.5 * tc0
    live = jrec.pose_mask
    np.testing.assert_allclose(trec.t[live], jrec.t[live], atol=1e-3)
    np.testing.assert_allclose(trec.points[jrec.pt_mask], jrec.points[jrec.pt_mask],
                               atol=2e-3)
    if free_second_cam:
        # The monocular scale gauge |t1| = 1 is restored after the solve.
        np.testing.assert_allclose(np.linalg.norm(trec.t[1]), 1.0, rtol=1e-5)


def test_reconstruct_from_rendered_images():
    # tests/test_cli_images.py's scene and settings, through the port.
    rng = np.random.default_rng(4)
    scene = SyntheticScene(rng, n_points=60, n_frames=5, image_size=(480, 360))
    views = render_scene_views(scene, rng, image_size=(480, 360))
    j = jconfig.PipelineConfig(
        sift=jconfig.SIFTConfig(capacity=512),
        ba=jconfig.BAConfig(interval=2),
        ransac=jconfig.RansacConfig(min_inliers=10, thr_px=3.0),
        matching=jconfig.MatchingConfig(ratio=0.85),
    )
    K = np.array([[500.0, 0, 240.0], [0, 500.0, 180.0], [0, 0, 1.0]])
    rec = reconstruct(None, Pinhole.from_K(K), interop.config_from(j), images=views,
                      device="cpu")
    assert rec.n_frames == 5
    assert int(rec.pt_mask.sum()) > 30
    ate = float(ate_rmse(rec.camera_centers(), gt_centers(scene)))
    assert ate < 0.35, ate
    assert rec.stage_seconds["sift"] > 0


def test_ate_matches_jax_evaluation(rng):
    from fastmatch_tpu.utils.evaluation import ate_rmse as j_ate

    est = rng.standard_normal((12, 3))
    gt = 2.0 * est @ np.linalg.qr(rng.standard_normal((3, 3)))[0].T + 0.3
    gt += 0.01 * rng.standard_normal(gt.shape)
    np.testing.assert_allclose(float(ate_rmse(est, gt)),
                               float(j_ate(jnp.asarray(est, jnp.float32),
                                           jnp.asarray(gt, jnp.float32))),
                               rtol=1e-3)


def test_reconstruct_default_device_is_cuda(rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    scene = SyntheticScene(rng, n_points=50, n_frames=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        reconstruct(synthetic_features(rng, scene), Pinhole.from_K(scene.K))


def test_reconstruct_with_the_jax_backend_name():
    """A config naming the JAX package's "pallas" backend hashes as it does
    there and runs the port's reconstruct (the kernel route, which takes
    its plain version on CPU tensors)."""
    j = jconfig.PipelineConfig(matching=jconfig.MatchingConfig(backend="pallas"),
                               ba=jconfig.BAConfig(interval=3, max_iters=6, pcg_iters=20),
                               map=jconfig.MapConfig(max_frames=8, max_points=2048,
                                                     max_obs=16384))
    cfg = interop.config_from(j)
    assert cfg.matching.backend == "pallas" and cfg.config_hash() == j.config_hash()
    rng = np.random.default_rng(3)
    scene = SyntheticScene(rng, n_points=200, n_frames=6)
    rec = reconstruct(synthetic_features(rng, scene, noise_px=0.3), Pinhole.from_K(scene.K),
                      cfg, device="cpu")
    assert rec.n_frames == 6
    assert float(ate_rmse(rec.camera_centers(), gt_centers(scene)[:6])) < 0.05
