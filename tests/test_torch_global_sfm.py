"""The port's global SfM (``fastmatch_tpu_torch/pipeline/global_sfm.py``)
beside the JAX package's, on the CPU.

``build_tracks`` (host union-find) is held equal to the JAX package's on
the same ``pair_matches``, the one-observation-per-frame rule included.
``build_view_graph`` and ``global_reconstruct`` run on tests/test_global_sfm.py's
10-frame fixture with shuffled keypoint order (``global_sfm_fixtures``);
the JAX package's figures there are ``global_sfm_fixtures.JAX`` (its run
takes ~90 s on an 8-core CPU), and ``test_jax_figures_live`` re-derives
them and is ``slow``. RANSAC cannot replay the JAX package's draws, so the
port is judged on outcomes: the same edge set, each edge's relative
rotation within 0.5 degrees of the JAX package's, 10/10 frames, ATE < 0.05
for both and the port's at most 1.5x the JAX package's + 0.005, the BA cost
lowered, more than 100 points and 500 observations.
"""

import numpy as np
import pytest
import torch

import global_sfm_fixtures as fx
from fastmatch_tpu.pipeline import global_sfm as jgs
from global_sfm_fixtures import JAX

from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.pipeline import global_sfm as tgs
from fastmatch_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)

ROT_TOL_DEG = 0.5


def _random_pair_matches(seed, n_frames=6, n_kp=40):
    """Random inlier matches between frame pairs, with same-frame
    collisions (two keypoints of one frame merged into a track)."""
    rng = np.random.default_rng(seed)
    pm = {}
    for i in range(n_frames):
        for j in range(i + 1, min(i + 3, n_frames)):
            k = int(rng.integers(5, 25))
            pm[(i, j)] = np.stack([rng.integers(0, n_kp, k), rng.integers(0, n_kp, k)],
                                  axis=1).astype(np.int64)
    return pm, [n_kp] * n_frames


CASES = {
    "chain": ({(0, 1): np.array([[0, 1], [2, 3]]), (1, 2): np.array([[1, 2]])}, [4, 4, 4]),
    "conflict": ({(0, 1): np.array([[0, 1], [0, 2]])}, [4, 4]),
    "random": _random_pair_matches(7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_tracks_equal(case):
    pm, n_kps = CASES[case]
    got = tgs.build_tracks(pm, n_kps)
    ref = jgs.build_tracks(pm, n_kps)
    assert got[3] == ref[3]
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # At most one observation of a track per frame.
    f, _, t, _ = got
    pairs = set(zip(t.tolist(), f.tolist()))
    assert len(pairs) == len(f)
    capped = tgs.build_tracks(pm, n_kps, max_tracks=1)
    assert capped[3] == min(1, ref[3]) and np.array_equal(capped[0],
                                                          jgs.build_tracks(pm, n_kps,
                                                                           max_tracks=1)[0])


def _run(seed=0):
    """The port's global_reconstruct on the fixture: (rec, view graph)."""
    scene, feats = fx.scene_and_features()
    graphs = []
    build = tgs.build_view_graph

    def keep_graph(*a, **kw):
        out = build(*a, **kw)
        graphs.append(out[0])
        return out

    tgs.build_view_graph = keep_graph
    try:
        rec = tgs.global_reconstruct(feats, Pinhole.from_K(scene.K),
                                     fx.pipeline_config("fastmatch_tpu_torch"),
                                     window=fx.WINDOW, seed=seed, device="cpu")
    finally:
        tgs.build_view_graph = build
    return rec, graphs[0]


@pytest.fixture(scope="module")
def port_run():
    rec, g = _run()
    scene, _ = fx.scene_and_features()
    return rec, g, fx.summary(rec, g, ate_rmse(rec.camera_centers(), fx.gt_centers(scene)))


def _rotvec_to_R(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1)[:, None, None]
    K = np.zeros((len(w), 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
    K = K - K.transpose(0, 2, 1)
    ths = np.where(th > 1e-12, th, 1.0)
    return (np.eye(3) + np.sin(th) / ths * K
            + (1 - np.cos(th)) / ths ** 2 * K @ K)


def test_view_graph_outcomes(port_run):
    _, g, got = port_run
    assert got["edges"] == JAX["edges"]
    Ra = _rotvec_to_R(got["rotvec"])
    Rb = _rotvec_to_R(JAX["rotvec"])
    D = np.einsum("eab,ecb->eac", Ra, Rb)
    ang = np.degrees(np.arccos(np.clip((np.trace(D, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert ang.max() < ROT_TOL_DEG, ang.max()
    assert g.weight.min() >= 24 and bool(g.mask.all())


def test_global_reconstruct_outcomes(port_run):
    rec, _, got = port_run
    assert got["n_frames"] == JAX["n_frames"] == 10
    assert got["ate"] < 0.05 and JAX["ate"] < 0.05
    assert got["ate"] <= 1.5 * JAX["ate"] + 0.005, (got["ate"], JAX["ate"])
    assert got["ba_cost"] < got["ba_cost0"]
    assert got["n_points"] > 100 and got["n_obs"] > 500
    st = rec.frame_stats[-1]
    assert st["stage"] == "global" and st["edges"] == len(JAX["edges"])
    assert set(rec.stage_seconds) == set(tgs.GLOBAL_STAGES)
    assert all(rec.stage_seconds[k] > 0 for k in ("match", "ransac", "averaging", "ba"))
    # Landmark descriptors: each track's first surviving observation's.
    assert np.abs(rec.pt_desc[rec.pt_mask]).sum(1).min() > 0


def test_rerun_bit_identical(port_run):
    rec, *_ = port_run
    again, _ = _run()
    for k in ("R", "t", "points", "obs_cam", "obs_pt", "obs_uv", "obs_mask", "pt_desc"):
        assert np.array_equal(getattr(again, k), getattr(rec, k)), k


def test_entry_point_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    scene, feats = fx.scene_and_features()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgs.global_reconstruct(feats, Pinhole.from_K(scene.K))


@pytest.mark.slow
def test_jax_figures_live():
    """The JAX package's run on the fixture still gives ``JAX``."""
    import jax.numpy as jnp

    from fastmatch_tpu.core.camera import Pinhole as JPinhole
    from fastmatch_tpu.utils.evaluation import ate_rmse as jate

    scene, feats = fx.scene_and_features()
    graphs = []
    build = jgs.build_view_graph

    def keep_graph(*a, **kw):
        out = build(*a, **kw)
        graphs.append(out[0])
        return out

    jgs.build_view_graph = keep_graph
    try:
        rec = jgs.global_reconstruct(feats, JPinhole.from_K(scene.K),
                                     fx.pipeline_config("fastmatch_tpu"), window=fx.WINDOW)
    finally:
        jgs.build_view_graph = build
    got = fx.summary(rec, graphs[0], jate(jnp.asarray(rec.camera_centers()),
                                          jnp.asarray(fx.gt_centers(scene))))
    for k in ("edges", "n_frames", "n_points", "n_obs"):
        assert got[k] == JAX[k], k
    np.testing.assert_allclose(got["rotvec"], JAX["rotvec"], atol=2e-7)
    for k in ("ate", "ba_cost0", "ba_cost"):
        assert got[k] == pytest.approx(JAX[k], rel=1e-3), k
