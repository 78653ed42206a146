"""The port's covisibility map-block partition (``dist/partition.py``)
beside the JAX package's (tests/test_partition.py's cases): covisibility
counts, balanced block recovery on a two-cluster scene and degenerate
inputs, each equal to the JAX package's output; the block order and
``partition_problem``'s layout equal to the JAX package's; and, on four
gloo ranks (spawned once, ``dist_ranks.partition_cases``), the partition
feeding distributed BA without changing the solution beyond the
all-reduce's summation order (rtol 1e-3 on the cost, atol 2e-3 on poses
and points), against the default sharded solve and the single-device
``ba_solve`` of both packages.
"""

import numpy as np
import pytest
import torch

import dist_ranks
import jax.numpy as jnp

from fastmatch_tpu.ba.lm import ba_solve as jax_ba_solve
from fastmatch_tpu.ba.problem import BAProblem as JProblem
from fastmatch_tpu.ba.problem import Observations as JObs
from fastmatch_tpu.core.lie import SE3 as JSE3
from fastmatch_tpu.dist import partition as jpart
from fastmatch_tpu_torch.ba import lm as tlm
from fastmatch_tpu_torch.dist import partition as tpart
from fastmatch_tpu_torch.interop import ba_problem_from_numpy

torch.set_num_threads(1)

WORLD = 4


def _two_cluster_obs(rng, n_frames=16, n_points=200, bridge=2):
    """Frames 0..7 see points 0..99, frames 8..15 see points 100..199;
    ``bridge`` frames near the boundary see a few of both."""
    cams, pts = [], []
    for f in range(n_frames):
        lo, hi = (0, 100) if f < n_frames // 2 else (100, 200)
        seen = rng.choice(np.arange(lo, hi), size=40, replace=False)
        if abs(f - n_frames // 2) <= bridge // 2:
            other = rng.choice(np.arange((hi) % 200, (hi) % 200 + 100),
                               size=5, replace=False)
            seen = np.concatenate([seen, other])
        cams.extend([f] * len(seen))
        pts.extend(seen.tolist())
    cam = np.asarray(cams, np.int32)
    pt = np.asarray(pts, np.int32)
    msk = np.ones(len(cam), bool)
    return cam, pt, msk, n_frames, n_points


def _synth_ba_arrays(rng, n_cams=8, n_pts=64, obs_per_cam=24):
    """tests/test_partition.py's _synth_ba_problem as numpy arrays (the
    BAProblem fields in order)."""
    pts = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (n_cams, 1, 1))
    t = np.zeros((n_cams, 3), np.float32)
    t[:, 2] = 4.0 + 0.3 * np.arange(n_cams)
    t[:, 0] = 0.1 * np.arange(n_cams)
    cam_idx = np.repeat(np.arange(n_cams, dtype=np.int32), obs_per_cam)
    pt_idx = np.concatenate([
        rng.integers(0, n_pts // 2, (n_cams // 2) * obs_per_cam),
        rng.integers(n_pts // 2, n_pts, (n_cams - n_cams // 2) * obs_per_cam),
    ]).astype(np.int32)
    p = np.einsum("oij,oj->oi", R[cam_idx], pts[pt_idx]) + t[cam_idx]
    uv = (p[:, :2] / p[:, 2:3]).astype(np.float32)
    uv += 0.001 * rng.standard_normal(uv.shape).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    X = pts + 0.01 * rng.standard_normal(pts.shape).astype(np.float32)
    return (R, t, X, cam_idx, pt_idx, uv, np.ones(len(cam_idx), bool), np.ones(n_cams, bool),
            np.ones(n_pts, bool), fixed)


def _jax_problem(arrs):
    R, t, X, ci, pi, uv, m, cm, pm, fx = (jnp.asarray(a) for a in arrs)
    return JProblem(JSE3(R, t), X, JObs(ci, pi, uv, m), cm, pm, fx)


@pytest.fixture(scope="module")
def arrays():
    return _synth_ba_arrays(np.random.default_rng(5))


@pytest.fixture(scope="module")
def ranks(request, tmp_path_factory, arrays):
    return dist_ranks.once(request, tmp_path_factory, "torch_partition_cases",
                           lambda: dist_ranks.spawn(dist_ranks.partition_cases, WORLD, arrays))


def test_matrix_matches_bruteforce_and_jax():
    rng = np.random.default_rng(0)
    cam, pt, msk, F, P = _two_cluster_obs(rng)
    msk = msk.copy()
    msk[::7] = False  # dead rows must not count
    C = tpart.covisibility_matrix(torch.from_numpy(cam), torch.from_numpy(pt),
                                  torch.from_numpy(msk), F, P)
    assert C.shape == (F, F)
    assert np.array_equal(C, C.T)
    sets = [set(pt[(cam == f) & msk]) for f in range(F)]
    for i in range(F):
        for j in range(F):
            assert C[i, j] == len(sets[i] & sets[j]), (i, j)
    np.testing.assert_array_equal(C, jpart.covisibility_matrix(cam, pt, msk, F, P))


def test_partition_recovers_clusters():
    rng = np.random.default_rng(1)
    cam, pt, msk, F, P = _two_cluster_obs(rng)
    C = tpart.covisibility_matrix(cam, pt, msk, F, P)
    blocks = tpart.partition_frames(C, 2)
    np.testing.assert_array_equal(blocks, jpart.partition_frames(C, 2))
    assert set(blocks.tolist()) == {0, 1}
    left, right = blocks[:6], blocks[10:]
    assert len(set(left.tolist())) == 1 and len(set(right.tolist())) == 1
    assert left[0] != right[0]
    w = np.bincount(blocks, weights=np.diag(C), minlength=2)
    assert w.max() <= 1.5 * np.diag(C).sum() / 2 + np.diag(C).max()


def test_degenerate_inputs():
    C = np.zeros((5, 5), np.int64)
    blocks = tpart.partition_frames(C, 2)
    assert blocks.shape == (5,) and ((blocks >= 0) & (blocks < 2)).all()
    np.testing.assert_array_equal(blocks, jpart.partition_frames(C, 2))
    C2 = np.zeros((3, 3), np.int64)
    C2[0, 0] = 4
    blocks2 = tpart.partition_frames(C2, 4)
    assert ((blocks2 >= 0) & (blocks2 < 4)).all()
    np.testing.assert_array_equal(blocks2, jpart.partition_frames(C2, 4))


def test_block_order_equals_jax(arrays):
    prob = ba_problem_from_numpy(*arrays, device="cpu")
    jp = _jax_problem(arrays)
    C = tpart.covisibility_matrix(prob.obs.cam_idx, prob.obs.pt_idx, prob.obs.mask,
                                  prob.n_cams, prob.n_points)
    blocks = tpart.partition_frames(C, WORLD)
    perm, sizes = tpart.order_observations_by_block(prob.obs, blocks, WORLD)
    jperm, jsizes = jpart.order_observations_by_block(jp.obs, blocks, WORLD)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(sizes, jsizes)
    assert sorted(perm.tolist()) == list(range(len(perm)))
    assert int(sizes.sum()) == int(arrays[6].sum())
    blk_of_row = blocks[arrays[3][perm]]
    assert (np.diff(blk_of_row) >= 0).all()


def test_partition_problem_layout_equals_jax(arrays):
    prob = ba_problem_from_numpy(*arrays, device="cpu")
    prob2, blocks = tpart.partition_problem(prob, WORLD, bucket=8)
    jprob2, jblocks = jpart.partition_problem(_jax_problem(arrays), WORLD, bucket=8)
    np.testing.assert_array_equal(blocks, jblocks)
    for k in ("cam_idx", "pt_idx", "uv", "mask"):
        got = getattr(prob2.obs, k)
        assert got.device == prob.obs.cam_idx.device
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jprob2.obs, k)), err_msg=k)
    S = prob2.obs.mask.shape[0] // WORLD
    pt2 = prob2.obs.pt_idx.numpy().reshape(WORLD, S)
    msk2 = prob2.obs.mask.numpy().reshape(WORLD, S)
    cam2 = prob2.obs.cam_idx.numpy().reshape(WORLD, S)
    for b in range(WORLD):
        assert (np.diff(pt2[b]) >= 0).all(), b
        k = int(msk2[b].sum())
        assert not msk2[b][:S - k].any() and msk2[b][S - k:].all(), b
        assert (blocks[cam2[b][msk2[b]]] == b).all(), b


@pytest.mark.parametrize("layout", ["blocks", "partition"])
def test_partitioned_dist_ba_equals_unpartitioned(ranks, arrays, layout):
    for r in ranks[1:]:
        for k in ("R", "t", "points"):
            np.testing.assert_array_equal(r[layout][k], ranks[0][layout][k])
    got, ref = ranks[0][layout], ranks[0]["plain"]
    assert got["cost"] < got["cost0"]
    port = tlm.ba_solve(ba_problem_from_numpy(*arrays, device="cpu"), device="cpu",
                        max_iters=5, pcg_iters=20)
    jres = jax_ba_solve(_jax_problem(arrays), max_iters=5, pcg_iters=20)
    for cost, t, X in ((ref["cost"], ref["t"], ref["points"]),
                       (float(port.cost), port.poses.t.numpy(), port.points.numpy()),
                       (float(jres.cost), np.asarray(jres.poses.t), np.asarray(jres.points))):
        np.testing.assert_allclose(got["cost"], cost, rtol=1e-3)
        np.testing.assert_allclose(got["t"], t, atol=2e-3)
        np.testing.assert_allclose(got["points"], X, atol=2e-3)
