"""The port's geometry (fastmatch_tpu_torch, CPU) against the JAX package's.

The deterministic solvers get the same numpy inputs on both sides. The
RANSAC estimators cannot share random bits (torch cannot replay JAX's
Gumbel noise), so the test draws the minimal-sample indices with JAX's own
``_sample_minimal_sets`` from JAX's key splits and feeds them to the port's
private ``*_from_samples`` functions, which must then give JAX's result.

Tolerances, with reasons: the fixed-iteration solvers are float32 in both
frameworks but reduce sums in different orders, so results agree to a few
1e-5 relative on well-conditioned inputs (5e-4 where an inverse iteration
on a DLT normal matrix amplifies that noise). Poses from RANSAC are
compared to 1e-3 (rotation entries, unit translation); inlier sets may
differ only at points within rounding of the threshold (>= 99% agreement,
n_inliers within 2).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fastmatch_tpu.core import batched_linalg as jla
from fastmatch_tpu.core.lie import SE3 as JSE3
from fastmatch_tpu.geometry import epipolar as jepi
from fastmatch_tpu.geometry import homography as jhom
from fastmatch_tpu.geometry import pnp as jpnp
from fastmatch_tpu.geometry import ransac as jran
from fastmatch_tpu.geometry.triangulation import triangulate_dlt as j_triangulate
from synth import SyntheticScene

from fastmatch_tpu_torch.core import batched_linalg as tla
from fastmatch_tpu_torch.core.lie import SE3 as TSE3
from fastmatch_tpu_torch.geometry import epipolar as tepi
from fastmatch_tpu_torch.geometry import homography as thom
from fastmatch_tpu_torch.geometry import pnp as tpnp
from fastmatch_tpu_torch.geometry import ransac as tran
from fastmatch_tpu_torch.geometry.triangulation import triangulate_dlt as t_triangulate

torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol):
    np.testing.assert_allclose(N(a), N(b), rtol=tol, atol=tol)


def _up_to_sign(a, b):
    a, b = N(a), N(b)
    s = np.sign((a * b).sum(-1, keepdims=True))
    return a * np.where(s == 0, 1, s), b


def _two_view(seed=0, n=160, noise=0.5, outliers=0.2, planar=False):
    """Normalized correspondences frames 0 -> 1 of a synthetic scene, with
    pixel noise and a share of outliers; returns x0, x1, mask, R_gt, t_gt."""
    rng = np.random.default_rng(seed)
    scene = SyntheticScene(rng, n_points=n, n_frames=6, span=0.6)
    if planar:
        scene.points[:, 2] = 0.0
        scene = _reproject(scene)
    vis = scene.visible[0] & scene.visible[3]
    px0 = scene.pixels[0, vis] + noise * rng.standard_normal((vis.sum(), 2))
    px1 = scene.pixels[3, vis] + noise * rng.standard_normal((vis.sum(), 2))
    n_out = int(outliers * len(px1))
    px1[:n_out] = rng.uniform(0, 640, (n_out, 2))
    K = scene.K
    x0 = ((px0 - K[:2, 2]) / K[0, 0]).astype(np.float32)
    x1 = ((px1 - K[:2, 2]) / K[0, 0]).astype(np.float32)
    R_rel = scene.R[3] @ scene.R[0].T
    t_rel = scene.t[3] - R_rel @ scene.t[0]
    return x0, x1, np.ones(len(x0), bool), R_rel, t_rel / np.linalg.norm(t_rel)


def _reproject(scene):
    cam = np.einsum("fij,pj->fpi", scene.R, scene.points) + scene.t[:, None, :]
    z = cam[..., 2]
    scene.pixels = cam[..., :2] / z[..., None] * 500.0 + scene.K[:2, 2]
    scene.visible = (z > 0.1) & (scene.pixels[..., 0] >= 0) & (scene.pixels[..., 0] < 640) \
        & (scene.pixels[..., 1] >= 0) & (scene.pixels[..., 1] < 480)
    return scene


def _pnp_data(seed=0, noise=0.5, outliers=0.2, planar=False):
    rng = np.random.default_rng(seed)
    scene = SyntheticScene(rng, n_points=200, n_frames=4)
    if planar:
        scene.points[:, 2] = 0.0
        scene = _reproject(scene)
    vis = scene.visible[2]
    X = scene.points[vis].astype(np.float32)
    px = scene.pixels[2, vis] + noise * rng.standard_normal((vis.sum(), 2))
    n_out = int(outliers * len(px))
    px[:n_out] = rng.uniform(0, 640, (n_out, 2))
    x = ((px - scene.K[:2, 2]) / 500.0).astype(np.float32)
    return X, x, np.ones(len(X), bool), scene.R[2], scene.t[2]


# -- core/batched_linalg ------------------------------------------------------


def _psd(rng, b, n, rank_def=1):
    A = rng.standard_normal((b, 2 * n, n)).astype(np.float32)
    A[..., -rank_def:] = A[..., :rank_def] * 0.5 + 1e-4 * A[..., -rank_def:]
    return np.einsum("bpi,bpj->bij", A, A).astype(np.float32)


@pytest.mark.parametrize("n", [4, 9, 12])
def test_smallest_eigvecs(rng, n):
    M = _psd(rng, 64, n)
    a, b = _up_to_sign(tla.smallest_eigvecs(T(M))[..., 0], jax.jit(jla.smallest_eigvecs)(jnp.asarray(M))[..., 0])
    _close(a, b, 5e-4)
    # It is a null-ish vector: the Rayleigh quotient is the smallest eigenvalue.
    v = N(tla.smallest_eigvecs(T(M))[..., 0])
    rq = np.einsum("bi,bij,bj->b", v, M, v)
    lam = np.linalg.eigvalsh(M.astype(np.float64))[:, 0]
    np.testing.assert_allclose(rq, lam, atol=1e-3 * np.abs(M).max())


def test_svd3_and_polar3(rng):
    M = rng.standard_normal((128, 3, 3)).astype(np.float32)
    M[:8, :, 2] = M[:8, :, 0]  # rank-deficient rows
    U, S, Vt = tla.svd3(T(M))
    jU, jS, jVt = jax.jit(jla.svd3)(jnp.asarray(M))
    _close(S, jS, 1e-4)
    _close(U @ torch.diag_embed(S) @ Vt, M, 1e-4)
    _close(U.transpose(-1, -2) @ U, np.broadcast_to(np.eye(3), M.shape), 1e-4)
    R = tla.polar3(T(M))
    _close(R, jax.jit(jla.polar3)(jnp.asarray(M)), 2e-4)
    _close(torch.linalg.det(R), np.ones(128), 1e-4)


def test_orth_complement(rng):
    u = rng.standard_normal((50, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = tla._orth_complement(T(u))
    _close(v, jax.jit(jla._orth_complement)(jnp.asarray(u)), 1e-5)
    _close((v * T(u)).sum(-1), np.zeros(50), 1e-5)


# -- geometry: deterministic solvers -------------------------------------------


def test_eight_point_and_sampson():
    x0, x1, _, R_gt, t_gt = _two_view(outliers=0.0, noise=0.0)
    E = tepi.eight_point_essential(T(x0), T(x1))
    jE = jax.jit(jepi.eight_point_essential)(jnp.asarray(x0), jnp.asarray(x1))
    a, b = _up_to_sign(E.reshape(-1), np.asarray(jE).reshape(-1))
    _close(a, b, 1e-4)
    err = tepi.sampson_error(E, T(x0), T(x1))
    _close(err, jax.jit(jepi.sampson_error)(jE, jnp.asarray(x0), jnp.asarray(x1)), 1e-6)
    assert float(err.max()) < 1e-8
    w = np.linspace(0.2, 1.0, len(x0)).astype(np.float32)
    Ew = tepi.eight_point_essential(T(x0), T(x1), w=T(w))
    jEw = jax.jit(jepi.eight_point_essential)(jnp.asarray(x0), jnp.asarray(x1), w=jnp.asarray(w))
    a, b = _up_to_sign(Ew.reshape(-1), np.asarray(jEw).reshape(-1))
    _close(a, b, 1e-4)


def test_decompose_essential_and_midpoint():
    x0, x1, _, R_gt, t_gt = _two_view(outliers=0.0, noise=0.0)
    E = jax.jit(jepi.eight_point_essential)(jnp.asarray(x0), jnp.asarray(x1))
    Rs, ts = tepi.decompose_essential(T(E))
    jRs, jts = jax.jit(jepi.decompose_essential)(E)
    _close(Rs, jRs, 1e-4)
    _close(ts, jts, 1e-4)
    d1, d2 = tepi.triangulate_midpoint(Rs, ts, T(x0)[None], T(x1)[None])
    jd1, jd2 = jax.jit(jax.vmap(lambda R, t: jepi.triangulate_midpoint(R, t, jnp.asarray(x0),
                                                               jnp.asarray(x1))))(jRs, jts)
    # Depths of the wrong candidates can come from near-parallel rays, where
    # the 2x2 solve is ill-conditioned: compare the well-conditioned ones
    # (|d| < 50, scene depth ~6) to 1e-3 and the signs, which cheirality
    # votes on, everywhere.
    for t_d, j_d in ((N(d1), np.asarray(jd1)), (N(d2), np.asarray(jd2))):
        ok = np.abs(j_d) < 50
        assert ok.mean() > 0.9
        np.testing.assert_allclose(t_d[ok], j_d[ok], rtol=1e-3, atol=1e-3)
        assert (np.sign(t_d) == np.sign(j_d)).mean() >= 0.995


def test_triangulate_dlt():
    rng = np.random.default_rng(3)
    scene = SyntheticScene(rng, n_points=100, n_frames=3)
    x = np.stack([(scene.pixels[f] - scene.K[:2, 2]) / 500.0 for f in range(3)]).astype(np.float32)
    mask = scene.visible[:3].copy()
    mask[1, ::7] = False
    R, t = scene.R[:3].astype(np.float32), scene.t[:3].astype(np.float32)
    pts, ok = t_triangulate(T(R), T(t), T(x), T(mask))
    jpts, jok = jax.jit(j_triangulate)(jnp.asarray(R), jnp.asarray(t), jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_array_equal(N(ok), np.asarray(jok))
    _close(N(pts)[N(ok)], np.asarray(jpts)[N(ok)], 1e-3)
    np.testing.assert_allclose(N(pts)[N(ok)], scene.points[N(ok)], atol=1e-3)


def test_pnp_dlt_and_refine():
    X, x, _, R_gt, t_gt = _pnp_data(outliers=0.0, noise=0.0)
    pose = tpnp.pnp_dlt(T(X), T(x))
    jpose = jax.jit(jpnp.pnp_dlt)(jnp.asarray(X), jnp.asarray(x))
    _close(pose.R, jpose.R, 5e-4)
    _close(pose.t, jpose.t, 5e-4)
    np.testing.assert_allclose(N(pose.R), R_gt, atol=1e-3)
    w = np.ones(len(X), np.float32)
    # Start off the solution by a small twist (the same one on both sides).
    tw = np.array([0.05, -0.03, 0.04, 0.01, -0.02, 0.015], np.float32)
    start = TSE3.exp(T(tw)).compose(pose)
    jstart = JSE3.exp(jnp.asarray(tw)).compose(jpose)
    ref = tpnp.refine_pose_gn(start, T(X), T(x), T(w), iters=8)
    jref = jax.jit(partial(jpnp.refine_pose_gn, iters=8))(jstart, jnp.asarray(X), jnp.asarray(x),
                                                          jnp.asarray(w))
    _close(ref.R, jref.R, 1e-4)
    _close(ref.t, jref.t, 1e-4)
    np.testing.assert_allclose(N(ref.t), t_gt, atol=1e-3)


def test_pnp_planar():
    X, x, _, R_gt, t_gt = _pnp_data(outliers=0.0, noise=0.0, planar=True)
    idx = np.arange(0, len(X), max(1, len(X) // 12))[:12]
    pose = tpnp.pnp_planar(T(X[idx]), T(x[idx]))
    jpose = jax.jit(jpnp.pnp_planar)(jnp.asarray(X[idx]), jnp.asarray(x[idx]))
    _close(pose.R, jpose.R, 5e-4)
    _close(pose.t, jpose.t, 5e-4)
    np.testing.assert_allclose(N(pose.R), R_gt, atol=1e-3)


def test_dlt_homography_and_decomposition():
    x0, x1, _, _, _ = _two_view(outliers=0.0, noise=0.0, planar=True)
    H = thom.dlt_homography(T(x0), T(x1))
    jH = jax.jit(jhom.dlt_homography)(jnp.asarray(x0), jnp.asarray(x1))
    _close(H, jH, 1e-4)
    _close(thom.symmetric_transfer_error(H, T(x0), T(x1)),
           jax.jit(jhom.symmetric_transfer_error)(jH, jnp.asarray(x0), jnp.asarray(x1)), 1e-6)
    Rs, ts, ns = thom.decompose_homography(H)
    jRs, jts, jns = jax.jit(jhom.decompose_homography)(jH)
    _close(Rs, jRs, 1e-3)
    _close(ts, jts, 1e-3)
    _close(ns, jns, 1e-3)


# -- RANSAC estimators fed JAX's sample indices ----------------------------------


def _assert_inliers_close(a, b):
    a, b = N(a), np.asarray(b)
    assert (a == b).mean() >= 0.99
    assert abs(int(a.sum()) - int(b.sum())) <= 2


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_essential_from_jax_samples(seed):
    x0, x1, mask, R_gt, t_gt = _two_view(seed=seed)
    key = jax.random.PRNGKey(seed)
    thr, n_hyp = (2.0 / 500.0) ** 2, 128
    ref = jran.ransac_essential(key, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(mask),
                                thr=thr, n_hyp=n_hyp)
    idx = jran._sample_minimal_sets(key, jnp.asarray(mask), n_hyp, 8)
    res = tran._ransac_essential_from_samples(T(idx).long(), T(x0), T(x1), T(mask), thr, 15)
    assert bool(res.ok) == bool(ref.ok) and bool(res.ok)
    _close(res.R, ref.R, 1e-3)
    _close(res.t, ref.t, 1e-3)
    _assert_inliers_close(res.inliers, ref.inliers)
    np.testing.assert_allclose(N(res.R), R_gt, atol=0.05)


@pytest.mark.parametrize("planar", [False, True])
def test_select_two_view_model_from_jax_samples(planar):
    x0, x1, mask, R_gt, _ = _two_view(seed=2, planar=planar)
    key = jax.random.PRNGKey(7)
    thr, n_hyp = (2.0 / 500.0) ** 2, 128
    ref = jhom.select_two_view_model(key, jnp.asarray(x0), jnp.asarray(x1),
                                     jnp.asarray(mask), thr=thr, n_hyp=n_hyp)
    ke, kh = jax.random.split(key)
    idx_e = jran._sample_minimal_sets(ke, jnp.asarray(mask), n_hyp, 8)
    idx_h = jran._sample_minimal_sets(kh, jnp.asarray(mask), n_hyp, 4)
    res = thom._select_two_view_model_from_samples(T(idx_e).long(), T(idx_h).long(), T(x0),
                                                   T(x1), T(mask), thr, 15)
    for f in ("used_homography", "ok", "ambiguous"):
        assert bool(getattr(res, f)) == bool(getattr(ref, f)), f
    assert bool(res.used_homography) == planar
    _close(res.R, ref.R, 1e-3)
    _close(res.t, ref.t, 1e-3)
    _assert_inliers_close(res.inliers, ref.inliers)


def test_ransac_homography_from_jax_samples():
    x0, x1, mask, _, _ = _two_view(seed=3, planar=True)
    key = jax.random.PRNGKey(5)
    thr, n_hyp = 2.0 * (2.0 / 500.0) ** 2, 128
    ref = jhom.ransac_homography(key, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(mask),
                                 thr=thr, n_hyp=n_hyp)
    idx = jran._sample_minimal_sets(key, jnp.asarray(mask), n_hyp, 4)
    res = thom._ransac_homography_from_samples(T(idx).long(), T(x0), T(x1), T(mask), thr, 12)
    assert bool(res.ok) == bool(ref.ok) and bool(res.ok)
    _close(res.H, ref.H, 1e-3)
    _assert_inliers_close(res.inliers, ref.inliers)
    g = torch.Generator().manual_seed(5)
    own = thom.ransac_homography(T(x0), T(x1), T(mask), thr=thr, n_hyp=n_hyp, generator=g,
                                 device="cpu")
    assert bool(own.ok)
    _assert_inliers_close(own.inliers, ref.inliers)


@pytest.mark.parametrize("planar", [False, True])
def test_ransac_pnp_from_jax_samples(planar):
    X, x, mask, R_gt, t_gt = _pnp_data(seed=4, planar=planar)
    key = jax.random.PRNGKey(11)
    thr, n_hyp = (2.0 / 500.0) ** 2, 128
    ref = jpnp.ransac_pnp(key, jnp.asarray(X), jnp.asarray(x), jnp.asarray(mask),
                          thr=thr, n_hyp=n_hyp, min_inliers=6)
    k6, k4 = jax.random.split(key)
    idx6 = jran._sample_minimal_sets(k6, jnp.asarray(mask), n_hyp // 2, 6)
    idx4 = jran._sample_minimal_sets(k4, jnp.asarray(mask), n_hyp - n_hyp // 2, 4)
    res = tpnp._ransac_pnp_from_samples(T(idx6).long(), T(idx4).long(), T(X), T(x),
                                        T(mask), thr, 6)
    assert bool(res.ok) == bool(ref.ok) and bool(res.ok)
    _close(res.pose.R, ref.pose.R, 1e-3)
    _close(res.pose.t, ref.pose.t, 1e-3)
    _assert_inliers_close(res.inliers, ref.inliers)
    np.testing.assert_allclose(N(res.pose.R), R_gt, atol=0.01)


def test_sampler_draws_valid_distinct_indices():
    mask = np.zeros(300, bool)
    mask[::3] = True
    g = torch.Generator().manual_seed(0)
    idx = N(tran._sample_minimal_sets(g, T(mask), 256, 8))
    assert idx.shape == (256, 8)
    assert mask[idx].all()
    assert all(len(set(r)) == 8 for r in idx)


def test_public_estimators_on_cpu():
    x0, x1, mask, R_gt, _ = _two_view(seed=5)
    thr = (2.0 / 500.0) ** 2
    g = torch.Generator().manual_seed(3)
    res = tran.ransac_essential(T(x0), T(x1), T(mask), thr=thr, n_hyp=256, generator=g,
                                device="cpu")
    assert bool(res.ok)
    np.testing.assert_allclose(N(res.R), R_gt, atol=0.02)
    two = thom.select_two_view_model(T(x0), T(x1), T(mask), thr=thr, n_hyp=256,
                                     device="cpu")
    assert bool(two.ok) and not bool(two.used_homography)
    X, x, pmask, R_p, _ = _pnp_data(seed=6)
    pn = tpnp.ransac_pnp(T(X), T(x), T(pmask), thr=thr, n_hyp=128, device="cpu")
    assert bool(pn.ok)
    np.testing.assert_allclose(N(pn.pose.R), R_p, atol=0.01)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tran.ransac_essential(T(x0), T(x1), T(mask))


# -- core/lie and core/camera ------------------------------------------------------


def test_lie_vs_jax(rng):
    from fastmatch_tpu.core.lie import SO3 as JSO3
    from fastmatch_tpu_torch.core.lie import SO3 as TSO3

    w = rng.standard_normal((64, 3)).astype(np.float32)
    w[:4] *= 1e-5                                   # small-angle branch
    w[4:8] *= 3.0 / np.linalg.norm(w[4:8], axis=1, keepdims=True)  # near pi
    R = TSO3.exp(T(w))
    _close(R, jax.jit(JSO3.exp)(jnp.asarray(w)), 1e-5)
    _close(TSO3.log(R), jax.jit(JSO3.log)(jnp.asarray(N(R))), 1e-4)
    tw = rng.standard_normal((64, 6)).astype(np.float32) * 0.5
    a, ja = TSE3.exp(T(tw)), JSE3.exp(jnp.asarray(tw))
    _close(a.t, ja.t, 1e-5)
    b, jb = a.inverse(), ja.inverse()
    _close(b.R, jb.R, 1e-5)
    _close(b.t, jb.t, 1e-5)
    c, jc = a.compose(b), ja.compose(jb)
    _close(c.R, np.broadcast_to(np.eye(3), (64, 3, 3)), 1e-5)
    _close(c.t, jc.t, 1e-5)
    X = rng.standard_normal((64, 3)).astype(np.float32)
    _close(a.apply(T(X)), ja.apply(jnp.asarray(X)), 1e-5)


@pytest.mark.parametrize("dist", [(), (-0.2, 0.05, 0.0, 1e-3, -2e-3)])
def test_normalize_np_vs_jax(rng, dist):
    from fastmatch_tpu.core.camera import Pinhole as JPinhole
    from fastmatch_tpu.core.camera import normalize_np as j_normalize
    from fastmatch_tpu_torch.core.camera import Pinhole as TPinhole
    from fastmatch_tpu_torch.core.camera import normalize_np as t_normalize

    K = np.array([[520.0, 0, 318.0], [0, 515.0, 242.0], [0, 0, 1.0]])
    uv = rng.uniform(0, 640, (200, 2))
    np.testing.assert_allclose(t_normalize(uv, TPinhole.from_K(K, dist)),
                               j_normalize(uv, JPinhole.from_K(K, dist)), rtol=1e-6,
                               atol=1e-7)
