"""The port's two-view solvers (fastmatch_tpu_torch, CPU) against the JAX
package's: ``smallest_eigvecs(k)``, the 5-point solver's stages and
outcomes, ``ransac_essential(solver="5pt")``, the 7- and 8-point
fundamental solvers and the closed-form cubic, ``ransac_fundamental`` fed
the JAX package's sample indices, ``verify_matches`` and the two pose
helpers.

Tolerances, with reasons. Both sides run float32 and reduce sums in other
orders. The 5-point nullspace is 4-dimensional with four near-zero
eigenvalues, so its basis is fixed only up to a rotation inside the space:
the test holds the subspace (its projector, 1e-4) and not the vectors. The
constraint matrix is a fixed polynomial of the basis (1e-5 of its largest
entry); the Gauss-Jordan result pivots on the same rows and agrees to 1e-4
of its largest entry. The root scan (sign changes, bisection) turns a
rounding difference near zero into another candidate set, so the solver
is judged on outcomes: the true E among the valid candidates (max entry
error < 1e-3 up to sign, the JAX package's own gate) and every valid
candidate an exact solution (Sampson error < 1e-6). RANSAC fed the JAX
package's indices gives its model to 1e-3 and its inliers to >= 99%.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fastmatch_tpu.core import batched_linalg as jla
from fastmatch_tpu.core.containers import Keypoints as JKeypoints
from fastmatch_tpu.core.containers import Matches as JMatches
from fastmatch_tpu.geometry import epipolar as jepi
from fastmatch_tpu.geometry import five_point as jfp
from fastmatch_tpu.geometry import fundamental as jfun
from fastmatch_tpu.geometry import homography as jhom
from fastmatch_tpu.geometry import ransac as jran
from fastmatch_tpu.matching.verify import verify_matches as j_verify
from synth import SyntheticScene

from fastmatch_tpu_torch.core import batched_linalg as tla
from fastmatch_tpu_torch.core.containers import Keypoints, Matches
from fastmatch_tpu_torch.geometry import epipolar as tepi
from fastmatch_tpu_torch.geometry import five_point as tfp
from fastmatch_tpu_torch.geometry import fundamental as tfun
from fastmatch_tpu_torch.geometry import homography as thom
from fastmatch_tpu_torch.geometry import ransac as tran
from fastmatch_tpu_torch.matching.verify import verify_matches

torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _up_to_sign_err(a, b):
    a, b = N(a), N(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def _rot(w):
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _rot_err_deg(R, R_gt):
    c = (np.trace(N(R) @ np.asarray(R_gt).T) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def _minimal_problems(seed, n):
    """n random 5-point problems (the JAX package's test_geometry fixture):
    (x1 (n, 5, 2), x2 (n, 5, 2), E_gt (n, 3, 3) unit norm)."""
    rng = np.random.default_rng(seed)
    x1s, x2s, Es = [], [], []
    for _ in range(n):
        X = np.column_stack([rng.uniform(-1.5, 1.5, (5, 2)), rng.uniform(2.0, 6.0, 5)])
        R = _rot(rng.standard_normal(3) * 0.2)
        t = rng.standard_normal(3)
        t /= np.linalg.norm(t)
        X2 = X @ R.T + t
        x1s.append(X[:, :2] / X[:, 2:3])
        x2s.append(X2[:, :2] / X2[:, 2:3])
        E = np.asarray(jepi.essential_from_pose(jnp.asarray(R, jnp.float32),
                                                jnp.asarray(t, jnp.float32)))
        Es.append(E / np.linalg.norm(E))
    return (np.stack(x1s).astype(np.float32), np.stack(x2s).astype(np.float32),
            np.stack(Es))


def _projector(V):
    V = N(V)
    return np.einsum("...ik,...jk->...ij", V, V)


@pytest.mark.parametrize("k", [2, 4])
def test_smallest_eigvecs_k(k):
    rng = np.random.default_rng(k)
    A = rng.standard_normal((32, 9 - k, 9)).astype(np.float32)
    M = np.einsum("bpi,bpj->bij", A, A).astype(np.float32)
    V = tla.smallest_eigvecs(T(M), k=k)
    jV = jax.jit(lambda m: jla.smallest_eigvecs(m, k=k))(jnp.asarray(M))
    assert V.shape == (32, 9, k)
    np.testing.assert_allclose(_projector(V), _projector(jV), atol=1e-4)
    np.testing.assert_allclose(N(V.transpose(-1, -2) @ V), np.broadcast_to(np.eye(k), (32, k, k)),
                               atol=1e-5)
    # k = 1 is the first column of the same solve, and unchanged.
    assert torch.equal(tla.smallest_eigvecs(T(M)), tla.smallest_eigvecs(T(M), k=1))


def test_five_point_stages():
    x1, x2, _ = _minimal_problems(0, 10)
    Eb = tfp._nullspace_basis(T(x1), T(x2))
    h1 = np.concatenate([x1, np.ones_like(x1[..., :1])], -1)
    h2 = np.concatenate([x2, np.ones_like(x2[..., :1])], -1)
    A = (h2[..., :, None] * h1[..., None, :]).reshape(10, 5, 9)
    ATA = np.einsum("...pi,...pj->...ij", A, A).astype(np.float32)
    jN = np.asarray(jax.jit(lambda m: jla.smallest_eigvecs(m, k=4))(jnp.asarray(ATA)))
    jEb = np.moveaxis(jN, -1, -2).reshape(10, 4, 3, 3)
    np.testing.assert_allclose(_projector(N(Eb).reshape(10, 4, 9).transpose(0, 2, 1)),
                               _projector(jN), atol=1e-4)
    C = tfp._constraint_matrix(T(jEb))
    jC = np.asarray(jax.jit(jfp._constraint_matrix)(jnp.asarray(jEb)))
    np.testing.assert_allclose(N(C), jC, atol=1e-5 * np.abs(jC).max())
    M = tfp._gauss_jordan(T(jC))
    jM = np.asarray(jax.jit(jfp._gauss_jordan)(jnp.asarray(jC)))
    np.testing.assert_allclose(N(M), jM, atol=1e-4 * np.abs(jM).max())


def test_five_point_outcomes():
    x1, x2, E_gt = _minimal_problems(1, 10)
    Es, valid = tfp.five_point_essential(T(x1), T(x2))
    assert Es.shape == (10, 32, 3, 3) and valid.shape == (10, 32)
    Es, valid = N(Es), N(valid)
    for i in range(10):
        assert valid[i].any()
        errs = [_up_to_sign_err(Es[i, s], E_gt[i]) for s in range(32) if valid[i, s]]
        assert min(errs) < 1e-3, f"problem {i}: best candidate {min(errs)}"
        samp = N(tepi.sampson_error(T(Es[i][valid[i]]), T(x1[i])[None], T(x2[i])[None]))
        assert samp.max() < 1e-6


def _outlier_scene(seed, P=300):
    """The JAX package's heavy-outlier 5-point fixture."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([rng.uniform(-1.5, 1.5, (P, 2)), rng.uniform(2.0, 6.0, P)])
    R = _rot(rng.standard_normal(3) * 0.08)
    t = np.array([0.4, -0.1, 0.15])
    X2 = X @ R.T + t
    x1 = (X[:, :2] / X[:, 2:3]).astype(np.float32)
    x2 = (X2[:, :2] / X2[:, 2:3]).astype(np.float32)
    x1 += rng.standard_normal(x1.shape).astype(np.float32) * 5e-4
    x2 += rng.standard_normal(x2.shape).astype(np.float32) * 5e-4
    bad = rng.random(P) < 0.6
    x2[bad] = rng.uniform(-1, 1, (int(bad.sum()), 2)).astype(np.float32)
    return x1, x2, np.ones(P, bool), R, bad


def test_ransac_5pt_from_jax_samples():
    x1, x2, mask, R_gt, bad = _outlier_scene(0)
    key = jax.random.PRNGKey(0)
    n_hyp, thr = 128, 1e-4
    ref = jran.ransac_essential(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
                                thr=thr, n_hyp=n_hyp, solver="5pt")
    idx = jran._sample_minimal_sets(key, jnp.asarray(mask), n_hyp, 5)
    res = tran._ransac_essential_from_samples(T(idx).long(), T(x1), T(x2), T(mask), thr, 15)
    assert bool(res.ok) and bool(ref.ok)
    np.testing.assert_allclose(N(res.R), np.asarray(ref.R), atol=1e-3)
    inl = N(res.inliers)
    assert (inl == np.asarray(ref.inliers)).mean() >= 0.99
    assert _rot_err_deg(res.R, R_gt) < 1.5
    assert (inl & bad).sum() <= 0.05 * max(inl.sum(), 1)
    # The port's own draws reach the same outcome.
    own = tran.ransac_essential(T(x1), T(x2), T(mask), thr=thr, n_hyp=n_hyp, solver="5pt",
                                generator=torch.Generator().manual_seed(0), device="cpu")
    assert bool(own.ok) and _rot_err_deg(own.R, R_gt) < 1.5
    with pytest.raises(ValueError, match="solver"):
        tran.ransac_essential(T(x1), T(x2), T(mask), solver="7pt", device="cpu")


def _pixel_pair(seed, noise=0.5, outliers=0.25):
    """Pixel correspondences frames 0 -> 3 of a synthetic scene, with noise
    and a share of outliers: (p0, p1, mask, K, R_rel, t_rel)."""
    rng = np.random.default_rng(seed)
    scene = SyntheticScene(rng, n_points=160, n_frames=6, span=0.6)
    vis = scene.visible[0] & scene.visible[3]
    p0 = scene.pixels[0, vis] + noise * rng.standard_normal((vis.sum(), 2))
    p1 = scene.pixels[3, vis] + noise * rng.standard_normal((vis.sum(), 2))
    n_out = int(outliers * len(p1))
    p1[:n_out] = rng.uniform(0, 640, (n_out, 2))
    R = scene.R[3] @ scene.R[0].T
    t = scene.t[3] - R @ scene.t[0]
    return (p0.astype(np.float32), p1.astype(np.float32), np.ones(len(p0), bool),
            scene.K.astype(np.float32), R.astype(np.float32), t.astype(np.float32))


def test_eight_point_fundamental():
    p0, p1, _, K, R, t = _pixel_pair(3, noise=0.0, outliers=0.0)
    F = tfun.eight_point_fundamental(T(p0), T(p1))
    jF = jax.jit(jfun.eight_point_fundamental)(jnp.asarray(p0), jnp.asarray(p1))
    assert _up_to_sign_err(F, jF) < 1e-4
    w = np.linspace(0.2, 1.0, len(p0)).astype(np.float32)
    Fw = tfun.eight_point_fundamental(T(p0), T(p1), w=T(w))
    jFw = jax.jit(jfun.eight_point_fundamental)(jnp.asarray(p0), jnp.asarray(p1),
                                                w=jnp.asarray(w))
    assert _up_to_sign_err(Fw, jFw) < 1e-4
    # Against the pose: F ~ K^-T [t]x R K^-1.
    E = tepi.essential_from_pose(T(R), T(t))
    jE = jepi.essential_from_pose(jnp.asarray(R), jnp.asarray(t))
    np.testing.assert_allclose(N(E), np.asarray(jE), atol=1e-6)
    F_gt = tfun.fundamental_from_essential(E, T(K), T(K))
    np.testing.assert_allclose(N(F_gt), np.asarray(jfun.fundamental_from_essential(
        jE, jnp.asarray(K), jnp.asarray(K))), rtol=1e-5, atol=1e-9)
    F_gt = N(F_gt) / np.linalg.norm(N(F_gt))
    assert _up_to_sign_err(F, F_gt) < 1e-3


def test_seven_point_fundamental():
    p0, p1, _, _, _, _ = _pixel_pair(4, noise=0.0, outliers=0.0)
    rng = np.random.default_rng(4)
    idx = np.stack([rng.choice(len(p0), 7, replace=False) for _ in range(16)])
    Fs, valid = tfun.seven_point_fundamental(T(p0[idx]), T(p1[idx]))
    jFs, jvalid = jax.jit(jfun.seven_point_fundamental)(jnp.asarray(p0[idx]),
                                                         jnp.asarray(p1[idx]))
    # The 2-dim nullspace's basis is fixed only up to a rotation inside it,
    # which reorders the cubic's roots: hold the candidate sets.
    v, jv = N(valid), np.asarray(jvalid)
    np.testing.assert_array_equal(v.sum(1), jv.sum(1))
    for b in range(16):
        for F in N(Fs)[b][v[b]]:
            assert min(_up_to_sign_err(F, jF) for jF in np.asarray(jFs)[b][jv[b]]) < 1e-3
    # Every valid candidate holds the 7 correspondences it came from.
    h0 = np.concatenate([p0[idx], np.ones((16, 7, 1), np.float32)], -1)
    h1 = np.concatenate([p1[idx], np.ones((16, 7, 1), np.float32)], -1)
    alg = np.einsum("bpi,bsij,bpj->bsp", h1, N(Fs), h0)
    assert np.abs(alg[v]).max() < 1e-3


@pytest.mark.parametrize("case", ["three_real", "one_real", "quadratic", "double_root"])
def test_cubic_roots(case):
    """Away from a double root both packages give the same roots (1e-4 of
    their scale) and numpy's real roots. At the double root of
    (x - 1)^2 (x + 2) the discriminant is 0 up to rounding: both packages
    take the trigonometric branch there and find 1, 1 and -2 to 1e-3."""
    rng = np.random.default_rng(5)
    if case == "three_real":
        r = np.sort(rng.uniform(-3, 3, (64, 3)), axis=1)
        r[:, 1] += 0.5
        r[:, 2] += 1.0
        coef = np.stack([np.poly(x) for x in r]) * rng.uniform(0.5, 2.0, (64, 1))
    elif case == "one_real":
        re = rng.uniform(-2, 2, 64)
        cplx = rng.uniform(-2, 2, 64) + 1j * rng.uniform(0.5, 2, 64)
        coef = np.stack([np.real(np.poly([a, b, np.conj(b)])) for a, b in zip(re, cplx)])
    elif case == "quadratic":
        r = rng.uniform(-3, 3, (64, 2))
        r[:, 1] += 1.0
        coef = np.concatenate([np.zeros((64, 1)), np.stack([np.poly(x) for x in r])], 1)
    else:
        coef = np.array([[1.0, 0.0, -3.0, 2.0]])
    coef = coef.astype(np.float32)
    roots, valid = tfun._cubic_roots(*(T(coef[:, i]) for i in range(4)))
    jroots, jvalid = jax.jit(jfun._cubic_roots)(*(jnp.asarray(coef[:, i]) for i in range(4)))
    np.testing.assert_array_equal(N(valid), np.asarray(jvalid))
    v = N(valid)
    scale = np.abs(np.asarray(jroots)).max()
    np.testing.assert_allclose(N(roots)[v], np.asarray(jroots)[v], atol=1e-4 * scale)
    for b in range(len(coef)):
        got = np.sort(N(roots)[b][v[b]])
        lead = 0 if coef[b, 0] != 0 else 1
        ref = np.roots(coef[b, lead:].astype(np.float64))
        ref = np.sort(ref[np.abs(ref.imag) < 1e-6].real)
        if case == "double_root":
            np.testing.assert_allclose(got, [-2.0, 1.0, 1.0], atol=1e-3)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-3 * max(1.0, np.abs(ref).max()))


def test_ransac_fundamental_from_jax_samples():
    p0, p1, mask, _, _, _ = _pixel_pair(6)
    key = jax.random.PRNGKey(3)
    n_hyp, thr = 128, 4.0
    ref = jfun.ransac_fundamental(key, jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(mask),
                                  thr=thr, n_hyp=n_hyp)
    idx = jran._sample_minimal_sets(key, jnp.asarray(mask), n_hyp, 7)
    res = tfun._ransac_fundamental_from_samples(T(idx).long(), T(p0), T(p1), T(mask), thr, 15)
    assert bool(res.ok) and bool(ref.ok)
    assert _up_to_sign_err(res.F, ref.F) < 1e-3
    inl = N(res.inliers)
    assert (inl == np.asarray(ref.inliers)).mean() >= 0.99
    own = tfun.ransac_fundamental(T(p0), T(p1), T(mask), thr=thr, n_hyp=n_hyp,
                                  generator=torch.Generator().manual_seed(1), device="cpu")
    assert bool(own.ok)
    assert (N(own.inliers) == np.asarray(ref.inliers)).mean() >= 0.97


@pytest.mark.parametrize("model", ["fundamental", "homography"])
def test_verify_matches(model):
    """The port's own draws against the JAX package's: the same trust
    decision, kept sets that agree on >= 97% of the slots, and few
    outliers kept. The homography case maps the points through a known
    homography."""
    p0, p1, _, _, _, _ = _pixel_pair(7, outliers=0.0)
    if model == "homography":
        H = np.array([[1.05, 0.02, 12.0], [-0.03, 0.98, -7.0], [1e-5, -2e-5, 1.0]])
        h = np.concatenate([p0, np.ones((len(p0), 1), np.float32)], 1) @ H.T
        p1 = (h[:, :2] / h[:, 2:]).astype(np.float32)
        p1 += np.random.default_rng(9).normal(0, 0.5, p1.shape).astype(np.float32)
    n = len(p0)
    p1[: int(0.3 * n)] = np.random.default_rng(10).uniform(0, 640, (int(0.3 * n), 2))
    cap = n + 16
    xy_a = np.zeros((cap, 2), np.float32)
    xy_b = np.zeros((cap, 2), np.float32)
    xy_a[:n] = p0
    xy_b[:n] = p1
    mask = np.arange(cap) < n
    rng = np.random.default_rng(7)
    idx = rng.permutation(cap).astype(np.int32)
    xy_b = xy_b[np.argsort(idx)]   # match i -> slot idx[i] holds p1[i]
    valid = mask.copy()
    z = np.zeros(cap, np.float32)
    jkp = [JKeypoints(jnp.asarray(xy), jnp.asarray(z), jnp.asarray(z), jnp.asarray(z),
                      jnp.asarray(mask)) for xy in (xy_a, xy_b)]
    tkp = [Keypoints(T(xy), T(z), T(z), T(z), T(mask)) for xy in (xy_a, xy_b)]
    dist = rng.uniform(0, 1, cap).astype(np.float32)
    ref = j_verify(jax.random.PRNGKey(0), *jkp, JMatches(jnp.asarray(idx), jnp.asarray(dist),
                                                          jnp.asarray(valid)), model=model)
    got = verify_matches(*tkp, Matches(T(idx), T(dist), T(valid)), model=model,
                         generator=torch.Generator().manual_seed(0), device="cpu")
    assert bool(got.ok) == bool(ref.ok)
    keep, jkeep = N(got.matches.valid), np.asarray(ref.matches.valid)
    assert (keep == jkeep).mean() >= 0.97
    assert np.isinf(N(got.matches.dist)[~keep]).all()
    assert bool(got.ok)
    # The outliers are the first 30% of the matches (an epipolar line can
    # pass near a few of them: at most 5% of the kept set).
    assert keep[: int(0.3 * n)].sum() <= 0.05 * keep.sum()
    with pytest.raises(ValueError, match="focal"):
        verify_matches(*tkp, Matches(T(idx), T(dist), T(valid)), model="essential", device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        verify_matches(*tkp, Matches(T(idx), T(dist), T(valid)), model="affine", device="cpu")


def test_homography_from_pose():
    rng = np.random.default_rng(8)
    R = _rot(rng.standard_normal(3) * 0.2).astype(np.float32)
    t = rng.standard_normal(3).astype(np.float32)
    n = rng.standard_normal(3).astype(np.float32)
    n /= np.linalg.norm(n)
    H = thom.homography_from_pose(T(R), T(t), T(n), 2.5)
    jH = jhom.homography_from_pose(jnp.asarray(R), jnp.asarray(t), jnp.asarray(n), 2.5)
    np.testing.assert_allclose(N(H), np.asarray(jH), atol=1e-6)
    # A point on the plane n.X = d maps through H: x2 ~ H x1.
    X = np.array([0.3, -0.2, 0.0], np.float32)
    X[2] = (2.5 - n[:2] @ X[:2]) / n[2]
    x2 = R @ X + t
    h = N(H) @ (X / X[2])
    np.testing.assert_allclose(h[:2] / h[2], x2[:2] / x2[2], atol=1e-4)
