"""Pose-graph optimization of the port (fastmatch_tpu_torch, CPU) against
the JAX package on the same seeded inputs:

- the Lie groups: SE3.log/retract/identity, Sim3 exp/log/compose/inverse/
  apply, _sim3_W and se3_adjoint at random and near-zero tangents (atol
  1e-5), and forward-mode Jacobians through them at a zero twist (finite,
  equal to jax.jacfwd's to 1e-4);
- edge_residuals, _edge_jacobians and _build_normal_eqs on a 40-pose
  drifted circle with 3 closures (tests/test_posegraph.py's construction,
  rebuilt in numpy), rtol 1e-4;
- pgo_solve dense and PCG with the Huber and Geman kernels, with position
  and pose priors, and with a wrong loop edge: the same iterations, final
  cost within rtol 1e-3, poses within 1e-3;
- (tests/test_torch_posegraph_long.py: pgo_solve_hierarchical on a
  200-pose chain, and the Sim(3) solver on a scale-drift problem.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmatch_tpu.core import lie as jlie
from fastmatch_tpu.posegraph import pgo as jpgo

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core import lie as tlie
from fastmatch_tpu_torch.posegraph import pgo as tpgo

torch.set_num_threads(1)

# The JAX package's helpers, jitted: eager vmap(jacfwd) takes seconds a call.
j_edge_jacobians = jax.jit(jpgo._edge_jacobians)
j_normal_eqs = jax.jit(jpgo._build_normal_eqs, static_argnums=(2, 3))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _tangents(rng, n, dim, scale):
    x = rng.normal(0, scale, (n, dim)).astype(np.float32)
    w = np.linalg.norm(x[:, 3:6], axis=1, keepdims=True)
    x[:, 3:6] *= np.where(w > 3.0, 3.0 / w, 1.0)   # |omega| <= pi: log's canonical range
    return x


# -- Lie groups -------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.7, 1e-5, 0.0])
def test_se3_vs_jax(scale):
    rng = np.random.default_rng(1)
    xi = _tangents(rng, 32, 6, scale)
    tw = _tangents(rng, 32, 6, 0.3)
    J, T = jlie.SE3.exp(jnp.asarray(xi)), tlie.SE3.exp(torch.from_numpy(xi))
    np.testing.assert_allclose(_np(T.log()), _np(J.log()), atol=1e-5)
    Jr, Tr = J.retract(jnp.asarray(tw)), T.retract(torch.from_numpy(tw))
    np.testing.assert_allclose(_np(Tr.R), _np(Jr.R), atol=1e-5)
    np.testing.assert_allclose(_np(Tr.t), _np(Jr.t), atol=1e-5)
    np.testing.assert_allclose(_np(tlie.se3_adjoint(T)), _np(jlie.se3_adjoint(J)), atol=1e-5)
    Ti = tlie.SE3.identity((2, 3), device="cpu")
    Ji = jlie.SE3.identity((2, 3))
    np.testing.assert_array_equal(_np(Ti.R), _np(Ji.R))
    np.testing.assert_array_equal(_np(Ti.t), _np(Ji.t))


@pytest.mark.parametrize("scale", [0.8, 1e-5, 0.0])
def test_sim3_vs_jax(scale):
    rng = np.random.default_rng(2)
    a, b = _tangents(rng, 32, 7, scale), _tangents(rng, 32, 7, 0.5)
    x = rng.normal(0, 1, (32, 3)).astype(np.float32)
    Ja, Jb = jlie.Sim3.exp(jnp.asarray(a)), jlie.Sim3.exp(jnp.asarray(b))
    Ta, Tb = tlie.Sim3.exp(torch.from_numpy(a)), tlie.Sim3.exp(torch.from_numpy(b))
    for got, ref in ((Ta, Ja), (Ta.compose(Tb), Ja.compose(Jb)), (Ta.inverse(), Ja.inverse())):
        for f in ("R", "t", "s"):
            np.testing.assert_allclose(_np(getattr(got, f)), _np(getattr(ref, f)), atol=1e-5)
    np.testing.assert_allclose(_np(Ta.log()), _np(Ja.log()), atol=1e-5)
    np.testing.assert_allclose(_np(Ta.apply(torch.from_numpy(x))),
                               _np(Ja.apply(jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(
        _np(tlie._sim3_W(torch.from_numpy(a[:, 3:6]), torch.from_numpy(a[:, 6]))),
        _np(jlie._sim3_W(jnp.asarray(a[:, 3:6]), jnp.asarray(a[:, 6]))), atol=1e-5)


@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_jacfwd_at_zero_vs_jax(group):
    rng = np.random.default_rng(3)
    if group == "se3":
        base = _tangents(rng, 1, 6, 0.6)[0]
        jT, tT = jlie.SE3.exp(jnp.asarray(base)), tlie.SE3.exp(torch.from_numpy(base))

        def jf(xi):
            return jlie.SE3.exp(xi).compose(jT).log()

        def tf(xi):
            return tlie.SE3.exp(xi).compose(tT).log()
    else:
        base = _tangents(rng, 1, 7, 0.6)[0]
        jT, tT = jlie.Sim3.exp(jnp.asarray(base)), tlie.Sim3.exp(torch.from_numpy(base))

        def jf(xi):
            return jlie.Sim3.exp(xi).compose(jT).log()

        def tf(xi):
            return tlie.Sim3.exp(xi).compose(tT).log()
    d = base.shape[0]
    ref = np.asarray(jax.jit(jax.jacfwd(jf))(jnp.zeros(d)))
    got = _np(torch.func.jacfwd(tf)(torch.zeros(d)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # Batched (vmap over poses) as the solvers take them; and at identity.
    many = _np(torch.func.vmap(torch.func.jacfwd(tf))(torch.zeros(4, d)))
    np.testing.assert_allclose(many, np.broadcast_to(ref, many.shape), atol=1e-4)
    eye = _np(torch.func.jacfwd(lambda xi: (tlie.SE3 if d == 6 else tlie.Sim3).exp(xi).log())(
        torch.zeros(d)))
    np.testing.assert_allclose(eye, np.eye(d), atol=1e-5)


# -- the pose graph -------------------------------------------------------------


def _so3(w):
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + W
    return np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th ** 2 * W @ W


def _se3(xi):
    v, w = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    V = (np.eye(3) + 0.5 * W if th < 1e-12 else
         np.eye(3) + (1 - np.cos(th)) / th ** 2 * W + (th - np.sin(th)) / th ** 3 * W @ W)
    return _so3(w), V @ v


def drifted_circle(rng, n=40, drift=0.02, closures=(), bad_loop=False, radius=5.0):
    """tests/test_posegraph.py's graph in numpy: a circle of n poses,
    odometry with N(0, drift) noise integrated into the start, exact loop
    closures (i, j), and optionally a wrong closure (n // 2, 0)."""
    Rg, tg = [], []
    for k in range(n):
        c, s = np.cos(2 * np.pi * k / n), np.sin(2 * np.pi * k / n)
        R_cw = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]]).T
        Rg.append(R_cw)
        tg.append(-R_cw @ np.array([radius * s, 0.0, -radius * c]))

    def rel(a, b):
        R = Rg[a] @ Rg[b].T
        return R, tg[a] - R @ tg[b]

    R0, t0 = [Rg[0]], [tg[0]]
    ei, ej, ZR, Zt = [], [], [], []
    for k in range(1, n):
        Rz, tz = rel(k, k - 1)
        nR, nt = _se3(np.concatenate([drift * rng.standard_normal(3),
                                      drift * 0.5 * rng.standard_normal(3)]))
        Rz, tz = nR @ Rz, nR @ tz + nt
        R0.append(Rz @ R0[-1])
        t0.append(Rz @ t0[-1] + tz)
        ei.append(k), ej.append(k - 1), ZR.append(Rz), Zt.append(tz)
    for a, b in closures:
        Rz, tz = rel(a, b)
        ei.append(a), ej.append(b), ZR.append(Rz), Zt.append(tz)
    if bad_loop:
        Rz, tz = _se3(rng.standard_normal(6))
        ei.append(n // 2), ej.append(0), ZR.append(Rz), Zt.append(tz)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(poses=(f32(R0), f32(t0)), edge_i=np.asarray(ei, np.int32),
                edge_j=np.asarray(ej, np.int32), Z=(f32(ZR), f32(Zt)),
                edge_weight=np.ones(len(ei), np.float32), pose_mask=np.ones(n, bool),
                fixed=fixed, Rg=f32(Rg), tg=f32(tg))


def both(a):
    """(JAX PoseGraph, port PoseGraph on the CPU) of one numpy graph."""
    j = jpgo.PoseGraph(jlie.SE3(*map(jnp.asarray, a["poses"])), jnp.asarray(a["edge_i"]),
                       jnp.asarray(a["edge_j"]), jlie.SE3(*map(jnp.asarray, a["Z"])),
                       jnp.asarray(a["edge_weight"]), jnp.asarray(a["pose_mask"]),
                       jnp.asarray(a["fixed"]))
    return j, interop.pose_graph_from_numpy(a, device="cpu")


def centers(R, t):
    return -np.einsum("fji,fj->fi", _np(R), _np(t))


CLOSURES_40 = ((39, 0), (20, 0), (30, 10))


def test_residuals_jacobians_normal_eqs_vs_jax():
    a = drifted_circle(np.random.default_rng(0), n=40, closures=CLOSURES_40)
    jg, tg = both(a)
    ref_jac = j_edge_jacobians(jg.poses, jg)
    np.testing.assert_allclose(_np(tpgo.edge_residuals(tg.poses, tg)), _np(ref_jac[0]),
                               rtol=1e-4, atol=1e-6)
    for got, ref in zip(tpgo._edge_jacobians(tg.poses, tg), ref_jac):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-4, atol=1e-5)
    for delta, kernel in ((None, "huber"), (0.05, "geman")):
        got = tpgo._build_normal_eqs(tg.poses, tg, delta, kernel)
        ref = j_normal_eqs(jg.poses, jg, delta, kernel)
        for x, y in zip(got, ref):
            np.testing.assert_allclose(_np(x), _np(y), rtol=1e-4, atol=1e-5)


def _hold(tres, jres, atol=1e-3):
    assert tres.iters == int(jres.iters)
    np.testing.assert_allclose(float(tres.cost0), float(jres.cost0), rtol=1e-4)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(_np(tres.poses.R), _np(jres.poses.R), atol=atol)
    np.testing.assert_allclose(_np(tres.poses.t), _np(jres.poses.t), atol=atol)


# Dense with the Geman kernel: test_pgo_solve_wrong_loop_vs_jax.
@pytest.mark.parametrize("solver,kernel,delta", [
    ("dense", "huber", None), ("pcg", "huber", 0.5), ("pcg", "geman", 0.5)])
def test_pgo_solve_vs_jax(solver, kernel, delta):
    a = drifted_circle(np.random.default_rng(1), n=40, closures=CLOSURES_40)
    jg, tg = both(a)
    kw = dict(max_iters=12, solver=solver, kernel=kernel, huber_delta_static=delta)
    tres = tpgo.pgo_solve(tg, device="cpu", **kw)
    _hold(tres, jpgo.pgo_solve(jg, **kw))
    assert float(tres.cost) < float(tres.cost0)


def test_pgo_solve_wrong_loop_vs_jax():
    a = drifted_circle(np.random.default_rng(2), n=40, drift=0.015,
                       closures=((39, 0),), bad_loop=True)
    jg, tg = both(a)
    kw = dict(max_iters=12, huber_delta_static=0.1, kernel="geman")
    tres = tpgo.pgo_solve(tg, device="cpu", **kw)
    _hold(tres, jpgo.pgo_solve(jg, **kw))
    gt = centers(a["Rg"], a["tg"])
    err = np.linalg.norm(centers(tres.poses.R, tres.poses.t) - gt, axis=1).max()
    err0 = np.linalg.norm(centers(*a["poses"]) - gt, axis=1).max()
    assert err < err0


@pytest.mark.parametrize("prior", ["position", "pose"])
def test_pgo_priors_vs_jax(prior):
    rng = np.random.default_rng(3)
    a = drifted_circle(rng, n=30)
    a["fixed"] = np.zeros(30, bool)
    jg, tg = both(a)
    if prior == "position":
        idx = np.arange(0, 30, 4)
        xyz = (centers(a["Rg"], a["tg"])[idx]
               + 0.005 * rng.standard_normal((len(idx), 3))).astype(np.float32)
        w = 10.0 * np.ones(len(idx), np.float32)
        jg = jpgo.with_position_priors(jg, idx, xyz, w)
        tg = tpgo.with_position_priors(tg, idx, xyz, w)
        kw = dict(prior_delta=0.25, kernel="geman")
    else:
        idx = np.array([0, 15])
        jg = jpgo.with_pose_priors(jg, idx, jlie.SE3(jnp.asarray(a["Rg"][idx]),
                                                     jnp.asarray(a["tg"][idx])), 50.0 * np.ones(2))
        tg = tpgo.with_pose_priors(tg, idx, tlie.SE3(torch.from_numpy(a["Rg"][idx]),
                                                     torch.from_numpy(a["tg"][idx])),
                                   50.0 * np.ones(2))
        kw = {}
    # The JAX graph round-trips through interop, priors included.
    tg2 = interop.pose_graph_from_numpy(jg, device="cpu")
    for name in ("prior_idx", "prior_xyz", "prior_weight", "prior_T_idx", "prior_T_weight"):
        x, y = getattr(tg2, name), getattr(tg, name)
        assert (x is None) == (y is None) and (x is None or torch.equal(x, y.to(x.dtype)))
    _hold(tpgo.pgo_solve(tg2, max_iters=10, device="cpu", **kw),
          jpgo.pgo_solve(jg, max_iters=10, **kw))


def test_entry_points_need_the_card_or_the_cpu():
    a = drifted_circle(np.random.default_rng(5), n=8)
    _, tg = both(a)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpgo.pgo_solve(tg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tlie.SE3.identity()
    with pytest.raises(ValueError, match="unknown solver"):
        tpgo.pgo_solve(tg, solver="qr", device="cpu")
