"""The port's long-graph pose-graph solvers (fastmatch_tpu_torch, CPU)
against the JAX package's on the same seeded inputs (the rest of
posegraph/ is held by tests/test_torch_posegraph.py, whose graph builder
and tolerances this file shares):

- pgo_solve_hierarchical on a 200-pose chain with 3 closures and
  segment_len 50: the same iterations, cost rtol 1e-3, poses within 2e-3;
- sim3_pgo_solve and sim3_correct_map on tests/test_sim3.py's scale-drift
  problem, rebuilt: residuals, normal equations (rtol 1e-4), the solve
  (same iterations, cost rtol 1e-3, poses within 1e-3) and the corrected
  map.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fastmatch_tpu.core import lie as jlie
from fastmatch_tpu.posegraph import pgo as jpgo
from fastmatch_tpu.posegraph import sim3 as jsim3
from test_torch_posegraph import _hold, _np, both, drifted_circle

from fastmatch_tpu_torch import interop
from fastmatch_tpu_torch.core import lie as tlie
from fastmatch_tpu_torch.posegraph import pgo as tpgo
from fastmatch_tpu_torch.posegraph import sim3 as tsim3

torch.set_num_threads(1)

# The JAX package's helpers, jitted: eager vmap(jacfwd) takes seconds a call.
j_sim3_residuals = jax.jit(jsim3.sim3_edge_residuals)
j_sim3_normal_eqs = jax.jit(jsim3._build_normal_eqs, static_argnums=(2, 3))


def test_pgo_hierarchical_vs_jax():
    a = drifted_circle(np.random.default_rng(4), n=200, drift=0.004, radius=10.0,
                       closures=((199, 0), (100, 0), (150, 50)))
    jg, tg = both(a)
    kw = dict(segment_len=50, coarse_max_iters=10, polish_max_iters=3, pcg_iters=30,
              huber_delta_static=0.5, kernel="geman")
    tres = tpgo.pgo_solve_hierarchical(tg, device="cpu", **kw)
    _hold(tres, jpgo.pgo_solve_hierarchical(jg, **kw), atol=2e-3)
    assert float(tres.cost) < float(tres.cost0)


# -- Sim(3) ------------------------------------------------------------------------


def scale_drift_problem(n=30, drift=1.03, radius=5.0):
    """tests/test_sim3.py's drift problem in numpy: a circle whose VO chain
    scales its translations by drift**k, plus one accurate Sim3 closure."""
    Rg, tg = [], []
    for k in range(n):
        ang = 2 * np.pi * k / n
        c = np.array([radius * np.cos(ang), radius * np.sin(ang), 0.0])
        z = -c / np.linalg.norm(c)
        x = np.array([-np.sin(ang), np.cos(ang), 0.0])
        Rcw = np.stack([x, np.cross(z, x), z], axis=1).T
        Rg.append(Rcw)
        tg.append(-Rcw @ c)
    sig = drift ** np.arange(n)
    Re, te, ZR, Zt = [Rg[0]], [tg[0]], [], []
    for k in range(n - 1):
        R = Rg[k] @ Rg[k + 1].T
        t = (tg[k] - R @ tg[k + 1]) * sig[k]
        ZR.append(R), Zt.append(t)
        Re.append(R.T @ Re[-1])
        te.append(R.T @ (te[-1] - t))
    R = Rg[n - 1] @ Rg[0].T
    ZR.append(R), Zt.append((tg[n - 1] - R @ tg[0]) * sig[n - 1])
    Z_scale = np.ones(n, np.float32)
    Z_scale[-1] = sig[n - 1]
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(n=n, sig=sig, Rg=f32(Rg), tg=f32(tg), R=f32(Re), t=f32(te),
                ei=np.arange(n, dtype=np.int32), ej=np.append(np.arange(1, n), 0).astype(np.int32),
                ZR=f32(ZR), Zt=f32(Zt), Z_scale=Z_scale)


def test_sim3_pgo_and_correct_map_vs_jax():
    p = scale_drift_problem()
    n = p["n"]
    fixed = np.zeros(n, bool)
    fixed[0] = True
    w = np.ones(n, np.float32)
    w[-1] = 5.0
    jest = jlie.SE3(jnp.asarray(p["R"]), jnp.asarray(p["t"]))
    test = tlie.SE3(torch.from_numpy(p["R"]), torch.from_numpy(p["t"]))
    jg = jsim3.graph_from_se3(jest, p["ei"], p["ej"], jlie.SE3(jnp.asarray(p["ZR"]),
                                                            jnp.asarray(p["Zt"])),
                              w, np.ones(n, bool), fixed, Z_scale=p["Z_scale"])
    tg = tsim3.graph_from_se3(test, p["ei"], p["ej"], tlie.SE3(torch.from_numpy(p["ZR"]),
                                                            torch.from_numpy(p["Zt"])),
                              w, np.ones(n, bool), fixed, Z_scale=p["Z_scale"])
    np.testing.assert_allclose(_np(tsim3.sim3_edge_residuals(tg.poses, tg)),
                               _np(j_sim3_residuals(jg.poses, jg)), atol=1e-5)
    for x, y in zip(tsim3._build_normal_eqs(tg.poses, tg, None, "huber"),
                    j_sim3_normal_eqs(jg.poses, jg, None, "huber")):
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-4, atol=1e-4)
    tres = tsim3.sim3_pgo_solve(tg, max_iters=20, device="cpu")
    jres = jsim3.sim3_pgo_solve(jg, max_iters=20)
    assert tres.iters == int(jres.iters)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-3, atol=1e-8)
    for f in ("R", "t", "s"):
        np.testing.assert_allclose(_np(getattr(tres.poses, f)), _np(getattr(jres.poses, f)),
                                   atol=1e-3)
    np.testing.assert_allclose(_np(tres.poses.s), p["sig"], rtol=0.08)
    rng = np.random.default_rng(4)
    pts = rng.normal(0, 1.0, (50, 3)).astype(np.float32)
    ref = rng.integers(0, n, 50).astype(np.int32)
    tp, tx = tsim3.sim3_correct_map(tres.poses, test, torch.from_numpy(pts),
                                    torch.from_numpy(ref).long())
    jp, jx = jsim3.sim3_correct_map(jres.poses, jest, jnp.asarray(pts), jnp.asarray(ref))
    np.testing.assert_allclose(_np(tp.t), _np(jp.t), atol=1e-3)
    np.testing.assert_allclose(_np(tx), _np(jx), atol=2e-3)
    # The interop twin of the JAX graph holds the same graph.
    tg2 = interop.sim3_graph_from_numpy(jg, device="cpu")
    for x, y in zip(tg2, tg):
        for u, v in zip(x, y) if isinstance(x, tuple) else ((x, y),):
            np.testing.assert_array_equal(_np(u), _np(v))
