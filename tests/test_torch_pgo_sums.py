"""PGO's fixed-order sums (fastmatch_tpu_torch, CPU) against the JAX
package's assembly.

Every sum over the pose graph's edges goes through the K4 wrapper
(``sorted_segment_sum``) with keys sorted once a solve (``_key_sum``):
H's 6x6 blocks by block index i*N + j, the gradient and the PCG sums by
pose. Held here: the sorted keys, offsets and longest segment exactly
against numpy's stable argsort and searchsorted; H, grad and the IRLS cost
of ``_build_normal_eqs``, with both kinds of prior, against the JAX
package's ``.at[].add`` assembly (rtol 1e-4, atol 1e-5: float32 sums in
another order); the Sim(3) assembly likewise; that the dense, PCG and
Sim(3) solvers sum through the K4 wrapper (launch counts by wrapper call,
none through ``index_add_``); and that two solves are bit-identical.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fastmatch_tpu.core import lie as jlie
from fastmatch_tpu.posegraph import pgo as jpgo
from fastmatch_tpu.posegraph import sim3 as jsim3

from fastmatch_tpu_torch.core import lie as tlie
from fastmatch_tpu_torch.kernels import segment_ops as k4
from fastmatch_tpu_torch.posegraph import pgo as tpgo
from fastmatch_tpu_torch.posegraph import sim3 as tsim3

from test_torch_posegraph import CLOSURES_40, _np, both, drifted_circle

torch.set_num_threads(1)

j_normal_eqs = jax.jit(jpgo._build_normal_eqs, static_argnums=(2, 3, 4))


def _with_priors(jg, tg, a):
    idx = np.array([5, 17, 33], np.int64)
    xyz = -np.einsum("kji,kj->ki", a["Rg"][idx], a["tg"][idx]).astype(np.float32)
    w = np.array([2.0, 1.0, 0.5], np.float32)
    jg = jpgo.with_position_priors(jg, idx, xyz, w)
    tg = tpgo.with_position_priors(tg, idx, xyz, w)
    pidx = np.array([10, 20], np.int64)
    jg = jpgo.with_pose_priors(jg, pidx, jlie.SE3(jnp.asarray(a["Rg"][pidx]),
                                                  jnp.asarray(a["tg"][pidx])), np.ones(2))
    tg = tpgo.with_pose_priors(tg, pidx, tlie.SE3(torch.from_numpy(a["Rg"][pidx]),
                                                  torch.from_numpy(a["tg"][pidx])), np.ones(2))
    return jg, tg


def test_key_sum_matches_numpy():
    rng = np.random.default_rng(0)
    keys = [rng.integers(0, 50, 40), rng.integers(0, 50, 40), np.array([3, 3, 49])]
    ks = tpgo._key_sum([torch.from_numpy(k) for k in keys], 50)
    flat = np.concatenate(keys)
    order = np.argsort(flat, kind="stable")
    np.testing.assert_array_equal(ks.perm.numpy(), order)
    np.testing.assert_array_equal(ks.seg.numpy(), flat[order])
    np.testing.assert_array_equal(ks.offsets.numpy(),
                                  np.searchsorted(flat[order], np.arange(51), side="left"))
    assert ks.max_len == np.bincount(flat).max() and ks.n == 50
    vals = [torch.from_numpy(rng.standard_normal((len(k), 2, 3)).astype(np.float32))
            for k in keys]
    got = tpgo._sum_rows(ks, vals).numpy()
    ref = np.zeros((50, 2, 3))
    np.add.at(ref, flat, np.concatenate([v.numpy() for v in vals]).astype(np.float64))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("priors", [False, True])
def test_normal_eqs_vs_jax(priors):
    a = drifted_circle(np.random.default_rng(2), n=40, closures=CLOSURES_40)
    jg, tg = both(a)
    if priors:
        jg, tg = _with_priors(jg, tg, a)
    for delta, kernel, pdelta in ((None, "huber", None), (0.05, "geman", 0.25)):
        before = k4.sorted_segment_sum.launches
        got = tpgo._build_normal_eqs(tg.poses, tg, delta, kernel, pdelta)
        assert k4.sorted_segment_sum.launches == before  # CPU tensors: the plain twin
        ref = j_normal_eqs(jg.poses, jg, delta, kernel, pdelta)
        for x, y in zip(got, ref):
            np.testing.assert_allclose(_np(x), _np(y), rtol=1e-4, atol=1e-5)


def test_sim3_normal_eqs_vs_jax():
    rng = np.random.default_rng(3)
    a = drifted_circle(rng, n=24, closures=((23, 0), (12, 2)))
    s = np.exp(rng.normal(0, 0.05, 24)).astype(np.float32)
    zs = np.exp(rng.normal(0, 0.05, len(a["edge_i"]))).astype(np.float32)
    R0, t0 = a["poses"]
    ZR, Zt = a["Z"]
    jg = jsim3.Sim3Graph(jlie.Sim3(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(s)),
                         jnp.asarray(a["edge_i"]), jnp.asarray(a["edge_j"]),
                         jlie.Sim3(jnp.asarray(ZR), jnp.asarray(Zt), jnp.asarray(zs)),
                         jnp.asarray(a["edge_weight"]), jnp.asarray(a["pose_mask"]),
                         jnp.asarray(a["fixed"]))
    tg = tsim3.Sim3Graph(tlie.Sim3(torch.from_numpy(R0), torch.from_numpy(t0),
                                   torch.from_numpy(s)),
                         torch.from_numpy(a["edge_i"]).long(), torch.from_numpy(a["edge_j"]).long(),
                         tlie.Sim3(torch.from_numpy(ZR), torch.from_numpy(Zt),
                                   torch.from_numpy(zs)),
                         torch.from_numpy(a["edge_weight"]), torch.from_numpy(a["pose_mask"]),
                         torch.from_numpy(a["fixed"]))
    got = tsim3._build_normal_eqs(tg.poses, tg, 0.1, "geman")
    ref = jax.jit(jsim3._build_normal_eqs, static_argnums=(2, 3))(jg.poses, jg, 0.1, "geman")
    for x, y in zip(got, ref):
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-4, atol=1e-5)


def _count_sums(monkeypatch):
    """Count the K4 wrapper's calls from PGO (on CPU tensors it takes its
    plain twin, which counts no launch) and forbid ``index_add_`` there."""
    calls = []
    real = tpgo.sorted_segment_sum

    def counting(vals, seg, n, offsets=None, max_len=None):
        calls.append((tuple(vals.shape), n))
        assert offsets is not None and max_len is not None  # built once a solve
        return real(vals, seg, n, offsets, max_len)

    monkeypatch.setattr(tpgo, "sorted_segment_sum", counting)
    return calls


@pytest.mark.parametrize("solver", ["dense", "pcg", "sim3"])
def test_solvers_sum_through_k4_bit_identically(monkeypatch, solver):
    a = drifted_circle(np.random.default_rng(4), n=30, closures=((29, 0), (15, 3)))
    _, tg = both(a)
    calls = _count_sums(monkeypatch)
    if solver == "sim3":
        sg = tsim3.Sim3Graph(tlie.Sim3(tg.poses.R, tg.poses.t, torch.ones(30)), tg.edge_i,
                             tg.edge_j, tlie.Sim3(tg.Z.R, tg.Z.t, torch.ones(len(tg.edge_i))),
                             tg.edge_weight, tg.pose_mask, tg.fixed)
        run = lambda: tsim3.sim3_pgo_solve(sg, max_iters=4, device="cpu")  # noqa: E731
    else:
        run = lambda: tpgo.pgo_solve(tg, max_iters=4, solver=solver, pcg_iters=8,  # noqa: E731
                                     device="cpu")
    first = run()
    # dense and Sim(3): H and grad an iteration; PCG: grad, the diagonal
    # blocks and one sum a matvec.
    per_iter = 2 if solver != "pcg" else 2 + 8
    assert len(calls) == per_iter * first.iters
    second = run()
    assert torch.equal(first.poses.R, second.poses.R) and torch.equal(first.cost, second.cost)
    assert float(first.cost) < float(first.cost0)
