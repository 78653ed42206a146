"""The port's grouped (block-dense) Schur layout and ``ba_solve(grouped=)``
(fastmatch_tpu_torch, CPU) against the JAX package's.

The layout tables are integers and equal the JAX package's exactly. The
grouped assembly, matvec, PCG and back substitution are held at the JAX
package's own tolerances for the grouped path against the segment-sum path
(``tests/test_ba.py::TestGroupedSchur``): matvec rtol 2e-4 / atol 1e-5,
PCG and back substitution rtol 1e-2 / atol 1e-4 (50 iterations amplify the
summation-order differences), final LM cost rtol 1e-3; the grouped
assembly against the JAX package's grouped assembly at BA's assembly
tolerance (rtol 1e-4 of each block's scale). Two grouped solves are
bit-identical: the grouped path has no scatter.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastmatch_tpu.ba import lm as jlm
from fastmatch_tpu.ba import schur as jschur

from fastmatch_tpu_torch.ba import lm as tlm
from fastmatch_tpu_torch.ba import schur as tschur
from fastmatch_tpu_torch.ba.problem import Observations
from fastmatch_tpu_torch.interop import ba_problem_from_numpy

from test_torch_ba import jax_problem, problem_arrays

torch.set_num_threads(1)


def _problems(**kw):
    arrs = problem_arrays(**kw)
    jp = jlm.sort_obs_by_point(jax_problem(arrs))
    tp = tlm.sort_obs_by_point(ba_problem_from_numpy(*arrs, device="cpu"))
    return arrs, jp, tp


def test_group_observations_layout():
    ci = torch.tensor([0, 1, 1, 2, 2, 2], dtype=torch.int32)
    pi = torch.tensor([3, 3, 0, 1, 0, 3], dtype=torch.int32)
    obs = Observations(ci, pi, torch.zeros(6, 2), torch.ones(6, dtype=torch.bool))
    g = tschur.group_observations(obs, n_cams=4, n_points=4)
    pt = g.pt_gather.numpy()
    assert set(pt[3][pt[3] < 6].tolist()) == {0, 1, 5}
    assert (pt[2] == 6).all()
    cam = g.cam_gather.numpy()
    assert set(cam[2][cam[2] < 6].tolist()) == {3, 4, 5}
    # The same tables as the JAX package's, on a BA problem with dead rows.
    _, jp, tp = _problems(seed=3, n_frames=6, n_points=64, cap_obs=512, shuffle=True)
    jg = jschur.group_observations(jp.obs, 6, 64)
    tg = tschur.group_observations(tp.obs, 6, 64)
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="group width"):
        tschur.group_observations(tp.obs, 6, 64, Kp=1)


def test_grouped_assembly_vs_jax():
    _, jp, tp = _problems(seed=4, n_frames=6, n_points=64, cap_obs=512)
    jg = jschur.group_observations(jp.obs, 6, 64)
    tg = tschur.group_observations(tp.obs, 6, 64)
    jsys, jcost = jschur.assemble_grouped(jp.poses, jp.points, jp.obs, jg, 6, 64, 0.01)
    tsys, tcost = tschur.assemble_grouped(tp.poses, tp.points, tp.obs, tg, 6, 64, 0.01)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
    for name in ("Hcc", "Hpp", "Wcp", "gc", "gp"):
        a, b = getattr(tsys, name).numpy(), np.asarray(getattr(jsys, name))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(), err_msg=name)
    # And the port's grouped assembly against its own segment-sum assembly.
    ssys, scost = tschur.assemble(tp.poses, tp.points, tp.obs, 6, 64, 0.01)
    np.testing.assert_allclose(float(tcost), float(scost), rtol=1e-5)
    for name in ("Hcc", "Hpp", "gc", "gp"):
        a, b = getattr(tsys, name).numpy(), getattr(ssys, name).numpy()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(), err_msg=name)


def test_grouped_matvec_and_pcg():
    """tests/test_ba.py's grouped-against-scatter check, on both sides:
    the port's grouped matvec, PCG and back substitution against its
    segment-sum path and against the JAX package's grouped path."""
    _, jp, tp = _problems(seed=5, n_frames=6, n_points=64, cap_obs=512)
    n_c, n_p = 6, 64
    lam = 1e-3
    upd = (tp.cam_mask & ~tp.fixed_cams).float()
    sys, _ = tschur.assemble(tp.poses, tp.points, tp.obs, n_c, n_p)
    keys = tschur.segment_keys(tp.obs, n_c, n_p)
    grouped = tschur.group_observations(tp.obs, n_c, n_p)
    gs = tschur.grouped_system(sys, grouped, torch.tensor(lam))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((n_c, 6)).astype(np.float32))
    Sx = tschur.schur_matvec(sys, tp.obs, torch.tensor(lam), x, n_p, upd, keys)
    Sx_g = tschur.schur_matvec_grouped(gs, grouped, x, upd)
    np.testing.assert_allclose(Sx.numpy(), Sx_g.numpy(), rtol=2e-4, atol=1e-5)
    dx = tschur.pcg_solve(sys, tp.obs, torch.tensor(lam), n_p, upd, keys, iters=50)
    dx_g = tschur.pcg_solve_grouped(sys, gs, grouped, upd, iters=50)
    np.testing.assert_allclose(dx.numpy(), dx_g.numpy(), rtol=1e-2, atol=1e-4)
    bp = tschur.back_substitute(sys, tp.obs, torch.tensor(lam), dx, n_p, keys)
    bp_g = tschur.back_substitute_grouped(sys, gs, grouped, dx_g)
    np.testing.assert_allclose(bp.numpy(), bp_g.numpy(), rtol=1e-2, atol=1e-4)

    jsys, _ = jschur.assemble(jp.poses, jp.points, jp.obs, n_c, n_p)
    jgrouped = jschur.group_observations(jp.obs, n_c, n_p)
    jgs = jschur.grouped_system(jsys, jgrouped, jnp.float32(lam))
    jupd = jnp.asarray(upd.numpy())
    np.testing.assert_allclose(
        Sx_g.numpy(), np.asarray(jschur.schur_matvec_grouped(jgs, jgrouped, jnp.asarray(x.numpy()),
                                                             jupd)), rtol=2e-4, atol=1e-5)
    jdx = jschur.pcg_solve_grouped(jsys, jgs, jgrouped, jupd, iters=50)
    np.testing.assert_allclose(dx_g.numpy(), np.asarray(jdx), rtol=1e-2, atol=1e-4)
    np.testing.assert_allclose(
        bp_g.numpy(), np.asarray(jschur.back_substitute_grouped(jsys, jgs, jgrouped, jdx)),
        rtol=1e-2, atol=1e-4)


def test_grouped_ba_solve_vs_jax():
    arrs = problem_arrays(seed=6, n_frames=6, n_points=64, noise_px=0.5, perturb=0.02,
                          cap_obs=512)
    kw = dict(max_iters=8, pcg_iters=30)
    jres = jlm.ba_solve(jax_problem(arrs), grouped="auto", **kw)
    tres = tlm.ba_solve(ba_problem_from_numpy(*arrs, device="cpu"), grouped="auto",
                        device="cpu", **kw)
    plain = tlm.ba_solve(ba_problem_from_numpy(*arrs, device="cpu"), device="cpu", **kw)
    np.testing.assert_allclose(float(tres.cost0), float(jres.cost0), rtol=1e-4)
    np.testing.assert_allclose(float(tres.cost0), float(plain.cost0), rtol=1e-5)
    assert float(tres.cost) < 0.5 * float(tres.cost0)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-3)
    np.testing.assert_allclose(float(tres.cost), float(plain.cost), rtol=1e-3)
    again = tlm.ba_solve(ba_problem_from_numpy(*arrs, device="cpu"), grouped="auto",
                         device="cpu", **kw)
    assert torch.equal(again.points, tres.points) and torch.equal(again.cost, tres.cost)
    with pytest.raises(ValueError, match="grouped"):
        tlm.ba_solve(ba_problem_from_numpy(*arrs, device="cpu"), grouped="yes", device="cpu")
