"""Levenberg-Marquardt bundle adjustment.

Port of ``fastmatch_tpu/ba/lm.py``: each iteration solves the
Schur-reduced camera system with PCG, back-substitutes the point update and
accepts or rejects with multiplicative damping; the gauge is fixed by
freezing ``fixed_cams``. The JAX ``lax.while_loop`` is a Python loop here,
reading one (accept, done) pair back per iteration. ``reduce`` is the
cross-rank hook of the observation-sharded solve (``dist/dist_ba.py``, the
JAX package's ``axis_name``): every camera and point sum and the cost pass
through it, so the (accept, done) pair that picks the LM branch reads the
reduced cost and every rank takes the same branch. ``grouped`` switches
the assembly to the scatter-free grouped layout (``ba/schur.py``), as in
the JAX package; ``FASTMATCH_CHECKIFY=1`` checks the observation table's
indices before the solve and its outputs after it (``utils/guards.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from fastmatch_tpu_torch.ba.problem import BAProblem, Observations
from fastmatch_tpu_torch.ba.schur import (
    GroupedObs,
    assemble,
    assemble_grouped,
    back_substitute,
    damped_pp_inverse,
    group_observations,
    pcg_solve,
    segment_keys,
)
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.core.lie import SE3
from fastmatch_tpu_torch.utils.guards import maybe_checked


class BAResult(NamedTuple):
    poses: SE3
    points: torch.Tensor
    cost0: torch.Tensor
    cost: torch.Tensor
    iters: int           # LM iterations executed
    accepted: int        # LM steps accepted


def ba_solve_raw(problem: BAProblem, max_iters: int = 20, pcg_iters: int = 40,
                 lam0: float = 1e-3, huber_delta_static: float | None = None,
                 rtol: float = 1e-6, grouped: GroupedObs | None = None,
                 reduce: Callable[[torch.Tensor], torch.Tensor] | None = None) -> BAResult:
    """Run LM to convergence (or max_iters) on the problem's device.
    ``grouped``: the block-dense grouping of the problem's observation
    table (``group_observations``); the assembly then gathers and sums over
    its fixed widths instead of segment sums (the PCG loop is the same).
    ``reduce`` (None: none): the sum over the ranks that each hold a slice
    of the observation table; the grouped route takes none."""
    if grouped is not None and reduce is not None:
        raise ValueError("the grouped route is single-device: pass grouped or reduce, not both")
    n_cams, n_points = problem.n_cams, problem.n_points
    obs = problem.obs
    keys = segment_keys(obs, n_cams, n_points)
    upd_mask = (problem.cam_mask & ~problem.fixed_cams).float()
    pt_upd = problem.pt_mask.float()

    def cost_at(R, t, X):
        if grouped is not None:
            return assemble_grouped(SE3(R, t), X, obs, grouped, n_cams, n_points,
                                    huber_delta_static, keys)
        return assemble(SE3(R, t), X, obs, n_cams, n_points, huber_delta_static, keys, reduce)

    R, t, X = problem.poses.R, problem.poses.t, problem.points
    sys, cost0 = cost_at(R, t, X)
    cost = cost0
    lam = torch.full((), lam0, dtype=torch.float32, device=X.device)
    it = accepted = 0
    done = False
    while it < max_iters and not done:
        Hpp_inv = damped_pp_inverse(sys, lam)
        dx_c = pcg_solve(sys, obs, lam, n_points, upd_mask, keys, iters=pcg_iters,
                         Hpp_inv=Hpp_inv, reduce=reduce)
        dx_p = back_substitute(sys, obs, lam, dx_c, n_points, keys,
                               Hpp_inv=Hpp_inv, reduce=reduce) * pt_upd[:, None]
        new_poses = SE3.exp(dx_c).compose(SE3(R, t))
        new_points = X + dx_p
        new_sys, new_cost = cost_at(new_poses.R, new_poses.t, new_points)
        accept_t = new_cost < cost
        rel = (cost - new_cost).abs() / torch.clamp(cost, min=1e-12)
        accept, small = torch.stack([accept_t, rel < rtol]).tolist()
        if accept:
            R, t, X, sys, cost = new_poses.R, new_poses.t, new_points, new_sys, new_cost
            lam = torch.clamp(lam * 0.5, 1e-9, 1e6)
            accepted += 1
        else:
            lam = torch.clamp(lam * 4.0, 1e-9, 1e6)
        done = accept and small
        it += 1
    return BAResult(poses=SE3(R, t), points=X, cost0=cost0, cost=cost, iters=it,
                    accepted=accepted)


def sort_obs_by_point(problem: BAProblem) -> BAProblem:
    """Sort the observation table by pt_idx (stable, mask-preserving): the
    point-keyed reductions then need no permutation."""
    o = problem.obs
    order = torch.argsort(o.pt_idx, stable=True)
    return problem._replace(obs=Observations(cam_idx=o.cam_idx[order],
                                             pt_idx=o.pt_idx[order],
                                             uv=o.uv[order], mask=o.mask[order]))


def _index_bounds(problem: BAProblem, *args, **kwargs):
    """The observation table's index checks for ``utils.guards``."""
    return [("obs.cam_idx", problem.obs.cam_idx, problem.n_cams),
            ("obs.pt_idx", problem.obs.pt_idx, problem.n_points)]


def ba_solve(problem: BAProblem, grouped: GroupedObs | None | str = None, device=None,
             **kwargs) -> BAResult:
    """BA entry point on ``device`` (``cuda`` unless ``device="cpu"``);
    keyword arguments as ``ba_solve_raw``. ``grouped="auto"`` builds the
    block-dense grouping on the host from the point-sorted table; a given
    ``GroupedObs`` must be that of the point-sorted table."""
    dev = resolve_device(device)

    def solve(problem):
        problem = sort_obs_by_point(problem.to(dev))
        g = grouped
        if isinstance(g, str):
            if g != "auto":
                raise ValueError(f"grouped must be None, a GroupedObs or 'auto', got {g!r}")
            g = group_observations(problem.obs, problem.n_cams, problem.n_points)
        return ba_solve_raw(problem, grouped=g, **kwargs)

    return maybe_checked(solve, _index_bounds)(problem)
