"""Distributed bundle adjustment.

Port of ``fastmatch_tpu/dist/dist_ba.py`` on ``torch.distributed``.
Observation-sharded BA: the observation table is split over the mesh's
``bank`` axis (map blocks or covisibility groups, one per rank); camera
poses and points are the same on every rank. Each rank runs the port's LM
solver (``ba/lm.ba_solve_raw``) on its slice with the ``reduce`` hook an
``all_reduce`` over the axis: every camera and point block sum and the cost
(K4 on the card, then the reduction; point gathers through K5), so the
only traffic is the (C,6,6)/(P,3,3)/(C,6)/(P,3) blocks a linearization and
two block vectors a PCG matrix-vector product. The LM accept decision
reads the reduced cost, so every rank takes the same branch.

Equal to the single-device ``ba_solve`` up to the order of the sums (the
all-reduce adds the ranks' partial sums in its own order).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from fastmatch_tpu_torch.ba.lm import BAResult, ba_solve_raw, sort_obs_by_point
from fastmatch_tpu_torch.ba.problem import BAProblem, Observations
from fastmatch_tpu_torch.dist.bootstrap import rank_device
from fastmatch_tpu_torch.dist.mesh import axis_rank, axis_size


def shard_observations(obs: Observations, n_shards: int) -> Observations:
    """Pad the observation table to a multiple of n_shards (dead padding)."""
    o = obs.mask.shape[0]
    rem = (-o) % n_shards
    if rem == 0:
        return obs

    def pad(x):
        return torch.cat([x, torch.zeros((rem,) + tuple(x.shape[1:]), dtype=x.dtype,
                                         device=x.device)])

    return Observations(cam_idx=pad(obs.cam_idx), pt_idx=pad(obs.pt_idx), uv=pad(obs.uv),
                        mask=pad(obs.mask))


def all_reduce_hook(group):
    """The ``reduce`` hook of ``ba_solve_raw``: an in-place sum over
    ``group`` (every value it is given is a fresh sum)."""

    def reduce(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=group)
        return x

    return reduce


def ba_solve_sharded(
    problem: BAProblem,
    mesh,
    max_iters: int = 20,
    pcg_iters: int = 40,
    huber_delta_static: float | None = None,
    presorted: bool = False,
) -> BAResult:
    """Run LM-BA with observations split over mesh axis ``bank``, on this
    rank's device. Every rank passes the same problem and gets the same
    result.

    ``presorted``: the caller has already laid the table out as equal,
    per-shard pt-sorted slices — e.g. covisibility map blocks from
    dist/partition.partition_problem — so skip the global pad+sort (which
    would scatter block rows across all ranks again)."""
    n_shards = axis_size(mesh, "bank")
    me = axis_rank(mesh, "bank")
    problem = problem.to(rank_device(mesh.device_type))
    if presorted:
        if problem.obs.mask.shape[0] % n_shards:
            raise ValueError(
                f"presorted obs capacity {problem.obs.mask.shape[0]} must be a "
                f"multiple of the bank axis size {n_shards}")
    else:
        # Pad first (padding appends pt_idx-0 rows), THEN pt-sort globally:
        # contiguous shards of a sorted table stay sorted, which the
        # segment kernels (K4, K5) need on every rank.
        obs = shard_observations(problem.obs, n_shards)
        problem = sort_obs_by_point(problem._replace(obs=obs))
    rows = problem.obs.mask.shape[0] // n_shards
    local = Observations(*(f[me * rows:(me + 1) * rows] for f in problem.obs))
    return ba_solve_raw(problem._replace(obs=local), max_iters=max_iters,
                        pcg_iters=pcg_iters, huber_delta_static=huber_delta_static,
                        reduce=all_reduce_hook(mesh.get_group("bank")))
