"""Sim(3) pose-graph optimization: loop closure with scale drift.

Port of ``fastmatch_tpu/posegraph/sim3.py``. A monocular reconstruction is
determined only up to a similarity, so its drift has a scale component that
an SE(3) correction cannot represent; this solver optimizes 7-dof
similarity poses (tangents ``[rho, omega, sigma]``, ``core/lie.Sim3``) with
the dense path of ``posegraph/pgo.py`` lifted to 7 dimensions: per-edge
residual log(Z^-1 S_i S_j^-1) with Jacobians by ``torch.func.jacfwd`` under
``vmap``, dense (7N, 7N) normal equations summed in a fixed order through
the K4 kernel wrapper (``pgo._dense_sums``, keys sorted once a solve), damped
Cholesky, LM accept/reject on the host with one readback an iteration, and
the robust kernels of ``pgo.py``. At least one pose must be ``fixed``.

``sim3_correct_map`` turns the solved similarities back into an SE3
trajectory and re-anchored landmarks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.core.lie import SE3, Sim3
from fastmatch_tpu_torch.posegraph.pgo import (_dense_sums, _robust_cost, _robust_weight,
                                                _sum_rows)


class Sim3Graph(NamedTuple):
    """poses: Sim3 batch (N,) cam-from-world similarities; edges i -> j with
    measurement Z_ij = S_i S_j^-1; the masking of ``pgo.PoseGraph``."""

    poses: Sim3
    edge_i: torch.Tensor       # (E,) int
    edge_j: torch.Tensor       # (E,) int
    Z: Sim3                    # (E,) measurements
    edge_weight: torch.Tensor  # (E,) float32; 0 = dead edge
    pose_mask: torch.Tensor    # (N,) bool
    fixed: torch.Tensor        # (N,) bool

    def to(self, device) -> "Sim3Graph":
        def mv(x):
            return Sim3(*(f.to(device) for f in x)) if isinstance(x, Sim3) else x.to(device)

        return Sim3Graph(*(mv(x) for x in self))


def graph_from_se3(poses: SE3, edge_i, edge_j, Z: SE3, edge_weight, pose_mask, fixed,
                   Z_scale=None) -> Sim3Graph:
    """Lift an SE3 pose graph to Sim3: poses and odometry edges get scale 1;
    loop closures pass their measured relative scale in ``Z_scale`` (E,)."""
    dev = poses.t.device

    def tens(x, dtype):
        return torch.as_tensor(x, dtype=dtype).to(dev)

    s1 = torch.ones(poses.t.shape[:-1], dtype=poses.t.dtype, device=dev)
    zs = (torch.ones(Z.t.shape[:-1], dtype=Z.t.dtype, device=dev) if Z_scale is None
          else tens(Z_scale, Z.t.dtype))
    return Sim3Graph(Sim3(poses.R, poses.t, s1), tens(edge_i, torch.int64),
                     tens(edge_j, torch.int64), Sim3(Z.R.to(dev), Z.t.to(dev), zs),
                     tens(edge_weight, torch.float32), tens(pose_mask, torch.bool),
                     tens(fixed, torch.bool))


def _take(S: Sim3, idx) -> Sim3:
    return Sim3(S.R[idx], S.t[idx], S.s[idx])


def sim3_edge_residuals(poses: Sim3, g: Sim3Graph) -> torch.Tensor:
    """(E, 7) residuals r_e = log(Z^-1 S_i S_j^-1)."""
    rel = _take(poses, g.edge_i).compose(_take(poses, g.edge_j).inverse())
    return g.Z.inverse().compose(rel).log()


def _res_edge(xi, Ri, ti, si, Rj, tj, sj, ZR, Zt, Zs):
    """One edge's residual at left tangents xi = [xi_i, xi_j] (14,), twice
    (the Jacobian's function and its value)."""
    Si = Sim3.exp(xi[:7]).compose(Sim3(Ri, ti, si))
    Sj = Sim3.exp(xi[7:]).compose(Sim3(Rj, tj, sj))
    r = Sim3(ZR, Zt, Zs).inverse().compose(Si.compose(Sj.inverse())).log()
    return r, r


def _edge_jacobians(poses: Sim3, g: Sim3Graph):
    """(r (E, 7), Ji (E, 7, 7), Jj (E, 7, 7)) wrt left tangents of S_i, S_j."""
    zeros = poses.t.new_zeros(14)
    jac = torch.func.jacfwd(_res_edge, has_aux=True)
    J, r = torch.func.vmap(lambda *a: jac(zeros, *a))(
        poses.R[g.edge_i], poses.t[g.edge_i], poses.s[g.edge_i],
        poses.R[g.edge_j], poses.t[g.edge_j], poses.s[g.edge_j], g.Z.R, g.Z.t, g.Z.s)
    return r, J[..., :7], J[..., 7:]


def _graph_cost(poses: Sim3, g: Sim3Graph, delta, kernel: str):
    rn = torch.linalg.norm(sim3_edge_residuals(poses, g), dim=-1)
    return (g.edge_weight * _robust_cost(rn, delta, kernel)).sum()


def _edge_normal_blocks(poses: Sim3, g: Sim3Graph, delta, kernel: str):
    """Per-edge 7x7 normal-equation blocks (IRLS-weighted): (Hii, Hjj, Hij,
    gi, gj)."""
    r, Ji, Jj = _edge_jacobians(poses, g)
    w = g.edge_weight
    if delta is not None:
        w = w * _robust_weight(torch.linalg.norm(r, dim=-1), delta, kernel)
    wv = w[:, None, None]
    Hii = torch.einsum("eki,ekj->eij", Ji * wv, Ji)
    Hjj = torch.einsum("eki,ekj->eij", Jj * wv, Jj)
    Hij = torch.einsum("eki,ekj->eij", Ji * wv, Jj)
    gi = torch.einsum("eki,ek->ei", Ji * wv, r)
    gj = torch.einsum("eki,ek->ei", Jj * wv, r)
    return Hii, Hjj, Hij, gi, gj


def _build_normal_eqs(poses: Sim3, g: Sim3Graph, delta, kernel: str, sums=None):
    """(H (7N, 7N), grad (7N,)) summed in a fixed order; ``sums``:
    ``pgo._dense_sums(g, N)``, built here when not given."""
    n = poses.R.shape[0]
    Hii, Hjj, Hij, gi, gj = _edge_normal_blocks(poses, g, delta, kernel)
    h_sum, g_sum = _dense_sums(g, n) if sums is None else sums
    H = _sum_rows(h_sum, [Hii, Hjj, Hij, Hij.transpose(-1, -2)])
    grad = _sum_rows(g_sum, [gi, gj])
    return H.view(n, n, 7, 7).permute(0, 2, 1, 3).reshape(7 * n, 7 * n), grad.reshape(7 * n)


class Sim3Result(NamedTuple):
    poses: Sim3
    cost0: torch.Tensor
    cost: torch.Tensor
    iters: int


def sim3_pgo_solve(g: Sim3Graph, max_iters: int = 30, lam0: float = 1e-4,
                   huber_delta_static: float | None = None, kernel: str = "huber",
                   rtol: float = 1e-8, device=None) -> Sim3Result:
    """LM over Sim(3) poses with dense damped-Cholesky normal equations, on
    ``device`` (``cuda`` unless ``device="cpu"``); one (accept, converged)
    readback an iteration."""
    g = g.to(resolve_device(device))
    n = g.poses.R.shape[0]
    upd = (g.pose_mask & ~g.fixed).float()
    upd7 = upd.repeat_interleave(7)

    def cost_of(S: Sim3):
        return _graph_cost(S, g, huber_delta_static, kernel)

    S = g.poses
    cost0 = cost = cost_of(S)
    lam = torch.tensor(lam0, dtype=torch.float32, device=S.t.device)
    it, done = 0, False
    sums = _dense_sums(g, n)  # the edge topology is fixed for the solve
    while it < max_iters and not done:
        H, grad = _build_normal_eqs(S, g, huber_delta_static, kernel, sums)
        H = H * upd7[:, None] * upd7[None, :] + torch.diag(1.0 - upd7)
        grad = grad * upd7
        L, info = torch.linalg.cholesky_ex(H + torch.diag(lam * torch.diagonal(H) + 1e-10))
        dx = -torch.cholesky_solve(grad[:, None], L)[:, 0].reshape(n, 7)
        bad = torch.isnan(dx).any() | (info != 0)
        dx = torch.where(bad, torch.zeros_like(dx), dx) * upd[:, None]
        new = Sim3.exp(dx).compose(S)
        new_cost = cost_of(new)
        accept_t = (new_cost < cost) & ~bad
        rel = (cost - new_cost).abs() / torch.clamp(cost, min=1e-15)
        accept, small = torch.stack([accept_t, rel < rtol]).tolist()
        if accept:
            S, cost = new, new_cost
        lam = torch.clamp(lam * (0.3 if accept else 5.0), 1e-10, 1e8)
        done = accept and small
        it += 1
    return Sim3Result(poses=S, cost0=cost0, cost=cost, iters=it)


def sim3_correct_map(solved: Sim3, old_poses: SE3, points: torch.Tensor,
                     point_ref: torch.Tensor):
    """Solved cam-from-world similarities back to an SE3 map: poses
    (R_i, t_i / s_i) (the same pinhole projection), and each landmark
    re-anchored through its reference keyframe ``point_ref`` (P,):
    x' = S_ref^-1 (T_ref_old x)."""
    new_poses = SE3(solved.R, solved.t / solved.s[..., None])
    x_cam = SE3(old_poses.R[point_ref], old_poses.t[point_ref]).apply(points)
    return new_poses, _take(solved, point_ref).inverse().apply(x_cam)
