"""Pose-graph optimization with loop closures (BASELINE.json config 4).

Port of ``fastmatch_tpu/posegraph/pgo.py``: Levenberg-Marquardt on SE(3)
poses with relative-pose edges (odometry and loop closures), robust edge
weights, optional unary priors, and the gauge fixed by freezing poses.

- Residuals and Jacobians per edge by forward-mode autodiff of the
  left-perturbed residual (``torch.func.jacfwd`` under ``torch.func.vmap``,
  as the JAX package vmaps ``jax.jacfwd``).
- ``solver="dense"``: the (6N, 6N) normal equations assembled as four
  6x6 blocks an edge summed into an (N*N, 6, 6) view of H, and solved by
  damped Cholesky (``torch.linalg.cholesky_ex``, ``cholesky_solve``).
- ``solver="pcg"``: the same system matrix-free, block-Jacobi PCG with
  segment sums over the poses; its ``pcg_iters`` loop reads nothing back.
- The JAX ``lax.while_loop`` is a host loop that reads back one pair
  (accept, converged) per LM iteration and stops on the same rule.

Every sum over the edges goes through the K4 kernel wrapper
(``kernels/segment_ops.sorted_segment_sum``) in a fixed order, as the JAX
package's ``segment_sum`` and ``.at[].add`` sum on XLA: the edge topology is
fixed for a solve, so ``_key_sum`` sorts the keys (block index i*N + j for
H, pose index for the gradient and the PCG sums) once per solve, and each
sum gathers its rows into that order and makes one K4 launch. Two solves on
the card are bit-identical (``index_add_`` would sum by float atomics, in
no fixed order). On the CPU the wrapper takes its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.core.lie import SE3
from fastmatch_tpu_torch.kernels.segment_ops import (segment_lengths, segment_offsets,
                                                     sorted_segment_sum)


class PoseGraph(NamedTuple):
    """poses: SE3 batch (N,); edges i -> j with measurement Z_ij = T_i T_j^-1
    (maps cam_j coordinates into cam_i). Optional unary priors: camera-centre
    (GPS) priors ``prior_idx`` (K,), ``prior_xyz`` (K, 3), ``prior_weight``
    (K,), and full-pose anchors ``prior_T_idx`` (K2,), ``prior_T`` (SE3),
    ``prior_T_weight`` (K2,); attach them with ``with_position_priors`` and
    ``with_pose_priors``."""

    poses: SE3
    edge_i: torch.Tensor       # (E,) int
    edge_j: torch.Tensor       # (E,) int
    Z: SE3                     # (E,) measurements
    edge_weight: torch.Tensor  # (E,) float32 (0 = dead edge)
    pose_mask: torch.Tensor    # (N,) bool, live poses
    fixed: torch.Tensor        # (N,) bool, gauge-fixed poses
    prior_idx: torch.Tensor | None = None
    prior_xyz: torch.Tensor | None = None
    prior_weight: torch.Tensor | None = None
    prior_T_idx: torch.Tensor | None = None
    prior_T: SE3 | None = None
    prior_T_weight: torch.Tensor | None = None

    def to(self, device) -> "PoseGraph":
        """The graph with every tensor on ``device``."""
        def mv(x):
            if x is None:
                return None
            if isinstance(x, SE3):
                return SE3(x.R.to(device), x.t.to(device))
            return x.to(device)

        return PoseGraph(*(mv(x) for x in self))


def _as(x, like: torch.Tensor, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=dtype).to(like.device)


def with_position_priors(g: PoseGraph, idx, xyz, weight) -> PoseGraph:
    """Attach GPS-style camera-centre priors (world coordinates)."""
    like = g.poses.t
    return g._replace(prior_idx=_as(idx, like, torch.int64),
                      prior_xyz=_as(xyz, like, torch.float32),
                      prior_weight=_as(weight, like, torch.float32))


def with_pose_priors(g: PoseGraph, idx, T: SE3, weight) -> PoseGraph:
    """Attach full SE3 anchors on the given poses."""
    like = g.poses.t
    return g._replace(prior_T_idx=_as(idx, like, torch.int64),
                      prior_T=SE3(T.R.to(like.device), T.t.to(like.device)),
                      prior_T_weight=_as(weight, like, torch.float32))


def _take(T: SE3, idx) -> SE3:
    return SE3(T.R[idx], T.t[idx])


def edge_residuals(poses: SE3, g: PoseGraph) -> torch.Tensor:
    """(E, 6) residuals r_e = log(Z^-1 T_i T_j^-1)."""
    rel = _take(poses, g.edge_i).compose(_take(poses, g.edge_j).inverse())
    return g.Z.inverse().compose(rel).log()


def _res_edge(xi, Ri, ti, Rj, tj, ZR, Zt):
    """One edge's residual at left perturbations xi = [xi_i, xi_j] (12,),
    twice: the Jacobian's function and its value (``has_aux``)."""
    Ti = SE3.exp(xi[:6]).compose(SE3(Ri, ti))
    Tj = SE3.exp(xi[6:]).compose(SE3(Rj, tj))
    r = SE3(ZR, Zt).inverse().compose(Ti.compose(Tj.inverse())).log()
    return r, r


def _edge_jacobians(poses: SE3, g: PoseGraph):
    """Per-edge residual and Jacobians wrt the left-multiplicative twists of
    T_i and T_j: (r (E, 6), Ji (E, 6, 6), Jj (E, 6, 6))."""
    zeros = poses.t.new_zeros(12)
    jac = torch.func.jacfwd(_res_edge, has_aux=True)
    J, r = torch.func.vmap(lambda *a: jac(zeros, *a))(
        poses.R[g.edge_i], poses.t[g.edge_i], poses.R[g.edge_j], poses.t[g.edge_j],
        g.Z.R, g.Z.t)
    return r, J[..., :6], J[..., 6:]


def _robust_weight(rn, delta, kernel: str):
    """IRLS weight rho'(r)/r for residual norm rn: Huber's linear tail keeps
    a constant pull on gross outliers; Geman-McClure redescends to zero
    (for possibly-wrong loop closures)."""
    if kernel == "huber":
        return torch.where(rn <= delta, torch.ones_like(rn), delta / torch.clamp(rn, min=1e-12))
    if kernel == "geman":
        return (delta ** 2 / (delta ** 2 + rn ** 2)) ** 2
    raise ValueError(f"unknown robust kernel {kernel!r}")


def _robust_cost(rn, delta, kernel: str):
    """The true robust loss rho(rn), which LM acceptance compares (the IRLS
    surrogate is not monotone for redescending kernels)."""
    if delta is None:
        return 0.5 * rn * rn
    if kernel == "huber":
        return torch.where(rn <= delta, 0.5 * rn * rn, delta * (rn - 0.5 * delta))
    if kernel == "geman":
        return 0.5 * delta ** 2 * rn ** 2 / (delta ** 2 + rn ** 2)
    raise ValueError(f"unknown robust kernel {kernel!r}")


def _center(R, t):
    """Camera centre c = -R^T t (batched)."""
    return -torch.einsum("...ji,...j->...i", R, t)


def _prior_residuals(poses: SE3, g: PoseGraph):
    """(pos_r (K, 3) or None, pose_r (K2, 6) or None)."""
    pos_r = pose_r = None
    if g.prior_idx is not None:
        pos_r = _center(poses.R[g.prior_idx], poses.t[g.prior_idx]) - g.prior_xyz
    if g.prior_T_idx is not None:
        pose_r = g.prior_T.inverse().compose(_take(poses, g.prior_T_idx)).log()
    return pos_r, pose_r


def _prior_cost(poses: SE3, g: PoseGraph, prior_delta, kernel: str):
    pos_r, pose_r = _prior_residuals(poses, g)
    cost = poses.t.new_zeros(())
    if pos_r is not None:
        cost = cost + (g.prior_weight
                       * _robust_cost(torch.linalg.norm(pos_r, dim=-1), prior_delta,
                                      kernel)).sum()
    if pose_r is not None:
        cost = cost + (g.prior_T_weight
                       * _robust_cost(torch.linalg.norm(pose_r, dim=-1), prior_delta,
                                      kernel)).sum()
    return cost


def _res_pos(xi, R, t, xyz):
    T = SE3.exp(xi).compose(SE3(R, t))
    r = _center(T.R, T.t) - xyz
    return r, r


def _res_pose(xi, R, t, ZR, Zt):
    r = SE3(ZR, Zt).inverse().compose(SE3.exp(xi).compose(SE3(R, t))).log()
    return r, r


def _weighted_blocks(J, r, w):
    """(J^T W J, J^T W r) per row of a (K, d, 6) Jacobian."""
    Jw = J * w[:, None, None]
    return torch.einsum("eki,ekj->eij", Jw, J), torch.einsum("eki,ek->ei", Jw, r)


def _prior_normal_blocks(poses: SE3, g: PoseGraph, prior_delta, kernel: str):
    """Unary normal-equation blocks: a list of (idx, Hk (K, 6, 6),
    gk (K, 6)), one group per prior type present."""
    groups = []
    zeros = poses.t.new_zeros(6)
    for idx, res, extra, weight in (
            (g.prior_idx, _res_pos, (g.prior_xyz,), g.prior_weight),
            (g.prior_T_idx, _res_pose,
             None if g.prior_T is None else (g.prior_T.R, g.prior_T.t), g.prior_T_weight)):
        if idx is None:
            continue
        jac = torch.func.jacfwd(res, has_aux=True)
        J, r = torch.func.vmap(lambda *a: jac(zeros, *a))(poses.R[idx], poses.t[idx], *extra)
        w = weight
        if prior_delta is not None:
            w = w * _robust_weight(torch.linalg.norm(r, dim=-1), prior_delta, kernel)
        groups.append((idx, *_weighted_blocks(J, r, w)))
    return groups


def _graph_cost(poses: SE3, g: PoseGraph, delta, kernel: str, prior_delta=None):
    """sum_e edge_weight * rho(|r_e|) (+ prior terms): residuals only, the
    LM acceptance criterion."""
    rn = torch.linalg.norm(edge_residuals(poses, g), dim=-1)
    cost = (g.edge_weight * _robust_cost(rn, delta, kernel)).sum()
    if g.prior_idx is not None or g.prior_T_idx is not None:
        cost = cost + _prior_cost(poses, g, prior_delta, kernel)
    return cost


def _edge_normal_blocks(poses: SE3, g: PoseGraph, huber_delta, kernel: str = "huber"):
    """Per-edge 6x6 normal-equation blocks (IRLS-weighted): (Hii, Hjj, Hij,
    gi, gj, w, r); the dense assembly and the PCG matvec share them."""
    r, Ji, Jj = _edge_jacobians(poses, g)
    w = g.edge_weight
    if huber_delta is not None:
        w = w * _robust_weight(torch.linalg.norm(r, dim=-1), huber_delta, kernel)
    Hii, gi = _weighted_blocks(Ji, r, w)
    Hjj, gj = _weighted_blocks(Jj, r, w)
    Hij = torch.einsum("eki,ekj->eij", Ji * w[:, None, None], Jj)
    return Hii, Hjj, Hij, gi, gj, w, r


class _KeySum(NamedTuple):
    """Row sums by keys that stay fixed for a solve, in a fixed order: the
    stable permutation that sorts the keys, the sorted int32 keys, their
    segment offsets and the longest segment (``sorted_segment_sum``'s
    inputs), and the segment count."""

    perm: torch.Tensor
    seg: torch.Tensor
    offsets: torch.Tensor
    max_len: int
    n: int


def _key_sum(keys, n: int) -> _KeySum:
    """The _KeySum of the concatenated ``keys`` into ``n`` segments (one
    readback: the longest segment)."""
    k = torch.cat([x.reshape(-1).long() for x in keys])
    perm = torch.argsort(k, stable=True)
    seg = k[perm].to(torch.int32).contiguous()
    offsets = segment_offsets(seg, n)
    return _KeySum(perm, seg, offsets, int(segment_lengths(offsets).max()), n)


def _sum_rows(ks: _KeySum, parts) -> torch.Tensor:
    """(n, ...) sums of the rows of ``parts`` (one tensor per key set given
    to ``_key_sum``, in that order), through one K4 call."""
    tail = parts[0].shape[1:]
    vals = torch.cat([p.reshape(p.shape[0], -1) for p in parts])[ks.perm].contiguous()
    out = sorted_segment_sum(vals, ks.seg, ks.n, ks.offsets, ks.max_len)
    return out.reshape((ks.n,) + tuple(tail))


def _prior_indices(g):
    """The prior groups' pose indices, in ``_prior_normal_blocks``' order
    (none on a ``sim3.Sim3Graph``)."""
    return [idx.long() for idx in (getattr(g, "prior_idx", None),
                                   getattr(g, "prior_T_idx", None)) if idx is not None]


def _node_sum(g, n: int) -> _KeySum:
    """Sums into the poses: edge_i's rows, edge_j's, then each prior's."""
    return _key_sum([g.edge_i, g.edge_j, *_prior_indices(g)], n)


def _dense_sums(g, n: int):
    """(H's block sum into N*N segments, the gradient's node sum)."""
    ei, ej = g.edge_i.long(), g.edge_j.long()
    blocks = [ei * n + ei, ej * n + ej, ei * n + ej, ej * n + ei]
    blocks += [idx * n + idx for idx in _prior_indices(g)]
    return _key_sum(blocks, n * n), _node_sum(g, n)


def _build_normal_eqs(poses: SE3, g: PoseGraph, huber_delta, kernel: str = "huber",
                      prior_delta=None, sums=None):
    """(H (6N, 6N), grad (6N,), IRLS cost): four 6x6 blocks an edge summed
    into an (N*N, 6, 6) view of H in a fixed order. ``sums``:
    ``_dense_sums(g, N)``, built here when not given (a solve builds it
    once)."""
    n = poses.R.shape[0]
    h_sum, g_sum = _dense_sums(g, n) if sums is None else sums
    Hii, Hjj, Hij, gi, gj, w, r = _edge_normal_blocks(poses, g, huber_delta, kernel)
    priors = _prior_normal_blocks(poses, g, prior_delta, kernel)
    H = _sum_rows(h_sum, [Hii, Hjj, Hij, Hij.transpose(-1, -2), *(Hk for _, Hk, _ in priors)])
    grad = _sum_rows(g_sum, [gi, gj, *(gk for _, _, gk in priors)])
    cost = 0.5 * (w * (r * r).sum(-1)).sum()
    H = H.view(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    return H, grad.reshape(6 * n), cost


def _pcg_normal_step(g: PoseGraph, poses: SE3, lam, huber_delta, kernel, upd,
                     pcg_iters: int, prior_delta=None, node_sum=None):
    """One LM linearization solved matrix-free: the damped gauge-masked
    normal equations ``(H + lam diag(H)) dx = -grad`` by block-Jacobi PCG,
    never forming H. The blocks are put into the node sum's key order once
    a step (``node_sum``: ``_node_sum(g, N)``, built here when not given):
    row r of the sum is ``A[r] x[a[r]] + B[r] x[b[r]]``, so a matvec is two
    gathers, two batched 6x6 block products and one K4 launch. Fixed iteration count
    with guarded alpha/beta (extra iterations are numeric no-ops); fixed
    poses ride an identity block with zero gradient, as in the dense
    path."""
    n = poses.R.shape[0]
    node = _node_sum(g, n) if node_sum is None else node_sum
    Hii, Hjj, Hij, gi, gj, _, _ = _edge_normal_blocks(poses, g, huber_delta, kernel)
    ei, ej = g.edge_i.long(), g.edge_j.long()
    updc = upd[:, None]
    prior_groups = [(idx.long(), Hk, gk)
                    for idx, Hk, gk in _prior_normal_blocks(poses, g, prior_delta, kernel)]
    grad = _sum_rows(node, [gi, gj, *(gk for _, _, gk in prior_groups)]) * updc
    D = _sum_rows(node, [Hii, Hjj, *(Hk for _, Hk, _ in prior_groups)])
    d = torch.diagonal(D, dim1=-2, dim2=-1)
    damp = lam * d + 1e-10
    eye6 = torch.eye(6, dtype=D.dtype, device=D.device)
    Dd = torch.where(upd[:, None, None] > 0, D + torch.diag_embed(damp), eye6)
    Minv = torch.linalg.inv_ex(Dd)[0]  # no singularity check, which would read back
    # Edge i's row: Hii x_i + Hij x_j; edge j's: Hij^T x_i + Hjj x_j; a
    # prior's: Hk x_k (its second block is zero).
    A = torch.cat([Hii, Hij.transpose(-1, -2), *(Hk for _, Hk, _ in prior_groups)])
    B = torch.cat([Hij, Hjj, *(torch.zeros_like(Hk) for _, Hk, _ in prior_groups)])
    a = torch.cat([ei, ei, *(idx for idx, _, _ in prior_groups)])
    b = torch.cat([ej, ej, *(idx for idx, _, _ in prior_groups)])
    A, B, a, b = A[node.perm], B[node.perm], a[node.perm], b[node.perm]

    def matvec(x):
        xm = x * updc
        rows = (torch.einsum("rij,rj->ri", A, xm[a])
                + torch.einsum("rij,rj->ri", B, xm[b])).contiguous()
        y = sorted_segment_sum(rows, node.seg, n, node.offsets, node.max_len) + damp * xm
        return y * updc + (1.0 - updc) * x

    def precond(r):
        return torch.einsum("nij,nj->ni", Minv, r)

    def guarded(num, den):
        tiny = den.abs() < 1e-20
        return torch.where(tiny, torch.zeros_like(num),
                           num / torch.where(tiny, torch.ones_like(den), den))

    r = -grad
    z = precond(r)
    x, p, rz = torch.zeros_like(r), z, (r * z).sum()
    for _ in range(pcg_iters):
        Hp = matvec(p)
        alpha = guarded(rz, (p * Hp).sum())
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        rz_new = (r * z).sum()
        p = p * guarded(rz_new, rz) + z
        rz = rz_new
    return x


class PGOResult(NamedTuple):
    poses: SE3
    cost0: torch.Tensor
    cost: torch.Tensor
    iters: int


def pgo_solve(g: PoseGraph, max_iters: int = 30, lam0: float = 1e-4,
              huber_delta_static: float | None = None, kernel: str = "huber",
              rtol: float = 1e-8, solver: str = "dense", pcg_iters: int = 64,
              prior_delta: float | None = None, device=None) -> PGOResult:
    """LM on the pose graph on ``device`` (``cuda`` unless ``device="cpu"``).

    ``solver="dense"``: one damped Cholesky of the (6N, 6N) system an
    iteration (config 4's ~500-1000 poses); ``solver="pcg"``: matrix-free
    block-Jacobi PCG, O(E) memory. ``prior_delta``: robust width of the
    prior factors in their own units (None: quadratic). Each iteration
    reads back one (accept, converged) pair; the loop stops after
    ``max_iters`` or at an accepted step whose relative cost change is
    below ``rtol``, as the JAX package's ``while_loop`` does."""
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown solver {solver!r}")
    g = g.to(resolve_device(device))
    n = g.poses.R.shape[0]
    upd = (g.pose_mask & ~g.fixed).float()
    upd6 = upd.repeat_interleave(6)

    def cost_of(T: SE3):
        return _graph_cost(T, g, huber_delta_static, kernel, prior_delta)

    # The edge topology is fixed for the solve: sort its keys once.
    sums = _dense_sums(g, n) if solver == "dense" else _node_sum(g, n)

    def dense_step(T: SE3, lam):
        H, grad, _ = _build_normal_eqs(T, g, huber_delta_static, kernel, prior_delta, sums)
        H = H * upd6[:, None] * upd6[None, :] + torch.diag(1.0 - upd6)
        grad = grad * upd6
        Hd = H + torch.diag(lam * torch.diagonal(H) + 1e-10)
        L, info = torch.linalg.cholesky_ex(Hd)
        dx = -torch.cholesky_solve(grad[:, None], L)[:, 0]
        # A failed factorization is a NaN step (rejected), as in XLA.
        return torch.where(info != 0, torch.full_like(dx, float("nan")), dx).reshape(n, 6)

    T = g.poses
    cost0 = cost = cost_of(T)
    lam = torch.full((), lam0, dtype=torch.float32, device=T.t.device)
    it, done = 0, False
    while it < max_iters and not done:
        if solver == "dense":
            dx = dense_step(T, lam)
        else:
            dx = _pcg_normal_step(g, T, lam, huber_delta_static, kernel, upd, pcg_iters,
                                  prior_delta, sums)
        bad = torch.isnan(dx).any()
        dx = torch.where(bad, torch.zeros_like(dx), dx) * upd[:, None]
        new = SE3.exp(dx).compose(T)
        new_cost = cost_of(new)
        accept_t = (new_cost < cost) & ~bad
        rel = (cost - new_cost).abs() / torch.clamp(cost, min=1e-15)
        accept, small = torch.stack([accept_t, rel < rtol]).tolist()
        if accept:
            T, cost = new, new_cost
        lam = torch.clamp(lam * (0.3 if accept else 5.0), 1e-10, 1e8)
        done = accept and small
        it += 1
    return PGOResult(poses=T, cost0=cost0, cost=cost, iters=it)


def pgo_solve_hierarchical(g: PoseGraph, segment_len: int = 250, coarse_max_iters: int = 40,
                           polish_max_iters: int = 10, pcg_iters: int = 80,
                           huber_delta_static: float | None = None, kernel: str = "huber",
                           device=None) -> PGOResult:
    """Coarse-to-fine LM for long chain-backbone graphs, as the JAX
    package's: (1) condense the odometry chain into anchors (every
    ``segment_len``-th pose, the last, and every closure endpoint) with
    composed measurements from float64 host bookkeeping, closures
    transported to their anchors; (2) solve the anchor graph densely; (3)
    spread each anchor's correction along its segment by geodesic
    interpolation; (4) polish with the flat PCG LM. Needs a live (k, k-1)
    edge for every live k."""
    g = g.to(resolve_device(device))
    dev = g.poses.t.device
    n = int(g.pose_mask.sum())
    ei = g.edge_i.cpu().numpy()
    ej = g.edge_j.cpu().numpy()
    ew = g.edge_weight.cpu().numpy()
    live_e = ew > 0
    chain = live_e & (ei == ej + 1) & (ei < n)
    chain_of = -np.ones(n, np.int64)
    chain_of[ei[chain]] = np.where(chain)[0]
    if n > 1 and (chain_of[1:n] < 0).any():
        missing = int(np.where(chain_of[1:n] < 0)[0][0]) + 1
        raise ValueError(f"hierarchical solve needs a full odometry chain; no live "
                         f"(k, k-1) edge for k={missing}")
    closure = live_e & ~chain & (ei < n) & (ej < n)

    # 1. cumulative odometry C_k = Z_k ... Z_1 (C_0 = I), float64.
    ZR = g.Z.R.cpu().numpy().astype(np.float64)
    Zt = g.Z.t.cpu().numpy().astype(np.float64)
    C_R = np.zeros((n, 3, 3))
    C_t = np.zeros((n, 3))
    C_R[0] = np.eye(3)
    for k in range(1, n):
        e = chain_of[k]
        C_R[k] = ZR[e] @ C_R[k - 1]
        C_t[k] = ZR[e] @ C_t[k - 1] + Zt[e]

    anchors = np.unique(np.concatenate([np.arange(0, n, segment_len), [n - 1],
                                        ei[closure], ej[closure]])).astype(np.int64)
    M = len(anchors)
    seg_of = np.searchsorted(anchors, np.arange(n), side="right") - 1
    a_idx = -np.ones(n, np.int64)
    a_idx[anchors] = np.arange(M)

    def rel(Ra, ta, Rb, tb):
        R = Ra @ Rb.T
        return R, ta - R @ tb

    cei, cej, cR, ct, cw = [], [], [], [], []
    w_chain = float(ew[chain].mean()) if chain.any() else 1.0
    for m in range(1, M):
        a, b = anchors[m], anchors[m - 1]
        R, t = rel(C_R[a], C_t[a], C_R[b], C_t[b])
        cei.append(m), cej.append(m - 1), cR.append(R), ct.append(t)
        cw.append(w_chain / max(int(a - b), 1))
    for e in np.where(closure)[0]:
        i, j = int(ei[e]), int(ej[e])
        ai, aj = anchors[seg_of[i]], anchors[seg_of[j]]
        DiR, Dit = rel(C_R[i], C_t[i], C_R[ai], C_t[ai])
        DjR, Djt = rel(C_R[j], C_t[j], C_R[aj], C_t[aj])
        R1 = DiR.T @ ZR[e]                 # Z' = Di^-1 Z Dj
        t1 = DiR.T @ (Zt[e] - Dit)
        cei.append(int(a_idx[ai])), cej.append(int(a_idx[aj]))
        cR.append(R1 @ DjR), ct.append(R1 @ Djt + t1), cw.append(float(ew[e]))

    def tens(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    R_old = g.poses.R.cpu().numpy().astype(np.float64)[:n]
    t_old = g.poses.t.cpu().numpy().astype(np.float64)[:n]
    fixed_a = g.fixed.cpu().numpy()[anchors]
    if not fixed_a.any():
        fixed_a = np.arange(M) == 0
    T_old_a = SE3(tens(R_old[anchors].astype(np.float32)), tens(t_old[anchors].astype(np.float32)))
    coarse = PoseGraph(poses=T_old_a, edge_i=tens(np.asarray(cei), torch.int64),
                       edge_j=tens(np.asarray(cej), torch.int64),
                       Z=SE3(tens(np.stack(cR).astype(np.float32)),
                             tens(np.stack(ct).astype(np.float32))),
                       edge_weight=tens(np.asarray(cw, np.float32)),
                       pose_mask=torch.ones(M, dtype=torch.bool, device=dev),
                       fixed=tens(fixed_a, torch.bool))

    cost0 = _graph_cost(g.poses, g, huber_delta_static, kernel, None)

    # 2. small dense solve on the anchor graph
    cres = pgo_solve(coarse, max_iters=coarse_max_iters, solver="dense",
                     huber_delta_static=huber_delta_static, kernel=kernel, device=dev)

    # 3. per-anchor left-deltas, geodesically interpolated along segments
    D = cres.poses.compose(T_old_a.inverse())
    seg = tens(seg_of, torch.int64)
    nxt = torch.clamp(seg + 1, max=M - 1)
    anc = tens(anchors, torch.int64)
    a0, a1 = anc[seg], anc[nxt]
    k = torch.arange(n, device=dev)
    frac = torch.where(a1 > a0, (k - a0) / torch.clamp(a1 - a0, min=1),
                       torch.zeros((), device=dev))
    Dm, Dn = _take(D, seg), _take(D, nxt)
    step = Dn.compose(Dm.inverse()).log()
    T_new = SE3.exp(frac[:, None] * step).compose(Dm).compose(
        SE3(tens(R_old.astype(np.float32)), tens(t_old.astype(np.float32))))
    R_full = g.poses.R.clone()
    t_full = g.poses.t.clone()
    R_full[:n] = T_new.R
    t_full[:n] = T_new.t

    # 4. polish with the flat PCG LM
    res = pgo_solve(g._replace(poses=SE3(R_full, t_full)), max_iters=polish_max_iters,
                    solver="pcg", pcg_iters=pcg_iters, huber_delta_static=huber_delta_static,
                    kernel=kernel, device=dev)
    return PGOResult(poses=res.poses, cost0=cost0, cost=res.cost, iters=cres.iters + res.iters)
