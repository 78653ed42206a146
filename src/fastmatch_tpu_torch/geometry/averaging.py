"""Global rotation and translation averaging over a view graph.

Port of ``fastmatch_tpu/geometry/averaging.py``. Rotation averaging is the
Lie-algebra Gauss-Newton iteration (Govindu-style): with world->camera
rotations ``R_i`` and measured relative rotations ``R_ij = R_j R_i^T``,
each outer iteration solves

    min_d  sum_e w_e || d_j - R_ij d_i - r_e ||^2        (gauge: d_0 = 0)

by conjugate gradients on the normal operator and retracts, with Huber
IRLS weights between iterations. Translation averaging finds the camera
centres whose differences best agree with the measured world-frame
directions: a spectral stage (shifted inverse power iteration on the
perpendicular-violation operator, each step a CG solve, IRLS between
rounds), then an LUD polish with per-edge scales under ``sum s_e = E``.

Every iteration count is fixed and nothing is read back to the host
between a solve's start and its result. Every sum over the edges into the
frames (the JAX package's ``.at[].add`` scatters) is one K4 launch over a
key set that stays fixed for the whole solve: a view graph's edges never
change, and masks and IRLS weights enter only as row weights. Two runs on
the card are therefore bit-identical (``index_add_`` sums with float
atomics there). ``edge_keys`` builds the key set (one readback); a caller
that solves more than once on the same edges builds it once and passes it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fastmatch_tpu_torch.core.lie import SO3
from fastmatch_tpu_torch.posegraph.pgo import _key_sum, _KeySum, _sum_rows


class ViewGraph(NamedTuple):
    """Pairwise relative-pose measurements, as tensors on one device.

    edge_i, edge_j: (E,) int32 frame indices (i < j by convention).
    R_ij: (E, 3, 3) relative rotation, ``x_cj = R_ij x_ci + t_ij``
      (``R_ij = R_j R_i^T`` for world->camera frames), as
      ``geometry/ransac.ransac_essential`` returns it for (x1=i, x2=j).
    t_ij: (E, 3) unit translation direction in camera-j coordinates.
    weight: (E,) f32 edge confidence (e.g. the RANSAC inlier count).
    mask: (E,) bool valid edges.
    """

    edge_i: torch.Tensor
    edge_j: torch.Tensor
    R_ij: torch.Tensor
    t_ij: torch.Tensor
    weight: torch.Tensor
    mask: torch.Tensor


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def spanning_tree_rotations(edge_i, edge_j, R_ij, weight, mask,
                            n_frames: int) -> np.ndarray:
    """Host-side init: propagate rotations over a max-weight spanning tree.

    BFS from frame 0 following edges in descending weight order. Frames
    unreachable from frame 0 stay at identity (the averaging only moves
    frames touched by valid edges, so they remain identity there too).
    """
    edge_i = _np(edge_i)
    edge_j = _np(edge_j)
    R_ij = _np(R_ij)
    mask = _np(mask)
    order = np.argsort(-np.where(mask, _np(weight), -1.0))
    adj: list[list[tuple[int, int]]] = [[] for _ in range(n_frames)]
    for e in order:
        if not mask[e]:
            continue
        adj[int(edge_i[e])].append((int(edge_j[e]), e))
        adj[int(edge_j[e])].append((int(edge_i[e]), e))
    R = np.tile(np.eye(3, dtype=np.float32), (n_frames, 1, 1))
    seen = np.zeros(n_frames, bool)
    seen[0] = True
    stack = [0]
    while stack:
        u = stack.pop()
        for v, e in adj[u]:
            if seen[v]:
                continue
            seen[v] = True
            if int(edge_i[e]) == u:     # R_j = R_ij R_i
                R[v] = R_ij[e] @ R[u]
            else:                       # R_i = R_ij^T R_j
                R[v] = R_ij[e].T @ R[u]
            stack.append(v)
    return R


def edge_keys(g: ViewGraph, n_frames: int) -> _KeySum:
    """The key set of every edge sum into the frames: edge_j's rows, then
    edge_i's (one readback: the longest segment)."""
    return _key_sum([g.edge_j, g.edge_i], n_frames)


def _into_frames(keys: _KeySum, at_j: torch.Tensor, at_i: torch.Tensor) -> torch.Tensor:
    """(F, ...) sums of ``at_j``'s rows into edge_j's frames plus ``at_i``'s
    into edge_i's: one K4 launch."""
    return _sum_rows(keys, [at_j, at_i])


def _update_mask(g: ViewGraph, keys: _KeySum) -> torch.Tensor:
    """(F, 1): 1 for frames touched by a valid edge, except frame 0 (the
    gauge)."""
    m = g.mask.to(torch.float32)[:, None]
    upd = (_into_frames(keys, m, m) > 0).to(torch.float32)
    upd[0] = 0.0
    return upd


def _huber_weight(r_norm: torch.Tensor, delta) -> torch.Tensor:
    """IRLS weight for the Huber kernel: 1 inside, delta/|r| outside."""
    return torch.clamp(delta / torch.clamp(r_norm, min=1e-12), max=1.0)


def _cg(matvec, b: torch.Tensor, iters: int, eps: float = 1e-12) -> torch.Tensor:
    """Plain conjugate gradients, fixed iteration count, (F, 3) unknowns."""
    x = torch.zeros_like(b)
    r = p = b
    rs = (b * b).sum()
    for _ in range(iters):
        Ap = matvec(p)
        alpha = rs / torch.clamp((p * Ap).sum(), min=eps)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = (r * r).sum()
        p = r + (rs_new / torch.clamp(rs, min=eps)) * p
        rs = rs_new
    return x


def _edge_rotation_error(g: ViewGraph, R: torch.Tensor) -> torch.Tensor:
    """(E, 3) Log(R_ij R_i R_j^T)."""
    ei, ej = g.edge_i.long(), g.edge_j.long()
    return SO3.log(torch.einsum("eab,ebc,edc->ead", g.R_ij, R[ei], R[ej]))


def rotation_averaging(
    g: ViewGraph,
    n_frames: int,
    R0: torch.Tensor,
    iters: int = 15,
    cg_iters: int = 30,
    huber_delta: float = 0.1,
    lam: float = 1e-6,
    keys: _KeySum | None = None,
) -> torch.Tensor:
    """IRLS Gauss-Newton rotation averaging on the graph's device. Returns
    (F, 3, 3) rotations.

    R0: (F, 3, 3) initialization (``spanning_tree_rotations``) on that
    device. Gauge: frame 0 stays at R0[0]. ``huber_delta`` is the robust
    width in radians of relative-rotation error; ``lam`` a small Tikhonov
    term keeping CG well-posed on weakly connected graphs. ``keys``:
    ``edge_keys(g, n_frames)``, built here when not given.
    """
    keys = edge_keys(g, n_frames) if keys is None else keys
    ei, ej = g.edge_i.long(), g.edge_j.long()
    Rij = g.R_ij
    w_edge = g.weight * g.mask.to(torch.float32)
    upd = _update_mask(g, keys)

    def normal_sum(u):
        """sum_e [u at j] - [R_ij^T u at i]: the normal operator's adjoint."""
        return _into_frames(keys, u, -torch.einsum("eba,eb->ea", Rij, u))

    R = R0.to(torch.float32)
    for _ in range(iters):
        r = _edge_rotation_error(g, R)
        w = (w_edge * _huber_weight(torch.linalg.norm(r, dim=-1), huber_delta))[:, None]

        def matvec(v):
            v = v * upd
            u = w * (v[ej] - torch.einsum("eab,eb->ea", Rij, v[ei]))
            return normal_sum(u) * upd + lam * v

        b = normal_sum(w * r) * upd
        delta = _cg(matvec, b, cg_iters) * upd
        R = torch.einsum("fab,fbc->fac", SO3.exp(delta), R)
    return R


def filter_edges_by_rotation(g: ViewGraph, R: torch.Tensor,
                             max_err_rad: float = 0.09) -> ViewGraph:
    """Drop edges inconsistent with the averaged rotations (1DSfM-style):
    an edge whose relative rotation disagrees with the global solution is
    almost always an outlier two-view estimate, and its translation
    direction would poison translation averaging. Returns the graph with
    those edges' mask cleared."""
    err = torch.linalg.norm(_edge_rotation_error(g, R), dim=-1)
    return g._replace(mask=g.mask & (err < max_err_rad))


def translation_averaging(
    g: ViewGraph,
    R: torch.Tensor,
    n_frames: int,
    irls_iters: int = 5,
    power_iters: int = 4,
    cg_iters: int = 50,
    refine_iters: int = 5,
    huber_delta: float = 0.1,
    sigma: float = 1e-2,
    s_floor: float = 0.05,
    keys: _KeySum | None = None,
) -> torch.Tensor:
    """Spectral + LUD translation averaging on the graph's device. Returns
    camera centres (F, 3).

    R: (F, 3, 3) global rotations from ``rotation_averaging``. Gauge: C_0
    = 0; the output has unit RMS centre norm. ``sigma`` is the
    inverse-iteration shift (relative to the mean edge weight);
    ``huber_delta`` the IRLS width as a fraction of edge length;
    ``s_floor`` keeps LUD edge scales from crossing zero. ``keys``:
    ``edge_keys(g, n_frames)``, built here when not given.
    """
    keys = edge_keys(g, n_frames) if keys is None else keys
    ei, ej = g.edge_i.long(), g.edge_j.long()
    mask = g.mask
    maskf = mask.to(torch.float32)
    # Normalize weights to O(1) so sigma and CG behave predictably.
    w_edge = g.weight * maskf
    w_edge = w_edge / torch.clamp(w_edge.sum() / torch.clamp(maskf.sum(), min=1.0),
                                  min=1e-12)
    # World-frame direction of (C_i - C_j): t_ij = R_j (C_i - C_j).
    d = torch.einsum("eba,eb->ea", R[ej], g.t_ij)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    upd = _update_mask(g, keys)

    def incidence_sum(u):
        """sum_e [u at i] - [u at j]."""
        return _into_frames(keys, -u, u)

    def perp_matvec(w):
        def mv(v):
            v = v * upd
            u = v[ei] - v[ej]
            u = w * (u - d * (d * u).sum(-1, keepdim=True))
            return incidence_sum(u) * upd + sigma * v
        return mv

    def fix_sign_scale(C):
        # Majority sign of edge projections, then unit RMS norm.
        proj = ((C[ei] - C[ej]) * d).sum(-1) * w_edge
        C = C * torch.sign(proj.sum() + 1e-30)
        rms = torch.sqrt(torch.clamp((C * C).sum() / n_frames, min=1e-18))
        return C / rms

    # --- stage 1: IRLS spectral solve of the perpendicular objective ----
    # Deterministic non-degenerate start: spread along an arbitrary ramp
    # (built on the device: a host constant would be a copy, and a sync).
    f = torch.arange(n_frames, dtype=torch.float32, device=R.device)
    f2 = f ** 2
    ramp = torch.stack([f * 1.0 + f2 * 0.01, f * 0.7 + f2 * -0.02, f * -0.4 + f2 * 0.03],
                       dim=-1)
    C = fix_sign_scale(ramp * upd)
    for _ in range(irls_iters):
        diff = C[ei] - C[ej]
        ln = torch.linalg.norm(diff, dim=-1)
        perp = diff - d * (d * diff).sum(-1, keepdim=True)
        w = (w_edge * _huber_weight(torch.linalg.norm(perp, dim=-1),
                                    huber_delta * torch.clamp(ln, min=1e-6)))[:, None]
        mv = perp_matvec(w)
        x = C
        for _ in range(power_iters):
            y = _cg(mv, x * upd, cg_iters)
            x = y / torch.sqrt(torch.clamp((y * y).sum(), min=1e-30))
        C = fix_sign_scale(x)

    # --- stage 2: LUD polish (per-edge scales, sum constraint) ----------
    n_valid = torch.clamp(maskf.sum(), min=1.0)
    w_safe = torch.where(mask, torch.clamp(w_edge, min=1e-6), 1.0)
    inv_w_sum = torch.where(mask, 1.0 / w_safe, 0.0).sum()
    # Rescale to the LUD gauge (mean edge scale 1) before polishing.
    proj = ((C[ei] - C[ej]) * d).sum(-1) * maskf
    C = C * n_valid / torch.clamp(proj.sum(), min=1e-12)
    for _ in range(refine_iters):
        diff = C[ei] - C[ej]
        p = torch.where(mask, (diff * d).sum(-1), 0.0)
        mu = (n_valid - p.sum()) / inv_w_sum
        s = torch.clamp(p + mu / w_safe, min=s_floor)
        rho = diff - s[:, None] * d
        w = (w_edge * _huber_weight(torch.linalg.norm(rho, dim=-1),
                                    huber_delta * torch.clamp(s, min=1e-6)))[:, None]

        def matvec(v):
            v = v * upd
            return incidence_sum(w * (v[ei] - v[ej])) * upd + 1e-6 * v

        b = incidence_sum(w * (s[:, None] * d)) * upd
        C = C + _cg(matvec, b - matvec(C), cg_iters) * upd
    return fix_sign_scale(C)
