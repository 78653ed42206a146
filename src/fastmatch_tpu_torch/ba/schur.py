"""Schur-complement reduced camera system, matrix-free.

Port of ``fastmatch_tpu/ba/schur.py`` (the ungrouped path): block normal
equations per camera (6x6), per point (3x3) and per observation (6x3
coupling), and PCG on the reduced camera system through its matrix-vector
product. Every reduction over the observation table goes through
``_seg_sum`` and so through the K4 kernel wrapper
(``kernels/segment_ops.sorted_segment_sum``), which needs sorted keys:
point keys are sorted by ``ba_solve``; camera keys are put in order by one
stable sort per solve (``segment_keys``), and camera-keyed values are
permuted into that order before each sum. ``segment_keys`` also builds each
key set's segment offsets and longest segment once per solve, which every
sum passes to the kernel. The point-keyed row gathers go
through the K5 kernel wrapper (``kernels/segment_ops.sorted_gather_rows``,
an exact copy); camera-keyed gathers stay plain indexing.

The grouped (block-dense) layout (``GroupedObs`` .. ``assemble_grouped``)
groups the observation table by point and by camera at fixed widths, so
each per-point and per-camera reduction is an einsum over a gathered
(segment, K, ...) tile: gathers and sums over a fixed K axis, no scatter,
in a fixed order on the card as on the CPU. The JAX package has no Pallas
kernel on that path, and neither has the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fastmatch_tpu_torch.core.lie import hat
from fastmatch_tpu_torch.kernels.segment_ops import (segment_lengths, segment_offsets,
                                                     sorted_gather_rows, sorted_segment_sum)


class SegmentKeys(NamedTuple):
    """Sorted reduction keys of one observation table, built once per
    solve. ``*_perm`` is the stable permutation that sorts the table's rows
    by that key, or None when the table is already in that order.
    ``pt_rows`` is each row's point key in the table's own order (``pt``
    itself once ``ba_solve`` has sorted the table by point). ``*_off`` are
    the sorted keys' segment offsets (``segment_offsets``) and ``*_max`` the
    longest segment's row count, which picks K4's variant. ``pt_gather`` is
    the (O, 3) float32 buffer that every point-keyed gather writes into:
    each gather's rows are consumed before the next gather."""

    pt: torch.Tensor
    pt_perm: torch.Tensor | None
    cam: torch.Tensor
    cam_perm: torch.Tensor | None
    pt_rows: torch.Tensor
    pt_off: torch.Tensor
    pt_max: int
    cam_off: torch.Tensor
    cam_max: int
    pt_gather: torch.Tensor


def _is_sorted(idx):
    return (idx[1:] >= idx[:-1]).all()


def segment_keys(obs, n_cams: int, n_points: int) -> SegmentKeys:
    """The observation table's SegmentKeys for ``n_cams`` camera and
    ``n_points`` point segments, with two readbacks."""
    pt_sorted, cam_sorted = torch.stack([_is_sorted(obs.pt_idx),
                                         _is_sorted(obs.cam_idx)]).tolist()

    def one(idx, is_sorted, n):
        perm = None if is_sorted else torch.argsort(idx, stable=True)
        keys = (idx if perm is None else idx[perm]).to(torch.int32).contiguous()
        return keys, perm, segment_offsets(keys, n)

    pt, pt_perm, pt_off = one(obs.pt_idx, pt_sorted, n_points)
    cam, cam_perm, cam_off = one(obs.cam_idx, cam_sorted, n_cams)
    pt_max, cam_max = torch.stack([segment_lengths(pt_off).max(),
                                   segment_lengths(cam_off).max()]).tolist()
    pt_rows = pt if pt_perm is None else obs.pt_idx.to(torch.int32).contiguous()
    pt_gather = torch.empty((pt.shape[0], 3), dtype=torch.float32, device=pt.device)
    return SegmentKeys(pt, pt_perm, cam, cam_perm, pt_rows, pt_off, pt_max, cam_off, cam_max,
                       pt_gather)


def _project(p):
    z = p[..., 2:3]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return p[..., :2] / z


def residuals_and_jacobians(poses, points, obs, huber_delta: float | None = None,
                            keys: SegmentKeys | None = None):
    """Per-observation residuals (O, 2), Jacobians Jc (O, 2, 6), Jp
    (O, 2, 3) and weights w (O,) folding mask, cheirality and Huber IRLS."""
    if keys is None:
        keys = segment_keys(obs, poses.R.shape[0], points.shape[0])
    Rc = _gather_rows(poses.R, obs.cam_idx)
    tc = _gather_rows(poses.t, obs.cam_idx)
    X = _gather_pt(points, keys)
    p = torch.einsum("oij,oj->oi", Rc, X) + tc
    res = _project(p) - obs.uv
    z = torch.where(p[:, 2].abs() < 1e-9, torch.full_like(p[:, 2], 1e-9), p[:, 2])
    iz = 1.0 / z
    zeros = torch.zeros_like(iz)
    Jproj = torch.stack([torch.stack([iz, zeros, -p[:, 0] * iz * iz], -1),
                         torch.stack([zeros, iz, -p[:, 1] * iz * iz], -1)], -2)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)
    Jc = Jproj @ torch.cat([eye, -hat(p)], dim=-1)
    Jp = Jproj @ Rc
    w = obs.mask.float()
    w = w * (p[:, 2] > 1e-6)
    if huber_delta is not None:
        rn = torch.linalg.vector_norm(res, dim=-1)
        w = w * torch.where(rn <= huber_delta, 1.0,
                            huber_delta / torch.clamp(rn, min=1e-12))
    return res, Jc, Jp, w


class BlockSystem(NamedTuple):
    """Block normal equations assembled from one linearization."""

    Hcc: torch.Tensor  # (C, 6, 6)
    Hpp: torch.Tensor  # (P, 3, 3)
    Wcp: torch.Tensor  # (O, 6, 3)
    gc: torch.Tensor   # (C, 6)
    gp: torch.Tensor   # (P, 3)
    Jc: torch.Tensor
    Jp: torch.Tensor
    w: torch.Tensor


def _seg_sum(vals, keys, n, perm, offsets, max_len, reduce=None):
    """Segment sum of (O, ...) rows by sorted ``keys`` into (n, ...), through
    the K4 kernel wrapper with the solve's offsets and longest segment;
    ``perm`` puts the rows in key order first. ``reduce`` (None: none) is
    applied to the sum: an all-reduce over the ranks that each hold a slice
    of the observation table (``dist/dist_ba.py``), the JAX package's
    ``_psum``."""
    shape = vals.shape
    flat = vals.reshape(shape[0], -1)
    if perm is not None:
        flat = flat[perm]
    out = sorted_segment_sum(flat.contiguous(), keys, n, offsets, max_len)
    out = out.reshape((n,) + shape[1:])
    return out if reduce is None else reduce(out)


def _seg_sum_pt(vals, keys: SegmentKeys, n, reduce=None):
    return _seg_sum(vals, keys.pt, n, keys.pt_perm, keys.pt_off, keys.pt_max, reduce)


def _seg_sum_cam(vals, keys: SegmentKeys, n, reduce=None):
    return _seg_sum(vals, keys.cam, n, keys.cam_perm, keys.cam_off, keys.cam_max, reduce)


def _gather_rows(table, idx):
    """table[idx] (plain indexing, as in the JAX package): camera keys."""
    return table[idx]


def _gather_pt(table, keys: SegmentKeys):
    """(P, 3) table rows by each observation's point key, through the K5
    kernel wrapper (``ba_solve`` sorts the observation table by point),
    into the solve's buffer ``keys.pt_gather``: use the result before the
    next gather."""
    return sorted_gather_rows(table.contiguous(), keys.pt_rows, out=keys.pt_gather)


def assemble(poses, points, obs, n_cams, n_points, huber_delta=None, keys=None, reduce=None):
    """Block normal equations and cost at (poses, points). With ``reduce``
    (the table is one rank's slice), every camera and point block and the
    cost are reduced over the ranks; the coupling blocks stay the rank's."""
    if keys is None:
        keys = segment_keys(obs, n_cams, n_points)
    res, Jc, Jp, w = residuals_and_jacobians(poses, points, obs, huber_delta, keys)
    wv = w[:, None, None]
    Hcc = _seg_sum_cam(torch.einsum("oki,okj->oij", Jc * wv, Jc), keys, n_cams, reduce)
    Hpp = _seg_sum_pt(torch.einsum("oki,okj->oij", Jp * wv, Jp), keys, n_points, reduce)
    Wcp = torch.einsum("oki,okj->oij", Jc * wv, Jp)
    gc = -_seg_sum_cam(torch.einsum("oki,ok->oi", Jc * wv, res), keys, n_cams, reduce)
    gp = -_seg_sum_pt(torch.einsum("oki,ok->oi", Jp * wv, res), keys, n_points, reduce)
    cost = 0.5 * (w * (res * res).sum(-1)).sum()
    if reduce is not None:
        cost = reduce(cost)
    return BlockSystem(Hcc, Hpp, Wcp, gc, gp, Jc, Jp, w), cost


def _damped(H, lam):
    """Levenberg damping: H + lam * diag(H) + eps*I."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + (lam * d + 1e-8)[..., None, :] * eye


def inv3x3(H):
    """Batched closed-form (cofactor) 3x3 inverse."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    Hc = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1),
                       torch.stack([G, Hc, I], -1)], -2)
    return inv / det[..., None, None]


def damped_pp_inverse(sys: BlockSystem, lam):
    """(H_pp + lam diag)^-1, closed form; constant for a fixed (sys, lam)."""
    return inv3x3(_damped(sys.Hpp, lam))


def schur_matvec(sys: BlockSystem, obs, lam, x, n_points, cam_update_mask,
                 keys: SegmentKeys, Hpp_inv=None, reduce=None):
    """S @ x for the reduced camera system; x (C, 6). With ``reduce``, the
    two coupling sums are reduced over the ranks (x, Hcc and Hpp are the
    same on every rank, the coupling blocks each rank's own)."""
    x = x * cam_update_mask[:, None]
    if Hpp_inv is None:
        Hpp_inv = damped_pp_inverse(sys, lam)
    yo = torch.einsum("oij,oi->oj", sys.Wcp, _gather_rows(x, obs.cam_idx))
    yp = _seg_sum_pt(yo, keys, n_points, reduce)
    zp = torch.einsum("pij,pj->pi", Hpp_inv, yp)
    wo = torch.einsum("oij,oj->oi", sys.Wcp, _gather_pt(zp, keys))
    wc = _seg_sum_cam(wo, keys, x.shape[0], reduce)
    Sx = torch.einsum("cij,cj->ci", _damped(sys.Hcc, lam), x) - wc
    return Sx * cam_update_mask[:, None]


def reduced_rhs(sys: BlockSystem, obs, lam, n_points, cam_update_mask,
                keys: SegmentKeys, Hpp_inv=None, reduce=None):
    """rhs = gc - H_cp (H_pp+lam)^-1 gp."""
    if Hpp_inv is None:
        Hpp_inv = damped_pp_inverse(sys, lam)
    zp = torch.einsum("pij,pj->pi", Hpp_inv, sys.gp)
    wo = torch.einsum("oij,oj->oi", sys.Wcp, _gather_pt(zp, keys))
    wc = _seg_sum_cam(wo, keys, sys.gc.shape[0], reduce)
    return (sys.gc - wc) * cam_update_mask[:, None]


def back_substitute(sys: BlockSystem, obs, lam, dx_c, n_points, keys: SegmentKeys,
                    Hpp_inv=None, reduce=None):
    """dx_p = (H_pp+lam)^-1 (gp - H_pc dx_c)."""
    if Hpp_inv is None:
        Hpp_inv = damped_pp_inverse(sys, lam)
    yo = torch.einsum("oij,oi->oj", sys.Wcp, _gather_rows(dx_c, obs.cam_idx))
    yp = _seg_sum_pt(yo, keys, n_points, reduce)
    return torch.einsum("pij,pj->pi", Hpp_inv, sys.gp - yp)


def pcg_solve(sys: BlockSystem, obs, lam, n_points, cam_update_mask,
              keys: SegmentKeys, iters: int = 40, Hpp_inv=None, reduce=None):
    """Preconditioned CG on the reduced camera system (block-Jacobi
    preconditioner, fixed iteration count, stagnation guarded as in the JAX
    package). With ``reduce`` each matvec is reduced over the ranks; the CG
    state is the same on every rank, so its dot products need no reduce."""
    if Hpp_inv is None:
        Hpp_inv = damped_pp_inverse(sys, lam)
    rhs = reduced_rhs(sys, obs, lam, n_points, cam_update_mask, keys, Hpp_inv, reduce)
    # inv_ex: no singularity check, which would read back (the blocks are damped).
    Minv = torch.linalg.inv_ex(_damped(sys.Hcc, lam))[0]

    def precond(r):
        return torch.einsum("cij,cj->ci", Minv, r) * cam_update_mask[:, None]

    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    p = z
    rz = (r * z).sum()
    for _ in range(iters):
        Sp = schur_matvec(sys, obs, lam, p, n_points, cam_update_mask, keys, Hpp_inv, reduce)
        pSp = (p * Sp).sum()
        small = pSp.abs() < 1e-20
        alpha = torch.where(small, 0.0, rz / torch.where(small, 1.0, pSp))
        x = x + alpha * p
        r = r - alpha * Sp
        z = precond(r)
        rz_new = (r * z).sum()
        small = rz.abs() < 1e-20
        beta = torch.where(small, 0.0, rz_new / torch.where(small, 1.0, rz))
        p = z + beta * p
        rz = rz_new
    return x


# --------------------------------------------------------------------------
# Scatter-free grouped layout
# --------------------------------------------------------------------------


class GroupedObs(NamedTuple):
    """The observation table grouped by point and by camera at fixed
    widths (int64 tensors on the table's device):

    pt_gather: (P, Kp) observation index per (point, slot); dead slots
               point at the zero pad row O.
    pt_cam:    (P, Kp) cam_idx of that observation (0 for pads: the padded
               coupling block is zero).
    cam_gather: (C, Kc), cam_pt: (C, Kc): the same, keyed by camera.
    """

    pt_gather: torch.Tensor
    pt_cam: torch.Tensor
    cam_gather: torch.Tensor
    cam_pt: torch.Tensor


def _group_one(idx: np.ndarray, mask: np.ndarray, n_segments: int, K=None) -> np.ndarray:
    """(n_segments, K) table of the live rows of each key, in row order,
    padded with the pad row ``len(idx)``; K is the longest segment rounded
    up to a multiple of 8 (at least 8) unless given."""
    o = idx.shape[0]
    live = np.where(mask)[0]
    counts = np.bincount(idx[live], minlength=n_segments)
    kmax = int(counts.max()) if live.size else 1
    if K is None:
        K = max(8, -8 * (-kmax // 8))
    elif kmax > K:
        raise ValueError(f"group width {K} < max segment count {kmax}")
    table = np.full((n_segments, K), o, np.int64)
    order = np.argsort(idx[live], kind="stable")
    sorted_obs = live[order]
    sorted_idx = idx[live][order]
    starts = np.searchsorted(sorted_idx, np.arange(n_segments))
    rank = np.arange(sorted_idx.shape[0]) - starts[sorted_idx]
    table[sorted_idx, rank] = sorted_obs
    return table


def group_observations(obs, n_cams: int, n_points: int, Kp: int | None = None,
                       Kc: int | None = None) -> GroupedObs:
    """Host-side (numpy) construction of the grouped layout, once per
    problem (the observation table is fixed across LM and PCG
    iterations); the tables land on the observation table's device."""
    ci = obs.cam_idx.cpu().numpy().astype(np.int64)
    pi = obs.pt_idx.cpu().numpy().astype(np.int64)
    mask = obs.mask.cpu().numpy()
    pt_gather = _group_one(pi, mask, n_points, Kp)
    cam_gather = _group_one(ci, mask, n_cams, Kc)
    ci_pad = np.concatenate([ci, np.zeros(1, np.int64)])
    pi_pad = np.concatenate([pi, np.zeros(1, np.int64)])
    dev = obs.cam_idx.device
    return GroupedObs(*(torch.from_numpy(a).to(dev) for a in (
        pt_gather, ci_pad[pt_gather], cam_gather, pi_pad[cam_gather])))


class GroupedSystem(NamedTuple):
    """Per-LM-iteration precompute for the scatter-free matvec: the
    coupling blocks gathered into both grouped layouts once an iteration,
    not once a matvec."""

    Wg_pt: torch.Tensor   # (P, Kp, 6, 3)
    Wg_cam: torch.Tensor  # (C, Kc, 6, 3)
    Hcc_l: torch.Tensor   # (C, 6, 6) damped
    Hpp_inv: torch.Tensor  # (P, 3, 3) damped inverse


def _pad_row(x):
    """x with one zero row appended (the grouped tables' pad row)."""
    return torch.cat([x, torch.zeros_like(x[:1])])


def grouped_system(sys: BlockSystem, grouped: GroupedObs, lam) -> GroupedSystem:
    Wpad = _pad_row(sys.Wcp)
    return GroupedSystem(Wg_pt=Wpad[grouped.pt_gather], Wg_cam=Wpad[grouped.cam_gather],
                         Hcc_l=_damped(sys.Hcc, lam), Hpp_inv=damped_pp_inverse(sys, lam))


def schur_matvec_grouped(gs: GroupedSystem, grouped: GroupedObs, x, cam_update_mask):
    """S @ x, scatter-free; x (C, 6)."""
    x = x * cam_update_mask[:, None]
    yp = torch.einsum("pkia,pki->pa", gs.Wg_pt, x[grouped.pt_cam])
    zp = torch.einsum("pij,pj->pi", gs.Hpp_inv, yp)
    wc = torch.einsum("ckia,cka->ci", gs.Wg_cam, zp[grouped.cam_pt])
    Sx = torch.einsum("cij,cj->ci", gs.Hcc_l, x) - wc
    return Sx * cam_update_mask[:, None]


def reduced_rhs_grouped(sys: BlockSystem, gs: GroupedSystem, grouped: GroupedObs,
                        cam_update_mask):
    zp = torch.einsum("pij,pj->pi", gs.Hpp_inv, sys.gp)
    wc = torch.einsum("ckia,cka->ci", gs.Wg_cam, zp[grouped.cam_pt])
    return (sys.gc - wc) * cam_update_mask[:, None]


def back_substitute_grouped(sys: BlockSystem, gs: GroupedSystem, grouped: GroupedObs, dx_c):
    yp = torch.einsum("pkia,pki->pa", gs.Wg_pt, dx_c[grouped.pt_cam])
    return torch.einsum("pij,pj->pi", gs.Hpp_inv, sys.gp - yp)


def pcg_solve_grouped(sys: BlockSystem, gs: GroupedSystem, grouped: GroupedObs,
                      cam_update_mask, iters: int = 40):
    """PCG on the reduced camera system with the scatter-free matvec; equal
    to ``pcg_solve`` up to summation order."""
    rhs = reduced_rhs_grouped(sys, gs, grouped, cam_update_mask)
    Minv = torch.linalg.inv_ex(gs.Hcc_l)[0]

    def precond(r):
        return torch.einsum("cij,cj->ci", Minv, r) * cam_update_mask[:, None]

    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    p = z
    rz = (r * z).sum()
    for _ in range(iters):
        Sp = schur_matvec_grouped(gs, grouped, p, cam_update_mask)
        pSp = (p * Sp).sum()
        small = pSp.abs() < 1e-20
        alpha = torch.where(small, 0.0, rz / torch.where(small, 1.0, pSp))
        x = x + alpha * p
        r = r - alpha * Sp
        z = precond(r)
        rz_new = (r * z).sum()
        small = rz.abs() < 1e-20
        beta = torch.where(small, 0.0, rz_new / torch.where(small, 1.0, rz))
        p = z + beta * p
        rz = rz_new
    return x


def assemble_grouped(poses, points, obs, grouped: GroupedObs, n_cams, n_points,
                     huber_delta=None, keys=None):
    """Scatter-free assembly: per-observation residuals and Jacobians
    gathered into the grouped layouts and reduced by einsums over K.
    Equal to ``assemble`` up to summation order."""
    if keys is None:
        keys = segment_keys(obs, n_cams, n_points)
    res, Jc, Jp, w = residuals_and_jacobians(poses, points, obs, huber_delta, keys)
    wv = w[:, None, None]
    Jcw = Jc * wv
    Jpw = Jp * wv
    res_pad = _pad_row(res)
    pg, cg = grouped.pt_gather, grouped.cam_gather
    Jp_g = _pad_row(Jpw)[pg]
    Hpp = torch.einsum("pkai,pkaj->pij", Jp_g, _pad_row(Jp)[pg])
    gp = -torch.einsum("pkai,pka->pi", Jp_g, res_pad[pg])
    Jc_g = _pad_row(Jcw)[cg]
    Hcc = torch.einsum("ckai,ckaj->cij", Jc_g, _pad_row(Jc)[cg])
    gc = -torch.einsum("ckai,cka->ci", Jc_g, res_pad[cg])
    Wcp = torch.einsum("oki,okj->oij", Jcw, Jp)
    cost = 0.5 * (w * (res * res).sum(-1)).sum()
    return BlockSystem(Hcc, Hpp, Wcp, gc, gp, Jc, Jp, w), cost
