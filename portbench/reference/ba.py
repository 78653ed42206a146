"""Plain bundle adjustment: residuals, cost, Schur-reduced LM step and solve.

Plain PyTorch, independent of the port. It takes the problem the benchmark
made (poses, points, the observation table) and works out again what
``ba_solve`` computes from it. Frozen copies of the port's formulas
(``ba/schur.py``, ``ba/lm.py``, ``core/lie.py``), each written out here:

- residual ``r = pi(R_c X_p + t_c) - uv`` with ``pi(p) = p[:2] / z`` (``z``
  kept away from 0 by 1e-9); weight ``w = mask * [z > 1e-6] * huber`` with
  the IRLS Huber factor ``min(1, delta / |r|)``; cost ``0.5 sum w |r|^2``;
- Jacobians ``Jc = Jproj [I | -hat(p)]`` (left-multiplied twist, translation
  first) and ``Jp = Jproj R_c``;
- Levenberg damping ``H + (lam diag(H) + 1e-8) I``; the reduced camera
  system ``S = Hcc - Hcp Hpp^-1 Hpc`` solved by a fixed number of
  block-Jacobi-preconditioned CG iterations from zero, with the port's
  stagnation guards; the point step by back-substitution;
- the update ``exp(dx_c) o pose`` and ``X + dx_p``; a step is accepted when
  the cost falls, the damping halves on acceptance and quadruples on
  rejection (clamped to [1e-9, 1e6]), and the solve ends after
  ``max_iters`` iterations or at an accepted step whose relative decrease
  is under ``rtol``; the cameras in ``fixed`` do not move.

Sums over the observation table are plain ``index_add_`` (by point) and
``segment_reduce`` over the table sorted by camera. The reference runs in
float64. ``operands="tf32"`` rounds every product's operands to TF32 and
runs in float32: the lower-precision control put in the port's place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.matcher import tf32_round


class Problem(NamedTuple):
    """R (C, 3, 3), t (C, 3) world-to-camera; X (P, 3); cam, pt (O,) int64
    with the table sorted by camera; uv (O, 2) normalised coordinates;
    cam_counts (C,) observations a camera; fixed (C,) bool."""

    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    cam: torch.Tensor
    pt: torch.Tensor
    uv: torch.Tensor
    cam_counts: torch.Tensor
    fixed: torch.Tensor


def make_problem(R, t, X, cam_idx, pt_idx, uv, fixed, dtype=torch.float64) -> Problem:
    """The reference's own copy of a problem, its table sorted by camera."""
    order = torch.argsort(cam_idx, stable=True)
    cam = cam_idx[order].long()
    counts = torch.bincount(cam, minlength=R.shape[0])
    return Problem(R.to(dtype), t.to(dtype), X.to(dtype), cam, pt_idx[order].long(),
                   uv[order].to(dtype), counts, fixed.bool())


class _Math:
    """einsum with each operand rounded as the precision asks."""

    def __init__(self, operands=None):
        self.operands = operands

    def __call__(self, spec, *xs):
        if self.operands == "tf32":
            xs = [tf32_round(x) for x in xs]
        elif self.operands is not None:
            raise ValueError(f"unknown operand rounding {self.operands!r}")
        return torch.einsum(spec, *xs)


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(tw, mm):
    """(..., 6) twist [v, w] -> (R, t): Rodrigues and the left Jacobian."""
    v, w = tw[..., :3], tw[..., 3:]
    th2 = (w * w).sum(-1)[..., None, None]
    small = th2 < 1e-8
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    W = _hat(w)
    W2 = mm("...ij,...jk->...ik", W, W)
    eye = torch.eye(3, dtype=tw.dtype, device=tw.device).expand(W.shape)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2s)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - torch.sin(th)) / (th2s * th))
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    return R, mm("...ij,...j->...i", V, v)


def residuals(R, t, X, prob: Problem, huber, mm, jacobians=False):
    """(res (O, 2), w (O,)) and, with ``jacobians``, (Jc (O, 2, 6), Jp (O, 2, 3))."""
    Rc = R[prob.cam]
    p = mm("oij,oj->oi", Rc, X[prob.pt]) + t[prob.cam]
    z = p[:, 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    res = p[:, :2] / zs[:, None] - prob.uv
    w = (z > 1e-6).to(p.dtype)
    if huber is not None:
        rn = torch.linalg.vector_norm(res, dim=-1)
        w = w * torch.where(rn <= huber, 1.0, huber / torch.clamp(rn, min=1e-12))
    if not jacobians:
        return res, w
    iz = 1.0 / zs
    zero = torch.zeros_like(iz)
    Jproj = torch.stack([torch.stack([iz, zero, -p[:, 0] * iz * iz], -1),
                         torch.stack([zero, iz, -p[:, 1] * iz * iz], -1)], -2)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)
    Jc = mm("oij,ojk->oik", Jproj, torch.cat([eye, -_hat(p)], -1))
    Jp = mm("oij,ojk->oik", Jproj, Rc)
    return res, w, Jc, Jp


def cost(R, t, X, prob: Problem, huber, mm=None):
    """0.5 sum w |r|^2 at (R, t, X), as a Python float."""
    mm = mm or _Math()
    res, w = residuals(R, t, X, prob, huber, mm)
    return float(0.5 * (w * (res * res).sum(-1)).sum())


def _cam_sum(vals, prob: Problem):
    flat = vals.reshape(vals.shape[0], -1)
    out = torch.segment_reduce(flat, "sum", lengths=prob.cam_counts, axis=0)
    return out.reshape((prob.cam_counts.shape[0],) + vals.shape[1:])


def _pt_sum(vals, prob: Problem, n_points):
    out = torch.zeros((n_points,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, prob.pt, vals)


def _damped(H, lam):
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + (lam * d + 1e-8)[..., None, :] * eye


class Step(NamedTuple):
    dx_c: torch.Tensor   # (C, 6)
    dx_p: torch.Tensor   # (P, 3)


class System(NamedTuple):
    """One linearisation's assembled blocks and its camera step: Hcc
    (C, 6, 6), Hpp (P, 3, 3), gc (C, 6), gp (P, 3), dx_c (C, 6)."""

    Hcc: torch.Tensor
    Hpp: torch.Tensor
    gc: torch.Tensor
    gp: torch.Tensor
    dx_c: torch.Tensor


def lm_step(R, t, X, prob: Problem, lam, huber, pcg_iters, mm) -> tuple:
    """One linearisation at (R, t, X): (cost, Step at damping ``lam``,
    its System)."""
    n_points = X.shape[0]
    res, w, Jc, Jp = residuals(R, t, X, prob, huber, mm, jacobians=True)
    Jcw = Jc * w[:, None, None]
    Jpw = Jp * w[:, None, None]
    Hcc = _cam_sum(mm("oki,okj->oij", Jcw, Jc), prob)
    Hpp = _pt_sum(mm("oki,okj->oij", Jpw, Jp), prob, n_points)
    Wcp = mm("oki,okj->oij", Jcw, Jp)
    gc = -_cam_sum(mm("oki,ok->oi", Jcw, res), prob)
    gp = -_pt_sum(mm("oki,ok->oi", Jpw, res), prob, n_points)
    c = 0.5 * (w * (res * res).sum(-1)).sum()
    upd = (~prob.fixed).to(X.dtype)[:, None]
    Hpp_inv = torch.linalg.inv(_damped(Hpp, lam))
    Hcc_l = _damped(Hcc, lam)
    Minv = torch.linalg.inv(Hcc_l)

    def coupled(zp):  # H_cp zp, summed by camera
        return _cam_sum(mm("oij,oj->oi", Wcp, zp[prob.pt]), prob)

    def matvec(x):
        x = x * upd
        yp = _pt_sum(mm("oij,oi->oj", Wcp, x[prob.cam]), prob, n_points)
        zp = mm("pij,pj->pi", Hpp_inv, yp)
        return (mm("cij,cj->ci", Hcc_l, x) - coupled(zp)) * upd

    rhs = (gc - coupled(mm("pij,pj->pi", Hpp_inv, gp))) * upd
    x = torch.zeros_like(rhs)
    r = rhs
    z = mm("cij,cj->ci", Minv, r) * upd
    p = z
    rz = (r * z).sum()
    for _ in range(pcg_iters):
        Sp = matvec(p)
        pSp = (p * Sp).sum()
        small = pSp.abs() < 1e-20
        alpha = torch.where(small, 0.0, rz / torch.where(small, 1.0, pSp))
        x = x + alpha * p
        r = r - alpha * Sp
        z = mm("cij,cj->ci", Minv, r) * upd
        rz_new = (r * z).sum()
        small = rz.abs() < 1e-20
        beta = torch.where(small, 0.0, rz_new / torch.where(small, 1.0, rz))
        p = z + beta * p
        rz = rz_new
    yp = _pt_sum(mm("oij,oi->oj", Wcp, x[prob.cam]), prob, n_points)
    dx_p = mm("pij,pj->pi", Hpp_inv, gp - yp)
    return c, Step(x, dx_p), System(Hcc, Hpp, gc, gp, x)


def apply_step(R, t, X, step: Step, mm):
    dR, dt = se3_exp(step.dx_c, mm)
    return (mm("cij,cjk->cik", dR, R), mm("cij,cj->ci", dR, t) + dt, X + step.dx_p)


class Solve(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    cost0: float
    cost: float
    iters: int
    first: System        # the first linearisation, at the start and ``lam0``


def solve(prob: Problem, huber, max_iters=15, pcg_iters=40, lam0=1e-3, rtol=1e-6,
          operands=None) -> Solve:
    """The LM solve of ``prob`` from its own poses and points."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mm = _Math(operands)
    R, t, X = prob.R, prob.t, prob.X
    lam = float(lam0)
    it = 0
    c, step, first = lm_step(R, t, X, prob, lam, huber, pcg_iters, mm)
    cost0 = c
    while it < max_iters:
        nR, nt, nX = apply_step(R, t, X, step, mm)
        res, w = residuals(nR, nt, nX, prob, huber, mm)
        new_c = 0.5 * (w * (res * res).sum(-1)).sum()
        accept = bool(new_c < c)
        rel = float((c - new_c).abs() / torch.clamp(c, min=1e-12))
        it += 1
        if accept:
            R, t, X, c = nR, nt, nX, new_c
            lam = min(max(lam * 0.5, 1e-9), 1e6)
        else:
            lam = min(max(lam * 4.0, 1e-9), 1e6)
        if (accept and rel < rtol) or it >= max_iters:
            break
        _, step, _ = lm_step(R, t, X, prob, lam, huber, pcg_iters, mm)
    return Solve(R, t, X, float(cost0), float(c), it, first)
