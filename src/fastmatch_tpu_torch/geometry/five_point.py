"""Minimal 5-point relative pose (essential matrix) solver.

Port of ``fastmatch_tpu/geometry/five_point.py``, step for step, batched
over leading axes and with a fixed op count:

1. the 4-dim nullspace of the 5 epipolar constraints by inverse subspace
   iteration (``core/batched_linalg.smallest_eigvecs(k=4)``):
   E = x E1 + y E2 + z E3 + E4;
2. the 10 cubic constraints (det E = 0, 2 E E^T E - tr(E E^T) E = 0)
   expanded numerically over the 20 monomials of degree <= 3 with constant
   product tables (one einsum a polynomial product);
3. Gauss-Jordan reduction with partial pivoting (branch-free row swaps as
   gathers) to [I | M];
4. three closing identities give B(z) [x, y, 1]^T = 0; det B(z) is
   evaluated on a tan-spaced grid, sign changes bracket up to 16 roots,
   and 40 bisection steps refine them; 16 fixed auxiliary starts are
   added;
5. (x, y) from B(z*)'s 2x2 normal equations, 24 damped Gauss-Newton steps
   on the cubic constraints, and a validation gate on det E and the trace
   identity.

``jax.lax.top_k`` is a stable descending sort here (equal ranks keep the
lower index first, as top_k does), and the 3x3 determinants are closed
form. Returns up to 32 candidates a sample; callers honour ``valid``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fastmatch_tpu_torch.core.batched_linalg import smallest_eigvecs
from fastmatch_tpu_torch.geometry.epipolar import _homog
from fastmatch_tpu_torch.geometry.fundamental import _det3
from fastmatch_tpu_torch.geometry.homography import _adjugate3

# Monomial bookkeeping (numpy, built at import; the JAX package's tables).
_M1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_M2 = [(i, j, k) for i in range(3) for j in range(3) for k in range(3) if i + j + k <= 2]
_LEAD = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (2, 0, 0), (1, 2, 0),
         (1, 1, 1), (1, 1, 0), (0, 3, 0), (0, 2, 1), (0, 2, 0)]
_TRAIL = [(1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
          (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0)]
_M3 = _LEAD + _TRAIL
_M2_IDX = {m: i for i, m in enumerate(_M2)}
_M3_IDX = {m: i for i, m in enumerate(_M3)}

_T11 = np.zeros((4, 4, len(_M2)), np.float32)   # deg1 x deg1 -> deg2
for _a, _ma in enumerate(_M1):
    for _b, _mb in enumerate(_M1):
        _T11[_a, _b, _M2_IDX[tuple(np.add(_ma, _mb))]] = 1.0
_T21 = np.zeros((len(_M2), 4, 20), np.float32)  # deg2 x deg1 -> deg3
for _a, _ma in enumerate(_M2):
    for _b, _mb in enumerate(_M1):
        _T21[_a, _b, _M3_IDX[tuple(np.add(_ma, _mb))]] = 1.0

_N_ROOTS = 16
_N_AUX = 16
_GRID = 512
_BISECT = 40
_POLISH = 24
_EXP = np.array(_M3, np.int32)                     # (20, 3)
_EXPF = _EXP.astype(np.float32)
_EXP_DEC = np.maximum(_EXP[None] - np.eye(3, dtype=np.int32)[:, None], 0).astype(np.float32)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _mul11(p, q):
    """(..., 4) x (..., 4) degree-1 polynomials -> (..., 10) degree 2."""
    return torch.einsum("...a,...b,abm->...m", p, q, _const(_T11, p))


def _mul21(p, q):
    """(..., 10) degree 2 x (..., 4) degree 1 -> (..., 20) degree 3."""
    return torch.einsum("...a,...b,abm->...m", p, q, _const(_T21, p))


def _constraint_matrix(Ebasis):
    """(..., 4, 3, 3) nullspace basis -> (..., 10, 20) cubic constraints:
    row 0 det E, rows 1-9 2 E E^T E - tr(E E^T) E row-major."""
    P = torch.movedim(Ebasis, -3, -1)  # (..., 3, 3, 4)

    def e(i, j):
        return P[..., i, j, :]

    det = P.new_zeros(P.shape[:-3] + (20,))
    for (j0, j1, j2, sgn) in ((0, 1, 2, 1.0), (1, 2, 0, 1.0), (2, 0, 1, 1.0),
                              (2, 1, 0, -1.0), (1, 0, 2, -1.0), (0, 2, 1, -1.0)):
        det = det + sgn * _mul21(_mul11(e(0, j0), e(1, j1)), e(2, j2))
    G = [[_mul11(e(i, 0), e(j, 0)) + _mul11(e(i, 1), e(j, 1)) + _mul11(e(i, 2), e(j, 2))
          for j in range(3)] for i in range(3)]
    trG = G[0][0] + G[1][1] + G[2][2]
    rows = [det]
    for i in range(3):
        for j in range(3):
            acc = _mul21(G[i][0], e(0, j)) + _mul21(G[i][1], e(1, j)) + _mul21(G[i][2], e(2, j))
            rows.append(2.0 * acc - _mul21(trG, e(i, j)))
    return torch.stack(rows, dim=-2)


def _gauss_jordan(C):
    """Reduce (..., 10, 20) to [I | M] with partial pivoting (rows
    equilibrated first); returns M (..., 10, 10)."""
    n = 10
    C = C / torch.clamp(torch.linalg.vector_norm(C, dim=-1, keepdim=True), min=1e-20)
    idx = torch.arange(n, device=C.device)
    for col in range(n):
        piv = torch.argmax(C[..., col:, col].abs(), dim=-1) + col
        sel = torch.where(idx == col, piv[..., None],
                          torch.where(idx == piv[..., None], col, idx))
        C = torch.take_along_dim(C, sel[..., :, None], dim=-2)
        p = C[..., col, :]
        pval = p[..., col:col + 1]
        p = p / torch.where(pval.abs() > 1e-20, pval, torch.ones_like(pval))
        f = C[..., :, col:col + 1]
        rowmask = (idx == col)[:, None]
        C = torch.where(rowmask, p[..., None, :], C - f * p[..., None, :])
    return C[..., :, 10:]


def _polyval(coef, z):
    """Horner over the last axis (highest degree first)."""
    acc = coef[..., 0]
    for i in range(1, coef.shape[-1]):
        acc = acc * z + coef[..., i]
    return acc


def _pmul(p, q):
    """Product of coefficient arrays (highest degree first)."""
    np_ = p.shape[-1]
    out = None
    for i in range(np_):
        zl = p.new_zeros(p.shape[:-1] + (i,))
        zr = p.new_zeros(p.shape[:-1] + (np_ - 1 - i,))
        term = torch.cat([zl, p[..., i:i + 1] * q, zr], dim=-1)
        out = term if out is None else out + term
    return out


def _padp(p, n):
    """Left-pad (high-degree side) to n coefficients."""
    return torch.cat([p.new_zeros(p.shape[:-1] + (n - p.shape[-1],)), p], dim=-1)


def _b_matrix_coeffs(a, b, c):
    """The three closing identities -> B(z) (..., 3, 3, 6), coefficients
    over [z^5 .. 1]."""
    def A(r):
        return a[..., r, :]

    def Bc(r):
        return b[..., r, :]

    def Cc(r):
        return c[..., r, :]

    a3, b3, c3 = A(3), Bc(3), Cc(3)
    a6, b6, c6 = A(6), Bc(6), Cc(6)
    a9, b9, c9 = A(9), Bc(9), Cc(9)
    rows = []
    # I1: x <x^2> - <x^3>
    alpha = _padp(_pmul(a3, a3), 6) + _padp(_pmul(b3, a6), 6) + _padp(c3, 6) - _padp(A(0), 6)
    beta = _padp(_pmul(a3, b3), 6) + _padp(_pmul(b3, b6), 6) - _padp(Bc(0), 6)
    gamma = _padp(_pmul(a3, c3), 6) + _padp(_pmul(b3, c6), 6) - _padp(Cc(0), 6)
    rows.append([alpha, beta, gamma])
    # I2: y <x^2> - <x^2 y>
    alpha = _padp(_pmul(a6, a3), 6) + _padp(_pmul(a9, b3), 6) - _padp(A(1), 6)
    beta = _padp(_pmul(b6, a3), 6) + _padp(_pmul(b9, b3), 6) + _padp(c3, 6) - _padp(Bc(1), 6)
    gamma = _padp(_pmul(c6, a3), 6) + _padp(_pmul(c9, b3), 6) - _padp(Cc(1), 6)
    rows.append([alpha, beta, gamma])
    # I3: y <y^2> - <y^3>
    alpha = _padp(_pmul(a6, a9), 6) + _padp(_pmul(a9, b9), 6) - _padp(A(7), 6)
    beta = _padp(_pmul(b6, a9), 6) + _padp(_pmul(b9, b9), 6) + _padp(c9, 6) - _padp(Bc(7), 6)
    gamma = _padp(_pmul(c6, a9), 6) + _padp(_pmul(c9, b9), 6) - _padp(Cc(7), 6)
    rows.append([alpha, beta, gamma])
    return torch.stack([torch.stack(r, dim=-2) for r in rows], dim=-3)


def _detB(Bc, z):
    """det B(z); Bc (..., 3, 3, 6), z (..., G) -> (..., G)."""
    return _det3(_polyval(Bc[..., None, :, :, :], z[..., :, None, None]))


def _mono20(xyz):
    """(..., 3) -> (..., 20) monomial values."""
    return torch.prod(xyz[..., None, :] ** _const(_EXPF, xyz), dim=-1)


def _mono20_jac(xyz):
    """(..., 3) -> (..., 20, 3) derivatives of the monomials."""
    base = torch.prod(xyz[..., None, None, :] ** _const(_EXP_DEC, xyz), dim=-1)  # (..., 3, 20)
    return torch.movedim(_const(_EXPF.T.copy(), xyz) * base, -2, -1)


def _newton_polish(C, xyz, iters: int = _POLISH):
    """Damped Gauss-Newton on r = C m(x, y, z), with the step clipped to
    norm 2 (a trust region)."""
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device)
    for _ in range(iters):
        r = torch.einsum("...ct,...t->...c", C, _mono20(xyz))
        J = torch.einsum("...ct,...ti->...ci", C, _mono20_jac(xyz))
        JtJ = torch.einsum("...ci,...cj->...ij", J, J)
        Jtr = torch.einsum("...ci,...c->...i", J, r)
        lam = 1e-8 * torch.diagonal(JtJ, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        H = JtJ + lam * eye
        det = _det3(H)
        det = torch.where(det.abs() > 1e-30, det, torch.ones_like(det))
        step = torch.einsum("...ij,...j->...i", _adjugate3(H), Jtr) / det[..., None]
        sn = torch.linalg.vector_norm(step, dim=-1, keepdim=True)
        step = step * (2.0 / torch.clamp(sn, min=2.0))
        xyz = xyz - step
    return xyz


def _nullspace_basis(x1, x2):
    """(..., 4, 3, 3): E = x E1 + y E2 + z E3 + E4 spans the constraints'
    nullspace."""
    h1 = _homog(x1)
    h2 = _homog(x2)
    A = (h2[..., :, None] * h1[..., None, :]).reshape(*x1.shape[:-2], 5, 9)
    ATA = torch.einsum("...pi,...pj->...ij", A, A)
    N = smallest_eigvecs(ATA, k=4)
    return torch.movedim(N, -1, -2).reshape(*x1.shape[:-2], 4, 3, 3)


def five_point_essential(x1: torch.Tensor, x2: torch.Tensor):
    """Essential matrices from exactly 5 normalized correspondences.

    x1, x2: (..., 5, 2). Returns (Es (..., 32, 3, 3), valid (..., 32)): 16
    det-B bracket slots and 16 auxiliary polish starts a sample; invalid
    slots hold garbage (identity where non-finite)."""
    Ebasis = _nullspace_basis(x1, x2)
    C = _constraint_matrix(Ebasis)
    M = _gauss_jordan(C)
    a, b, c = -M[..., :, 0:3], -M[..., :, 3:6], -M[..., :, 6:10]
    Bc = _b_matrix_coeffs(a, b, c)
    # A positive scale per row of B(z) keeps every root and sign of det B
    # and bounds its dynamic range.
    Bc = Bc / torch.clamp(Bc.abs().amax(dim=(-2, -1), keepdim=True), min=1e-30)

    # Root scan over z = tan(theta): brackets from sign changes.
    dev, dt = x1.device, x1.dtype
    theta = torch.linspace(-math.pi / 2 + 2e-2, math.pi / 2 - 2e-2, _GRID, dtype=dt, device=dev)
    d = _detB(Bc, torch.tan(theta).expand(Bc.shape[:-3] + (_GRID,)))
    sc = torch.sign(d[..., :-1]) * torch.sign(d[..., 1:]) < 0
    rank = sc * torch.arange(_GRID - 1, 0, -1, device=dev)
    val, bi = torch.sort(rank, dim=-1, descending=True, stable=True)
    val, bi = val[..., :_N_ROOTS], bi[..., :_N_ROOTS]
    has_root = val > 0
    lo = theta[bi]
    hi = theta[torch.clamp(bi + 1, max=_GRID - 1)]
    dlo = torch.take_along_dim(d, bi, dim=-1)
    for _ in range(_BISECT):
        mid = 0.5 * (lo + hi)
        dm = _detB(Bc, torch.tan(mid))
        left = (dlo * dm) <= 0
        lo, hi, dlo = (torch.where(left, lo, mid), torch.where(left, mid, hi),
                       torch.where(left, dlo, dm))
    z = torch.tan(0.5 * (lo + hi))

    # Auxiliary polish starts: a fixed spread of z recovers roots the scan
    # lost on a rounding knife-edge (and even-multiplicity touches).
    theta_aux = torch.linspace(-math.pi / 2 + 0.1, math.pi / 2 - 0.1, _N_AUX, dtype=dt,
                               device=dev)
    z = torch.cat([z, torch.tan(theta_aux).expand(z.shape[:-1] + (_N_AUX,))], dim=-1)
    has_root = torch.cat([has_root, has_root.new_ones(has_root.shape[:-1] + (_N_AUX,))], dim=-1)

    # (x, y) by least squares on B(z*) [x, y, 1] = 0.
    vals = _polyval(Bc[..., None, :, :, :], z[..., :, None, None])
    A2 = vals[..., :, :2]
    g2 = -vals[..., :, 2]
    AtA = torch.einsum("...ri,...rj->...ij", A2, A2)
    Atg = torch.einsum("...ri,...r->...i", A2, g2)
    det2 = AtA[..., 0, 0] * AtA[..., 1, 1] - AtA[..., 0, 1] * AtA[..., 1, 0]
    det2s = torch.where(det2.abs() > 1e-20, det2, torch.ones_like(det2))
    xs = (AtA[..., 1, 1] * Atg[..., 0] - AtA[..., 0, 1] * Atg[..., 1]) / det2s
    ys = (AtA[..., 0, 0] * Atg[..., 1] - AtA[..., 1, 0] * Atg[..., 0]) / det2s

    xyz = _newton_polish(C[..., None, :, :], torch.stack([xs, ys, z], dim=-1))
    xs, ys, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    E = (xs[..., None, None] * Ebasis[..., None, 0, :, :]
         + ys[..., None, None] * Ebasis[..., None, 1, :, :]
         + z[..., None, None] * Ebasis[..., None, 2, :, :]
         + Ebasis[..., None, 3, :, :])
    E = E / torch.clamp(torch.linalg.vector_norm(E, dim=(-2, -1), keepdim=True), min=1e-20)

    # Validate against the cubic constraints on the normalized E.
    detE = _det3(E)
    EEt = E @ E.transpose(-2, -1)
    tr = torch.diagonal(EEt, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    rmax = (2.0 * (EEt @ E) - tr * E).abs().amax(dim=(-2, -1))
    valid = has_root & (detE.abs() < 1e-3) & (rmax < 1e-2)
    finite = torch.isfinite(E).all(-1).all(-1)
    valid = valid & finite
    E = torch.where(finite[..., None, None], E, torch.eye(3, dtype=dt, device=dev))
    return E, valid
