"""Fixed-iteration batched small-matrix factorizations.

Port of ``fastmatch_tpu/core/batched_linalg.py``, routine for routine: these
fixed op-count solvers define the geometry stack's numerics (DLT null
vectors, 3x3 SVD, nearest rotation), so they are ported as written rather
than replaced by ``torch.linalg.eigh``/``svd``.
"""

from __future__ import annotations

import numpy as np
import torch

# Deterministic start subspace for the inverse iteration (the JAX package's
# slab: same seed, same values).
_INIT = np.random.default_rng(12345).standard_normal((32, 8)).astype(np.float32)

_CONSTS: dict = {}


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``a`` on ``like``'s device in its dtype, copied there once: a copy
    from host memory on every call would synchronize with the card. The
    cached tensors are only read."""
    a = np.ascontiguousarray(a)
    key = (a.tobytes(), a.shape, like.dtype, like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return t


def smallest_eigvecs(M: torch.Tensor, k: int = 1, iters: int = 6,
                     shift_rel: float = 1e-6) -> torch.Tensor:
    """Approximate eigenvectors of the ``k`` smallest eigenvalues of a
    batched symmetric PSD matrix M (..., n, n); returns (..., n, k),
    columns orthonormal, ordered by ascending Rayleigh quotient.

    Inverse subspace iteration on a (k + 1)-column subspace (2 columns for
    k = 1) of (M + eps*I), one Cholesky factor, then Rayleigh-Ritz: a
    closed-form 2x2 rotation for k = 1 (every DLT's null vector), unrolled
    cyclic Jacobi sweeps as Givens products and an ascending sort for
    larger subspaces (the 5-point solver's k = 4). Batches whose Cholesky
    fails get identity-basis columns, as in the JAX package.
    """
    n = M.shape[-1]
    ks = min(max(k + 1, 2), n)
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eps = shift_rel * tr / n
    L, info = torch.linalg.cholesky_ex(M + eps * eye)
    bad = (info != 0) | ~torch.isfinite(L).all(-1).all(-1)
    L = torch.where(bad[..., None, None], eye, L)

    V = _const(_INIT[:n, :ks], M).expand(M.shape[:-2] + (n, ks))

    def _orthonormalize(V):
        cols = []
        for j in range(ks):
            v = V[..., :, j]
            for u in cols:
                v = v - (v * u).sum(-1, keepdim=True) * u
            nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
            cols.append(v / torch.clamp(nv, min=1e-20))
        return torch.stack(cols, dim=-1)

    Lt = L.transpose(-2, -1)
    for _ in range(iters):
        Y = torch.linalg.solve_triangular(L, V, upper=False)
        V = torch.linalg.solve_triangular(Lt, Y, upper=True)
        V = _orthonormalize(V)

    H = V.transpose(-2, -1) @ (M @ V)
    if ks == 2:
        h11 = H[..., 0, 0]
        h22 = H[..., 1, 1]
        h12 = H[..., 0, 1]
        theta = 0.5 * torch.atan2(2.0 * h12, h11 - h22)
        c, s = torch.cos(theta), torch.sin(theta)
        e1 = c * c * h11 + 2 * c * s * h12 + s * s * h22
        e2 = s * s * h11 - 2 * c * s * h12 + c * c * h22
        v1 = c[..., None] * V[..., :, 0] + s[..., None] * V[..., :, 1]
        v2 = -s[..., None] * V[..., :, 0] + c[..., None] * V[..., :, 1]
        first = (e1 <= e2)[..., None]
        return torch.stack([torch.where(first, v1, v2),
                            torch.where(first, v2, v1)], dim=-1)[..., :, :k]
    # ks >= 3: three cyclic Jacobi sweeps on the small H, then columns in
    # ascending order of their Rayleigh quotients.
    Q = torch.eye(ks, dtype=M.dtype, device=M.device).expand(H.shape)
    pairs = [(p, q) for p in range(ks) for q in range(p + 1, ks)]
    for _ in range(3):
        for (p, q) in pairs:
            th = 0.5 * torch.atan2(2.0 * H[..., p, q], H[..., p, p] - H[..., q, q])
            G = _givens(ks, p, q, torch.cos(th), torch.sin(th))
            H = G.transpose(-2, -1) @ H @ G
            Q = Q @ G
    Vr = V @ Q
    ev = torch.diagonal(H, dim1=-2, dim2=-1)
    order = torch.argsort(ev, dim=-1, stable=True)
    return torch.take_along_dim(Vr, order[..., None, :], dim=-1)[..., :, :k]


def _givens(n, p, q, c, s):
    """Batched (..., n, n) Givens rotation built from one-hot constants:
    identity except [p,p]=[q,q]=c, [p,q]=-s, [q,p]=s."""
    ep = np.zeros((n,), np.float32)
    eq = np.zeros((n,), np.float32)
    ep[p] = 1.0
    eq[q] = 1.0

    Epp, Eqq = _const(np.outer(ep, ep), c), _const(np.outer(eq, eq), c)
    Epq, Eqp = _const(np.outer(ep, eq), c), _const(np.outer(eq, ep), c)
    eye = _const(np.eye(n, dtype=np.float32), c)
    c1 = (c - 1.0)[..., None, None]
    sb = s[..., None, None]
    return eye + c1 * (Epp + Eqq) - sb * Epq + sb * Eqp


def _orth_complement(u: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to unit u (..., 3), branchless."""
    ex = _const(np.array([1.0, 0.0, 0.0], np.float32), u)
    ey = _const(np.array([0.0, 1.0, 0.0], np.float32), u)
    a = torch.linalg.cross(u, ex * torch.ones_like(u), dim=-1)
    b = torch.linalg.cross(u, ey * torch.ones_like(u), dim=-1)
    na = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    nb = torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    v = torch.where(na > nb, a, b)
    return v / torch.clamp(torch.maximum(na, nb), min=1e-20)


def svd3(M: torch.Tensor, sweeps: int = 4):
    """Batched 3x3 SVD by one-sided Jacobi: M = U diag(S) V^T, S descending,
    U completed to a full orthogonal basis for rank-deficient inputs."""
    B = M
    V = torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)
    for _ in range(sweeps):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            bp = B[..., :, p]
            bq = B[..., :, q]
            app = (bp * bp).sum(-1)
            aqq = (bq * bq).sum(-1)
            apq = (bp * bq).sum(-1)
            theta = 0.5 * torch.atan2(2.0 * apq, app - aqq)
            G = _givens(3, p, q, torch.cos(theta), torch.sin(theta))
            B = B @ G
            V = V @ G
    S = torch.linalg.vector_norm(B, dim=-2)

    order = torch.argsort(-S, dim=-1, stable=True)
    S = torch.take_along_dim(S, order, dim=-1)
    B = torch.take_along_dim(B, order[..., None, :], dim=-1)
    V = torch.take_along_dim(V, order[..., None, :], dim=-1)

    eps = 1e-12 + 1e-6 * S[..., 0:1]
    u0 = B[..., :, 0] / torch.clamp(S[..., 0:1], min=1e-20)
    ex = _const(np.array([1.0, 0.0, 0.0], np.float32), M)
    u0 = torch.where(S[..., 0:1] > 1e-20, u0, ex.expand(u0.shape))
    u1 = B[..., :, 1] / torch.clamp(S[..., 1:2], min=1e-20)
    u1 = torch.where(S[..., 1:2] > eps, u1, _orth_complement(u0))
    u2 = B[..., :, 2] / torch.clamp(S[..., 2:3], min=1e-20)
    c01 = torch.linalg.cross(u0, u1, dim=-1)
    u2 = torch.where(S[..., 2:3] > eps, u2, c01)
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, S, V.transpose(-2, -1)


def polar3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation (Frobenius) to a batched 3x3: U diag(1,1,det) V^T."""
    U, _, Vt = svd3(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return U @ (D[..., :, None] * Vt)
