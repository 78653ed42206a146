"""SO(3)/SE(3)/Sim(3) Lie-group operations on batched tensors.

Port of ``fastmatch_tpu/core/lie.py``: rotations are 3x3 matrices, SE(3) is
(R, t), Sim(3) is (R, t, s), twists are ``[v, omega]`` (translation first)
and Sim(3) tangents ``[rho, omega, sigma]``. All functions broadcast over
leading batch axes and are safe under ``torch.func.jacfwd``/``vmap``: every
small-angle branch feeds its unselected formula a safe argument (the JAX
package's "double-where"), so no NaN tangent appears at theta -> 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fastmatch_tpu_torch.core.device import resolve_device

_EPS = 1e-8


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


class SO3:
    """Static namespace of SO(3) ops on 3x3 rotation matrices."""

    @staticmethod
    def exp(w: torch.Tensor) -> torch.Tensor:
        """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
        theta2 = (w * w).sum(-1)[..., None, None]
        small = theta2 < _EPS
        theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
        theta = torch.sqrt(theta2_safe)
        W = hat(w)
        W2 = W @ W
        a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
        b = torch.where(small, 0.5 - theta2 / 24.0,
                        (1.0 - torch.cos(theta)) / theta2_safe)
        return _eye3(w, W.shape) + a * W + b * W2

    @staticmethod
    def log(R: torch.Tensor) -> torch.Tensor:
        """(..., 3, 3) rotation -> (..., 3) axis-angle (|w| <= pi); near pi
        the axis comes from the symmetric part, as in the JAX package."""
        # Scalars keep a trailing axis of 1 (here and in _sim3_W): forward-
        # mode AD promotes a 0-dim tensor times a Python float to float64.
        w_skew = vee(R - R.transpose(-1, -2)) * 0.5
        sn2 = (w_skew * w_skew).sum(-1, keepdim=True)
        trace = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
        cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
        small = (sn2 < 1e-12) & (cos_t > 0.0)
        sn2_safe = torch.where(small, torch.ones_like(sn2), sn2)
        sin_norm = torch.sqrt(sn2_safe)
        theta = torch.atan2(sin_norm, cos_t)
        near_pi = theta > 2.7
        scale = torch.where(small, 1.0 + sn2 / 6.0, theta / sin_norm)
        w_generic = scale * w_skew
        S = 0.5 * (R + R.transpose(-1, -2))
        B = S - cos_t[..., None] * _eye3(R, R.shape)
        diagB = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
        # Column k of B by a one-hot sum: a batched take_along_dim gives
        # wrong tangents under torch.func.vmap(jacfwd).
        k = torch.argmax(diagB, dim=-1, keepdim=True)
        onehot = (torch.arange(3, device=R.device) == k).to(R.dtype)
        col = (B * onehot[..., None, :]).sum(-1)
        cn2 = (col * col).sum(-1, keepdim=True)
        axis = col / torch.sqrt(torch.where(cn2 < _EPS * _EPS,
                                            torch.ones_like(cn2), cn2))
        sign = torch.where((axis * w_skew).sum(-1, keepdim=True) < 0.0, -1.0, 1.0)
        w_pi = theta * axis * sign
        return torch.where(near_pi, w_pi, w_generic)

    @staticmethod
    def left_jacobian(w: torch.Tensor) -> torch.Tensor:
        """SO(3) left Jacobian J_l(w): (..., 3) -> (..., 3, 3)."""
        theta2 = (w * w).sum(-1)[..., None, None]
        small = theta2 < _EPS
        theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
        theta = torch.sqrt(theta2_safe)
        W = hat(w)
        W2 = W @ W
        b = torch.where(small, 0.5 - theta2 / 24.0,
                        (1.0 - torch.cos(theta)) / theta2_safe)
        c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                        (theta - torch.sin(theta)) / (theta2_safe * theta))
        return _eye3(w, W.shape) + b * W + c * W2


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", M, v)


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b for (..., 3, 3) A by its adjugate: the logs' solves, written
    out because a batched ``torch.linalg.solve`` gives NaN tangents under
    ``torch.func.vmap(jacfwd)``."""
    c0 = torch.cross(A[..., 1, :], A[..., 2, :], dim=-1)
    c1 = torch.cross(A[..., 2, :], A[..., 0, :], dim=-1)
    c2 = torch.cross(A[..., 0, :], A[..., 1, :], dim=-1)
    det = (A[..., 0, :] * c0).sum(-1, keepdim=True)
    return (c0 * b[..., :1] + c1 * b[..., 1:2] + c2 * b[..., 2:]) / det


class SE3(NamedTuple):
    """Rigid transform x_out = R @ x + t; R (..., 3, 3), t (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), device=None, dtype=torch.float32) -> "SE3":
        """Identity transforms of ``batch_shape`` on ``device`` (``cuda``
        unless ``device="cpu"``)."""
        dev = resolve_device(device)
        R = torch.eye(3, dtype=dtype, device=dev).expand(*batch_shape, 3, 3).clone()
        return SE3(R, torch.zeros(*batch_shape, 3, dtype=dtype, device=dev))

    @staticmethod
    def exp(twist: torch.Tensor) -> "SE3":
        """(..., 6) twist [v, omega] -> SE3."""
        v, w = twist[..., :3], twist[..., 3:]
        R = SO3.exp(w)
        V = SO3.left_jacobian(w)
        return SE3(R, _mv(V, v))

    def log(self) -> torch.Tensor:
        """SE3 -> (..., 6) twist [v, omega]."""
        w = SO3.log(self.R)
        V = SO3.left_jacobian(w)
        v = _solve3(V, self.t)
        return torch.cat([v, w], dim=-1)

    def compose(self, other: "SE3") -> "SE3":
        """self o other (apply ``other`` first)."""
        R = self.R @ other.R
        t = torch.einsum("...ij,...j->...i", self.R, other.t) + self.t
        return SE3(R, t)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -torch.einsum("...ij,...j->...i", Rt, self.t))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform (..., 3) points (batch axes broadcast)."""
        return torch.einsum("...ij,...j->...i", self.R, points) + self.t

    def retract(self, twist: torch.Tensor) -> "SE3":
        """Left-multiplicative update exp(twist) o self (the BA/PGO
        retraction)."""
        return SE3.exp(twist).compose(self)


def _sim3_W(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Sim(3) translation mixer W(w, sigma) = int_0^1 e^{sigma u} exp(u w^) du
    = C I + A w^ + B (w^)^2, with the JAX package's coefficients: expm1 and
    half-angle forms (no cancellation at small arguments) and Taylor
    fallbacks at small theta and small sigma, each fed a safe argument."""
    sigma = sigma[..., None]
    one = torch.ones_like(sigma)
    theta2 = (w * w).sum(-1, keepdim=True)
    t_small = theta2 < _EPS
    s_small = sigma * sigma < _EPS
    theta2_safe = torch.where(t_small, one, theta2)
    theta = torch.sqrt(theta2_safe)
    sigma_safe = torch.where(s_small, one, sigma)
    em1 = torch.expm1(sigma)
    s = em1 + 1.0
    one_m_cos = 2.0 * torch.sin(0.5 * theta) ** 2
    c = sigma * sigma + theta2
    c_safe = torch.where(t_small & s_small, one, c)

    C = torch.where(s_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, em1 / sigma_safe)
    a_sin = s * torch.sin(theta)
    one_m_b = one_m_cos - em1 * torch.cos(theta)
    A_gen = (a_sin * sigma + one_m_b * theta) / (theta * c_safe)
    A_tsmall = torch.where(s_small, 0.5 + sigma / 3.0,
                           (sigma * s - em1) / (sigma_safe * sigma_safe))
    A = torch.where(t_small, A_tsmall, A_gen)
    I_cos_gen = (-one_m_b * sigma + a_sin * theta) / c_safe
    B_gen = (C - I_cos_gen) / theta2_safe
    B_tsmall = torch.where(s_small, 1.0 / 6.0 + sigma / 8.0,
                           (s * (0.5 * sigma * sigma - sigma) + em1)
                           / (sigma_safe * sigma_safe * sigma_safe))
    B = torch.where(t_small, B_tsmall, B_gen)

    W = hat(w)
    return C[..., None] * _eye3(w, W.shape) + A[..., None] * W + B[..., None] * (W @ W)


class Sim3(NamedTuple):
    """Similarity x_out = s R @ x + t; R (..., 3, 3), t (..., 3), s (...,).
    Tangents are (..., 7) ``[rho, omega, sigma]``: the SE3 twist layout with
    a trailing log-scale slot (the monocular drift group of
    ``posegraph/sim3.py``)."""

    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), device=None, dtype=torch.float32) -> "Sim3":
        """Identity similarities on ``device`` (``cuda`` unless
        ``device="cpu"``)."""
        T = SE3.identity(batch_shape, device, dtype)
        return Sim3(T.R, T.t, torch.ones(batch_shape, dtype=dtype, device=T.t.device))

    @staticmethod
    def from_se3(T: SE3, s=None) -> "Sim3":
        if s is None:
            s = torch.ones(T.t.shape[:-1], dtype=T.t.dtype, device=T.t.device)
        return Sim3(T.R, T.t, torch.as_tensor(s, dtype=T.t.dtype, device=T.t.device))

    def se3(self) -> SE3:
        """Drop the scale (callers rescale t or points themselves)."""
        return SE3(self.R, self.t)

    @staticmethod
    def exp(tangent: torch.Tensor) -> "Sim3":
        """(..., 7) [rho, omega, sigma] -> Sim3."""
        rho, w, sigma = tangent[..., :3], tangent[..., 3:6], tangent[..., 6]
        return Sim3(SO3.exp(w), _mv(_sim3_W(w, sigma), rho), torch.exp(sigma))

    def log(self) -> torch.Tensor:
        """Sim3 -> (..., 7) [rho, omega, sigma]."""
        w = SO3.log(self.R)
        sigma = torch.log(self.s)
        rho = _solve3(_sim3_W(w, sigma), self.t)
        return torch.cat([rho, w, sigma[..., None]], dim=-1)

    def compose(self, other: "Sim3") -> "Sim3":
        """self o other (apply ``other`` first)."""
        return Sim3(self.R @ other.R, self.s[..., None] * _mv(self.R, other.t) + self.t,
                    self.s * other.s)

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        inv_s = torch.reciprocal(self.s)
        return Sim3(Rt, -inv_s[..., None] * _mv(Rt, self.t), inv_s)

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        return self.s[..., None] * _mv(self.R, points) + self.t

    def retract(self, tangent: torch.Tensor) -> "Sim3":
        """Left-multiplicative update exp(tangent) o self."""
        return Sim3.exp(tangent).compose(self)


def se3_adjoint(g: SE3) -> torch.Tensor:
    """Adjoint matrix Ad_g: (..., 6, 6) for twist order [v, omega]."""
    R, t = g.R, g.t
    top = torch.cat([R, hat(t) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)
