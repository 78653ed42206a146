"""SO(3)/SE(3) Lie-group operations on batched tensors.

Port of ``fastmatch_tpu/core/lie.py``: rotations are 3x3 matrices, SE(3) is
(R, t), twists are ``[v, omega]`` (translation first). All functions
broadcast over leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
        w_skew = vee(R - R.transpose(-1, -2)) * 0.5
        sn2 = (w_skew * w_skew).sum(-1)
        trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
        cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
        small = (sn2 < 1e-12) & (cos_t > 0.0)
        sn2_safe = torch.where(small, torch.ones_like(sn2), sn2)
        sin_norm = torch.sqrt(sn2_safe)
        theta = torch.atan2(sin_norm, cos_t)
        near_pi = theta > 2.7
        scale = torch.where(small, 1.0 + sn2 / 6.0, theta / sin_norm)
        w_generic = scale[..., None] * w_skew
        S = 0.5 * (R + R.transpose(-1, -2))
        B = S - cos_t[..., None, None] * _eye3(R, R.shape)
        diagB = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
        k = torch.argmax(diagB, dim=-1)
        col = torch.take_along_dim(B.transpose(-1, -2), k[..., None, None],
                                   dim=-2)[..., 0, :]
        cn2 = (col * col).sum(-1, keepdim=True)
        axis = col / torch.sqrt(torch.where(cn2 < _EPS * _EPS,
                                            torch.ones_like(cn2), cn2))
        sign = torch.where((axis * w_skew).sum(-1, keepdim=True) < 0.0, -1.0, 1.0)
        w_pi = theta[..., None] * axis * sign
        return torch.where(near_pi[..., None], w_pi, w_generic)

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


class SE3(NamedTuple):
    """Rigid transform x_out = R @ x + t; R (..., 3, 3), t (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def exp(twist: torch.Tensor) -> "SE3":
        """(..., 6) twist [v, omega] -> SE3."""
        v, w = twist[..., :3], twist[..., 3:]
        R = SO3.exp(w)
        V = SO3.left_jacobian(w)
        return SE3(R, torch.einsum("...ij,...j->...i", V, v))

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
