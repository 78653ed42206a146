"""Camera models: pinhole with Brown-Conrady distortion, and the
equidistant fisheye.

Port of ``fastmatch_tpu/core/camera.py``. Both models hold their
intrinsics as Python floats and expose one surface: ``project`` and
``unproject`` over batched tensors (on the tensors' device), ``K``,
``from_K`` and ``intrinsics_vector``. The pipeline meets them through two
shared functions with the same iteration structure:

- ``normalize_pixels`` (torch): pixels -> normalized coordinates over a
  packed (9,) intrinsics vector, the model named by a string;
  ``project_pixels`` is its forward inverse;
- ``normalize_np`` (numpy): the host-side mirror that the incremental
  engines (``pipeline/reconstruct.py``, ``pipeline/slam.py``) call, which
  dispatches on ``cam.model`` and raises on an unknown model.

Everything downstream of normalization works in normalized coordinates
and is model-agnostic.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_UNDIST_ITERS = 10
_FISHEYE_NEWTON_ITERS = 8


def _K(fx, fy, cx, cy) -> torch.Tensor:
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=torch.float32)


def _dist(dist, n):
    return tuple(float(x) for x in dist) + (0.0,) * (n - len(dist))


def _fxfycxcy(K):
    K = np.asarray(K.cpu() if torch.is_tensor(K) else K, np.float64)
    return float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])


def _clamped_depth(pts_cam, eps):
    z = pts_cam[..., 2]
    return torch.where(z.abs() < eps, torch.full_like(z, eps), z)


class Pinhole(NamedTuple):
    """Pinhole intrinsics (Python floats) with Brown-Conrady distortion:
    k1, k2, k3 radial and p1, p2 tangential coefficients."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    model = "pinhole"

    @staticmethod
    def from_K(K, dist=()) -> "Pinhole":
        """``dist``: optional (k1, k2[, k3[, p1, p2]]) coefficients."""
        return Pinhole(*_fxfycxcy(K), *_dist(dist, 5))

    def K(self) -> torch.Tensor:
        return _K(self.fx, self.fy, self.cx, self.cy)

    def intrinsics_vector(self) -> np.ndarray:
        """(9,) float32 [fx fy cx cy k1 k2 k3 p1 p2]."""
        return np.asarray(self, np.float32)

    def project(self, pts_cam: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
        """(..., 3) camera-frame points -> (..., 2) pixels; points behind
        the camera project through a clamped depth."""
        z = _clamped_depth(pts_cam, eps)
        xn = pts_cam[..., 0] / z
        yn = pts_cam[..., 1] / z
        r2 = xn * xn + yn * yn
        d = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
        xy2 = 2.0 * xn * yn
        xd = xn * d + self.p1 * xy2 + self.p2 * (r2 + 2.0 * xn * xn)
        yd = yn * d + self.p1 * (r2 + 2.0 * yn * yn) + self.p2 * xy2
        return torch.stack([self.fx * xd + self.cx, self.fy * yd + self.cy], dim=-1)

    def unproject(self, pix: torch.Tensor, undistort_iters: int = _UNDIST_ITERS):
        """(..., 2) pixels -> (..., 3) unit-depth rays; the distortion is
        inverted by ``undistort_iters`` fixed-point steps."""
        xd = (pix[..., 0] - self.cx) / self.fx
        yd = (pix[..., 1] - self.cy) / self.fy
        xn, yn = xd, yd
        for _ in range(undistort_iters):
            r2 = xn * xn + yn * yn
            d = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
            xy2 = 2.0 * xn * yn
            tx = self.p1 * xy2 + self.p2 * (r2 + 2.0 * xn * xn)
            ty = self.p1 * (r2 + 2.0 * yn * yn) + self.p2 * xy2
            xn = (xd - tx) / d
            yn = (yd - ty) / d
        return torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)


class Fisheye(NamedTuple):
    """Equidistant fisheye (the theta polynomial of cv2.fisheye and
    Kannala-Brandt): r_d = theta (1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8),
    pixels = f * (x / |x|_xy) * r_d + c."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0

    model = "fisheye"

    @staticmethod
    def from_K(K, dist=()) -> "Fisheye":
        """``dist``: optional (k1[, k2[, k3[, k4]]]) coefficients."""
        return Fisheye(*_fxfycxcy(K), *_dist(dist, 4))

    def K(self) -> torch.Tensor:
        return _K(self.fx, self.fy, self.cx, self.cy)

    def intrinsics_vector(self) -> np.ndarray:
        """(9,) float32 [fx fy cx cy k1 k2 k3 k4 0]."""
        return np.asarray(tuple(self) + (0.0,), np.float32)

    def _thd(self, th):
        t2 = th * th
        return th * (1.0 + t2 * (self.k1 + t2 * (self.k2 + t2 * (self.k3 + t2 * self.k4))))

    def project(self, pts_cam: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
        """(..., 3) camera-frame points -> (..., 2) pixels (equidistant)."""
        z = _clamped_depth(pts_cam, eps)
        a = pts_cam[..., 0] / z
        b = pts_cam[..., 1] / z
        r = torch.sqrt(a * a + b * b)
        thd = self._thd(torch.arctan(r))
        scale = torch.where(r > eps, thd / torch.clamp(r, min=eps), torch.ones_like(r))
        return torch.stack([self.fx * a * scale + self.cx, self.fy * b * scale + self.cy],
                           dim=-1)

    def unproject(self, pix: torch.Tensor, newton_iters: int = _FISHEYE_NEWTON_ITERS):
        """(..., 2) pixels -> (..., 3) unit-depth rays: ``newton_iters``
        Newton steps on the theta polynomial from theta0 = theta_d."""
        xd = (pix[..., 0] - self.cx) / self.fx
        yd = (pix[..., 1] - self.cy) / self.fy
        thd = torch.sqrt(xd * xd + yd * yd)
        th = thd
        for _ in range(newton_iters):
            t2 = th * th
            g = self._thd(th) - thd
            dg = 1.0 + t2 * (3.0 * self.k1 + t2 * (5.0 * self.k2 + t2 * (
                7.0 * self.k3 + t2 * 9.0 * self.k4)))
            th = th - g / torch.where(dg.abs() < 1e-9, torch.full_like(dg, 1e-9), dg)
        scale = torch.where(thd > 1e-9, torch.tan(th) / torch.clamp(thd, min=1e-9),
                            torch.ones_like(thd))
        return torch.stack([xd * scale, yd * scale, torch.ones_like(xd)], dim=-1)


def normalize_pixels(xy: torch.Tensor, vec: torch.Tensor, model: str = "pinhole"):
    """Pixels (..., 2) -> normalized coordinates over a packed (9,)
    intrinsics vector (``intrinsics_vector``), on the tensors' device."""
    f = vec[:2]
    c = vec[2:4]
    xd = (xy - c) / f
    if model == "pinhole":
        k1, k2, k3, p1, p2 = vec[4], vec[5], vec[6], vec[7], vec[8]
        xn = xd
        for _ in range(_UNDIST_ITERS):
            r2 = (xn * xn).sum(-1, keepdim=True)
            d = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
            x, y = xn[..., 0:1], xn[..., 1:2]
            xy2 = 2.0 * x * y
            tx = p1 * xy2 + p2 * (r2 + 2.0 * x * x)
            ty = p1 * (r2 + 2.0 * y * y) + p2 * xy2
            xn = (xd - torch.cat([tx, ty], dim=-1)) / d
        return xn
    if model == "fisheye":
        k1, k2, k3, k4 = vec[4], vec[5], vec[6], vec[7]
        thd = torch.linalg.vector_norm(xd, dim=-1, keepdim=True)
        th = thd
        for _ in range(_FISHEYE_NEWTON_ITERS):
            t2 = th * th
            g = th * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - thd
            dg = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + t2 * 9.0 * k4)))
            th = th - g / torch.where(dg.abs() < 1e-9, torch.full_like(dg, 1e-9), dg)
        scale = torch.where(thd > 1e-9, torch.tan(th) / torch.clamp(thd, min=1e-9),
                            torch.ones_like(thd))
        return xd * scale
    raise ValueError(f"unknown camera model {model!r}")


def project_pixels(xn: torch.Tensor, vec: torch.Tensor, model: str = "pinhole"):
    """Normalized coordinates (..., 2) -> pixels over a packed (9,)
    intrinsics vector: the forward inverse of ``normalize_pixels``."""
    f = vec[:2]
    c = vec[2:4]
    if model == "pinhole":
        k1, k2, k3, p1, p2 = vec[4], vec[5], vec[6], vec[7], vec[8]
        x, y = xn[..., 0:1], xn[..., 1:2]
        r2 = x * x + y * y
        d = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xy2 = 2.0 * x * y
        xd = x * d + p1 * xy2 + p2 * (r2 + 2.0 * x * x)
        yd = y * d + p1 * (r2 + 2.0 * y * y) + p2 * xy2
        return torch.cat([xd, yd], dim=-1) * f + c
    if model == "fisheye":
        k1, k2, k3, k4 = vec[4], vec[5], vec[6], vec[7]
        r = torch.linalg.vector_norm(xn, dim=-1, keepdim=True)
        th = torch.arctan(r)
        t2 = th * th
        thd = th * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        scale = torch.where(r > 1e-9, thd / torch.clamp(r, min=1e-9), torch.ones_like(r))
        return xn * scale * f + c
    raise ValueError(f"unknown camera model {model!r}")


def normalize_np(uv_px: np.ndarray, cam) -> np.ndarray:
    """Host-side (numpy, float64) pixels -> normalized coordinates for
    either model, dispatching on ``cam.model`` with the iteration structure
    of ``normalize_pixels``; raises on an unknown model."""
    model = getattr(cam, "model", "pinhole")
    f = np.array([float(cam.fx), float(cam.fy)])
    c = np.array([float(cam.cx), float(cam.cy)])
    xd = (uv_px - c) / f

    def s(name):
        return float(getattr(cam, name, 0.0))

    if model == "pinhole":
        k1, k2, k3, p1, p2 = s("k1"), s("k2"), s("k3"), s("p1"), s("p2")
        if not (k1 or k2 or k3 or p1 or p2):
            return xd
        xn = xd.copy()
        for _ in range(_UNDIST_ITERS):
            r2 = np.sum(xn * xn, axis=-1, keepdims=True)
            d = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
            x, y = xn[..., 0:1], xn[..., 1:2]
            xy2 = 2.0 * x * y
            tx = p1 * xy2 + p2 * (r2 + 2.0 * x * x)
            ty = p1 * (r2 + 2.0 * y * y) + p2 * xy2
            xn = (xd - np.concatenate([tx, ty], axis=-1)) / d
        return xn
    if model == "fisheye":
        k1, k2, k3, k4 = s("k1"), s("k2"), s("k3"), s("k4")
        thd = np.linalg.norm(xd, axis=-1, keepdims=True)
        th = thd.copy()
        for _ in range(_FISHEYE_NEWTON_ITERS):
            t2 = th * th
            g = th * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - thd
            dg = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + t2 * 9.0 * k4)))
            th = th - g / np.where(np.abs(dg) < 1e-9, 1e-9, dg)
        scale = np.where(thd > 1e-9, np.tan(th) / np.maximum(thd, 1e-9), 1.0)
        return xd * scale
    raise ValueError(f"unknown camera model {model!r}")
