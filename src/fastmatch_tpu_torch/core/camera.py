"""Pinhole camera model and the host-side pixel normalization.

Port of ``fastmatch_tpu/core/camera.py``'s ``Pinhole`` (with Brown-Conrady
coefficients kept as fields) and ``normalize_np``. The fisheye model waits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_UNDIST_ITERS = 10


class Pinhole(NamedTuple):
    """Pinhole intrinsics (Python floats) with Brown-Conrady distortion
    coefficients k1, k2, k3 (radial) and p1, p2 (tangential)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @staticmethod
    def from_K(K, dist=()) -> "Pinhole":
        """``dist``: optional (k1, k2[, k3[, p1, p2]]) coefficients."""
        K = np.asarray(K, np.float64)
        d = tuple(float(x) for x in dist) + (0.0,) * (5 - len(dist))
        return Pinhole(float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                       float(K[1, 2]), *d)


def normalize_np(uv_px: np.ndarray, cam: Pinhole) -> np.ndarray:
    """Host-side (numpy) pixels -> normalized coords, with the JAX package's
    fixed-point undistortion (same iteration structure)."""
    f = np.array([float(cam.fx), float(cam.fy)])
    c = np.array([float(cam.cx), float(cam.cy)])
    xd = (uv_px - c) / f
    k1, k2, k3, p1, p2 = cam.k1, cam.k2, cam.k3, cam.p1, cam.p2
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
