"""IMU preintegration and visual-inertial alignment on tensors.

Port of ``fastmatch_tpu/sensors/imu.py``. Gyro/accel samples between
keyframes are preintegrated into relative-motion pseudo-measurements
(Forster et al.'s on-manifold Euler recursion) with first-order bias
Jacobians, and a linear solve recovers the metric scale, gravity and
per-keyframe velocities that a monocular map cannot observe.

The JAX package's ``lax.scan`` over samples is a loop over the sample axis
here, batched over any leading interval axes (its ``vmap``); a masked
sample is a no-op. ``vi_align`` assembles its dense normal equations and
solves them by Cholesky, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fastmatch_tpu_torch.core.device import as_f32, resolve_device
from fastmatch_tpu_torch.core.lie import SO3, hat


class ImuPreintegration(NamedTuple):
    """Preintegrated motion over one keyframe interval (body frame of the
    interval's FIRST keyframe). Leading batch axes allowed."""

    dR: torch.Tensor      # (3, 3) rotation delta
    dv: torch.Tensor      # (3,) velocity delta (gravity-free)
    dp: torch.Tensor      # (3,) position delta (gravity-free)
    dt: torch.Tensor      # () total duration
    # bias Jacobians (first-order correction around the integration bias)
    dR_dbg: torch.Tensor  # (3, 3)  d log(dR) / d gyro-bias
    dv_dbg: torch.Tensor  # (3, 3)
    dv_dba: torch.Tensor  # (3, 3)
    dp_dbg: torch.Tensor  # (3, 3)
    dp_dba: torch.Tensor  # (3, 3)


def _right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO3 right Jacobian Jr(w) of (..., 3) -> (..., 3, 3), series-stable
    near 0."""
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2 + 1e-24)
    W = hat(w)
    small = th2 < 1e-12
    c1 = torch.where(small, torch.full_like(th2, 0.5),
                     (1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-24))
    c2 = torch.where(small, torch.full_like(th2, 1.0 / 6.0),
                     (th - torch.sin(th)) / torch.clamp(th2 * th, min=1e-24))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - c1 * W + c2 * (W @ W)


def preintegrate(gyro, accel, dts, mask=None, bias_g=None, bias_a=None,
                 device=None) -> ImuPreintegration:
    """Integrate IMU sample runs into relative-motion measurements on
    ``device``.

    gyro/accel: (..., N, 3) body-frame samples (rad/s, raw specific force in
    m/s^2, gravity reaction included); dts: (..., N) per-sample durations;
    mask: (..., N) live samples (False rows are no-ops); leading axes are
    intervals. Biases ((..., 3)) are subtracted before integration; the
    returned Jacobians correct the factors for small bias updates without
    integrating again."""
    dev = resolve_device(device)
    gyro, accel, dts = as_f32(gyro, dev), as_f32(accel, dev), as_f32(dts, dev)
    batch = gyro.shape[:-2]
    mask = (torch.ones(dts.shape, dtype=torch.bool, device=dev) if mask is None
            else torch.as_tensor(mask).to(device=dev, dtype=torch.bool))
    bias_g = torch.zeros(3, device=dev) if bias_g is None else as_f32(bias_g, dev)
    bias_a = torch.zeros(3, device=dev) if bias_a is None else as_f32(bias_a, dev)
    m = mask.float()
    w = (gyro - bias_g[..., None, :]) * m[..., None]
    a = (accel - bias_a[..., None, :]) * m[..., None]
    dts = dts * m

    eye = torch.eye(3, device=dev).expand(*batch, 3, 3)
    zero3 = torch.zeros(*batch, 3, 3, device=dev)
    dR, dv, dp = eye, torch.zeros(*batch, 3, device=dev), torch.zeros(*batch, 3, device=dev)
    t = torch.zeros(batch, device=dev)
    dR_dbg = dv_dbg = dv_dba = dp_dbg = dp_dba = zero3
    for i in range(gyro.shape[-2]):
        wi, ai, dt = w[..., i, :], a[..., i, :], dts[..., i]
        dtv, dtm = dt[..., None], dt[..., None, None]
        Rinc = SO3.exp(wi * dtv)
        # Euler on the manifold (the Forster convention): the sample is
        # rotated by the PRE-update dR.
        acc_w = (dR @ ai[..., None])[..., 0]
        dp_new = dp + dv * dtv + 0.5 * acc_w * dtv * dtv
        dv_new = dv + acc_w * dtv
        # Bias Jacobians, first order, by the same recursion as the state.
        A = dR @ hat(ai)
        dp_dbg_n = dp_dbg + dv_dbg * dtm - 0.5 * A @ dR_dbg * dtm * dtm
        dp_dba_n = dp_dba + dv_dba * dtm - 0.5 * dR * dtm * dtm
        dv_dbg_n = dv_dbg - A @ dR_dbg * dtm
        dv_dba_n = dv_dba - dR * dtm
        Jr = _right_jacobian(wi * dtv)
        dR_dbg = Rinc.transpose(-1, -2) @ dR_dbg - Jr * dtm
        dR = dR @ Rinc
        dv, dp, t = dv_new, dp_new, t + dt
        dp_dbg, dp_dba, dv_dbg, dv_dba = dp_dbg_n, dp_dba_n, dv_dbg_n, dv_dba_n
    return ImuPreintegration(dR=dR, dv=dv, dp=dp, dt=t, dR_dbg=dR_dbg, dv_dbg=dv_dbg,
                             dv_dba=dv_dba, dp_dbg=dp_dbg, dp_dba=dp_dba)


def predict(Ri, pi, vi, pre: ImuPreintegration, g):
    """Propagate keyframe state i through a preintegrated interval.

    Ri: (3, 3) body->world, pi/vi: (3,) world, g: (3,) world gravity.
    Returns (Rj, pj, vj)."""
    dev = pre.dR.device
    Ri, pi, vi, g = (as_f32(x, dev) for x in (Ri, pi, vi, g))
    dt = pre.dt
    Rj = Ri @ pre.dR
    vj = vi + g * dt + Ri @ pre.dv
    pj = pi + vi * dt + 0.5 * g * dt * dt + Ri @ pre.dp
    return Rj, pj, vj


def vi_align(R_wb, p_cam, pres: ImuPreintegration, g_mag: float = 9.81):
    """Monocular visual-inertial initialization on the device of ``pres``:
    scale, gravity and velocities from camera poses and preintegrated IMU
    intervals.

    R_wb: (F, 3, 3) body-to-world rotations of the keyframes; p_cam: (F, 3)
    keyframe positions in the unscaled monocular frame; pres: batch with
    leading axis F-1 (interval i -> i+1). Returns (s, g, v (F, 3), resid):
    metric scale (p_metric = s * p_cam), world gravity renormalized to
    ``g_mag``, per-keyframe velocities, and the RMS residual.

    Linear system per interval (unknowns s, g, v_i):
        s*p_{i+1} = s*p_i + v_i dt + 0.5 g dt^2 + R_i dp_i
        v_{i+1}   = v_i + g dt + R_i dv_i
    """
    dev = pres.dt.device
    R_wb, p_cam = as_f32(R_wb, dev), as_f32(p_cam, dev)
    F = p_cam.shape[0]
    dts = pres.dt
    n_unk = 1 + 3 + 3 * F                # s, g, v_0..v_{F-1}
    I3 = torch.eye(3, device=dev)
    A = torch.zeros((6 * (F - 1), n_unk), device=dev)
    b = torch.zeros(6 * (F - 1), device=dev)
    for i in range(F - 1):
        dt = dts[i]
        r0, v0, v1 = 6 * i, 4 + 3 * i, 7 + 3 * i
        # position rows
        A[r0:r0 + 3, 0] = p_cam[i + 1] - p_cam[i]
        A[r0:r0 + 3, 1:4] = -0.5 * dt * dt * I3
        A[r0:r0 + 3, v0:v0 + 3] = -dt * I3
        b[r0:r0 + 3] = R_wb[i] @ pres.dp[i]
        # velocity rows
        A[r0 + 3:r0 + 6, 1:4] = -dt * I3
        A[r0 + 3:r0 + 6, v0:v0 + 3] = -I3
        A[r0 + 3:r0 + 6, v1:v1 + 3] = I3
        b[r0 + 3:r0 + 6] = R_wb[i] @ pres.dv[i]
    AtA = A.T @ A + 1e-8 * torch.eye(n_unk, device=dev)
    Atb = A.T @ b
    x = torch.cholesky_solve(Atb[:, None], torch.linalg.cholesky(AtA))[:, 0]
    s = x[0]
    g = x[1:4]
    v = x[4:].reshape(F, 3)
    resid = torch.sqrt(torch.mean((A @ x - b) ** 2))
    # Renormalize gravity to the known magnitude (the scale/gravity
    # ambiguity along g is weakly observable on short runs).
    g = g * (g_mag / torch.clamp(torch.linalg.vector_norm(g), min=1e-9))
    return s, g, v, resid


def gravity_rotation(g: np.ndarray) -> np.ndarray:
    """The minimal rotation taking the direction of ``g`` to (0, 0, -1)."""
    g = np.asarray(g, np.float64)
    a = g / np.linalg.norm(g)
    b = np.array([0.0, 0.0, -1.0])
    vx = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(vx) < 1e-12:
        return np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    K = np.array([[0, -vx[2], vx[1]], [vx[2], 0, -vx[0]], [-vx[1], vx[0], 0]])
    return np.eye(3) + K + K @ K / (1.0 + c)


def apply_vi_alignment(rec, pres: ImuPreintegration, g_mag: float = 9.81):
    """Metric-upgrade a monocular Reconstruction in place from IMU data.

    ``pres``: ImuPreintegration batch over consecutive frame intervals
    (leading axis rec.n_frames - 1; camera frame == body frame). Runs
    ``vi_align`` on the reconstruction's poses, then applies the one global
    similarity that makes the map metric and gravity-aligned (gravity along
    -z): X' = s R_g X, R' = R R_g^T, t' = s t, which preserves every
    projection. Returns dict(scale, gravity, resid)."""
    F = rec.n_frames
    dev = pres.dt.device
    R_wc = np.asarray(rec.R[:F])                       # world->cam
    centers = -np.einsum("fji,fj->fi", R_wc, np.asarray(rec.t[:F]))
    s, g, _, resid = vi_align(torch.from_numpy(R_wc.transpose(0, 2, 1).copy()).to(dev),
                              torch.from_numpy(centers.astype(np.float32)).to(dev),
                              pres, g_mag=g_mag)
    s = float(s)
    g_np = g.cpu().numpy().astype(np.float64)
    R_g = gravity_rotation(g_np)
    rec.R[:F] = np.einsum("fij,kj->fik", R_wc, R_g).astype(np.float32)
    rec.t[:F] = (s * np.asarray(rec.t[:F])).astype(np.float32)
    live = rec.pt_mask
    rec.points[live] = (s * (np.asarray(rec.points[live]) @ R_g.T)).astype(np.float32)
    return dict(scale=s, gravity=[float(x) for x in g_np], resid=float(resid))
