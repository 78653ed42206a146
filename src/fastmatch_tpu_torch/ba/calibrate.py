"""Self-calibration: intrinsics refinement against the reconstructed map.

Port of ``fastmatch_tpu/ba/calibrate.py``. The engine works in normalized
image coordinates (intrinsics are divided out at ingestion), so a
calibration error is frozen into the map. This post-pass closes the gap:

1. Recover the raw pixel observations from the stored normalized ones
   through the current model's exact forward projection
   (``core/camera.project_pixels`` inverts ``normalize_pixels``).
2. LM over the packed (9,) intrinsics vector with the map held fixed:
   residuals are pixel reprojection errors, the (O, 2, 9) Jacobian comes
   from one ``torch.func.jacfwd``, and the normal equations are one 9x9
   solve. Frozen parameters (``free``) get zeroed Jacobian columns and unit
   damping, so their entries never move.
3. Alternate with standard BA (block coordinate descent): refit intrinsics
   -> renormalize observations -> BA over poses and points -> repeat.

The LM loop stops on a data-dependent flag: it reads that flag back once
an iteration (at most ``max_iters`` readbacks). Its cost and normal
equations pass through an optional ``reduce`` hook (the identity by
default), so observation-sharded refinement can sum them across ranks.

Monocular sequences determine focal length only through perspective
effects: low-parallax motion leaves fx near-gauge, and the refinement then
returns it nearly unchanged. Principal point and tangential terms are the
weakest; they default to frozen.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from fastmatch_tpu_torch.ba.lm import ba_solve
from fastmatch_tpu_torch.ba.problem import BAProblem, Observations
from fastmatch_tpu_torch.core.camera import normalize_pixels, project_pixels
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.core.lie import SE3

# Default free-parameter sets by model: focal, centre and two radial
# terms. k3/p1/p2 (pinhole) and k3/k4 (fisheye) are near-unobservable on
# typical SLAM coverage and stay frozen unless the caller opts in.
_DEFAULT_FREE = {
    "pinhole": (0, 1, 2, 3, 4, 5),
    "fisheye": (0, 1, 2, 3, 4, 5),
}

_PARAM_NAMES = {
    "pinhole": ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "p1", "p2"),
    "fisheye": ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4", "-"),
}


class CalibResult(NamedTuple):
    vec: torch.Tensor       # (9,) refined packed intrinsics
    cost0: torch.Tensor     # mean squared pixel error before
    cost: torch.Tensor      # ... and after
    iters: int              # LM iterations executed
    accepted: int           # LM steps accepted


def param_indices(model: str, names) -> tuple:
    """Map parameter names (e.g. ("fx", "k1")) to packed-vector indices."""
    table = _PARAM_NAMES[model]
    return tuple(table.index(n) for n in names)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def refine_intrinsics(
    R: torch.Tensor,          # (C, 3, 3) world->camera rotations
    t: torch.Tensor,          # (C, 3)
    points: torch.Tensor,     # (P, 3)
    obs_cam: torch.Tensor,    # (O,) int32
    obs_pt: torch.Tensor,     # (O,) int32
    uv_px: torch.Tensor,      # (O, 2) pixel observations
    obs_mask: torch.Tensor,   # (O,) bool
    vec0: torch.Tensor,       # (9,) packed intrinsics start
    model: str = "pinhole",
    free: tuple = None,
    max_iters: int = 12,
    huber_px: float = 2.0,
    reduce: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> CalibResult:
    """LM over the packed intrinsics vector with the map held fixed, on the
    tensors' device.

    Residuals: ``project_pixels(x/z, vec) - uv_px`` per live observation
    (rows with z <= 0 get zero weight), Huber-weighted in pixels.
    ``reduce``: applied to the cost's sum and count and to the 9x9 normal
    equations' matrix and vector (``torch.distributed.all_reduce`` for an
    observation-sharded refinement); the identity when None.
    """
    red = _identity if reduce is None else reduce
    free = _DEFAULT_FREE[model] if free is None else free
    dev = vec0.device
    fmask = torch.zeros(9, dtype=torch.float32, device=dev)
    fmask[list(free)] = 1.0
    oc, op = obs_cam.long(), obs_pt.long()

    Xc = torch.einsum("oij,oj->oi", R[oc], points[op]) + t[oc]
    z = Xc[..., 2]
    w_geom = (obs_mask & (z > 1e-6)).to(torch.float32)
    zs = torch.where(z.abs() < 1e-6, 1e-6, z)
    xn = Xc[..., :2] / zs[..., None]

    def residuals(vec):
        return project_pixels(xn, vec, model) - uv_px

    def robust(r):
        """(rho, IRLS weight) of each row's squared error."""
        e2 = (r * r).sum(-1)
        if not (huber_px and huber_px > 0):
            return e2, torch.ones_like(e2)
        d2 = float(huber_px * huber_px)
        e2c = torch.clamp(e2, min=1e-12)
        inside = e2 <= d2
        return (torch.where(inside, e2, 2.0 * torch.sqrt(d2 * e2c) - d2),
                torch.where(inside, 1.0, torch.sqrt(d2 / e2c)))

    def cost(r):
        rho, _ = robust(r)
        csum = red((w_geom * rho).sum())
        cnt = red(w_geom.sum())
        return csum / torch.clamp(cnt, min=1.0)

    def normal_eq(vec):
        r = residuals(vec)
        J = torch.func.jacfwd(residuals)(vec) * fmask      # (O, 2, 9), frozen columns 0
        w = w_geom * robust(r)[1]
        A = torch.einsum("o,oik,oil->kl", w, J, J)
        g = torch.einsum("o,oik,oi->k", w, J, r)
        return red(A), red(g)

    cost0 = cost(residuals(vec0))
    vec, cur = vec0, cost0
    lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    it = 0
    while it < max_iters:
        A, g = normal_eq(vec)
        # Marquardt damping on free params; frozen rows get identity so the
        # 9x9 stays SPD and their update is exactly zero (g is zero there).
        diag = torch.diagonal(A) * fmask
        damp = lam * torch.clamp(diag, min=1e-6) + (1.0 - fmask)
        step = torch.linalg.solve_ex(A + torch.diag(damp), g[:, None])[0][:, 0] * fmask
        new_vec = vec - step
        new_cost = cost(residuals(new_vec))
        accept = new_cost < cur
        vec = torch.where(accept, new_vec, vec)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        rel = (cur - new_cost).abs() / torch.clamp(cur, min=1e-12)
        cur = torch.where(accept, new_cost, cur)
        accepted = accepted + accept.to(torch.int64)
        it += 1
        if bool(accept & (rel < 1e-9)):
            break
    return CalibResult(vec=vec, cost0=cost0, cost=cur, iters=it, accepted=int(accepted))


def recover_pixels(obs_uv_norm: torch.Tensor, vec: torch.Tensor, model: str) -> torch.Tensor:
    """Stored normalized observations -> the raw pixels they came from
    (exact forward projection through the model that normalized them)."""
    return project_pixels(obs_uv_norm, vec, model)


def calibrate_map(
    R, t, points, obs_cam, obs_pt, uv_px, obs_mask,
    cam_mask, pt_mask, fixed_cams,
    vec0, model="pinhole", free=None, rounds: int = 3,
    huber_px: float = 2.0, ba_kwargs: dict | None = None,
    reduce: Callable[[torch.Tensor], torch.Tensor] | None = None, device=None,
):
    """Alternating self-calibration on ``device`` (``cuda`` unless
    ``device="cpu"``): intrinsics LM <-> pose/point BA.

    Each round refits the packed vector against the current map,
    renormalizes the pixel observations with it, and runs one standard BA
    (``ba/lm.py``: K4, K5). Both block solves decrease the same pixel
    reprojection objective, so the alternation is monotone in practice.

    Returns (vec, R, t, points, history) where history is a list of
    (cal_cost_px2, ba_cost) per round.
    """
    dev = resolve_device(device)
    R, t, points, obs_cam, obs_pt, uv_px, obs_mask, cam_mask, pt_mask, fixed_cams = (
        torch.as_tensor(a).to(dev) for a in (R, t, points, obs_cam, obs_pt, uv_px, obs_mask,
                                              cam_mask, pt_mask, fixed_cams))
    vec = torch.as_tensor(vec0, dtype=torch.float32).to(dev)
    ba_kwargs = dict(ba_kwargs or {})
    history = []
    for _ in range(rounds):
        res = refine_intrinsics(R, t, points, obs_cam, obs_pt, uv_px, obs_mask, vec,
                                model=model, free=free, huber_px=huber_px, reduce=reduce)
        vec = res.vec
        uv_n = normalize_pixels(uv_px, vec, model)
        prob = BAProblem(poses=SE3(R, t), points=points,
                         obs=Observations(obs_cam, obs_pt, uv_n, obs_mask),
                         cam_mask=cam_mask, pt_mask=pt_mask, fixed_cams=fixed_cams)
        ba = ba_solve(prob, device=dev, **ba_kwargs)
        R, t, points = ba.poses.R, ba.poses.t, ba.points
        history.append((float(res.cost), float(ba.cost)))
    return vec, R, t, points, history


def self_calibrate(rec, camera, cfg, rounds: int = 3, free=None, metrics=None):
    """Post-pass over a Reconstruction (what reconstruct()/slam()/
    global_reconstruct() return), on its device: refine intrinsics against
    the final map, update poses, points and observations in place, and
    return (the refined camera of the same model class, history).

    The observations' pixels are recovered exactly through the current
    model first (see the module docstring). ``cfg``: the PipelineConfig
    that built the map (its BA budgets and Huber width are reused)."""
    model = getattr(camera, "model", "pinhole")
    vec0_np = camera.intrinsics_vector()
    dev = rec.device
    vec0 = torch.from_numpy(vec0_np).to(dev)
    fixed = np.zeros_like(rec.pose_mask)
    fixed[:2] = True
    # Live observations are an append-ordered prefix of the capacity table:
    # the solve takes exactly those rows (run_ba compacts the same way).
    B = rec.n_obs

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    uv_px = recover_pixels(dev_t(rec.obs_uv[:B]), vec0, model)
    vec, R, t, X, history = calibrate_map(
        dev_t(rec.R), dev_t(rec.t), dev_t(rec.points), dev_t(rec.obs_cam[:B]),
        dev_t(rec.obs_pt[:B]), uv_px, dev_t(rec.obs_mask[:B]), dev_t(rec.pose_mask),
        dev_t(rec.pt_mask), dev_t(fixed & rec.pose_mask), vec0, model=model, free=free,
        rounds=rounds, huber_px=cfg.ba.huber_px,
        ba_kwargs=dict(max_iters=cfg.ba.max_iters, pcg_iters=cfg.ba.pcg_iters,
                       huber_delta_static=cfg.ba.huber_px / float(vec0_np[0])),
        device=dev)
    rec.R = R.cpu().numpy().copy()
    rec.t = t.cpu().numpy().copy()
    rec.points = X.cpu().numpy().copy()
    rec.obs_uv = rec.obs_uv.copy()
    rec.obs_uv[:B] = normalize_pixels(uv_px, vec, model).cpu().numpy()
    vec_np = vec.cpu().numpy()
    if metrics:
        metrics.log("self_calibrate", rounds=rounds, cost_px2=history[-1][0],
                    vec=[float(v) for v in vec_np])
    names = _PARAM_NAMES[model]
    kw = {n: float(vec_np[i]) for i, n in enumerate(names) if n != "-"}
    return type(camera)(**kw), history
