"""Pyramidal Lucas-Kanade (KLT) feature tracking on tensors.

Port of ``fastmatch_tpu/features/klt.py``: consecutive frames are related
by direct photometric tracking of Shi-Tomasi corners, the small-baseline
front end of visual odometry. Each point fetches two integer-aligned
patches a pyramid level through the K3 kernel wrapper
(``kernels/patch_gather.gather_patch_sets``): a template of
``_round8(win + 4)`` pixels from the previous frame and a target of
``_round8(win + 2 * margin + 2)`` pixels from the next. Every resample
after that is a pair of hat-function weight products against those
patches (bilinear interpolation at c is sum_p relu(1 - |c - p|) patch[p]),
so the LK iterations read no image memory.

The templates of every level depend only on the points, so one K3 call
fetches all of them before the level loop; a level's targets depend on
the coarser level's flow, so each level makes one more call: ``1 + levels``
launches a tracked frame on the card. Starts are clamped here, as in the
JAX package, so every set has pad 0. The per-point ``vmap`` of the JAX
package is batched tensors, the fixed iteration counts are Python loops
with no readback, and the products run in true float32 (the package turns
TF32 off at import).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from fastmatch_tpu_torch.core.containers import Keypoints
from fastmatch_tpu_torch.core.device import as_f32, resolve_device
from fastmatch_tpu_torch.dense.stereo import _box
from fastmatch_tpu_torch.features.sift import _blur, _top_k
from fastmatch_tpu_torch.kernels.patch_gather import PatchSet, gather_patch_sets


class KLTConfig(NamedTuple):
    levels: int = 3            # pyramid levels (coarsest tracks 4x-downscaled)
    win: int = 11              # odd tracking window side, pixels
    iters: int = 8             # LK iterations per level (fixed count)
    margin: int = 6            # target-patch slack around the estimate, px/level
    min_eig: float = 1e-4      # Shi-Tomasi gate on G's min eigenvalue (per px)
    max_residual: float = 0.06 # mean |T - J| on [0,1] images for a live track
    blur_sigma: float = 1.0    # pre-downsample anti-alias blur


def build_pyramid(img, cfg: KLTConfig = KLTConfig(), device=None):
    """(H, W) [0,1] grayscale -> list of ``cfg.levels`` contiguous images,
    coarse last: level l is level l-1 blurred by ``blur_sigma`` (the SIFT
    blur, reflect padding) and 2x-subsampled."""
    img = as_f32(img, device)
    pyr = [img]
    for _ in range(1, cfg.levels):
        img = _blur(img, cfg.blur_sigma)[::2, ::2].contiguous()
        pyr.append(img)
    return pyr


def _hat(c: torch.Tensor, size: int) -> torch.Tensor:
    """(..., S) coords -> (..., S, size) bilinear weight rows: relu(1 - |c - p|)."""
    p = torch.arange(size, dtype=torch.float32, device=c.device)
    return torch.clamp(1.0 - (c[..., None] - p).abs(), min=0.0)


def _round8(v: int) -> int:
    return v + (-v) % 8


def _starts(c: torch.Tensor, patch: int, size: int) -> torch.Tensor:
    """Integer patch starts centred on the rounded coordinates ``c``, clamped
    so the patch lies inside an axis of ``size`` pixels (int32)."""
    s = torch.round(c).to(torch.int32) - patch // 2
    return torch.clamp(s, 0, max(size - patch, 0))


def _lyx(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(K,) row/column starts into a one-level stack -> K3's (K, 3) table."""
    return torch.stack([torch.zeros_like(y), y, x], dim=1).contiguous()


def _patch_sides(cfg: KLTConfig, shape):
    """(template, target) patch sides at a level of ``shape``: tiny coarse
    levels shrink them to a multiple of 8 that fits the image."""
    PT = _round8(cfg.win + 4)
    PB = _round8(cfg.win + 2 * cfg.margin + 2)
    fit = (min(shape) // 8) * 8
    return min(PT, fit), min(PB, fit)


def track_pyramids(prev_pyr, next_pyr, pts, mask, cfg: KLTConfig = KLTConfig(), device=None):
    """Track ``pts`` (C, 2) xy pixels from prev to next (lists of level
    tensors from ``build_pyramid``) on ``device``.

    Returns (new_pts (C, 2), status (C,) bool, err (C,) f32): ``status``
    is mask AND textured-window AND in bounds AND photometric residual
    under ``cfg.max_residual``; ``err`` is the final mean absolute
    residual. Makes ``1 + cfg.levels`` K3 calls."""
    dev = resolve_device(device)
    pts = torch.as_tensor(pts, dtype=torch.float32).to(dev)
    mask = torch.as_tensor(mask, dtype=torch.bool).to(dev)
    win, m = cfg.win, float(cfg.margin)
    K = pts.shape[0]
    # Centered sample offsets: the template grid carries a +-1 gradient margin.
    ut = torch.arange(win + 2, dtype=torch.float32, device=dev) - (win + 1) / 2.0
    uw = torch.arange(win, dtype=torch.float32, device=dev) - (win - 1) / 2.0
    levels = range(cfg.levels - 1, -1, -1)
    ptl = {l: pts * (0.5 ** l) for l in levels}

    # Every level's templates in one K3 call: they depend on pts alone.
    tsets, toff = [], {}
    for l in levels:
        H, W = prev_pyr[l].shape
        PT = _patch_sides(cfg, (H, W))[0]
        cx = _starts(ptl[l][:, 0], PT, W)
        cy = _starts(ptl[l][:, 1], PT, H)
        toff[l] = (cx.float(), cy.float())
        tsets.append(PatchSet(prev_pyr[l][None], _lyx(cy, cx), PT, 0))
    templates = dict(zip(levels, gather_patch_sets(tsets)))

    flow = torch.zeros_like(pts)
    ok_eig = torch.ones(K, dtype=torch.bool, device=dev)
    err = torch.zeros(K, dtype=torch.float32, device=dev)
    for l in levels:
        H, W = prev_pyr[l].shape
        PT, PB = _patch_sides(cfg, (H, W))
        p = ptl[l]
        qx = _starts(p[:, 0] + flow[:, 0], PB, W)
        qy = _starts(p[:, 1] + flow[:, 1], PB, H)
        (patch_q,) = gather_patch_sets([PatchSet(next_pyr[l][None], _lyx(qy, qx), PB, 0)])
        patch_t = templates[l]
        ox, oy = toff[l]
        qox, qoy = qx.float(), qy.float()

        rx = torch.clamp(p[:, 0] - ox, 0.5, PT - 1.5)
        ry = torch.clamp(p[:, 1] - oy, 0.5, PT - 1.5)
        hy = _hat(torch.clamp(ry[:, None] + ut, 0.5, PT - 1.5), PT)
        hx = _hat(torch.clamp(rx[:, None] + ut, 0.5, PT - 1.5), PT)
        t2 = torch.matmul(torch.matmul(hy, patch_t), hx.transpose(1, 2))
        T = t2[:, 1:-1, 1:-1]                              # (K, win, win)
        Ix = 0.5 * (t2[:, 1:-1, 2:] - t2[:, 1:-1, :-2])
        Iy = 0.5 * (t2[:, 2:, 1:-1] - t2[:, :-2, 1:-1])
        gxx = (Ix * Ix).sum((1, 2))
        gxy = (Ix * Iy).sum((1, 2))
        gyy = (Iy * Iy).sum((1, 2))
        mineig = 0.5 * (gxx + gyy - torch.sqrt((gxx - gyy) ** 2 + 4 * gxy * gxy))
        det = gxx * gyy - gxy * gxy
        # A product with the reciprocal, as PyTorch divides a CUDA tensor by
        # a host scalar: the card and the CPU round alike.
        good = (mineig * (1.0 / (win * win))) > cfg.min_eig
        inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))

        def sample_j(d):
            jx = torch.clamp(p[:, 0:1] + d[:, 0:1] - qox[:, None] + uw, 0.5, PB - 1.5)
            jy = torch.clamp(p[:, 1:2] + d[:, 1:2] - qoy[:, None] + uw, 0.5, PB - 1.5)
            return torch.matmul(torch.matmul(_hat(jy, PB), patch_q), _hat(jx, PB).transpose(1, 2))

        g = flow
        d = g
        for _ in range(cfg.iters):
            r = T - sample_j(d)
            bx = (r * Ix).sum((1, 2))
            by = (r * Iy).sum((1, 2))
            dx = inv_det * (gyy * bx - gxy * by)
            dy = inv_det * (gxx * by - gxy * bx)
            # Clamp each step, and the total drift from the level's prior, so
            # a divergent window stays inside its target patch (the residual
            # gate flags it). A degenerate window has inv_det 0 and steps 0;
            # the min-eig gate is applied at the finest level only.
            step = torch.clamp(torch.stack([dx, dy], dim=1), -m, m)
            d = g + torch.clamp(d + step - g, -(m + 1.0), m + 1.0)
        flow = d
        err = (T - sample_j(d)).abs().mean((1, 2))
        if l == 0:
            ok_eig = ok_eig & good
        else:
            flow = flow * 2.0

    new_pts = pts + flow
    H0, W0 = prev_pyr[0].shape
    b = win / 2.0 + 1.0
    in_bounds = ((new_pts[:, 0] >= b) & (new_pts[:, 0] <= W0 - 1 - b)
                 & (new_pts[:, 1] >= b) & (new_pts[:, 1] <= H0 - 1 - b))
    status = mask & ok_eig & in_bounds & (err < cfg.max_residual)
    return new_pts, status, err


def track(prev_img, next_img, pts, mask, cfg: KLTConfig = KLTConfig(), device=None):
    """Build both pyramids and track (``track_pyramids``; reuse pyramids
    across a sequence when tracking frame t -> t+1 -> t+2 ...)."""
    return track_pyramids(build_pyramid(prev_img, cfg, device),
                          build_pyramid(next_img, cfg, device), pts, mask, cfg, device)


def shi_tomasi(img, capacity: int = 1024, win: int = 5, min_dist: int = 3,
               device=None) -> Keypoints:
    """Good features to track: min-eig of the structure tensor, NMS, top-k.

    (H, W) [0,1] grayscale -> Keypoints at ``capacity`` on ``device`` (score
    = min-eig response per pixel; masked rows zero). ``win``: box window of
    the gradient sums; ``min_dist``: NMS suppression radius in pixels."""
    img = as_f32(img, device)
    H, W = img.shape
    p = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    gx = 0.5 * (p[1:-1, 2:] - p[1:-1, :-2])
    gy = 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1])
    # Window sums as fixed-order adds (``dense.stereo._box``), so the card and
    # the CPU round alike; the JAX package takes float32 prefix-sum differences.
    gxx, gxy, gyy = _box(gx * gx, win), _box(gx * gy, win), _box(gy * gy, win)
    score = 0.5 * (gxx + gyy - torch.sqrt((gxx - gyy) ** 2 + 4 * gxy * gxy))
    # Kill the border band where windows hang off the image.
    r = win // 2 + 1
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    interior = (yy >= r) & (yy < H - r) & (xx >= r) & (xx < W - r)
    score = torch.where(interior, score, torch.zeros_like(score))
    k = 2 * min_dist + 1
    pooled = F.max_pool2d(score[None, None], k, stride=1, padding=min_dist)[0, 0]
    flat = torch.where((score >= pooled) & (score > 0), score, torch.zeros_like(score))
    vals, idx = _top_k(flat.reshape(-1), capacity)
    m = vals > 0
    xy = torch.stack([(idx % W).float(), (idx // W).float()], dim=1)
    return Keypoints(xy=torch.where(m[:, None], xy, torch.zeros_like(xy)),
                     scale=torch.full((capacity,), float(win), device=img.device),
                     angle=torch.zeros(capacity, device=img.device),
                     score=torch.where(m, vals, torch.zeros_like(vals)), mask=m)


def track_pair(img0, img1, cfg: KLTConfig = KLTConfig(), capacity: int = 1024, device=None):
    """Detect Shi-Tomasi corners on img0 and KLT-track them into img1 on
    ``device``. Returns (pts0 (C, 2), pts1 (C, 2), status (C,), err (C,)),
    correspondences for the two-view estimators."""
    img0, img1 = as_f32(img0, device), as_f32(img1, device)
    kps = shi_tomasi(img0, capacity=capacity, device=img0.device)
    pts1, status, err = track(img0, img1, kps.xy, kps.mask, cfg, img0.device)
    return kps.xy, pts1, status, err
