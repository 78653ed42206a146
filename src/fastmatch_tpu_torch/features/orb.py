"""ORB-style binary features: FAST-9 corners + oriented BRIEF, on tensors.

Port of ``fastmatch_tpu/features/orb.py``, function for function:

- the pyramid levels are the JAX package's ``jax.image.resize(..., "linear")``
  (a triangle filter stretched by the downscale factor, normalised per
  output pixel), built here as separable weight matrices in numpy and
  applied as two products;
- FAST-9 scores every pixel from 16 shifted views of the image, keeps a
  corner where 9 contiguous circle pixels are all brighter or all darker,
  suppresses non-maxima with a 3x3 max pool and selects with a stable top-k
  (the lowest index wins among the many tied scores);
- every level is detected and blurred first; then one call of the K3 kernel
  wrapper (``kernels/patch_gather.gather_patch_sets``) fetches every level's
  keypoint patches, with the JAX package's replicate padding folded into
  the gather; each patch is oriented by its intensity centroid, and its
  256 rotated BRIEF tests are bilinear samples taken as hat-function
  weight products against the patch; the bits are packed into 8 words.

The BRIEF pattern is the JAX package's: the same numpy generator and seed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from fastmatch_tpu_torch.core.containers import BinaryDescriptors, Keypoints, pack_bits
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.features.sift import _blur, _lyx, _top_k
from fastmatch_tpu_torch.kernels.patch_gather import PatchSet, gather_patch_sets


class ORBConfig(NamedTuple):
    capacity: int = 2048
    n_levels: int = 4                # image pyramid levels
    scale_step: float = 1.25         # per-level downscale factor
    fast_threshold: float = 0.08     # on [0,1] images (~cv2's 20/255)
    fast_arc: int = 9                # contiguous circle pixels (FAST-9)
    blur_sigma: float = 2.0          # pre-BRIEF smoothing
    n_bits: int = 256
    pattern_radius: float = 12.0     # BRIEF test offsets clipped to this
    pattern_seed: int = 20140901
    centroid_radius: int = 15        # orientation moment disk
    patch: int = 40                  # per-keypoint patch (covers rotation)


# Radius-3 Bresenham circle, 16 (dy, dx) offsets, clockwise from 12 o'clock.
_CIRCLE = [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
           (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
           (-3, -1)]


@functools.lru_cache(maxsize=None)
def _brief_pattern(n_bits: int, radius: float, seed: int) -> np.ndarray:
    """(n_bits, 4) float32 test-pair offsets (y1, x1, y2, x2), Gaussian with
    sigma = radius/2 clipped to the disk of ``radius``; near-degenerate
    pairs are nudged apart."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, radius / 2.0, size=(n_bits, 4))
    pts = np.clip(pts, -radius, radius)
    d = np.hypot(pts[:, 0] - pts[:, 2], pts[:, 1] - pts[:, 3])
    bad = d < 1.0
    pts[bad, 2:] = np.clip(pts[bad, 2:] + 2.0, -radius, radius)
    return pts.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(..., "linear")``
    along one axis (``compute_weight_mat`` with antialiasing): a triangle
    kernel stretched by max(n_in / n_out, 1), normalised per output."""
    inv_scale = n_in / n_out
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(inv_scale)
              - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = np.zeros((1, n_out), np.float32)
    for row in w:
        total += row
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def _resize_linear(img: torch.Tensor, shape) -> torch.Tensor:
    """(H, W) -> ``shape``, as ``jax.image.resize(img, shape, "linear")``."""
    h, w = img.shape
    wy = torch.from_numpy(_resize_weights(h, shape[0])).to(img.device)
    wx = torch.from_numpy(_resize_weights(w, shape[1])).to(img.device)
    return (wy.T @ img) @ wx


def _detect_level(img: torch.Tensor, cfg: ORBConfig, k_level: int):
    """FAST-9 corners on one pyramid level: (xy (K, 2) level coords, score
    (K,), mask (K,), yy, xx)."""
    h, w = img.shape
    t = cfg.fast_threshold
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    circ = torch.stack([p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] for dy, dx in _CIRCLE])
    bright = circ > img[None] + t
    dark = circ < img[None] - t

    def arc_any(flags):
        ext = torch.cat([flags, flags[:cfg.fast_arc - 1]], dim=0)
        runs = [ext[s:s + cfg.fast_arc].all(dim=0) for s in range(16)]
        return torch.stack(runs).any(dim=0)

    corner = arc_any(bright) | arc_any(dark)
    sb = torch.clamp(circ - img[None] - t, min=0.0).sum(dim=0)
    sd = torch.clamp(img[None] - circ - t, min=0.0).sum(dim=0)
    score = torch.where(corner, torch.maximum(sb, sd), 0.0)

    b = cfg.patch // 2
    yi = torch.arange(h, device=img.device)[:, None]
    xi = torch.arange(w, device=img.device)[None, :]
    interior = (yi >= b) & (yi < h - b) & (xi >= b) & (xi < w - b)
    score = torch.where(interior, score, 0.0)

    # 3x3 non-max suppression (-inf borders); ties keep both.
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    score = torch.where(score >= pooled, score, 0.0)

    vals, idx = _top_k(score.reshape(-1), k_level)
    yy = (idx // w).to(torch.int32)
    xx = (idx % w).to(torch.int32)
    mask = vals > 0.0
    xy = torch.stack([xx.float(), yy.float()], dim=-1)
    return xy, vals, mask, yy, xx


def _patch_set(blurred: torch.Tensor, yy, xx, cfg: ORBConfig) -> PatchSet:
    """K3 segment of one level's keypoint patches: P x P windows of the
    blurred level, replicate-padded by P // 2."""
    half = cfg.patch // 2
    # start + half (pad) - half (centre) == the keypoint pixel itself
    return PatchSet(blurred[None], _lyx(torch.zeros_like(yy), yy, xx), cfg.patch, half)


def _orient_and_describe(patches: torch.Tensor, cfg: ORBConfig):
    """Per-keypoint orientation (intensity centroid) and rotated BRIEF bits
    from each keypoint's patch (``_patch_set``): (angle (K,), bits
    (K, n_bits) bool)."""
    P = cfg.patch
    half = P // 2
    dev = patches.device

    off = np.arange(P, dtype=np.float32) - half
    oy, ox = np.meshgrid(off, off, indexing="ij")
    disk = ((oy ** 2 + ox ** 2) <= cfg.centroid_radius ** 2).astype(np.float32)
    wy = torch.from_numpy(oy * disk).to(dev)
    wx = torch.from_numpy(ox * disk).to(dev)
    m01 = torch.einsum("kpq,pq->k", patches, wy)
    m10 = torch.einsum("kpq,pq->k", patches, wx)
    angle = torch.atan2(m01, m10)

    pat = _brief_pattern(cfg.n_bits, cfg.pattern_radius, cfg.pattern_seed)
    py = torch.from_numpy(np.concatenate([pat[:, 0], pat[:, 2]])).to(dev)  # (2n,)
    px = torch.from_numpy(np.concatenate([pat[:, 1], pat[:, 3]])).to(dev)
    pr = torch.arange(P, dtype=torch.float32, device=dev)
    ct = torch.cos(angle)[:, None]
    st = torch.sin(angle)[:, None]
    sx = torch.clamp(ct * px - st * py + half, 0.0, P - 1.0)      # (K, 2n)
    sy = torch.clamp(st * px + ct * py + half, 0.0, P - 1.0)
    # Bilinear sample = sum_pq hat(sy - p) hat(sx - q) patch[p, q]:
    # (2n, P) @ (P, P), then a row-wise weighted sum.
    wyv = torch.clamp(1.0 - (sy[..., None] - pr).abs(), min=0.0)  # (K, 2n, P)
    wxv = torch.clamp(1.0 - (sx[..., None] - pr).abs(), min=0.0)
    vals = ((wyv @ patches) * wxv).sum(-1)                          # (K, 2n)
    bits = vals[:, :cfg.n_bits] < vals[:, cfg.n_bits:]
    return angle, bits


def _detect(img: torch.Tensor, cfg: ORBConfig):
    """Detection of every pyramid level: (per level (xy, score, mask), K3
    segments, one a level)."""
    levels = [img]
    for l in range(1, cfg.n_levels):
        sh = (int(round(img.shape[0] / cfg.scale_step ** l)),
              int(round(img.shape[1] / cfg.scale_step ** l)))
        levels.append(_resize_linear(img, sh))

    dets, sets = [], []
    for l, lv in enumerate(levels):
        k_level = max(cfg.capacity // (2 ** l), 128)
        xy, vals, mask, yy, xx = _detect_level(lv, cfg, k_level)
        sets.append(_patch_set(_blur(lv, cfg.blur_sigma), yy, xx, cfg))
        dets.append((xy, vals, mask))
    return dets, sets


def detect_and_describe_orb(img, cfg: ORBConfig = ORBConfig(), device=None):
    """(H, W) [0,1] grayscale -> (Keypoints, BinaryDescriptors) at capacity,
    on ``device`` (``cuda`` unless ``device="cpu"``). Keypoint xy are
    level-0 pixel coordinates; ``scale`` is the level's scale factor. One K3
    call a frame."""
    dev = resolve_device(device)
    img = torch.as_tensor(img, dtype=torch.float32).to(dev)
    dets, sets = _detect(img, cfg)
    patches = gather_patch_sets(sets)
    outs = []
    for l, (xy, vals, mask) in enumerate(dets):
        angle, bits = _orient_and_describe(patches[l], cfg)
        mult = float(cfg.scale_step ** l)
        outs.append(dict(xy=xy * mult, scale=torch.full(xy.shape[:1], mult, device=dev),
                         angle=angle, score=torch.where(mask, vals, 0.0), mask=mask,
                         bits=bits))
    cat = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    sel = torch.where(cat["mask"], cat["score"], -1.0)
    _, pick = _top_k(sel, cfg.capacity)
    mask_f = cat["mask"][pick] & (sel[pick] > 0)
    kps = Keypoints(xy=cat["xy"][pick], scale=cat["scale"][pick], angle=cat["angle"][pick],
                    score=cat["score"][pick], mask=mask_f)
    packed = pack_bits(cat["bits"][pick] & mask_f[:, None])
    return kps, BinaryDescriptors(packed=packed, mask=mask_f)
