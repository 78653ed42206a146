"""SIFT detection + description on tensors.

Port of ``fastmatch_tpu/features/sift.py``, function for function: the
separable blur is shift-and-add (not a convolution, so it stays exact f32),
DoG extrema use 3x3 max/min pooling with -inf borders, one Newton step
refines each extremum, per-octave and global selection take the top scores
with the lowest index winning ties, the orientation histogram is a one-hot
contraction, and the descriptor samples one patch per keypoint through
hat-function weight matrices. All octaves are detected first; then one call
of the K3 kernel wrapper (``kernels/patch_gather.gather_patch_sets``)
fetches every octave's orientation and descriptor patches, with the JAX
package's replicate padding folded into the gather.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from fastmatch_tpu_torch.core.containers import Descriptors, Keypoints
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.kernels.patch_gather import PatchSet, gather_patch_sets


class SIFTConfig(NamedTuple):
    n_octaves: int = 4
    scales_per_octave: int = 3       # s: DoG levels carrying extrema
    sigma0: float = 1.6              # base blur of octave level 0
    init_sigma: float = 0.5          # assumed blur of the input image
    contrast_thr: float = 0.04       # on [0,1] images (cv2 convention / 255)
    edge_thr: float = 10.0
    capacity: int = 2048             # total keypoint capacity
    ori_radius: int = 8              # orientation patch radius (pixels)
    ori_bins: int = 36
    desc_width: int = 4              # 4x4 spatial cells
    desc_bins: int = 8               # orientation bins per cell
    desc_samples: int = 16           # 16x16 sample grid


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W) image with reflect padding, as
    shift-and-add of static taps (exact f32, same op order as the JAX
    package)."""
    if sigma <= 0:
        return img
    kv = _gauss_kernel1d(sigma)
    r = (len(kv) - 1) // 2
    h, w = img.shape
    p = F.pad(img[None], (0, 0, r, r), mode="reflect")[0]
    img = sum(float(kv[i]) * p[i:i + h, :] for i in range(len(kv)))
    p = F.pad(img[None], (r, r, 0, 0), mode="reflect")[0]
    return sum(float(kv[i]) * p[:, i:i + w] for i in range(len(kv)))


def _gaussian_pyramid(img: torch.Tensor, cfg: SIFTConfig):
    """List (octaves) of stacked (L, H_o, W_o) Gaussian images, L = s + 3."""
    s = cfg.scales_per_octave
    n_levels = s + 3
    k = 2.0 ** (1.0 / s)
    sigmas = [cfg.sigma0 * (k ** l) for l in range(n_levels)]
    inc = [math.sqrt(max(sigmas[l] ** 2 - sigmas[l - 1] ** 2, 1e-8))
           for l in range(1, n_levels)]
    base = _blur(img, math.sqrt(max(cfg.sigma0 ** 2 - cfg.init_sigma ** 2, 0.01)))
    octaves = []
    cur = base
    for _ in range(cfg.n_octaves):
        levels = [cur]
        for l in range(1, n_levels):
            levels.append(_blur(levels[-1], inc[l - 1]))
        octaves.append(torch.stack(levels))
        cur = levels[s][::2, ::2]
    return octaves, sigmas


def _solve3x3(H: torch.Tensor, g: torch.Tensor):
    """Batched closed-form solve H x = -g for 3x3 H (adjugate; det-guarded)."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g2, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g2 - d * i
    E = a * i - c * g2
    Fc = c * d - a * f
    G = d * h - e * g2
    Hh = b * g2 - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    bad = det.abs() < 1e-12
    det_safe = torch.where(bad, torch.ones_like(det), det)
    x = -(A * g[..., 0] + B * g[..., 1] + C * g[..., 2]) / det_safe
    y = -(D * g[..., 0] + E * g[..., 1] + Fc * g[..., 2]) / det_safe
    z = -(G * g[..., 0] + Hh * g[..., 1] + I * g[..., 2]) / det_safe
    return torch.stack([x, y, z], dim=-1), bad


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` on a 1-D tensor: the k largest, lowest index first
    among equal values (a stable descending sort)."""
    v, i = torch.sort(x, descending=True, stable=True)
    return v[:k], i[:k]


def _detect_octave(dog: torch.Tensor, cfg: SIFTConfig, k_oct: int):
    """Extrema + refinement for one octave's (L-1, H, W) DoG stack; returns
    the top-k candidates: xy, level, offset, value, mask, (yy, xx)."""
    _, H, W = dog.shape
    s = cfg.scales_per_octave
    mx = F.max_pool2d(dog[None], 3, stride=1, padding=1)[0]
    mn = -F.max_pool2d(-dog[None], 3, stride=1, padding=1)[0]
    dev = dog.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    border = 5
    inside = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)

    def roll(x, sy, sx):
        if sy:
            x = torch.roll(x, sy, 0)
        if sx:
            x = torch.roll(x, sx, 1)
        return x

    scores, offs, vals = [], [], []
    for l in range(1, 1 + s):
        v = dog[l]
        lo, hi = dog[l - 1], dog[l + 1]
        is_max = (v >= mx[l - 1]) & (v >= mx[l + 1]) & (v == mx[l])
        is_min = (v <= mn[l - 1]) & (v <= mn[l + 1]) & (v == mn[l])
        prelim = (v.abs() > 0.5 * cfg.contrast_thr / s) & (is_max | is_min)
        dx = 0.5 * (roll(v, 0, -1) - roll(v, 0, 1))
        dy = 0.5 * (roll(v, -1, 0) - roll(v, 1, 0))
        ds = 0.5 * (hi - lo)
        dxx = roll(v, 0, -1) + roll(v, 0, 1) - 2 * v
        dyy = roll(v, -1, 0) + roll(v, 1, 0) - 2 * v
        dss = hi + lo - 2 * v
        dxy = 0.25 * (roll(v, -1, -1) - roll(v, -1, 1) - roll(v, 1, -1) + roll(v, 1, 1))
        dxs = 0.25 * (roll(hi, 0, -1) - roll(hi, 0, 1) - roll(lo, 0, -1) + roll(lo, 0, 1))
        dys = 0.25 * (roll(hi, -1, 0) - roll(hi, 1, 0) - roll(lo, -1, 0) + roll(lo, 1, 0))
        Hm = torch.stack([torch.stack([dxx, dxy, dxs], -1),
                          torch.stack([dxy, dyy, dys], -1),
                          torch.stack([dxs, dys, dss], -1)], -2)
        grad = torch.stack([dx, dy, ds], -1)
        off, bad = _solve3x3(Hm, grad)
        refined = v + 0.5 * (grad * off).sum(-1)
        tr = dxx + dyy
        det2 = dxx * dyy - dxy * dxy
        r = cfg.edge_thr
        edge_ok = (det2 > 0) & (tr * tr * r < (r + 1) ** 2 * det2)
        off_ok = (off.abs() < 1.5).all(-1)
        ok = prelim & edge_ok & off_ok & ~bad & (refined.abs() * s > cfg.contrast_thr)
        ok &= inside
        scores.append(torch.where(ok, refined.abs(), torch.full_like(v, -1.0)))
        offs.append(off)
        vals.append(refined)
    score = torch.stack(scores)
    off_all = torch.stack(offs).reshape(-1, 3)
    val_all = torch.stack(vals).reshape(-1)
    top, idx = _top_k(score.reshape(-1), k_oct)
    lvl = idx // (H * W)
    rem = idx % (H * W)
    yy = rem // W
    xx = rem % W
    off_sel = off_all[idx]
    val_sel = val_all[idx]
    mask = top > 0.0
    xy = torch.stack([xx.float() + off_sel[:, 0], yy.float() + off_sel[:, 1]], -1)
    return xy, (lvl + 1).to(torch.int32), off_sel, val_sel, mask, (yy, xx)


def _lyx(l, y, x):
    """(K,) level/row/col starts -> the (K, 3) int32 table K3 reads."""
    return torch.stack([l, y, x], dim=1).to(torch.int32).contiguous()


def _orientation_set(gauss: torch.Tensor, yx, lvl, cfg: SIFTConfig) -> PatchSet:
    """K3 segment of the orientation patches: (2R+3)^2 windows of the octave
    stack ``gauss`` (replicate-padded by R+1) around integer (y, x) at level
    ``lvl``, a one-pixel margin for the central differences."""
    R = cfg.ori_radius
    return PatchSet(gauss, _lyx(lvl, yx[0] + 1, yx[1] + 1), 2 * R + 3, R + 1)


def _orientation(img: torch.Tensor, sigma_rel, cfg: SIFTConfig):
    """Dominant orientation per keypoint from its (2R+3)^2 orientation patch
    ``img`` (``_orientation_set``)."""
    R = cfg.ori_radius
    d = torch.arange(-R, R + 1, device=img.device, dtype=torch.float32)
    oy, ox = torch.meshgrid(d, d, indexing="ij")
    gx = 0.5 * (img[:, 1:-1, 2:] - img[:, 1:-1, :-2])
    gy = 0.5 * (img[:, 2:, 1:-1] - img[:, :-2, 1:-1])
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)
    w_sig = (1.5 * sigma_rel)[:, None, None]
    w = torch.exp(-(ox ** 2 + oy ** 2) / (2.0 * w_sig * w_sig))
    nb = cfg.ori_bins
    binf = (ang + math.pi) / (2 * math.pi) * nb
    b0 = binf.to(torch.int32).clamp(0, nb - 1)
    K = img.shape[0]
    onehot = F.one_hot(b0.reshape(K, -1).long(), nb).float()
    hist = torch.einsum("kp,kpb->kb", (w * mag).reshape(K, -1), onehot)
    for _ in range(2):
        hist = (6 * hist
                + 4 * (torch.roll(hist, 1, -1) + torch.roll(hist, -1, -1))
                + (torch.roll(hist, 2, -1) + torch.roll(hist, -2, -1))) / 16.0
    pk = torch.argmax(hist, dim=-1)

    def at(i):
        return torch.gather(hist, 1, (i % nb)[:, None])[:, 0]

    l_, c_, r_ = at(pk - 1), at(pk), at(pk + 1)
    denom = l_ - 2 * c_ + r_
    tiny = denom.abs() < 1e-9
    interp = torch.where(tiny, torch.zeros_like(denom),
                         0.5 * (l_ - r_) / torch.where(tiny, torch.ones_like(denom), denom))
    bin_pos = (pk.float() + interp) % nb
    return bin_pos / nb * 2 * math.pi - math.pi


def _descriptor_weights(cfg: SIFTConfig) -> np.ndarray:
    """Static 16->4 trilinear cell weights per sample index."""
    n, d = cfg.desc_samples, cfg.desc_width
    coords = (np.arange(n) + 0.5) * d / n - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(coords[:, None] - np.arange(d)[None, :]))
    return w.astype(np.float32)


_DESC_PAD = 2  # replicate padding of the descriptor patches' stack


def _descriptor_set(gauss: torch.Tensor, xy, lvl, cfg: SIFTConfig):
    """K3 segment of the descriptor patches (one a keypoint, sized to the
    worst-case support, of the octave stack replicate-padded by 2) and the
    padded (row, col) starts (oys, oxs) that the descriptor reads them by."""
    _, H, W = gauss.shape
    pad = _DESC_PAD
    Hp, Wp = H + 2 * pad, W + 2 * pad
    smax = cfg.sigma0 * 2.0 ** ((cfg.scales_per_octave + 1.5) / cfg.scales_per_octave)
    support = 3.0 * smax * (cfg.desc_width / 2.0) * math.sqrt(2.0) + 2.0
    P = int(math.ceil(2.0 * support)) + 4
    P = min(P + (-P) % 8, Hp, Wp)
    oxs = (torch.round(xy[:, 0]).to(torch.int32) + pad - P // 2).clamp(0, Wp - P)
    oys = (torch.round(xy[:, 1]).to(torch.int32) + pad - P // 2).clamp(0, Hp - P)
    return PatchSet(gauss, _lyx(lvl, oys, oxs), P, pad), (oys, oxs)


def _descriptors(patch, shape, xy, starts, angle, sigma_rel, cfg: SIFTConfig):
    """128-d descriptors from each keypoint's descriptor patch ``patch``
    (``_descriptor_set``, padded starts ``starts``) of an octave of
    (H, W) ``shape``; xy in octave pixel coords (subpixel). Bilinear samples
    as hat-function weight matrices (see the JAX package for the
    derivation)."""
    H, W = shape
    dev = patch.device
    n = cfg.desc_samples
    pad = _DESC_PAD
    P = patch.shape[-1]
    oys, oxs = starts

    u = (np.arange(n) + 0.5) * cfg.desc_width / n - cfg.desc_width / 2
    uu_np, vv_np = np.meshgrid(u, u, indexing="ij")
    uu = torch.as_tensor(uu_np.astype(np.float32), device=dev)
    vv = torch.as_tensor(vv_np.astype(np.float32), device=dev)
    wgauss = torch.exp(-(uu ** 2 + vv ** 2) / (2 * (0.5 * cfg.desc_width) ** 2))
    w_spatial = torch.as_tensor(_descriptor_weights(cfg), device=dev)

    pr = torch.arange(P, device=dev, dtype=torch.float32)

    K = xy.shape[0]
    hw = (3.0 * sigma_rel)[:, None, None]
    ct = torch.cos(angle)[:, None, None]
    st = torch.sin(angle)[:, None, None]
    sx = xy[:, 0, None, None] + (ct * vv - st * uu) * hw
    sy = xy[:, 1, None, None] + (st * vv + ct * uu) * hw
    sxc = torch.clamp(sx, 0.0, W - 1.0) + pad
    syc = torch.clamp(sy, 0.0, H - 1.0) + pad
    sxr = torch.clamp((sxc - oxs[:, None, None]).reshape(K, -1), 0.5, P - 1.5)
    syr = torch.clamp((syc - oys[:, None, None]).reshape(K, -1), 0.5, P - 1.5)

    def wmat(c):
        return torch.clamp(1.0 - (c[..., None] - pr).abs(), min=0.0)

    ty = wmat(syr) @ patch
    gx = (ty * (wmat(sxr + 0.5) - wmat(sxr - 0.5))).sum(-1)
    tdy = (wmat(syr + 0.5) - wmat(syr - 0.5)) @ patch
    gy = (tdy * wmat(sxr)).sum(-1)
    gx = gx.reshape(K, n, n)
    gy = gy.reshape(K, n, n)
    mag = torch.sqrt(gx * gx + gy * gy) * wgauss
    ang = torch.atan2(gy, gx) - angle[:, None, None]
    nb = cfg.desc_bins
    binf = (ang / (2 * math.pi)) * nb
    binf = torch.remainder(binf, nb)
    fl = torch.floor(binf)
    b0 = fl.long() % nb
    fb = binf - fl
    ob = (F.one_hot(b0, nb).float() * (1 - fb)[..., None]
          + F.one_hot((b0 + 1) % nb, nb).float() * fb[..., None])
    contrib = mag[..., None] * ob
    desc = torch.einsum("ic,jd,kijb->kcdb", w_spatial, w_spatial, contrib)
    v = desc.reshape(K, -1)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    v = torch.clamp(v, max=0.2)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    return v


class _Octave(NamedTuple):
    """One octave's detections, as the description stage reads them."""
    shape: tuple
    xy: torch.Tensor
    val: torch.Tensor
    mask: torch.Tensor
    sigma_rel: torch.Tensor
    desc_starts: tuple


def _detect(img: torch.Tensor, cfg: SIFTConfig):
    """Detection of every octave: (octaves, K3 segments). The segments are
    every octave's orientation set, then every octave's descriptor set."""
    pyramid, _ = _gaussian_pyramid(img, cfg)
    s = cfg.scales_per_octave
    k_per = [max(cfg.capacity // (2 ** o), 128) for o in range(cfg.n_octaves)]
    octaves, ori_sets, desc_sets = [], [], []
    for o, gauss in enumerate(pyramid):
        dog = gauss[1:] - gauss[:-1]
        xy, lvl, off, val, mask, yx = _detect_octave(dog, cfg, k_per[o])
        sigma_rel = cfg.sigma0 * torch.exp2((lvl.float() + off[:, 2]) / s)
        desc_set, starts = _descriptor_set(gauss, xy, lvl, cfg)
        ori_sets.append(_orientation_set(gauss, yx, lvl, cfg))
        desc_sets.append(desc_set)
        octaves.append(_Octave(tuple(gauss.shape[1:]), xy, val, mask, sigma_rel, starts))
    return octaves, ori_sets + desc_sets


def detect_and_describe(img, cfg: SIFTConfig = SIFTConfig(), device=None):
    """(H, W) [0,1] grayscale -> (Keypoints, Descriptors) at cfg.capacity on
    ``device`` (``cuda`` unless ``device="cpu"``). One K3 call a frame."""
    dev = resolve_device(device)
    img = torch.as_tensor(img, dtype=torch.float32).to(dev)
    octaves, sets = _detect(img, cfg)
    patches = gather_patch_sets(sets)
    n = len(octaves)
    outs = []
    for o, oc in enumerate(octaves):
        angle = _orientation(patches[o], oc.sigma_rel, cfg)
        desc = _descriptors(patches[n + o], oc.shape, oc.xy, oc.desc_starts, angle,
                            oc.sigma_rel, cfg)
        scale_mult = float(2 ** o)
        outs.append(dict(xy=oc.xy * scale_mult, scale=oc.sigma_rel * scale_mult,
                         angle=angle, score=torch.where(oc.mask, oc.val, 0.0),
                         mask=oc.mask, desc=desc))
    cat = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    sel_score = torch.where(cat["mask"], cat["score"].abs(), -1.0)
    _, pick = _top_k(sel_score, cfg.capacity)
    mask_f = cat["mask"][pick] & (sel_score[pick] > 0)
    kps = Keypoints(xy=cat["xy"][pick], scale=cat["scale"][pick],
                    angle=cat["angle"][pick], score=cat["score"][pick], mask=mask_f)
    descs = Descriptors(data=torch.where(mask_f[:, None], cat["desc"][pick], 0.0),
                        mask=mask_f)
    return kps, descs
