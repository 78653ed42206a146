"""Dense rectified-stereo depth on tensors: a shift-sweep ZNCC matcher.

Port of ``fastmatch_tpu/dense/stereo.py``. For a rectified pair the search
is 1-D along scan lines, so the right image warped by disparity d is
``torch.roll(right, d, 1)``; window sums are two cumulative-sum differences
a plane; the cost is zero-mean normalized cross-correlation from five box
moments; the winner is kept in a streamed winner-take-all over the D
hypotheses (eight (H, W) planes live, never the (D, H, W) volume), refined
by a parabola through its neighbours, and checked left-right from the same
winners. The JAX package's three ``fori_loop``s over disparities are
Python loops over (H, W) planes here; none reads back to the host.

``rectify_pair`` brings a calibrated two-view pair into this geometry
(Fusiello's rectification) with one float32 homography warp and a 4-tap
bilinear resample per image, written out as in the JAX package. The window
sums are fixed-order adds and the ZNCC divides by a correctly rounded square
root, so the card and the CPU give the same disparities.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from fastmatch_tpu_torch.core.device import as_f32


class StereoConfig(NamedTuple):
    max_disp: int = 64         # disparity hypotheses [0, max_disp)
    win: int = 9               # odd aggregation window side
    lr_tol: float = 1.25       # left-right consistency tolerance, px
    min_zncc: float = 0.5      # cost gate: best ZNCC must exceed this
    min_std: float = 0.01      # window contrast gate: textureless windows
                               # give 0/0 ZNCC noise, not low scores
    uniq: float = 1.02         # uniqueness: 2nd best cost >= uniq * best
                               # (2nd best taken outside +-1 of the winner)


def _box(x: torch.Tensor, win: int) -> torch.Tensor:
    """(..., H, W) -> same-shape (win, win) box SUM (edge-truncated), as
    ``win`` shifted adds an axis in a fixed order. The JAX package takes two
    float32 prefix-sum differences, which lose ~1e-5 of a window's sum to
    cancellation in a pattern set by the device's scan order; fixed-order
    adds round alike on the card and the CPU, and the subpixel parabola
    would amplify any difference ~1000x."""
    r = win // 2
    for dim in (-2, -1):
        n = x.shape[dim]
        p = F.pad(x, (0, 0, r, r) if dim == -2 else (r, r))
        acc = p.narrow(dim, 0, n)
        for i in range(1, win):
            acc = acc + p.narrow(dim, i, n)
        x = acc
    return x


def stereo_disparity(left, right, cfg: StereoConfig = StereoConfig(), device=None):
    """(H, W) rectified grayscale pair -> (disp (H, W) f32, valid (H, W))
    on ``device``.

    Disparity convention: left pixel (y, x) matches right pixel (y, x - d),
    d in [0, cfg.max_disp). Invalid pixels (failed cost, uniqueness or LR
    gates, or a d-range leaving the image) report disp 0."""
    L, R = as_f32(left, device), as_f32(right, device)
    dev = L.device
    H, W = L.shape
    win, D = cfg.win, cfg.max_disp
    # Products with 1/n, not divisions by n: PyTorch divides a CUDA tensor by
    # a host scalar as a product with its reciprocal, so this rounds alike
    # on the card and the CPU.
    inv_n = 1.0 / (win * win)

    # Left moments are shared by every hypothesis, and the right image's
    # are computed once: box(roll(R, d)) == roll(box(R), d) wherever the
    # window does not straddle the wrap seam, and every such column is
    # masked by the range gate.
    sL = _box(L, win)
    sLL = _box(L * L, win)
    varL = torch.clamp(sLL - sL * sL * inv_n, min=1e-8)
    sR0 = _box(R, win)
    varR0 = torch.clamp(_box(R * R, win) - sR0 * sR0 * inv_n, min=1e-8)
    xs = torch.arange(W, device=dev)[None, :]
    neg = torch.full((H, W), -2.0, device=dev)
    zero = torch.zeros((H, W), dtype=torch.int32, device=dev)

    def cost_at(d):
        """ZNCC of L against R shifted right by d, -2 out of range."""
        Rd = torch.roll(R, d, 1)
        sR = torch.roll(sR0, d, 1)
        varR = torch.roll(varR0, d, 1)
        cov = _box(L * Rd, win) - sL * sR * inv_n
        # 1 / sqrt, not rsqrt: CUDA's rsqrtf is within 2 ulp, sqrt and the
        # division are correctly rounded on both devices, so the card and
        # the CPU pick the same winner where two hypotheses nearly tie.
        zncc = cov / torch.sqrt(varL * varR)
        return torch.where(xs >= d + win // 2, zncc, neg)

    # Streamed winner-take-all: best, second best outside the winner's +-1,
    # and the costs at the winner's two neighbours (the parabola).
    b1, d1, b2, prevc, cm1, cp1 = neg, zero, neg, neg, neg, neg
    for d in range(D):
        z = cost_at(d)
        better = z > b1
        b2 = torch.where(better, torch.where((d1 - d).abs() > 1, b1, b2),
                         torch.where((z > b2) & ((d - d1).abs() > 1), z, b2))
        cm1 = torch.where(better, prevc, cm1)
        cp1 = torch.where(d1 == d - 1, z, cp1)
        b1 = torch.where(better, z, b1)
        d1 = torch.where(better, torch.full_like(d1, d), d1)
        prevc = z

    # Subpixel: parabola through (cm1, b1, cp1); clamp at the range ends.
    denom = cm1 - 2.0 * b1 + cp1
    big = denom.abs() > 1e-9
    off = torch.where(big, 0.5 * (cm1 - cp1) / torch.where(big, denom, torch.ones_like(denom)),
                      torch.zeros_like(denom))
    off = torch.clamp(off, -0.5, 0.5)
    interior = (d1 > 0) & (d1 < D - 1)
    disp = d1.float() + torch.where(interior, off, torch.zeros_like(off))

    # Right-referenced winners from the same costs: right pixel x matches
    # left x + d, so rolling the left winner plane by -d aligns its claims.
    rb1, rd1 = neg, zero
    for d in range(D):
        claims = torch.roll(torch.where(d1 == d, b1, neg), -d, 1)
        claims = torch.where(xs < W - d, claims, neg)
        better = claims > rb1
        rb1 = torch.where(better, claims, rb1)
        rd1 = torch.where(better, torch.full_like(rd1, d), rd1)
    # LR check: right (y, x - d1) must claim d1 back (a one-hot select over d).
    rd_at = zero
    for d in range(D):
        rd_at = torch.where(d1 == d, torch.roll(rd1, d, 1), rd_at)
    lr_ok = (rd_at - d1).abs() <= cfg.lr_tol

    valid = (b1 > cfg.min_zncc) & ((b2 < -1.5) | (b2 <= b1 / cfg.uniq))
    valid = valid & (varL * inv_n > cfg.min_std ** 2)
    valid = valid & lr_ok & (xs >= disp + win // 2)
    border = win // 2
    yy = torch.arange(H, device=dev)[:, None]
    valid = valid & (yy >= border) & (yy < H - border) & (xs < W - border)
    return torch.where(valid, disp, torch.zeros_like(disp)), valid


def stereo_batch(left, right, cfg: StereoConfig = StereoConfig(), device=None):
    """(B, H, W) pairs -> ((B, H, W) disp, (B, H, W) valid), one sweep a
    pair (the JAX package's vmap)."""
    L, R = as_f32(left, device), as_f32(right, device)
    outs = [stereo_disparity(l, r, cfg, L.device) for l, r in zip(L, R)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def depth_from_disparity(disp, valid, fx: float, baseline: float):
    """disp (H, W) px -> depth (H, W) along the rectified z axis."""
    disp = torch.as_tensor(disp)
    valid = torch.as_tensor(valid).to(disp.device)
    ok = valid & (disp > 1e-3)
    return torch.where(ok, fx * baseline / torch.clamp(disp, min=1e-3), torch.zeros_like(disp))


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def disparity_to_points(disp, valid, K: np.ndarray, baseline: float,
                        image: np.ndarray | None = None,
                        stride: int = 2, max_depth: float = np.inf):
    """Disparity map -> (N, 3) points (+ (N,) intensities) in the rectified
    left-camera frame, subsampled by ``stride`` (host-side numpy, for
    ``utils/export.save_ply``)."""
    disp = _np(disp)[::stride, ::stride]
    valid = _np(valid)[::stride, ::stride]
    H, W = disp.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    z = np.where(valid & (disp > 1e-3), fx * baseline / np.maximum(disp, 1e-3), 0.0)
    keep = valid & (z > 0) & (z < max_depth)
    ys, xs = np.mgrid[0:H, 0:W]
    xs = xs * stride
    ys = ys * stride
    pts = np.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z], -1)[keep]
    if image is None:
        return pts, None
    inten = _np(image)[::stride, ::stride][keep]
    return pts, inten


def _warp(img: torch.Tensor, Hmat: np.ndarray) -> torch.Tensor:
    """Resample ``img`` through the inverse of homography ``Hmat``: a
    float32 einsum of the pixel grid, then bilinear weights on the four
    clamped neighbours; pixels mapped from outside the image are 0."""
    H_, W_ = img.shape
    dev = img.device
    yy, xx = torch.meshgrid(torch.arange(H_, device=dev), torch.arange(W_, device=dev),
                            indexing="ij")
    Hinv = np.linalg.inv(Hmat).astype(np.float32)
    xf, yf = xx.float(), yy.float()
    # The float32 product Hinv @ (x, y, 1) written out term by term in the
    # order of a dot product, so the card and the CPU round alike.
    src = [(float(Hinv[i, 0]) * xf + float(Hinv[i, 1]) * yf) + float(Hinv[i, 2])
           for i in range(3)]
    sx = src[0] / src[2]
    sy = src[1] / src[2]
    x0 = torch.clamp(torch.floor(sx).to(torch.int32), 0, W_ - 2).long()
    y0 = torch.clamp(torch.floor(sy).to(torch.int32), 0, H_ - 2).long()
    fx_ = torch.clamp(sx - x0, 0.0, 1.0)
    fy_ = torch.clamp(sy - y0, 0.0, 1.0)

    def g(yo, xo):
        return img[y0 + yo, x0 + xo]

    out = ((1 - fy_) * ((1 - fx_) * g(0, 0) + fx_ * g(0, 1))
           + fy_ * ((1 - fx_) * g(1, 0) + fx_ * g(1, 1)))
    inside = (sx >= 0) & (sx <= W_ - 1) & (sy >= 0) & (sy <= H_ - 1)
    return torch.where(inside, out, torch.zeros_like(out))


def rectify_pair(img_a, img_b, K: np.ndarray, R_ab: np.ndarray, t_ab: np.ndarray,
                 device=None):
    """Calibrated two-view pair -> rectified pair + rectification metadata,
    on ``device``.

    (R_ab, t_ab): pose of camera b relative to a (x_b = R_ab x_a + t_ab).
    Returns (rect_a, rect_b, info) with info = dict(K_rect, R_rect_a,
    baseline): both images resampled so epipolar lines are horizontal and
    ``stereo_disparity(rect_a, rect_b)`` applies. The new x axis points
    along the baseline toward camera b, which makes a the left camera.

    Raises ValueError on a zero baseline and when the baseline is (near-)
    parallel to camera a's optical axis: forward motion puts the epipole
    inside the image and no rectifying rotation exists. ``densify`` skips
    such a pair."""
    K = np.asarray(K, np.float64)
    R_ab = np.asarray(R_ab, np.float64)
    t_ab = np.asarray(t_ab, np.float64)
    c_b = -R_ab.T @ t_ab
    baseline = float(np.linalg.norm(c_b))
    if baseline < 1e-9:
        raise ValueError("rectification needs a nonzero baseline")
    ex = c_b / baseline
    ez0 = np.array([0.0, 0.0, 1.0])
    if abs(float(ex @ ez0)) > 0.99:
        raise ValueError(
            "rectification is degenerate: baseline is (near-)parallel to "
            f"the optical axis (|ex.ez| = {abs(float(ex @ ez0)):.3f} > 0.99); "
            "forward-motion pairs cannot be rectified into a horizontal-"
            "disparity stereo pair")
    ey = np.cross(ez0, ex)
    ey /= np.linalg.norm(ey)
    ez = np.cross(ex, ey)
    R_rect = np.stack([ex, ey, ez])          # world(a) -> rectified
    Ha = K @ R_rect @ np.linalg.inv(K)
    Hb = K @ R_rect @ R_ab.T @ np.linalg.inv(K)
    rect_a = _warp(as_f32(img_a, device), Ha)
    rect_b = _warp(as_f32(img_b, device), Hb)
    return rect_a, rect_b, dict(K_rect=K, R_rect_a=R_rect, baseline=baseline)
