"""Image-pair datasets with ground-truth correspondence, trajectory ground
truth, and the match-evaluation harness.

Port of ``fastmatch_tpu/datasets.py`` (the parts that need no data):

- ``load_vgg_dataset``: an Oxford-VGG affine-covariant sequence directory
  (``img1..imgN`` + ``H1toKp`` homographies); images decode through the
  port's native loader (``utils/imageio.py``);
- ``synthesize_warped_pair``: a random texture and a homography-warped
  second view in numpy, exact ground truth without files;
- ``load_tum_trajectory``: TUM ``ts tx ty tz qx qy qz qw`` files;
- ``evaluate_pairs``: detect -> match -> precision/recall per pair on
  ``device`` (``cuda`` unless ``device="cpu"``), and the aggregate.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ImagePair:
    """Two images and the ground-truth homography mapping pixel
    coordinates of ``a`` into ``b`` (3x3)."""

    name: str
    image_a: str | np.ndarray
    image_b: str | np.ndarray
    H_ab: np.ndarray


def _resize_np(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Separable bilinear resize with the native ``fm_resize_bilinear``'s
    centre-aligned sampling and edge clamping."""
    sh, sw = img.shape
    ys = np.clip((np.arange(h) + 0.5) * sh / h - 0.5, 0, sh - 1)
    xs = np.clip((np.arange(w) + 0.5) * sw / w - 0.5, 0, sw - 1)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, sh - 2)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, sw - 2)
    fy = (ys - y0).astype(np.float32)[:, None]
    fx = (xs - x0).astype(np.float32)[None, :]
    r0 = img[y0][:, x0] * (1 - fx) + img[y0][:, x0 + 1] * fx
    r1 = img[y0 + 1][:, x0] * (1 - fx) + img[y0 + 1][:, x0 + 1] * fx
    return (r0 * (1 - fy) + r1 * fy).astype(np.float32)


def _gray(img: str | np.ndarray, size=None) -> np.ndarray:
    """(H, W) float32 grayscale, resized to ``size`` ((w, h)) when given."""
    if isinstance(img, np.ndarray):
        img = img.astype(np.float32)
        if size is not None and (img.shape[1], img.shape[0]) != size:
            return _resize_np(img, *size)
        return img
    from fastmatch_tpu_torch.utils.imageio import load_gray

    return load_gray(img, size=size)


def load_vgg_dataset(root: str) -> list[ImagePair]:
    """The pairs (img1 -> imgK) of an Oxford-VGG style directory:
    ``img1.<ext>`` .. ``imgN.<ext>`` and plain-text 3x3 homographies
    ``H1to2p`` .. ``H1toNp``."""
    imgs = {}
    for p in glob.glob(os.path.join(root, "img*.*")):
        m = re.match(r"img(\d+)\.\w+$", os.path.basename(p))
        if m:
            imgs[int(m.group(1))] = p
    pairs = []
    for hp in sorted(glob.glob(os.path.join(root, "H1to*p"))):
        m = re.match(r"H1to(\d+)p$", os.path.basename(hp))
        if not m:
            continue
        k = int(m.group(1))
        if 1 not in imgs or k not in imgs:
            continue
        H = np.loadtxt(hp, dtype=np.float64).reshape(3, 3)
        pairs.append(ImagePair(name=f"{os.path.basename(os.path.normpath(root))}:1to{k}",
                               image_a=imgs[1], image_b=imgs[k], H_ab=H.astype(np.float32)))
    if not pairs:
        raise FileNotFoundError(f"no img*/H1to*p files under {root}")
    return pairs


def render_texture(rng: np.random.Generator, h: int = 256, w: int = 256,
                   n_blobs: int = 160) -> np.ndarray:
    """Random smooth texture in [0, 1]: anisotropic Gaussian blobs over a
    gradient background."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.15 + 0.2 * (xx / w) + 0.1 * (yy / h)
    cx = rng.uniform(8, w - 8, n_blobs)
    cy = rng.uniform(8, h - 8, n_blobs)
    s = rng.uniform(1.5, 6.0, n_blobs)
    amp = rng.uniform(-0.6, 0.8, n_blobs)
    for i in range(n_blobs):
        d2 = (xx - cx[i]) ** 2 + (yy - cy[i]) ** 2
        img += amp[i] * np.exp(-d2 / (2 * s[i] ** 2))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def random_homography(rng: np.random.Generator, h: int, w: int, max_rot: float = 0.25,
                      max_persp: float = 1.5e-4, scale_range=(0.85, 1.15)) -> np.ndarray:
    """Random in-frame homography about the image centre."""
    cx, cy = w / 2.0, h / 2.0
    th = rng.uniform(-max_rot, max_rot)
    sc = rng.uniform(*scale_range)
    tx, ty = rng.uniform(-0.05, 0.05, 2) * (w, h)
    C = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
    R = np.array([[sc * np.cos(th), -sc * np.sin(th), tx],
                  [sc * np.sin(th), sc * np.cos(th), ty],
                  [rng.uniform(-max_persp, max_persp), rng.uniform(-max_persp, max_persp), 1.0]])
    return (np.linalg.inv(C) @ R @ C).astype(np.float32)


def warp_image(img: np.ndarray, H_ab: np.ndarray) -> np.ndarray:
    """View a warped into view b by bilinear sampling: output (x, y)
    samples ``a`` at H_ab^-1 (x, y); outside the frame is 0."""
    h, w = img.shape
    Hinv = np.linalg.inv(H_ab.astype(np.float64))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    p = Hinv @ np.stack([xx, yy, np.ones_like(xx)], 0).reshape(3, -1)
    sx = (p[0] / p[2]).reshape(h, w)
    sy = (p[1] / p[2]).reshape(h, w)
    valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    x0c = np.clip(np.floor(sx).astype(np.int64), 0, w - 2)
    y0c = np.clip(np.floor(sy).astype(np.int64), 0, h - 2)
    fx, fy = sx - x0c, sy - y0c
    out = (img[y0c, x0c] * (1 - fy) * (1 - fx) + img[y0c, x0c + 1] * (1 - fy) * fx
           + img[y0c + 1, x0c] * fy * (1 - fx) + img[y0c + 1, x0c + 1] * fy * fx)
    return np.where(valid, out, 0.0).astype(np.float32)


def synthesize_warped_pair(seed: int = 0, h: int = 256, w: int = 256) -> ImagePair:
    """A self-contained evaluation pair: random texture, random homography."""
    rng = np.random.default_rng(seed)
    a = render_texture(rng, h, w)
    H = random_homography(rng, h, w)
    return ImagePair(name=f"synth-{seed}", image_a=a, image_b=warp_image(a, H), H_ab=H)


def load_tum_trajectory(path: str):
    """(timestamps (N,), centres (N, 3) f32, quaternions (N, 4) xyzw f32)
    of a TUM-format file (``#`` comments)."""
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) != 8:
                raise ValueError(f"expected 8 columns in TUM file, got {len(vals)}")
            rows.append(vals)
    arr = np.asarray(rows, np.float64)
    return arr[:, 0], arr[:, 1:4].astype(np.float32), arr[:, 4:8].astype(np.float32)


def evaluate_pairs(pairs, sift_cfg=None, ratio: float = 0.8, tol: float = 3.0,
                   backend: str = "auto", size=None, plot_dir=None, device=None):
    """detect -> match -> precision/recall over image pairs on ``device``.
    Returns (per-pair dicts, aggregate dict); pairs with no prediction (NaN
    precision) or no ground truth (NaN recall) are left out of the means
    and counted apart. ``plot_dir``: also write each pair's side-by-side
    match figure (lines coloured by ground-truth correctness) and a
    precision/recall bar chart, ``summary.png``, there (utils/viz.py)."""
    import torch

    from fastmatch_tpu_torch.core.device import resolve_device
    from fastmatch_tpu_torch.features.sift import SIFTConfig, detect_and_describe
    from fastmatch_tpu_torch.matching.matcher import match_pair
    from fastmatch_tpu_torch.utils.evaluation import match_precision_recall

    dev = resolve_device(device)
    cfg = sift_cfg or SIFTConfig()
    results = []
    for pair in pairs:
        ia0 = _gray(pair.image_a)
        ib0 = _gray(pair.image_b)
        ia = _gray(ia0, size) if size is not None else ia0
        ib = _gray(ib0, size) if size is not None else ib0
        H_ab = np.asarray(pair.H_ab, np.float64)
        if size is not None:
            # H maps original-resolution pixels: H' = S_b H S_a^-1.
            w, h = size
            Sa = np.diag([w / ia0.shape[1], h / ia0.shape[0], 1.0])
            Sb = np.diag([w / ib0.shape[1], h / ib0.shape[0], 1.0])
            H_ab = Sb @ H_ab @ np.linalg.inv(Sa)
        kpa, da = detect_and_describe(torch.from_numpy(ia), cfg, device=dev)
        kpb, db = detect_and_describe(torch.from_numpy(ib), cfg, device=dev)
        m = match_pair(da, db, ratio=ratio, backend=backend, device=dev)
        ev = match_precision_recall(kpa.xy, kpa.mask, kpb.xy, kpb.mask, m.idx, m.valid,
                                    torch.from_numpy(H_ab.astype(np.float32)).to(dev),
                                    tol=tol)
        if plot_dir is not None:
            import os

            from fastmatch_tpu_torch.utils.viz import draw_matches

            os.makedirs(plot_dir, exist_ok=True)
            safe = str(pair.name).replace("/", "_").replace(" ", "_")
            draw_matches(ia, kpa.xy.cpu().numpy(), ib, kpb.xy.cpu().numpy(),
                         m.idx.cpu().numpy(), m.valid.cpu().numpy(),
                         os.path.join(plot_dir, f"{safe}.png"), H_ab=H_ab, tol=tol)
        results.append({"pair": pair.name, "precision": float(ev.precision),
                        "recall": float(ev.recall), "n_correct": int(ev.n_correct),
                        "n_predicted": int(ev.n_predicted), "n_gt": int(ev.n_gt)})
    prec = [r["precision"] for r in results if not np.isnan(r["precision"])]
    rec = [r["recall"] for r in results if not np.isnan(r["recall"])]
    agg = {
        "pairs": len(results),
        "pairs_no_prediction": sum(1 for r in results if np.isnan(r["precision"])),
        "pairs_no_gt": sum(1 for r in results if np.isnan(r["recall"])),
        "mean_precision": float(np.mean(prec)) if prec else float("nan"),
        "mean_recall": float(np.mean(rec)) if rec else float("nan"),
        "n_correct": int(sum(r["n_correct"] for r in results)),
        "n_predicted": int(sum(r["n_predicted"] for r in results)),
        "n_gt": int(sum(r["n_gt"] for r in results)),
    }
    if plot_dir is not None and results:
        import os

        from fastmatch_tpu_torch.utils.viz import plot_match_stats

        plot_match_stats(results, os.path.join(plot_dir, "summary.png"))
    return results, agg
