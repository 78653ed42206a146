"""Dense mapping over a sparse reconstruction: rectify and stereo-sweep
selected frame pairs, fuse the depth maps into one world-frame cloud.

Port of ``fastmatch_tpu/dense/densify.py``. Any engine's output (the
``Reconstruction`` of reconstruct, vo or slam) plus its images gives a
dense cloud: pairs are picked by their baseline over the sparse map's
median depth, each pair goes through ``rectify_pair`` and
``stereo_disparity`` on the device, and the host fuses the points on a
voxel grid. A pair that cannot be rectified (forward motion) is skipped.
"""

from __future__ import annotations

import numpy as np

from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.dense.stereo import (StereoConfig, disparity_to_points,
                                              rectify_pair, stereo_disparity)


def select_pairs(R: np.ndarray, t: np.ndarray, median_depth: float,
                 max_step: int = 4, min_ratio: float = 0.02,
                 max_ratio: float = 0.35):
    """Frame pairs (i, j) whose baseline/median-depth ratio suits stereo.

    Greedy: for each i, the smallest step j = i+1..i+max_step whose ratio
    clears min_ratio (and stays under max_ratio) wins; frames with no
    usable partner contribute nothing (rotation-only spans)."""
    F = R.shape[0]
    C = -np.einsum("fji,fj->fi", R, t)
    pairs = []
    for i in range(F - 1):
        for j in range(i + 1, min(i + 1 + max_step, F)):
            ratio = np.linalg.norm(C[j] - C[i]) / max(median_depth, 1e-9)
            if ratio >= min_ratio:
                if ratio <= max_ratio:
                    pairs.append((i, j))
                break
    return pairs


def densify(images, R: np.ndarray, t: np.ndarray, K: np.ndarray,
            sparse_points: np.ndarray | None = None,
            pairs: list | None = None,
            cfg: StereoConfig = StereoConfig(),
            stride: int = 2, voxel: float | None = None,
            max_depth_factor: float = 4.0, device=None):
    """images: (F, H, W) [0,1] grayscale (indexable); R/t: (F, 3, 3)/(F, 3)
    world->camera; K: (3, 3). Each pair's sweep runs on ``device``. Returns
    (points (N, 3) world, intensity (N,), report dict).

    ``voxel``: fusion grid size in world units (default: median scene
    depth / 200). ``max_depth_factor``: drop stereo depths beyond this
    multiple of the median sparse depth (distant low-parallax noise)."""
    dev = resolve_device(device)
    R = np.asarray(R)
    t = np.asarray(t)
    F = R.shape[0]
    if sparse_points is not None and len(sparse_points):
        # Median depth of the sparse map over all cameras that see it.
        z = []
        for f in range(F):
            zf = (np.asarray(sparse_points) @ R[f].T + t[f])[:, 2]
            z.append(zf[zf > 0])
        med_depth = float(np.median(np.concatenate(z))) if z else 1.0
    else:
        med_depth = 1.0
    if pairs is None:
        pairs = select_pairs(R, t, med_depth)
    if voxel is None:
        voxel = med_depth / 200.0

    all_pts, all_int = [], []
    used = 0
    for i, j in pairs:
        R_ab = R[j] @ R[i].T
        t_ab = t[j] - R_ab @ t[i]
        try:
            ra, rb, info = rectify_pair(images[i], images[j], K, R_ab, t_ab, device=dev)
        except ValueError:
            continue
        disp, valid = stereo_disparity(ra, rb, cfg, device=dev)
        pts_r, inten = disparity_to_points(
            disp, valid, K, info["baseline"], image=ra,
            stride=stride, max_depth=max_depth_factor * med_depth)
        if len(pts_r) == 0:
            continue
        # rectified-a frame -> camera-a frame -> world
        pts_a = pts_r @ info["R_rect_a"]
        pts_w = (pts_a - t[i]) @ R[i]
        all_pts.append(pts_w)
        all_int.append(inten)
        used += 1
    if not all_pts:
        return (np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
                dict(pairs_used=0, pairs_considered=len(pairs)))
    pts = np.concatenate(all_pts).astype(np.float32)
    inten = np.concatenate(all_int).astype(np.float32)
    # Voxel fusion: one representative point per occupied cell.
    if voxel > 0:
        cells = np.round(pts / voxel).astype(np.int64)
        _, keep = np.unique(cells, axis=0, return_index=True)
        pts, inten = pts[keep], inten[keep]
    return pts, inten, dict(pairs_used=used, pairs_considered=len(pairs),
                            n_points=int(len(pts)), voxel=voxel,
                            median_depth=med_depth)
