"""Localization against a prebuilt map (kidnapped-robot relocalization).

Port of ``fastmatch_tpu/pipeline/localize.py``. A saved map's landmark
descriptor bank is indexed once and queried many times: above
``ANN_CROSSOVER_ROWS`` rows through a cluster-sorted IVF index
(``matching/ann.build_index_sorted``), below it by the exact matcher.
Both searches end in K2 on the card: the exact one over the whole bank,
the IVF one over its compact ``budget``-row bank.

Flow: query descriptors -> nearest-landmark match (IVF or exact) -> RANSAC
PnP on the matched 3D points -> camera pose. CLI: ``locate <map dir>
<features>``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fastmatch_tpu_torch.core.camera import normalize_np
from fastmatch_tpu_torch.core.containers import Descriptors
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.geometry.pnp import ransac_pnp
from fastmatch_tpu_torch.matching.ann import IVFIndexSorted, build_index_sorted, match_pair_ann_big
from fastmatch_tpu_torch.matching.matcher import match_pair

# The JAX package's crossover (measured on its TPU, docs/PERFORMANCE.md
# "ANN"): banks of at least this many rows get the IVF index. Kept as the
# default rule so that both packages index a map alike.
ANN_CROSSOVER_ROWS = 100_000


class MapIndex(NamedTuple):
    """Queryable snapshot of a map: landmark positions and descriptor bank
    on one device, with an IVF index for large banks."""

    points: torch.Tensor        # (P, 3)
    bank: Descriptors           # (P, 128) landmark descriptors
    ivf: IVFIndexSorted | None


def default_n_clusters(rows: int) -> int:
    """The JAX package's rule: the power of two at or above sqrt(rows),
    clamped to [64, 4096] (2048 clusters for 4,000,000 rows)."""
    return int(min(4096, max(64, 2 ** int(np.ceil(np.log2(max(rows, 2) ** 0.5))))))


def build_map_index(points, pt_desc, pt_mask, ann_threshold: int | None = None,
                    n_clusters: int | None = None, seed: int = 0, device=None) -> MapIndex:
    """A localization index over a map's landmarks on ``device`` (``cuda``
    unless ``device="cpu"``). ``ann_threshold``: banks of at least this many
    rows get the IVF index (None: ``ANN_CROSSOVER_ROWS``; 0 forces IVF, a
    huge value exact search). The k-means draws come from a generator
    seeded with ``seed``, so an index is a function of (map, seed)."""
    dev = resolve_device(device)

    def tens(a, dtype):
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a, copy=True))
        return t.to(device=dev, dtype=dtype)

    pts = tens(points, torch.float32)
    bank = Descriptors(tens(pt_desc, torch.float32).contiguous(), tens(pt_mask, torch.bool))
    thr = ANN_CROSSOVER_ROWS if ann_threshold is None else ann_threshold
    ivf = None
    if bank.data.shape[0] >= thr:
        k = default_n_clusters(bank.data.shape[0]) if n_clusters is None else n_clusters
        ivf = build_index_sorted(bank, n_clusters=k,
                                 generator=torch.Generator(dev).manual_seed(seed))
    return MapIndex(points=pts, bank=bank, ivf=ivf)


class LocalizeResult(NamedTuple):
    ok: torch.Tensor            # bool: PnP succeeded
    R: torch.Tensor             # (3, 3) world->cam
    t: torch.Tensor             # (3,)
    n_matches: torch.Tensor     # 2D-3D candidates after the ratio test
    n_inliers: torch.Tensor


def match_to_map(index: MapIndex, desc, mask, ratio: float = 0.8, budget: int = 8192,
                 n_probe: int = 8):
    """The 2D-3D candidates of a query: ratio test, no cross-check (the
    bank is much larger than the query and most landmarks are unseen; PnP
    RANSAC is the verifier), through the IVF index or the exact matcher."""
    dev = index.points.device
    q = Descriptors(torch.as_tensor(np.asarray(desc, np.float32)).to(dev),
                    torch.as_tensor(np.asarray(mask, bool)).to(dev))
    if index.ivf is not None:
        return match_pair_ann_big(q, index.ivf, budget=min(budget, index.bank.data.shape[0]),
                                  n_probe=n_probe, ratio=ratio, cross_check=False, device=dev)
    return match_pair(q, index.bank, ratio=ratio, cross_check=False, device=dev)


def pnp_from_matches(points: torch.Tensor, m, xn: np.ndarray, thr_n: float, n_hyp: int,
                     min_inliers: int, seed: int) -> LocalizeResult:
    """RANSAC PnP of matched landmarks (``points[m.idx]`` where ``m.valid``)
    against normalized query coordinates; the draws from a generator on the
    points' device seeded with ``seed``."""
    dev = points.device
    X = points[m.idx.long().clamp(0, points.shape[0] - 1)]
    pn = ransac_pnp(X, torch.from_numpy(np.asarray(xn, np.float32)).to(dev), m.valid,
                    thr=thr_n, n_hyp=n_hyp, min_inliers=min_inliers,
                    generator=torch.Generator(dev).manual_seed(seed), device=dev)
    return LocalizeResult(ok=pn.ok, R=pn.pose.R, t=pn.pose.t,
                          n_matches=m.valid.sum(dtype=torch.int32), n_inliers=pn.n_inliers)


def localize(index: MapIndex, xy: np.ndarray, desc: np.ndarray, mask: np.ndarray, camera,
             thr_px: float = 2.0, ratio: float = 0.8, n_hyp: int = 512, min_inliers: int = 12,
             budget: int = 8192, n_probe: int = 8, seed: int = 0) -> LocalizeResult:
    """Localize one frame's (C, 2) pixel keypoints, (C, 128) descriptors
    and (C,) mask against the map, on the index's device. Returns the
    world->cam pose; the result's tensors stay on that device."""
    m = match_to_map(index, desc, mask, ratio, budget, n_probe)
    xn = normalize_np(np.asarray(xy, np.float32), camera)
    thr_n = float(np.float32((thr_px / float(camera.fx)) ** 2))
    return pnp_from_matches(index.points, m, xn, thr_n, n_hyp, min_inliers, seed)


def map_index_from_checkpoint(path: str, ann_threshold: int | None = None, seed: int = 0,
                              device=None) -> MapIndex:
    """Load a ``checkpoint.save_map`` directory into a MapIndex."""
    from fastmatch_tpu_torch.pipeline.checkpoint import load_map_arrays

    tree = load_map_arrays(path)
    return build_map_index(tree["points"], tree["pt_desc"], tree["pt_mask"],
                           ann_threshold=ann_threshold, seed=seed, device=device)
