"""Geometric verification of putative matches.

Port of ``fastmatch_tpu/matching/verify.py``: keep only the matches that
agree with one two-view model fitted robustly over the padded match arrays
(no dynamic shapes). Models: "fundamental" (uncalibrated pixels, the
default), "homography" (planar scenes, pure rotation), "essential"
(calibrated: needs the focal length and principal point). When the model
cannot be trusted (``ok`` False) the matches pass through unfiltered.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fastmatch_tpu_torch.core.containers import Keypoints, Matches
from fastmatch_tpu_torch.core.device import resolve_device


class VerifyResult(NamedTuple):
    matches: Matches          # input matches with valid &= model inliers
    model: torch.Tensor       # (3, 3) fitted F / H / E
    n_inliers: torch.Tensor   # scalar int
    ok: torch.Tensor          # scalar bool; False: matches pass unfiltered


def verify_matches(kp_a: Keypoints, kp_b: Keypoints, matches: Matches,
                   model: str = "fundamental", thr_px: float = 3.0, n_hyp: int = 512,
                   min_inliers: int = 15, focal: float | None = None,
                   pp: tuple[float, float] = (0.0, 0.0),
                   generator: torch.Generator | None = None, device=None) -> VerifyResult:
    """Keep the matches consistent with one robustly fitted two-view model,
    on ``device`` (``cuda`` unless ``device="cpu"``). The paired
    coordinates (xy_a[i], xy_b[matches.idx[i]]) of valid slots feed a
    fixed-K RANSAC; invalid slots are masked, never sampled. ``generator``
    draws the minimal samples (the JAX package's ``key``)."""
    dev = resolve_device(device)
    xa = kp_a.xy.to(dev)
    xb = kp_b.xy.to(dev)[matches.idx.to(dev).long()]
    valid = matches.valid.to(dev) & kp_a.mask.to(dev)
    kw = dict(n_hyp=n_hyp, min_inliers=min_inliers, generator=generator, device=dev)
    if model == "fundamental":
        from fastmatch_tpu_torch.geometry.fundamental import ransac_fundamental

        res = ransac_fundamental(xa, xb, valid, thr=thr_px ** 2, **kw)
        M = res.F
    elif model == "homography":
        from fastmatch_tpu_torch.geometry.homography import ransac_homography

        res = ransac_homography(xa, xb, valid, thr=2.0 * thr_px ** 2, **kw)
        M = res.H
    elif model == "essential":
        if focal is None:
            raise ValueError("model='essential' requires focal")
        from fastmatch_tpu_torch.geometry.ransac import ransac_essential

        c = torch.tensor(pp, dtype=torch.float32, device=dev)
        res = ransac_essential((xa - c) / focal, (xb - c) / focal, valid,
                               thr=(thr_px / focal) ** 2, **kw)
        M = res.E
    else:
        raise ValueError(f"unknown verification model {model!r}")
    keep = torch.where(res.ok, valid & res.inliers, valid)
    out = Matches(idx=matches.idx.to(dev),
                  dist=torch.where(keep, matches.dist.to(dev), float("inf")), valid=keep)
    return VerifyResult(matches=out, model=M, n_inliers=res.n_inliers, ok=res.ok)
