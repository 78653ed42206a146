"""Bundle-adjustment problem containers.

Port of ``fastmatch_tpu/ba/problem.py``: a fixed-capacity observation table
of (camera, point, uv) triples with a validity mask; dead observations point
at segment 0 with zero weight.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fastmatch_tpu_torch.core.lie import SE3


class Observations(NamedTuple):
    """cam_idx (O,) int; pt_idx (O,) int; uv (O, 2) f32 normalized image
    coords; mask (O,) bool."""

    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    mask: torch.Tensor


class BAProblem(NamedTuple):
    """poses: world->camera SE3 (C,); points (P, 3); obs; cam_mask (C,)
    live cameras; pt_mask (P,) live points; fixed_cams (C,) gauge cameras."""

    poses: SE3
    points: torch.Tensor
    obs: Observations
    cam_mask: torch.Tensor
    pt_mask: torch.Tensor
    fixed_cams: torch.Tensor

    @property
    def n_cams(self) -> int:
        return self.cam_mask.shape[-1]

    @property
    def n_points(self) -> int:
        return self.pt_mask.shape[-1]

    def to(self, device) -> "BAProblem":
        return BAProblem(
            poses=SE3(self.poses.R.to(device), self.poses.t.to(device)),
            points=self.points.to(device),
            obs=Observations(*(f.to(device) for f in self.obs)),
            cam_mask=self.cam_mask.to(device), pt_mask=self.pt_mask.to(device),
            fixed_cams=self.fixed_cams.to(device))
