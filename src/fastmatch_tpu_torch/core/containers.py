"""Fixed-capacity padded containers and the masking discipline.

The port keeps the JAX package's convention (``fastmatch_tpu/core/
containers.py``): every ragged collection is stored at a fixed capacity
with a boolean ``mask`` of live entries; padded descriptor rows are zero and
every reduction over the capacity axis is mask-aware.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Canonical SIFT descriptor dimensionality (4x4 spatial bins x 8 orientations).
DESC_DIM = 128
# Default per-image keypoint capacity.
DEFAULT_CAPACITY = 2048


class Keypoints(NamedTuple):
    """Detected keypoints at fixed capacity: xy (C, 2), scale (C,), angle
    (C,), score (C,) float32 and mask (C,) bool."""

    xy: torch.Tensor
    scale: torch.Tensor
    angle: torch.Tensor
    score: torch.Tensor
    mask: torch.Tensor


class Descriptors(NamedTuple):
    """data (C, 128) float32 (padded rows zero); mask (C,) bool."""

    data: torch.Tensor
    mask: torch.Tensor


class Matches(NamedTuple):
    """One row per A-slot: idx (C,) int32 into B, dist (C,) float32 squared
    L2 (BIG where invalid), valid (C,) bool."""

    idx: torch.Tensor
    dist: torch.Tensor
    valid: torch.Tensor

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1)


def pad_to_capacity(arr: np.ndarray, capacity: int, fill: float = 0.0):
    """Pad a host array's leading axis to ``capacity``; return (padded, mask).
    Truncates (keeping the first ``capacity`` rows) if over capacity."""
    n = min(arr.shape[0], capacity)
    padded = np.full((capacity,) + arr.shape[1:], fill, dtype=arr.dtype)
    padded[:n] = arr[:n]
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return padded, mask


def descriptors_from_numpy(desc: np.ndarray, capacity: int = DEFAULT_CAPACITY,
                           device="cpu") -> Descriptors:
    """Build a padded Descriptors container from a host (N, 128) array."""
    if desc.ndim != 2 or desc.shape[1] != DESC_DIM:
        raise ValueError(f"expected (N, {DESC_DIM}) descriptors, got {desc.shape}")
    data, mask = pad_to_capacity(desc.astype(np.float32), capacity)
    return Descriptors(torch.from_numpy(data).to(device),
                       torch.from_numpy(mask).to(device))
