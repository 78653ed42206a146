"""Fixed-capacity padded containers and the masking discipline.

The port keeps the JAX package's convention (``fastmatch_tpu/core/
containers.py``): every ragged collection is stored at a fixed capacity
with a boolean ``mask`` of live entries; padded descriptor rows are zero and
every reduction over the capacity axis is mask-aware.

Packed binary descriptors hold their ``uint32`` words in an ``int32`` tensor
with the same bits (``numpy.view``): PyTorch lacks shift and sum kernels for
``uint32`` on some builds, so packing and unpacking go through ``int64``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fastmatch_tpu_torch.core.device import resolve_device

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


class BinaryDescriptors(NamedTuple):
    """packed (C, W) int32 holding uint32 words (bit i of word w is test
    32*w + i; padded rows all-zero); mask (C,) bool. Leading batch axes are
    allowed."""

    packed: torch.Tensor
    mask: torch.Tensor

    @property
    def n_bits(self) -> int:
        return self.packed.shape[-1] * 32

    def count(self) -> torch.Tensor:
        return self.mask.sum(-1)


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
                           device=None) -> Descriptors:
    """Build a padded Descriptors container from a host (N, 128) array, on
    ``device`` (``cuda`` unless ``device="cpu"``)."""
    if desc.ndim != 2 or desc.shape[1] != DESC_DIM:
        raise ValueError(f"expected (N, {DESC_DIM}) descriptors, got {desc.shape}")
    dev = resolve_device(device)
    data, mask = pad_to_capacity(desc.astype(np.float32), capacity)
    return Descriptors(torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev))


def unpack_bits_signed(packed: torch.Tensor, mask: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """(..., W) packed words -> (..., 32*W) ``dtype`` in {-1, +1}; rows where
    ``mask`` is False unpack to zeros."""
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    bits = (packed.to(torch.int64)[..., None] >> shifts) & 1      # (..., W, 32)
    signed = (2 * bits - 1).to(dtype).reshape(*packed.shape[:-1], packed.shape[-1] * 32)
    return torch.where(mask[..., None], signed, torch.zeros((), dtype=dtype,
                                                            device=packed.device))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32*W) bool/0-1 bits -> (..., W) int32 tensor of uint32 words."""
    if bits.shape[-1] % 32:
        raise ValueError(f"bit count must be a multiple of 32, got {bits.shape[-1]}")
    w = bits.shape[-1] // 32
    grouped = bits.to(torch.int64).reshape(*bits.shape[:-1], w, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (grouped << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def binary_descriptors_from_numpy(packed: np.ndarray, capacity: int = DEFAULT_CAPACITY,
                                  device=None) -> BinaryDescriptors:
    """Build a padded BinaryDescriptors container from a host (N, W) uint32
    array, on ``device`` (``cuda`` unless ``device="cpu"``)."""
    if packed.ndim != 2 or packed.dtype != np.uint32:
        raise ValueError(f"expected (N, W) uint32 packed bits, got {packed.shape} {packed.dtype}")
    dev = resolve_device(device)
    data, mask = pad_to_capacity(packed, capacity)
    return BinaryDescriptors(torch.from_numpy(data.view(np.int32)).to(dev),
                             torch.from_numpy(mask).to(dev))
