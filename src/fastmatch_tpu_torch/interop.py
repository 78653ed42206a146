"""State carried across from the JAX package, as numpy arrays.

The port never imports the JAX package; these helpers take the plain numpy
arrays (or any object with the same field names) that the JAX side hands
out and build the port's containers, so both packages can run on identical
inputs: descriptors, a bundle-adjustment problem, a reconstruction's map
state and the configuration dataclasses.

Every constructor here takes ``device=None`` and resolves it as every
entry point of the port does (``core.device.resolve_device``): the card
unless the caller asks for the CPU, as the CPU tests do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fastmatch_tpu_torch.ba.problem import BAProblem, Observations
from fastmatch_tpu_torch.core.camera import Pinhole
from fastmatch_tpu_torch.core.containers import (BinaryDescriptors, Descriptors,
                                                 descriptors_from_numpy, pad_to_capacity)
from fastmatch_tpu_torch.core.device import resolve_device
from fastmatch_tpu_torch.core.lie import SE3
from fastmatch_tpu_torch.features.sift import SIFTConfig
from fastmatch_tpu_torch.pipeline import config as _config
from fastmatch_tpu_torch.pipeline.reconstruct import Reconstruction

__all__ = [
    "descriptors_from_numpy", "descriptors_from_arrays", "batched_descriptors_from_numpy",
    "binary_descriptors_from_arrays", "ba_problem_from_numpy",
    "config_from", "reconstruction_from_numpy",
    "reconstruction_to_numpy",
]

# The JAX package's matcher backend names and the port's.
_BACKENDS = {"jnp": "plain", "pallas": "kernel"}

# Map state of a Reconstruction: arrays and counters.
MAP_ARRAYS = ("R", "t", "pose_mask", "points", "pt_mask", "pt_desc", "obs_cam",
              "obs_pt", "obs_uv", "obs_mask")
MAP_COUNTERS = ("n_frames", "n_points", "n_obs")


def _t(a, device, dtype=None) -> torch.Tensor:
    device = resolve_device(device)
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def descriptors_from_arrays(data, mask, device=None) -> Descriptors:
    """Descriptors from a (C, D) float array and its (C,) mask as given
    (no re-padding)."""
    return Descriptors(_t(data, device, torch.float32), _t(mask, device, torch.bool))


def batched_descriptors_from_numpy(descs, capacity: int, device=None) -> Descriptors:
    """Batched Descriptors (B, capacity, D) from a list of (N_i, D) float
    arrays, each padded to ``capacity`` (truncated above it) as
    ``descriptors_from_numpy`` pads one set."""
    padded = [pad_to_capacity(np.asarray(d, np.float32), capacity) for d in descs]
    return descriptors_from_arrays(np.stack([d for d, _ in padded]),
                                   np.stack([m for _, m in padded]), device)


def binary_descriptors_from_arrays(packed, mask, device=None) -> BinaryDescriptors:
    """BinaryDescriptors from a (..., C, W) uint32 array and its (..., C)
    mask as given; the words are held in an int32 tensor with the same
    bits."""
    words = np.ascontiguousarray(packed, dtype=np.uint32).view(np.int32)
    return BinaryDescriptors(_t(words, device), _t(mask, device, torch.bool))


def ba_problem_from_numpy(R, t, points, cam_idx, pt_idx, uv, obs_mask, cam_mask,
                          pt_mask, fixed_cams, device=None) -> BAProblem:
    """A BAProblem from numpy arrays: poses (C, 3, 3)/(C, 3), points (P, 3),
    the observation table (O,) x 3 + uv (O, 2), and the camera/point/gauge
    masks."""
    return BAProblem(
        poses=SE3(_t(R, device, torch.float32), _t(t, device, torch.float32)),
        points=_t(points, device, torch.float32),
        obs=Observations(_t(cam_idx, device, torch.int32), _t(pt_idx, device, torch.int32),
                         _t(uv, device, torch.float32), _t(obs_mask, device, torch.bool)),
        cam_mask=_t(cam_mask, device, torch.bool),
        pt_mask=_t(pt_mask, device, torch.bool),
        fixed_cams=_t(fixed_cams, device, torch.bool),
    )


def config_from(other) -> _config.PipelineConfig:
    """The port's PipelineConfig holding the same values as ``other``, any
    object with the JAX package's field names (its PipelineConfig, or a
    nested dict). The matcher backend names are translated ("jnp" ->
    "plain", "pallas" -> "kernel"); everything else is copied."""

    def get(o, name):
        return o[name] if isinstance(o, dict) else getattr(o, name)

    def build(cls, o):
        kw = {}
        for f in dataclasses.fields(cls):
            v = get(o, f.name)
            if cls is _config.MatchingConfig and f.name == "backend":
                v = _BACKENDS.get(v, v)
            kw[f.name] = v
        return cls(**kw)

    sift = get(other, "sift")
    return _config.PipelineConfig(
        sift=SIFTConfig(**{k: get(sift, k) for k in SIFTConfig._fields}),
        matching=build(_config.MatchingConfig, get(other, "matching")),
        ransac=build(_config.RansacConfig, get(other, "ransac")),
        ba=build(_config.BAConfig, get(other, "ba")),
        map=build(_config.MapConfig, get(other, "map")),
    )


def reconstruction_from_numpy(state, cfg, camera: Pinhole, device=None) -> Reconstruction:
    """A Reconstruction whose map state is copied from ``state`` (a dict, or
    any object with the JAX Reconstruction's attribute names)."""
    rec = Reconstruction(cfg=cfg, camera=camera, device=resolve_device(device))

    def get(name):
        return state[name] if isinstance(state, dict) else getattr(state, name)

    for name in MAP_ARRAYS:
        ref = getattr(rec, name)
        setattr(rec, name, np.array(get(name), dtype=ref.dtype, copy=True))
    for name in MAP_COUNTERS:
        setattr(rec, name, int(get(name)))
    return rec


def reconstruction_to_numpy(rec) -> dict:
    """The map state of a Reconstruction (either package's) as a dict of
    numpy arrays and ints."""
    out = {name: np.array(getattr(rec, name), copy=True) for name in MAP_ARRAYS}
    out.update({name: int(getattr(rec, name)) for name in MAP_COUNTERS})
    return out
