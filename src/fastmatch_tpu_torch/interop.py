"""State carried across from the JAX package, as numpy arrays.

The port never imports the JAX package; these helpers take the plain numpy
arrays (or any object with the same field names) that the JAX side hands
out and build the port's containers, so both packages can run on identical
inputs: descriptors, a bundle-adjustment problem, a reconstruction's map
state, the device tracker's and the VO scan engine's states, IMU
preintegrations and the configuration dataclasses.

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
from fastmatch_tpu_torch.core.lie import SE3, Sim3
from fastmatch_tpu_torch.dense.stereo import StereoConfig
from fastmatch_tpu_torch.features.klt import KLTConfig
from fastmatch_tpu_torch.features.sift import SIFTConfig
from fastmatch_tpu_torch.matching.ann import IVFIndex, IVFIndexSorted
from fastmatch_tpu_torch.matching.vlad import Vocabulary
from fastmatch_tpu_torch.pipeline import checkpoint as _checkpoint
from fastmatch_tpu_torch.pipeline import config as _config
from fastmatch_tpu_torch.pipeline.reconstruct import Reconstruction
from fastmatch_tpu_torch.pipeline.slam import SlamResult
from fastmatch_tpu_torch.pipeline.stereo_vo import StereoVOConfig
from fastmatch_tpu_torch.pipeline.tracker import TrackerStatic, TrackState
from fastmatch_tpu_torch.pipeline.vo import VOConfig
from fastmatch_tpu_torch.pipeline.vo_scan import VOScanState, VOScanStatic
from fastmatch_tpu_torch.sensors.imu import ImuPreintegration
from fastmatch_tpu_torch.posegraph.pgo import PoseGraph
from fastmatch_tpu_torch.posegraph.sim3 import Sim3Graph

__all__ = [
    "descriptors_from_numpy", "descriptors_from_arrays", "batched_descriptors_from_numpy",
    "binary_descriptors_from_arrays", "ba_problem_from_numpy",
    "config_from", "reconstruction_from_numpy",
    "reconstruction_to_numpy", "pose_graph_from_numpy", "sim3_graph_from_numpy",
    "slam_state_from_numpy", "slam_state_to_numpy", "track_state_from_numpy",
    "track_state_to_numpy", "tracker_static_from", "klt_config_from", "vo_config_from",
    "stereo_config_from", "stereo_vo_config_from", "vo_scan_static_from",
    "vo_scan_state_from_numpy", "vo_scan_state_to_numpy", "imu_preintegration_from_numpy",
    "map_checkpoint_from_numpy", "ivf_index_from_numpy", "ivf_index_sorted_from_numpy",
    "vocabulary_from_numpy",
]

# Map state of a Reconstruction: arrays and counters.
MAP_ARRAYS = ("R", "t", "pose_mask", "points", "pt_mask", "pt_desc", "obs_cam",
              "obs_pt", "obs_uv", "obs_mask")
MAP_COUNTERS = ("n_frames", "n_points", "n_obs")


def _field(o, name, default=None, required=True):
    """Field ``name`` of a dict or an object with that attribute."""
    if isinstance(o, dict):
        return o[name] if required else o.get(name, default)
    return getattr(o, name) if required else getattr(o, name, default)


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
    nested dict). Every value is copied as it is, the matcher backend name
    included (the port takes the JAX package's names), so the two configs
    hash alike."""

    def build(cls, o):
        return cls(**{f.name: _field(o, f.name) for f in dataclasses.fields(cls)})

    sift = _field(other, "sift")
    return _config.PipelineConfig(
        sift=SIFTConfig(**{k: _field(sift, k) for k in SIFTConfig._fields}),
        matching=build(_config.MatchingConfig, _field(other, "matching")),
        ransac=build(_config.RansacConfig, _field(other, "ransac")),
        ba=build(_config.BAConfig, _field(other, "ba")),
        map=build(_config.MapConfig, _field(other, "map")),
    )


def reconstruction_from_numpy(state, cfg, camera: Pinhole, device=None) -> Reconstruction:
    """A Reconstruction whose map state is copied from ``state`` (a dict, or
    any object with the JAX Reconstruction's attribute names)."""
    rec = Reconstruction(cfg=cfg, camera=camera, device=resolve_device(device))
    for name in MAP_ARRAYS:
        ref = getattr(rec, name)
        setattr(rec, name, np.array(_field(state, name), dtype=ref.dtype, copy=True))
    for name in MAP_COUNTERS:
        setattr(rec, name, int(_field(state, name)))
    return rec


def reconstruction_to_numpy(rec) -> dict:
    """The map state of a Reconstruction (either package's) as a dict of
    numpy arrays and ints."""
    out = {name: np.array(getattr(rec, name), copy=True) for name in MAP_ARRAYS}
    out.update({name: int(getattr(rec, name)) for name in MAP_COUNTERS})
    return out


def _graph_from_numpy(cls, group, g, device):
    """A pose graph ``cls`` of the port from the arrays of the JAX
    package's (or any object or dict with its field names; each pose batch
    a tuple of the group's fields, such as (R, t)), optional fields
    included."""
    kinds = {"edge_i": torch.int64, "edge_j": torch.int64, "prior_idx": torch.int64,
             "prior_T_idx": torch.int64, "pose_mask": torch.bool, "fixed": torch.bool}
    fields = {}
    for name in cls._fields:
        v = _field(g, name, required=name not in cls._field_defaults)
        if v is None:
            fields[name] = None
        elif name in ("poses", "Z", "prior_T"):
            fields[name] = group(*(_t(x, device, torch.float32) for x in v))
        else:
            fields[name] = _t(v, device, kinds.get(name, torch.float32))
    return cls(**fields)


def pose_graph_from_numpy(g, device=None) -> PoseGraph:
    """A PoseGraph from the JAX package's PoseGraph arrays (poses, Z and
    prior_T as (R, t) pairs), its optional priors included."""
    return _graph_from_numpy(PoseGraph, SE3, g, device)


def sim3_graph_from_numpy(g, device=None) -> Sim3Graph:
    """A Sim3Graph from the JAX package's Sim3Graph arrays (poses and Z as
    (R, t, s) triples)."""
    return _graph_from_numpy(Sim3Graph, Sim3, g, device)


def slam_state_to_numpy(out, kp_landmark=None) -> dict:
    """A SLAM run's state (either package's SlamResult): the map state of
    its Reconstruction, ``odo_edges`` and ``loop_edges`` as lists of
    (i, j, Z R, Z t) with numpy arrays, ``pgo_runs``, and the per-frame
    keypoint -> landmark arrays ``kp_landmark`` when given."""
    state = reconstruction_to_numpy(out.rec)

    def edges(es):
        return [(int(i), int(j), np.array(R, np.float32, copy=True),
                 np.array(t, np.float32, copy=True)) for i, j, R, t in es]

    state.update(odo_edges=edges(out.odo_edges), loop_edges=edges(out.loop_edges),
                 pgo_runs=int(out.pgo_runs),
                 kp_landmark=None if kp_landmark is None else
                 [np.array(k, np.int64, copy=True) for k in kp_landmark])
    return state


def slam_state_from_numpy(state: dict, cfg, camera: Pinhole, device=None):
    """(SlamResult, kp_landmark) of the port from ``slam_state_to_numpy``'s
    dict: the map state on ``device`` and the edge lists, so that both
    packages continue from one state."""
    out = SlamResult(rec=reconstruction_from_numpy(state, cfg, camera, device))
    for name in ("odo_edges", "loop_edges"):
        getattr(out, name).extend((int(i), int(j), np.array(R, np.float32, copy=True),
                                   np.array(t, np.float32, copy=True))
                                  for i, j, R, t in state[name])
    out.pgo_runs = int(state.get("pgo_runs", 0))
    kp = state.get("kp_landmark")
    return out, None if kp is None else [np.array(k, np.int64, copy=True) for k in kp]


# TrackState fields by dtype (the rest are float32).
_TRACK_BOOL = ("pose_mask", "pt_mask", "obs_mask", "prev_mask")
_TRACK_INT = ("pt_last_seen", "obs_cam", "obs_pt", "n_frames", "n_points", "n_obs", "last_kf",
              "prev_f", "prev_lm")


def track_state_to_numpy(state) -> dict:
    """A device tracker state (either package's TrackState, or a dict with
    its field names) as a dict of numpy arrays, the counters 0-dim."""
    out = {}
    for name in TrackState._fields:
        v = _field(state, name)
        out[name] = v.cpu().numpy().copy() if isinstance(v, torch.Tensor) else np.array(v)
    return out


def track_state_from_numpy(state, device=None) -> TrackState:
    """The port's TrackState on ``device`` from ``track_state_to_numpy``'s
    dict (or any object with TrackState's field names), so that both
    packages continue from one state."""
    def kind(name):
        return (torch.bool if name in _TRACK_BOOL else
                torch.int32 if name in _TRACK_INT else torch.float32)

    return TrackState(**{name: _t(_field(state, name), device, kind(name))
                         for name in TrackState._fields})


def tracker_static_from(other) -> TrackerStatic:
    """The port's TrackerStatic holding the values of ``other`` (the JAX
    package's TrackerStatic, or a dict with its field names)."""
    return TrackerStatic(**{f.name: _field(other, f.name)
                            for f in dataclasses.fields(TrackerStatic)})


# Configurations of the small-baseline front end: a nested field of one of
# these classes is rebuilt as the port's class of the same name.
_NESTED = {"klt": KLTConfig, "stereo": StereoConfig}


def _config_of(cls, other):
    """``cls`` (a dataclass or NamedTuple of the port) holding the values of
    ``other``, any object or dict with the JAX package's field names."""
    names = cls._fields if hasattr(cls, "_fields") else [f.name for f in dataclasses.fields(cls)]
    return cls(**{n: _config_of(_NESTED[n], _field(other, n)) if n in _NESTED
                  else _field(other, n) for n in names})


def klt_config_from(other) -> KLTConfig:
    """The port's KLTConfig with the values of the JAX package's."""
    return _config_of(KLTConfig, other)


def stereo_config_from(other) -> StereoConfig:
    """The port's StereoConfig with the values of the JAX package's."""
    return _config_of(StereoConfig, other)


def vo_config_from(other) -> VOConfig:
    """The port's VOConfig (its KLTConfig included) with the values of the
    JAX package's."""
    return _config_of(VOConfig, other)


def stereo_vo_config_from(other) -> StereoVOConfig:
    """The port's StereoVOConfig (KLT and stereo configs included) with the
    values of the JAX package's."""
    return _config_of(StereoVOConfig, other)


def vo_scan_static_from(other) -> VOScanStatic:
    """The port's VOScanStatic with the values of the JAX package's."""
    return _config_of(VOScanStatic, other)


# VOScanState fields by dtype (the rest are float32; prev_pyr is a tuple).
_SCAN_BOOL = ("alive", "pose_mask", "pt_mask", "obs_mask")
_SCAN_INT = ("lid", "first_frame", "obs_cam", "obs_pt", "n_points", "n_obs", "n_kfs",
             "last_ba_kf")


def vo_scan_state_to_numpy(state) -> dict:
    """A VO scan state (either package's VOScanState, or a dict with its
    field names) as a dict of numpy arrays, the counters 0-dim and
    ``prev_pyr`` a list of level arrays."""
    def host(v):
        return v.cpu().numpy().copy() if isinstance(v, torch.Tensor) else np.array(v)

    out = {name: host(_field(state, name)) for name in VOScanState._fields
           if name != "prev_pyr"}
    out["prev_pyr"] = [host(level) for level in _field(state, "prev_pyr")]
    return out


def vo_scan_state_from_numpy(state, device=None) -> VOScanState:
    """The port's VOScanState on ``device`` from ``vo_scan_state_to_numpy``'s
    dict (or any object with VOScanState's field names)."""
    def kind(name):
        return (torch.bool if name in _SCAN_BOOL else
                torch.int32 if name in _SCAN_INT else torch.float32)

    fields = {name: _t(_field(state, name), device, kind(name))
              for name in VOScanState._fields if name != "prev_pyr"}
    fields["prev_pyr"] = tuple(_t(level, device, torch.float32).contiguous()
                               for level in _field(state, "prev_pyr"))
    return VOScanState(**fields)


def imu_preintegration_from_numpy(pre, device=None) -> ImuPreintegration:
    """The port's ImuPreintegration (float32, leading batch axes kept) from
    the JAX package's arrays or a dict with its field names."""
    return ImuPreintegration(**{name: _t(_field(pre, name), device, torch.float32)
                                for name in ImuPreintegration._fields})


def map_checkpoint_from_numpy(tree, path: str) -> None:
    """Write the JAX package's map checkpoint tree (``save_map``'s orbax
    tree as ``orbax.checkpoint.PyTreeCheckpointer().restore`` returns it, or
    any dict of arrays with its keys: the map arrays, ``counters`` and
    ``config_hash``) into ``path`` in the port's format (``map.pt``). The
    arrays keep their dtypes and the config hash its bytes."""
    out = {name: torch.from_numpy(np.array(_field(tree, name), copy=True))
           for name in _checkpoint.MAP_ARRAYS}
    out.update(format=_checkpoint.MAP_FORMAT,
               counters=torch.from_numpy(np.array(_field(tree, "counters"), np.int64)),
               config_hash=torch.from_numpy(np.array(_field(tree, "config_hash"), np.uint8)))
    _checkpoint._save(out, path, _checkpoint.MAP_FILE)


def _descriptors_of(d, device) -> Descriptors:
    return descriptors_from_arrays(_field(d, "data"), _field(d, "mask"), device)


def ivf_index_from_numpy(index, device=None) -> IVFIndex:
    """The port's IVFIndex from the JAX package's (centroids, assign, desc)."""
    return IVFIndex(centroids=_t(_field(index, "centroids"), device, torch.float32),
                    assign=_t(_field(index, "assign"), device, torch.int32),
                    desc=_descriptors_of(_field(index, "desc"), device))


def ivf_index_sorted_from_numpy(index, device=None) -> IVFIndexSorted:
    """The port's IVFIndexSorted from the JAX package's (centroids, desc,
    perm, starts, assign), so that both packages search one index."""
    return IVFIndexSorted(centroids=_t(_field(index, "centroids"), device, torch.float32),
                          desc=_descriptors_of(_field(index, "desc"), device),
                          perm=_t(_field(index, "perm"), device, torch.int32),
                          starts=_t(_field(index, "starts"), device, torch.int32),
                          assign=_t(_field(index, "assign"), device, torch.int32))


def vocabulary_from_numpy(vocab, device=None) -> Vocabulary:
    """The port's Vocabulary from the JAX package's (its ``words``)."""
    return Vocabulary(words=_t(_field(vocab, "words"), device, torch.float32))
