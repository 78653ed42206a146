"""Checkpoints of a map and of a device-resident SLAM run.

Port of ``fastmatch_tpu/pipeline/checkpoint.py``. The JAX package writes
orbax directories; orbax imports JAX, so the port has its own format: a
directory (the CLI's argument stays a directory) holding

- ``map.pt``: a reconstruction's map state (poses, landmarks, descriptor
  bank, observation table, counters) and the 16-byte config hash;
- ``track.pt``: a ``drive_slam`` run's ``TrackState``, the driver's
  bookkeeping and the pose-graph edges, for ``drive_slam(resume=...)``.

Each file is one ``torch.save`` of a dict of CPU tensors, ints and
strings, and is read with ``torch.load(..., weights_only=True)``: a
service opens whatever path it is given, so loading runs no pickled code.
An orbax directory of the JAX package converts with
``interop.map_checkpoint_from_numpy``; handed to this module as it is, it
raises ``ValueError``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

MAP_FILE = "map.pt"
TRACK_FILE = "track.pt"
MAP_FORMAT = "fastmatch_tpu_torch.map/1"
TRACK_FORMAT = "fastmatch_tpu_torch.track/1"
MAP_ARRAYS = ("R", "t", "pose_mask", "points", "pt_mask", "pt_desc", "obs_cam", "obs_pt",
              "obs_uv", "obs_mask")


def _cpu(a) -> torch.Tensor:
    """A CPU tensor copy of an array or tensor, dtype kept."""
    if torch.is_tensor(a):
        return a.detach().to("cpu").clone()
    return torch.from_numpy(np.array(a, copy=True))


def _hash_bytes(cfg) -> torch.Tensor:
    """The config hash as the JAX package stores it: 16 uint8, NUL-padded."""
    raw = cfg.config_hash().encode().ljust(16, b"\0")[:16]
    return torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).copy())


def _save(tree: dict, path: str, name: str) -> None:
    """Write ``tree`` to ``path/name`` through a temporary file, so that a
    reader never sees half a checkpoint."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, name + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, name))


def _load(path: str, name: str, fmt: str) -> dict:
    """The dict in ``path/name``, loaded without running pickled code.
    Raises ValueError for a directory without it (an orbax directory of
    the JAX package, or a checkpoint of the other kind)."""
    path = os.path.abspath(path)
    f = os.path.join(path, name)
    if not os.path.isfile(f):
        hint = ("convert the JAX package's orbax map with "
                "fastmatch_tpu_torch.interop.map_checkpoint_from_numpy"
                if name == MAP_FILE else "write one with checkpoint.save_track_state")
        raise ValueError(f"{path} holds no {name}: not a checkpoint of this package ({hint})")
    tree = torch.load(f, map_location="cpu", weights_only=True)
    if tree.get("format") != fmt:
        raise ValueError(f"{f}: format {tree.get('format')!r}, expected {fmt!r}")
    return tree


def save_map(rec, path: str) -> None:
    """Save the reconstruction's map state to ``path`` (a directory)."""
    tree = {name: _cpu(getattr(rec, name)) for name in MAP_ARRAYS}
    tree.update(format=MAP_FORMAT,
                counters=torch.tensor([rec.n_frames, rec.n_points, rec.n_obs],
                                      dtype=torch.int64),
                config_hash=_hash_bytes(rec.cfg))
    _save(tree, path, MAP_FILE)


def load_map_arrays(path: str) -> dict:
    """A ``save_map`` directory as numpy arrays (the map arrays, ``counters``
    and ``config_hash``): what the localization, retrieval and merge
    loaders read."""
    tree = _load(path, MAP_FILE, MAP_FORMAT)
    return {k: v.numpy() for k, v in tree.items() if torch.is_tensor(v)}


def restore_map(rec, path: str, strict_config: bool = True):
    """Restore map state into ``rec`` (a fresh Reconstruction with matching
    capacities and config). ``strict_config`` raises ValueError when the
    saved config hash differs from ``rec.cfg``'s. Returns rec."""
    state = load_map_arrays(path)
    saved = bytes(state["config_hash"]).rstrip(b"\0").decode()
    if strict_config and saved != rec.cfg.config_hash():
        raise ValueError(f"checkpoint config hash {saved} != current {rec.cfg.config_hash()}")
    for name in MAP_ARRAYS:
        getattr(rec, name)[:] = state[name]
    rec.n_frames, rec.n_points, rec.n_obs = (int(x) for x in state["counters"])
    return rec


def _edges_to_tensors(edges) -> dict:
    if not edges:
        return {"i": torch.zeros(0, dtype=torch.int32), "j": torch.zeros(0, dtype=torch.int32),
                "R": torch.zeros((0, 3, 3)), "t": torch.zeros((0, 3))}
    return {"i": torch.tensor([e[0] for e in edges], dtype=torch.int32),
            "j": torch.tensor([e[1] for e in edges], dtype=torch.int32),
            "R": torch.from_numpy(np.stack([np.asarray(e[2]) for e in edges])),
            "t": torch.from_numpy(np.stack([np.asarray(e[3]) for e in edges]))}


def _edges_from_tensors(d) -> list:
    return [(int(i), int(j), R, t) for i, j, R, t in
            zip(d["i"].tolist(), d["j"].tolist(), d["R"].numpy(), d["t"].numpy())]


def save_track_state(state, book: dict, out, path: str) -> None:
    """Checkpoint a device-resident SLAM run (``tracker.TrackState``, the
    driver's bookkeeping dict and the pose-graph edges of its
    ``SlamResult``). Draws are a pure function of (seed, frame, purpose),
    so ``drive_slam(resume=restore_track_state(path))`` continues bit for
    bit with the uninterrupted run."""
    tree = {
        "format": TRACK_FORMAT,
        "state": {k: _cpu(v) for k, v in state._asdict().items()},
        "book": {k: (int(v) if np.ndim(v) == 0 else _cpu(v)) for k, v in book.items()},
        "odo": _edges_to_tensors(out.odo_edges),
        "loops": _edges_to_tensors(out.loop_edges),
        "frame_seq": torch.tensor(list(out.frame_seq), dtype=torch.int64),
        "pgo_runs": int(out.pgo_runs),
    }
    _save(tree, path, TRACK_FILE)


def restore_track_state(path: str, device=None):
    """(state, book, out) for ``drive_slam(resume=...)``, the state on
    ``device`` (``cuda`` unless ``device="cpu"``). ``out.rec`` is None: the
    driver builds it at the end of the run."""
    from fastmatch_tpu_torch.core.device import resolve_device
    from fastmatch_tpu_torch.pipeline.slam import SlamResult
    from fastmatch_tpu_torch.pipeline.tracker import TrackState

    dev = resolve_device(device)
    tree = _load(path, TRACK_FILE, TRACK_FORMAT)
    state = TrackState(**{k: v.to(dev) for k, v in tree["state"].items()})
    book = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in tree["book"].items()}
    out = SlamResult(rec=None)
    out.odo_edges = _edges_from_tensors(tree["odo"])
    out.loop_edges = _edges_from_tensors(tree["loops"])
    out.frame_seq = [int(x) for x in tree["frame_seq"].tolist()]
    out.pgo_runs = int(tree["pgo_runs"])
    return state, book, out
