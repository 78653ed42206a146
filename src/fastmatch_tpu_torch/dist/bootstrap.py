"""Multi-process bootstrap.

Port of ``fastmatch_tpu/dist/bootstrap.py`` on ``torch.distributed``: every
process runs the same program and drives one device; the default process
group joins them, NCCL on the card and gloo on the CPU (only when the
caller asks for the CPU). The config is broadcast from rank 0, so every
process solves the same problem.

With none of ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID``
set, a world-size-1 group is made on a local store, so a single process
takes the same distributed code path. NCCL takes one GPU per rank and
refuses two ranks on one GPU: asking for more ranks on a host than it has
GPUs raises ``TooManyRanksError``; nothing switches to gloo or to the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from fastmatch_tpu_torch.core.device import resolve_device

# Every collective of the group fails after this long instead of hanging on
# a dead peer (``dist/watchdog.py`` bounds the card's asynchronous waits).
DEFAULT_TIMEOUT_S = 600.0
CONFIG_BYTES = 65536


class TooManyRanksError(RuntimeError):
    """More NCCL ranks on a host than it has GPUs."""


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> dict:
    """Join the default process group on ``device``'s backend (``cuda``:
    NCCL, unless ``device="cpu"``: gloo). Arguments default to the
    environment variables COORDINATOR_ADDRESS (``host:port``),
    NUM_PROCESSES and PROCESS_ID; with none set, a world-size-1 group. A
    group that exists already is kept if its backend is ``device``'s.
    Returns a status dict."""
    dev = resolve_device(device)
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", "0") or 0)
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("PROCESS_ID", "-1"))
    )
    configured = [coordinator is not None and coordinator != "",
                  num_processes > 1, process_id >= 0]
    if any(configured) and not all(configured):
        # Fail fast: a partially-specified launch (e.g. COORDINATOR_ADDRESS
        # typo'd) silently becoming N independent single-process jobs is the
        # worst failure mode a distributed bootstrap can have.
        raise RuntimeError(
            "partial distributed config: coordinator="
            f"{coordinator!r} num_processes={num_processes} "
            f"process_id={process_id} — set all three or none"
        )
    world, rank = (num_processes, process_id) if all(configured) else (1, 0)
    backend = _backend(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend} "
                               f"for {dev.type}")
    else:
        kw = {}
        if dev.type == "cuda":
            local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            n_gpus = torch.cuda.device_count()
            if local_world > n_gpus:
                raise TooManyRanksError(
                    f"{local_world} NCCL ranks on a host with {n_gpus} GPU(s): NCCL takes "
                    "one GPU per rank")
            local = int(os.environ.get("LOCAL_RANK", rank % local_world))
            dev = torch.device("cuda", local if dev.index is None else dev.index)
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        timeout = timedelta(seconds=timeout_s)
        if world == 1:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                    timeout=timeout, **kw)
        else:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                    world_size=world, rank=rank, timeout=timeout, **kw)
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }


def rank_device(device=None) -> torch.device:
    """The device this rank drives: ``device`` (``cuda`` unless
    ``device="cpu"``), on the CUDA side the GPU that
    ``initialize_distributed`` selected."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _encode_cfg(o):
    """Config tree -> JSON-able dict. Nodes are frozen dataclasses or
    NamedTuples (SIFTConfig); leaves are plain scalars/strings; plain
    tuples/lists recurse element-wise."""
    if dataclasses.is_dataclass(o):
        return {f.name: _encode_cfg(getattr(o, f.name)) for f in dataclasses.fields(o)}
    if hasattr(o, "_fields"):
        return {k: _encode_cfg(v) for k, v in o._asdict().items()}
    if isinstance(o, (tuple, list)):
        return [_encode_cfg(v) for v in o]
    return o


def _rebuild_cfg(template, data):
    """Rebuild a config of ``template``'s type from decoded JSON ``data`` —
    every process constructs the same types locally, only values travel."""
    if dataclasses.is_dataclass(template):
        kw = {
            f.name: _rebuild_cfg(getattr(template, f.name), data[f.name])
            for f in dataclasses.fields(template)
        }
        return dataclasses.replace(template, **kw)
    if hasattr(template, "_fields"):
        kw = {k: _rebuild_cfg(getattr(template, k), data[k]) for k in template._fields}
        return template._replace(**kw)
    if isinstance(template, (tuple, list)):
        rebuilt = [
            _rebuild_cfg(template[i] if i < len(template) else None, v)
            for i, v in enumerate(data)
        ]
        return tuple(rebuilt) if isinstance(template, tuple) else rebuilt
    return data


def _group_device() -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def broadcast_config(cfg, is_source: bool | None = None):
    """Broadcast a config tree to every rank as its JSON bytes — every
    rank then runs the same configuration (its hash is recorded in
    checkpoints). ``is_source`` marks the owning rank (default: rank 0)."""
    if dist.get_world_size() == 1:
        return cfg
    dev = _group_device()
    src = 0
    if is_source is not None:
        # The owner's rank, agreed by every rank in one reduction.
        mark = torch.tensor([dist.get_rank() if is_source else -1], device=dev)
        dist.all_reduce(mark, op=dist.ReduceOp.MAX)
        src = int(mark.item())
        if src < 0:
            raise ValueError("broadcast_config: no rank is the source")
    payload = json.dumps(_encode_cfg(cfg)).encode()
    if len(payload) > CONFIG_BYTES:
        raise ValueError(f"config too large to broadcast ({len(payload)} bytes)")
    buf = torch.zeros(CONFIG_BYTES, dtype=torch.uint8, device=dev)
    if dist.get_rank() == src:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(dev)
    dist.broadcast(buf, src=src)
    data = bytes(buf.cpu().numpy()).rstrip(b"\0")
    return _rebuild_cfg(cfg, json.loads(data.decode()))
