"""Metrics and profiling hooks.

Port of ``fastmatch_tpu/utils/metrics.py``: structured events written as
JSONL (one object per event, the JAX package's event names and fields),
mirrored to TensorBoard scalars when a writer is available, and a
``torch.profiler`` trace region behind a flag so that production runs pay
nothing.
"""

from __future__ import annotations

import contextlib
import json
import time


def _is_rank0() -> bool:
    """Rank 0 of an initialised ``torch.distributed`` group, or the only
    process (the JAX package's ``jax.process_index() == 0``)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MetricsLogger:
    """JSONL metrics sink, enabled on rank 0 only in multi-process runs."""

    def __init__(self, path: str | None = None, tensorboard_dir: str | None = None):
        self.enabled = _is_rank0()
        self._fh = open(path, "a") if (path and self.enabled) else None
        self._tb = None
        if tensorboard_dir and self.enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception:
                self._tb = None
        self._step = 0

    def log(self, event: str, **fields):
        if not self.enabled:
            return
        rec = {"ts": time.time(), "event": event, "step": self._step, **fields}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._tb:
            for k, v in fields.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{event}/{k}", v, self._step)
        self._step += 1

    @contextlib.contextmanager
    def timer(self, name: str, **fields):
        t0 = time.perf_counter()
        yield
        self.log(name, seconds=time.perf_counter() - t0, **fields)

    def close(self):
        if self._fh:
            self._fh.close()
        if self._tb:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """A ``torch.profiler`` region (CPU, and CUDA when available) whose
    trace is written under ``logdir`` for TensorBoard; no-op when logdir is
    None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
