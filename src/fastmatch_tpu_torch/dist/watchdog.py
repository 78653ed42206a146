"""In-engine failure detection.

Port of ``fastmatch_tpu/dist/watchdog.py``. On the card, work and
collectives are queued asynchronously: a collective whose peer died never
completes, and the surviving process blocks forever in the next readback.
A SLAM engine on many cards must turn that hang into a bounded detection
and a checkpoint restart (the recovery model is checkpoint-restart, not
elastic). The process group's own ``timeout`` bounds collectives that
block the host (gloo); the watchdog bounds the card's queued work.

Two mechanisms, both host-side:

- ``Watchdog.wait(tree)`` — time-bounded readback. A CUDA event is
  recorded on the current stream after the tensors of ``tree``, and a daemon
  thread synchronizes it; if that does not finish within ``timeout_s``,
  the watchdog fires ``on_timeout`` (e.g. flush a final snapshot marker)
  and raises ``CollectiveTimeout`` in the CALLER's thread, which can then
  abort cleanly for the supervisor to restart from the last checkpoint. The
  orphaned blocker thread is a daemon: it cannot be cancelled, but it no
  longer holds the engine hostage — process exit proceeds. A leaf that is
  not a tensor but has ``synchronize()`` (a CUDA event, a stream) is
  waited on as it is; CPU tensors are ready when they exist.
- ``Heartbeat`` — a per-process liveness file (mtime = last beat) written
  by a daemon thread, plus ``stale_peers`` for a supervisor or rank 0
  to distinguish "peer died" from "collective merely slow" before
  deciding to restart.

The distributed pipeline (dist/pipeline.py) arms a Watchdog around every
sharded BA result when ``DistConfig.collective_timeout_s > 0``.
"""

from __future__ import annotations

import os
import threading
import time

import torch

from fastmatch_tpu_torch.dist.overlap import tensors_of


class CollectiveTimeout(RuntimeError):
    """A device readback (collective) failed to complete in time —
    treat as peer/host loss and restart from the last checkpoint."""


def _waitables(tree) -> list:
    """What ``Watchdog.wait`` synchronizes for ``tree``: one event on the
    current stream of each CUDA device its tensors are on, and every leaf
    with a ``synchronize`` method."""
    leaves = tree if isinstance(tree, (tuple, list)) else [tree]
    out = [x for x in leaves if not torch.is_tensor(x) and hasattr(x, "synchronize")]
    for dev in sorted({t.device.index for t in tensors_of(tree) if t.is_cuda}):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        out.append(ev)
    return out


class Watchdog:
    """Time-bounded readback for distributed steps."""

    def __init__(self, timeout_s: float, on_timeout=None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.on_timeout = on_timeout

    def wait(self, tree):
        """Block until every tensor in ``tree`` is ready, or raise
        CollectiveTimeout after ``timeout_s`` seconds. Returns ``tree``.
        Exceptions raised by the wait itself (e.g. the runtime noticing a
        dead peer first) are re-raised unchanged."""
        waits = _waitables(tree)
        done = threading.Event()
        err: list[BaseException] = []

        def blocker():
            try:
                for w in waits:
                    w.synchronize()
            except BaseException as e:  # noqa: BLE001 — relay to caller
                err.append(e)
            finally:
                done.set()

        th = threading.Thread(target=blocker, daemon=True,
                              name="fastmatch-watchdog-blocker")
        th.start()
        if not done.wait(self.timeout_s):
            if self.on_timeout is not None:
                self.on_timeout()
            raise CollectiveTimeout(
                f"device readback did not complete within "
                f"{self.timeout_s:.1f}s — peer/host loss assumed; restart "
                f"from the last checkpoint")
        if err:
            raise err[0]
        return tree


class Heartbeat:
    """Per-process liveness file: mtime = last beat.

    ``Heartbeat(path).start()`` touches ``path`` every ``interval_s`` from
    a daemon thread; a supervisor (or rank 0) calls
    ``stale_peers(paths, stale_s)`` to identify dead processes before
    tearing the job down."""

    def __init__(self, path: str, interval_s: float = 2.0):
        self.path = path
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self):
        with open(self.path, "a"):
            os.utime(self.path, None)

    def start(self) -> "Heartbeat":
        self.beat()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="fastmatch-heartbeat")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.beat()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1)


def stale_peers(paths: dict, stale_s: float, now: float | None = None):
    """{name: heartbeat_path} -> [names] whose file is missing or whose
    last beat is older than ``stale_s`` seconds."""
    now = time.time() if now is None else now
    dead = []
    for name, path in paths.items():
        try:
            if now - os.path.getmtime(path) > stale_s:
                dead.append(name)
        except OSError:
            dead.append(name)
    return dead
