"""Localization serving: a long-running query service over a prebuilt map.

Port of ``fastmatch_tpu/pipeline/serve.py``. The map is built offline
(``reconstruct``/``slam --checkpoint``); many clients then ask "where is
this frame?":

- **The index once.** The map index (IVF above the crossover) is built at
  start-up; queries are padded to power-of-two capacity buckets, as the
  JAX package pads them.
- **Warmup before the socket opens.** ``serve`` drives one synthetic query
  through the whole path before binding: on the card its first K2 launch
  builds K2's library with ``nvcc``, which no live request may pay for. A
  build or launch failure raises there, before the socket exists; there is
  no CPU fallback.
- **Transport**: the stdlib ``ThreadingHTTPServer``. ``POST /localize``
  with an npz body (arrays ``xy`` (C, 2), ``desc`` (C, 128), optional
  ``mask``) answers JSON ``{ok, R, t, center, n_matches, n_inliers, ms}``;
  ``GET /healthz`` reports the map size, the index kind and the queries
  served. A lock serializes the device work, and every tensor names its
  device: a handler thread does not inherit the main thread's current CUDA
  device.

CLI: ``serve <map dir> --focal F --port 8080``.
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import time

import numpy as np
import torch

from fastmatch_tpu_torch.pipeline.localize import MapIndex, localize


def _bucket(n: int, floor: int = 256) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _on(dev: torch.device):
    """The CUDA device context of ``dev`` (nothing on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class LocalizeService:
    """Pad-to-bucket wrapper around ``localize``; thread-safe (a lock
    serializes the device work)."""

    def __init__(self, index: MapIndex, camera, thr_px: float = 2.0, ratio: float = 0.8,
                 budget: int = 8192, min_inliers: int = 12, seed: int = 0):
        self.index = index
        self.camera = camera
        self.thr_px = thr_px
        self.ratio = ratio
        self.budget = budget
        self.min_inliers = min_inliers
        self.seed = seed
        self.queries = 0
        self.device = index.points.device
        self._lock = threading.Lock()

    def query(self, xy, desc, mask=None) -> dict:
        xy = np.asarray(xy, np.float32)
        desc = np.asarray(desc, np.float32)
        n = xy.shape[0]
        if desc.ndim != 2 or desc.shape[0] != n or xy.shape != (n, 2):
            raise ValueError(f"xy {xy.shape} and desc {desc.shape} disagree")
        mask = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
        cap = _bucket(n)
        pxy = np.zeros((cap, 2), np.float32)
        pd = np.zeros((cap, desc.shape[1]), np.float32)
        pm = np.zeros(cap, bool)
        pxy[:n], pd[:n], pm[:n] = xy, desc, mask
        t0 = time.perf_counter()
        with self._lock, _on(self.device):
            r = localize(self.index, pxy, pd, pm, self.camera, thr_px=self.thr_px,
                         ratio=self.ratio, budget=self.budget, min_inliers=self.min_inliers,
                         seed=self.seed)
            # One readback: ok, counts, R, t.
            v = torch.cat([r.ok.reshape(1).double(), r.n_matches.reshape(1).double(),
                           r.n_inliers.reshape(1).double(), r.R.reshape(-1).double(),
                           r.t.reshape(-1).double()]).cpu().numpy()
            self.queries += 1
        R = v[3:12].reshape(3, 3)
        t = v[12:15]
        return {
            "ok": bool(v[0]),
            "R": R.tolist(), "t": t.tolist(), "center": (-R.T @ t).tolist(),
            "n_matches": int(v[1]), "n_inliers": int(v[2]),
            "ms": round(1e3 * (time.perf_counter() - t0), 2),
        }

    def warmup(self, cap: int = 1024) -> None:
        """Run the query path once before serving (synthetic descriptors;
        the result is discarded): on the card this builds and launches
        K2, and raises if either fails."""
        rng = np.random.default_rng(0)
        d = np.abs(rng.standard_normal((cap, self.index.bank.data.shape[1]))).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
        xy = rng.uniform(0, 2 * float(self.camera.cx), (cap, 2)).astype(np.float32)
        self.query(xy, d)
        self.queries = 0

    def health(self) -> dict:
        bank = self.index.bank
        return {
            "status": "ok",
            "map_points": int(bank.mask.sum()),
            "bank_capacity": int(bank.data.shape[0]),
            "index": "ivf" if self.index.ivf is not None else "exact",
            "queries_served": self.queries,
        }


def make_server(service: LocalizeService, host: str = "127.0.0.1", port: int = 0):
    """Build (not start) the HTTP server; ``port=0`` binds a free port
    (``server.server_port``), and ``server.service`` is the service."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, service.health())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/localize":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                data = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                if "xy" not in data or "desc" not in data:
                    raise KeyError("need arrays 'xy' and 'desc'")
                out = service.query(data["xy"], data["desc"],
                                    data["mask"] if "mask" in data else None)
                self._reply(200, out)
            except Exception as e:  # noqa: BLE001 (the serving boundary)
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):  # quiet; the counters live in /healthz
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.service = service
    return server


def serve(map_ckpt: str, camera, host: str = "127.0.0.1", port: int = 8080,
          ann_threshold: int | None = None, thr_px: float = 2.0, warmup_cap: int = 1024,
          ready_event: threading.Event | None = None, device=None, on_bind=None):
    """Load the map, run the warmup, and serve until interrupted (or until
    ``server.shutdown()`` from another thread). ``on_bind(server)`` is
    called once the socket is bound, before ``ready_event`` is set (a
    caller on port 0 reads ``server.server_port`` there). Returns the
    service."""
    from fastmatch_tpu_torch.pipeline.localize import map_index_from_checkpoint

    index = map_index_from_checkpoint(map_ckpt, ann_threshold=ann_threshold, device=device)
    service = LocalizeService(index, camera, thr_px=thr_px)
    service.warmup(warmup_cap)
    httpd = make_server(service, host, port)
    if on_bind is not None:
        on_bind(httpd)
    if ready_event is not None:
        ready_event.set()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return service
