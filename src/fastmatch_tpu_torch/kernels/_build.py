"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``_build/<name>-<hash>.so`` inside the package (the hash covers the source,
every ``csrc/*.cuh`` it includes and the flags, so an edited source or
header rebuilds). ``build_all`` starts one
``nvcc`` per source at once and waits for all of them. Nothing is built when
a module is imported: the first launch of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("batch_match", "distance_topk", "gather_rows", "patch_gather", "segment_sum")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
_entries: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: str, seen: list) -> list:
    """``path`` and, depth first, every file of ``CSRC`` it includes with
    quotes, each once."""
    if path in seen:
        return seen
    seen.append(path)
    with open(path, "rb") as fh:
        text = fh.read()
    for inc in _INCLUDE.findall(text):
        _sources(os.path.join(CSRC, inc.decode()), seen)
    return seen


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(os.path.join(CSRC, f"{name}.cu"), []):
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for one source unless its library is built; returns
    (name, process or None, target, tmp path)."""
    target = _target(name)
    if os.path.exists(target):
        return name, None, target, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, proc, target, tmp


def _finish(name, proc, target, tmp) -> str:
    if proc is not None:
        out, _ = proc.communicate()
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as fh:
            fh.write(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, target)
    return target


def build_all() -> float:
    """Build every kernel library in parallel (one nvcc per source); load
    them. Returns the wall seconds the build took."""
    t0 = time.perf_counter()
    with _lock:
        jobs = [_start(n) for n in SOURCES if n not in _libs]
        for job in jobs:
            _libs[job[0]] = ctypes.CDLL(_finish(*job))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(_finish(*_start(name)))
            lib = _libs[name]
    return lib


def entry(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, with its argument
    types and its ``int`` (cudaError_t) result declared once, not per call."""
    fn = _entries.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _entries[symbol] = fn
    return fn


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` printed for the last build of ``name``."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    return open(path).read() if os.path.exists(path) else ""


def check(rc: int, what: str):
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def ptr(t) -> int:
    """A tensor's device address, for a ``c_void_p`` argument."""
    return t.data_ptr()


def stream_of(t) -> int:
    """The raw handle of the current CUDA stream of a tensor's device, for a
    ``c_void_p``. Read without building a ``torch.cuda.Stream`` object, as
    Triton's launcher reads it: it is paid on every launch."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
