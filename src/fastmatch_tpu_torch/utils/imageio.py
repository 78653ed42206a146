"""Host-side image loading through the port's own native library.

Port of ``fastmatch_tpu/utils/imageio.py``: a ctypes binding of the
library in ``csrc/imageio/`` (JPEG, PNG, PGM and PPM to grayscale float32
in [0, 1], bilinear resize, and a threaded prefetching frame loader). Its
JPEG and PNG decoders (with their inflate) are the port's own C++, which
give libjpeg's and libpng's arrays bit for bit, so the library needs no
image or compression headers: it builds from ``csrc/imageio/`` alone with
``g++`` and ``-lpthread``, at first use, into the package's git-ignored
``_build/`` directory (``fmimageio-<hash>.so``; the hash covers every
source and header and the command). A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
NATIVE = os.path.normpath(os.path.join(_HERE, "..", "csrc", "imageio"))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("imageio.cpp", "jpeg.cpp", "png.cpp", "loader.cpp")
HEADERS = ("decode.h",)
CXX_FLAGS = ["-O2", "-fPIC", "-Wall", "-std=c++17", "-shared"]
LD_LIBS = ["-lpthread"]

_lib = None
_lock = threading.Lock()
_F32P = ctypes.POINTER(ctypes.c_float)


def _target() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LD_LIBS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(NATIVE, name), "rb") as fh:
            digest.update(name.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"fmimageio-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Build the library unless it is built; returns its path."""
    target = _target()
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, *(os.path.join(NATIVE, s) for s in SOURCES),
           *LD_LIBS]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed to build the image library:\n{out.stderr}")
    os.replace(tmp, target)
    return target


def _load_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.fm_load_gray.argtypes = [ctypes.c_char_p, ctypes.POINTER(_F32P),
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]
            lib.fm_load_gray.restype = ctypes.c_int
            lib.fm_resize_bilinear.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, _F32P,
                                               ctypes.c_int, ctypes.c_int]
            lib.fm_resize_bilinear.restype = ctypes.c_int
            lib.fm_free.argtypes = [_F32P]
            lib.fm_free.restype = None
            lib.fm_loader_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 5
            lib.fm_loader_open.restype = ctypes.c_void_p
            lib.fm_loader_next.argtypes = [ctypes.c_void_p, _F32P]
            lib.fm_loader_next.restype = ctypes.c_int
            lib.fm_loader_close.argtypes = [ctypes.c_void_p]
            lib.fm_loader_close.restype = None
            _lib = lib
    return _lib


def load_gray(path: str, size: tuple[int, int] | None = None) -> np.ndarray:
    """Decode an image to (H, W) float32 grayscale in [0, 1]; resized to
    ``size`` = (width, height) when given."""
    lib = _load_lib()
    data = _F32P()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.fm_load_gray(path.encode(), ctypes.byref(data), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"fm_load_gray({path!r}) failed with code {rc}")
    try:
        img = np.ctypeslib.as_array(data, shape=(h.value, w.value)).copy()
    finally:
        lib.fm_free(data)
    if size is not None and (w.value, h.value) != tuple(size):
        dw, dh = size
        out = np.empty((dh, dw), np.float32)
        rc = lib.fm_resize_bilinear(img.ctypes.data_as(_F32P), w.value, h.value,
                                    out.ctypes.data_as(_F32P), dw, dh)
        if rc != 0:
            raise IOError("fm_resize_bilinear failed")
        return out
    return img


class FrameLoader:
    """Threaded prefetching frame loader (``csrc/imageio/loader.cpp``): worker
    threads decode and resize ahead of the consumer into a bounded reorder
    buffer; iteration yields (index, (H, W) float32 in [0, 1]) in order,
    skipping frames that fail to decode (their index is missing).

        with FrameLoader(paths, size=(640, 480)) as frames:
            for idx, img in frames: ...
    """

    def __init__(self, paths: list[str], size: tuple[int, int], n_threads: int = 4,
                 prefetch: int = 8):
        self._handle = None  # set first: close() runs even if __init__ fails
        self._lib = _load_lib()
        self._w, self._h = size
        paths = list(paths)
        self._handle = self._lib.fm_loader_open("\n".join(paths).encode(), len(paths),
                                                self._w, self._h, n_threads, prefetch)
        if not self._handle:
            raise IOError("fm_loader_open failed")

    def __iter__(self):
        while True:
            buf = np.empty((self._h, self._w), np.float32)
            rc = self._lib.fm_loader_next(self._handle, buf.ctypes.data_as(_F32P))
            if rc == -1:
                return
            if rc == -2:
                continue
            yield rc, buf

    def close(self):
        if self._handle:
            self._lib.fm_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
