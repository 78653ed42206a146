"""Corrupt the image corpus at random and hold the port's decoder to the
JAX package's on every result (CPU; needs the JAX package's native image
library, libjpeg + libpng).

    python tools/fuzz_torch_imageio.py [--seed 0] [--n 4000] [--sanitize]

Each case takes a JPEG (Huffman- or arithmetic-coded) or PNG of
tests/data/torch_images/ and applies 1-3 edits (a bit flip, a byte
overwritten, the file cut, a byte inserted or deleted), then decodes it with
both libraries: the arrays must be equal bit for bit, or the return codes
equal. ``--sanitize`` builds the
port's sources with AddressSanitizer and UndefinedBehaviorSanitizer into a
temporary directory and re-runs the script under them. Mismatching cases
are written to ``--keep DIR`` when given. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import random
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
DATA = os.path.join(ROOT, "tests", "data", "torch_images")
ADAM7 = ("png_adam7.png", "png_adam7_gray.png")


def decoder(lib):
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.fm_load_gray.argtypes = [ctypes.c_char_p, ctypes.POINTER(f32p),
                                 ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]

    def load(path):
        data, w, h = f32p(), ctypes.c_int(), ctypes.c_int()
        rc = lib.fm_load_gray(path.encode(), ctypes.byref(data), ctypes.byref(w), ctypes.byref(h))
        if rc:
            return rc
        return np.ctypeslib.as_array(data, shape=(h.value, w.value)).copy()
    return load


def mutate(rnd, data):
    d = bytearray(data)
    for _ in range(rnd.randint(1, 3)):
        op, i = rnd.random(), rnd.randrange(len(d))
        if op < 0.5:
            d[i] ^= 1 << rnd.randrange(8)
        elif op < 0.75:
            d[i] = rnd.randrange(256)
        elif op < 0.85:
            d = d[:max(i, 3)]
        elif op < 0.95:
            d[i:i] = bytes([rnd.randrange(256)])
        else:
            del d[i]
    return bytes(d)


def sanitized_rerun(argv):
    from fastmatch_tpu_torch.utils import imageio

    tmp = tempfile.mkdtemp()
    so = os.path.join(tmp, "fmimageio-asan.so")
    subprocess.run(["g++", "-O1", "-g", "-fsanitize=address,undefined", "-fno-omit-frame-pointer",
                    "-fno-sanitize-recover=undefined", "-fPIC", "-std=c++17", "-shared", "-o", so,
                    *(os.path.join(imageio.NATIVE, s) for s in imageio.SOURCES), *imageio.LD_LIBS],
                   check=True)
    runtimes = [subprocess.run(["g++", f"-print-file-name={n}"], capture_output=True, text=True,
                               check=True).stdout.strip() for n in ("libasan.so", "libubsan.so")]
    env = dict(os.environ, LD_PRELOAD=":".join(runtimes), ASAN_OPTIONS="detect_leaks=0",
               FUZZ_PORT_LIBRARY=so)
    args = [a for a in argv if a != "--sanitize"]
    return subprocess.run([sys.executable, os.path.abspath(__file__), *args], env=env).returncode


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--keep", default=None, help="directory for mismatching cases")
    args = ap.parse_args(argv)
    if args.sanitize:
        return sanitized_rerun(argv)
    from fastmatch_tpu.utils import imageio as jimageio
    from fastmatch_tpu_torch.utils import imageio

    jimageio.load_gray(os.path.join(DATA, "pnm_gray.pgm"))  # builds native/ if needed
    ref = decoder(jimageio._load_lib())
    port = decoder(ctypes.CDLL(os.environ.get("FUZZ_PORT_LIBRARY") or imageio.build()))
    files = sorted(f for f in glob.glob(os.path.join(DATA, "*"))
                   if f.endswith((".jpg", ".png")) and os.path.basename(f) not in ADAM7)
    rnd = random.Random(args.seed)
    counts = dict(cases=0, equal=0, mismatch=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "case.bin")
        for case in range(args.n):
            src = rnd.choice(files)
            with open(src, "rb") as fh:
                data = mutate(rnd, fh.read())
            with open(path, "wb") as fh:
                fh.write(data)
            a, b = ref(path), port(path)
            same = (a == b if isinstance(a, int) and isinstance(b, int)
                    else not isinstance(a, int) and not isinstance(b, int)
                    and a.shape == b.shape and np.array_equal(a, b))
            counts["cases"] += 1
            if same:
                counts["equal"] += 1
            else:
                counts["mismatch"] += 1
                if args.keep:
                    os.makedirs(args.keep, exist_ok=True)
                    name = f"{os.path.basename(src)}.{args.seed}.{case}.bin"
                    with open(os.path.join(args.keep, name), "wb") as fh:
                        fh.write(data)
    print(json.dumps(dict(seed=args.seed, sanitized="FUZZ_PORT_LIBRARY" in os.environ, **counts)))
    return 1 if counts["mismatch"] else 0


if __name__ == "__main__":
    sys.exit(main())
