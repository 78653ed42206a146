"""The port's image library (``csrc/imageio/``, through
``fastmatch_tpu_torch.utils.imageio``) beside the JAX package's
(``native/``: libjpeg-turbo and libpng) on the corpus of
``tests/data/torch_images/`` (written by
``tools/make_torch_image_fixtures.py``): every file decodes to the same
float32 array bit for bit, or fails with the same return code. The one
chosen difference is Adam7: libpng, read row by row as the library reads
it, returns the passes' rows rather than the image, and the port refuses
the file (code 2). Arithmetic-coded files (SOF9, SOF10) are held like the
others. Also the arrays against ``references.npz`` (what ``chip_smoke.py``
holds the card's machine to), the arithmetic transcodes of the smoke frames
against their Huffman originals, the arithmetic decoder's probability table
against libjpeg's ``jpeg_aritab``, the bilinear resize, the threaded frame
loader over a mixed list, and the build's independence from image and
compression headers.
"""

import ctypes
import ctypes.util
import hashlib
import os
import re

import numpy as np
import pytest
import torch

from fastmatch_tpu.utils import imageio as jimageio

from fastmatch_tpu_torch.utils import imageio

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_images")
FILES = sorted(n for n in os.listdir(DATA) if n != "references.npz")
ADAM7 = ("png_adam7.png", "png_adam7_gray.png")
INV255 = np.float32(1.0) / np.float32(255.0)


def decode(load, path):
    """The array, or the return code in the IOError."""
    try:
        return load(path)
    except IOError as e:
        m = re.search(r"fm_load_gray\(.*\) failed with code (\d+)", str(e))
        assert m, str(e)
        return int(m.group(1))


@pytest.fixture(scope="module")
def refs():
    return np.load(os.path.join(DATA, "references.npz"))


@pytest.mark.parametrize("name", FILES)
def test_decode_equals_jax(name):
    path = os.path.join(DATA, name)
    got, want = decode(imageio.load_gray, path), decode(jimageio.load_gray, path)
    if name in ADAM7:
        assert got == 2 and isinstance(want, np.ndarray)
        return
    if isinstance(want, int):
        assert got == want
    else:
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert got.shape == want.shape and np.array_equal(got, want)


def test_decode_equals_references(refs):
    seen = set()
    for key in refs.files:
        kind, _, name = key.rpartition(":")
        seen.add(name)
        got = decode(imageio.load_gray, os.path.join(DATA, name))
        if name in ADAM7:
            assert got == 2, name
        elif kind == "rc":
            assert got == int(refs[key]), name
        elif kind == "f32":
            assert np.array_equal(got, refs[key]), name
        elif kind == "sha256":
            shape, digest = str(refs[key]).split(":")
            assert "x".join(map(str, got.shape)) == shape, name
            assert hashlib.sha256(got.tobytes()).hexdigest() == digest, name
        else:
            assert np.array_equal(got, refs[key].astype(np.float32) * INV255), name
    assert seen == set(FILES)


@pytest.mark.parametrize("arith, huffman", [("smoke_000_arith.jpg", "smoke_000.jpg"),
                                             ("smoke_001_arith.jpg", "smoke_001.jpg"),
                                             ("smoke_000_arith_prog.jpg", "smoke_000.jpg")])
def test_arith_transcode_equals_huffman(arith, huffman):
    # Lossless transcodes: the same DCT coefficients, so the same image.
    got = imageio.load_gray(os.path.join(DATA, arith))
    want = imageio.load_gray(os.path.join(DATA, huffman))
    assert got.shape == (480, 640) and np.array_equal(got, want)


def test_arith_table_equals_libjpeg():
    """Every state of T.81 Table D.2 (and libjpeg's fixed state 113), not
    only those the corpus reaches: libjpeg-turbo's ``jpeg_aritab`` packs a
    state as Qe << 16 | NMPS << 8 | SWITCH << 7 | NLPS in a long."""
    n = 114
    qe, nmps, nlps, sw = (ctypes.c_uint16 * n)(), *((ctypes.c_uint8 * n)() for _ in range(3))
    port = ctypes.CDLL(imageio.build())
    assert port.fm_jpeg_arith_states(qe, nmps, nlps, sw) == n
    libjpeg = ctypes.CDLL(ctypes.util.find_library("jpeg") or "libjpeg.so.62")
    ref = np.array((ctypes.c_long * n).in_dll(libjpeg, "jpeg_aritab"), np.int64)
    np.testing.assert_array_equal(np.array(qe), ref >> 16)
    np.testing.assert_array_equal(np.array(nmps), (ref >> 8) & 0xFF)
    np.testing.assert_array_equal(np.array(sw), (ref >> 7) & 1)
    np.testing.assert_array_equal(np.array(nlps), ref & 0x7F)


@pytest.mark.parametrize("size", [(40, 30), (101, 77)])
def test_resize_equals_jax(size):
    for name in ("jpeg_420_q75.jpg", "png_rgb8_160x120.png", "pnm_rgb.ppm"):
        path = os.path.join(DATA, name)
        got, want = imageio.load_gray(path, size=size), jimageio.load_gray(path, size=size)
        assert got.shape == (size[1], size[0]) and np.array_equal(got, want)


@pytest.mark.parametrize("n_threads", [1, 4])
def test_frame_loader_mixed_list(n_threads):
    names = ["jpeg_progressive.jpg", "png_palette4.png", "pnm_gray.pgm", "jpeg_gray.jpg",
             "png_rgb16_gamma.png", "jpeg_adobe_rgb_420.jpg", "pnm_rgb.ppm"] * 2
    paths = [os.path.join(DATA, n) for n in names]
    size = (56, 42)
    with imageio.FrameLoader(paths, size=size, n_threads=n_threads, prefetch=3) as frames:
        got = list(frames)
    assert [i for i, _ in got] == list(range(len(paths)))
    for (_, img), path in zip(got, paths):
        assert np.array_equal(img, imageio.load_gray(path, size=size))


def test_build_needs_no_image_headers():
    includes = set()
    for name in os.listdir(imageio.NATIVE):
        with open(os.path.join(imageio.NATIVE, name)) as fh:
            includes |= set(re.findall(r"#include\s*[<\"]([^>\"]+)[>\"]", fh.read()))
    assert not includes & {"jpeglib.h", "png.h", "zlib.h"}, includes
    assert set(imageio.SOURCES) | set(imageio.HEADERS) == set(os.listdir(imageio.NATIVE))
    assert imageio.LD_LIBS == ["-lpthread"]
    assert os.path.exists(imageio.build())
