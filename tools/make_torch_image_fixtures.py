"""Write the image-decoder corpus of tests/data/torch_images/.

    python tools/make_torch_image_fixtures.py

Needs PIL and cv2 (encoders), and the JAX package's native image library
(libjpeg + libpng), whose ``load_gray`` decodes every file into
``references.npz``: the array the port's decoder must give bit for bit, or
the return code it must give. The port's tests and ``chip_smoke.py`` read
the corpus; nothing in the port imports this script.

Most files are at most 160 x 120. ``smoke_000.jpg`` and ``smoke_001.jpg``
are frames 0 and 1 of the smoke scene (``chip_smoke.SMOKE_SCENE``) at
640 x 480, JPEG q90. PNG variants the encoders cannot make (forced filter
types, stored or fixed-Huffman zlib streams, split IDATs, Adam7, gamma
chunks, bad CRC or Adler-32) come from the hand writer below, JPEG ones
(standard tables, Adobe RGB with subsampling, truncation) from byte edits
of encoder output. Arithmetic-coded JPEGs (``jpeg_arith_*``: SOF9,
``jpeg_arith_prog_*``: SOF10, and ``smoke_*_arith*.jpg``) are the Huffman
files transcoded losslessly by ``tools/jpeg_transcode.c``, which this script
compiles with ``gcc ... -ljpeg`` (the system's libjpeg-turbo), some of them
edited afterwards.

references.npz holds, for a file ``name``: ``name`` the decode's 8-bit
codes (uint8; the decode is ``codes * (1.0f / 255.0f)`` in float32,
checked here), or ``f32:name`` the float32 decode itself (PNM with maxval
below 255 and PPM), or ``rc:name`` the return code of a file that does not
decode. The two 640 x 480 frames, whose codes would outweigh the rest of
the corpus, are held by ``sha256:name``: "HxW:" and the SHA-256 of the
float32 decode's bytes.
"""

from __future__ import annotations

import hashlib
import io
import os
import struct
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_images")
SMOKE_SEED, SMOKE_POINTS, SMOKE_FRAMES, SMOKE_SPAN = 0, 400, 50, 1.2


def texture(h, w, seed=0, noise=5.0):
    """(h, w, 3) uint8: gradients, edges and noise, as a camera frame has."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    r = 128 + 100 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    g = 255 * (xx + yy) / (w + h)
    b = np.where((xx // 16 + yy // 16) % 2 == 0, 200.0, 40.0)
    img = np.stack([r, g, b], -1) + rng.normal(0, noise, (h, w, 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def gray_of(rgb):
    return np.round(rgb @ np.array([0.299, 0.587, 0.114])).astype(np.uint8)


# ---------- JPEG ----------

def pil_jpeg(arr, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def segments(data):
    """[(marker, start, end)] of the marker segments before the first SOS."""
    out, i = [], 2
    while i < len(data):
        m = data[i + 1]
        length = struct.unpack(">H", data[i + 2:i + 4])[0]
        out.append((m, i, i + 2 + length))
        if m == 0xDA:
            break
        i += 2 + length
    return out


def strip_segments(data, markers):
    keep, last = [data[:2]], 2
    for m, s, e in segments(data):
        if m in markers:
            keep.append(data[last:s])
            last = e
    keep.append(data[last:])
    return b"".join(keep)


def as_adobe_rgb(data):
    """The same entropy data, read as RGB: the JFIF APP0 swapped for an
    Adobe APP14 with transform 0, so libjpeg upsamples G and B from Cb's
    and Cr's sampling and mixes RGB to gray."""
    data = strip_segments(data, {0xE0})
    app14 = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
    return data[:2] + app14 + data[2:]


def as_rgb_ids(data):
    """No JFIF marker and component ids 'R', 'G', 'B': libjpeg's RGB guess."""
    data = bytearray(strip_segments(data, {0xE0}))
    for m, s, e in segments(bytes(data)):
        if m == 0xC0:
            for k, cid in enumerate(b"RGB"):
                data[s + 10 + 3 * k] = cid
        if m == 0xDA:
            for k, cid in enumerate(b"RGB"):
                data[s + 5 + 2 * k] = cid
    return bytes(data)


def jpeg_files():
    import cv2

    files = {}
    rgb = texture(40, 48, seed=1)
    for q in (50, 75, 95, 100):
        for name, ss in (("444", 0), ("422", 1), ("420", 2)):
            files[f"jpeg_{name}_q{q}.jpg"] = pil_jpeg(rgb, quality=q, subsampling=ss)
    big = texture(48, 64, seed=2)
    files["jpeg_gray.jpg"] = pil_jpeg(gray_of(big), quality=85)
    files["jpeg_optimized.jpg"] = pil_jpeg(big, quality=80, optimize=True)
    files["jpeg_restart_blocks.jpg"] = pil_jpeg(big, quality=80, restart_marker_blocks=5)
    files["jpeg_restart_rows.jpg"] = pil_jpeg(big, quality=80, restart_marker_rows=1)
    files["jpeg_progressive.jpg"] = pil_jpeg(big, quality=80, progressive=True)
    files["jpeg_progressive_gray.jpg"] = pil_jpeg(gray_of(big), quality=80, progressive=True)
    files["jpeg_progressive_restart.jpg"] = pil_jpeg(rgb, quality=80, progressive=True,
                                                     restart_marker_blocks=3)
    files["jpeg_1x1.jpg"] = pil_jpeg(rgb[:1, :1])
    files["jpeg_1x1_gray.jpg"] = pil_jpeg(gray_of(rgb[:1, :1]))
    files["jpeg_odd_17x9_420.jpg"] = pil_jpeg(rgb[:17, :9], subsampling=2)
    files["jpeg_odd_37x51_422.jpg"] = pil_jpeg(rgb[:51, :37], subsampling=1)
    files["jpeg_odd_1x33_420.jpg"] = pil_jpeg(rgb[:33, :1], subsampling=2)
    files["jpeg_odd_45x3_gray_progressive.jpg"] = pil_jpeg(gray_of(rgb[:3, :45]), progressive=True)
    files["jpeg_440.jpg"] = cv2.imencode(".jpg", rgb, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                       0x121111])[1].tobytes()
    files["jpeg_411.jpg"] = cv2.imencode(".jpg", rgb, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                       0x411111])[1].tobytes()
    # 16-bit quantisation tables (SOF1) and, with q = 1, coefficients up to 1024.
    coarse = [list(np.clip(np.arange(64) * 9 + 200, 1, 1000)) for _ in range(2)]
    files["jpeg_sof1_dqt16.jpg"] = pil_jpeg(big, qtables=coarse)
    files["jpeg_q1_tables.jpg"] = pil_jpeg(big, qtables=[[1] * 64, [1] * 64])
    # No DHT: the standard tables of T.81 Annex K, which libjpeg supplies.
    files["jpeg_no_dht.jpg"] = strip_segments(pil_jpeg(big, quality=75), {0xC4})
    files["jpeg_adobe_rgb.jpg"] = pil_jpeg(big, quality=90, keep_rgb=True)
    files["jpeg_adobe_rgb_420.jpg"] = as_adobe_rgb(pil_jpeg(big, quality=90, subsampling=2))
    files["jpeg_adobe_rgb_422.jpg"] = as_adobe_rgb(pil_jpeg(big, quality=90, subsampling=1))
    files["jpeg_adobe_rgb_440.jpg"] = as_adobe_rgb(files["jpeg_440.jpg"])
    files["jpeg_adobe_rgb_411.jpg"] = as_adobe_rgb(files["jpeg_411.jpg"])
    files["jpeg_adobe_rgb_420_narrow.jpg"] = as_adobe_rgb(pil_jpeg(rgb[:20, :4], subsampling=2))
    files["jpeg_adobe_rgb_422_narrow.jpg"] = as_adobe_rgb(pil_jpeg(rgb[:20, :3], subsampling=1))
    files["jpeg_rgb_ids.jpg"] = as_rgb_ids(pil_jpeg(rgb, quality=90, subsampling=2))
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(big).convert("CMYK").save(buf, "JPEG", quality=90)
    files["jpeg_cmyk.jpg"] = buf.getvalue()
    # Cut inside the entropy-coded data: libjpeg warns, reads zero bits to
    # the end of the MCU and returns the image (rc 0); cut in the headers,
    # it fails.
    def cut(data, share):
        start = segments(data)[-1][2]
        return data[:start + int((len(data) - start) * share)]

    full = pil_jpeg(big, quality=75, subsampling=2)
    files["jpeg_truncated.jpg"] = cut(full, 0.6)
    files["jpeg_truncated_restart.jpg"] = cut(files["jpeg_restart_blocks.jpg"], 0.5)
    # Progressive, cut: libjpeg-turbo's inter-block smoothing estimates the
    # coefficients that are not yet at full precision.
    files["jpeg_truncated_progressive_dc.jpg"] = cut(files["jpeg_progressive.jpg"], 0.05)
    files["jpeg_truncated_progressive_ac.jpg"] = cut(files["jpeg_progressive.jpg"], 0.5)
    files["jpeg_truncated_progressive_gray.jpg"] = cut(files["jpeg_progressive_gray.jpg"], 0.3)
    files["jpeg_truncated_header.jpg"] = full[:300]
    files["jpeg_no_eoi.jpg"] = full[:-2]
    return files


def scan_data_start(data):
    """Offset of the first scan's entropy-coded data."""
    return segments(data)[-1][2]


def marker_positions(data, wanted):
    """Offsets of every marker in ``wanted`` (segments and entropy-coded
    data walked alike, FF 00 skipped)."""
    out, i = [], 2
    while i + 1 < len(data):
        if data[i] != 0xFF or data[i + 1] in (0x00, 0xFF):
            i += 1
            continue
        m = data[i + 1]
        if m in wanted:
            out.append(i)
        if 0xD0 <= m <= 0xD9 or m == 0x01:
            i += 2
        else:
            i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return out


def strip_everywhere(data, marker):
    """``data`` without any segment of ``marker`` (DAC between scans too)."""
    for i in reversed(marker_positions(data, {marker})):
        length = struct.unpack(">H", data[i + 2:i + 4])[0]
        data = data[:i] + data[i + 2 + length:]
    return data


def transcoder():
    """tools/jpeg_transcode.c built with the system's libjpeg: a function
    (jpeg bytes, *options) -> jpeg bytes."""
    import subprocess
    import tempfile

    tmp = tempfile.mkdtemp()
    exe = os.path.join(tmp, "jpeg_transcode")
    subprocess.run(["gcc", "-O2", "-o", exe, os.path.join(ROOT, "tools", "jpeg_transcode.c"),
                    "-ljpeg"], check=True)

    def run(data, *options):
        src, dst = os.path.join(tmp, "in.jpg"), os.path.join(tmp, "out.jpg")
        with open(src, "wb") as fh:
            fh.write(data)
        subprocess.run([exe, src, dst, *map(str, options)], check=True)
        with open(dst, "rb") as fh:
            return fh.read()
    return run


def arith_files(huffman, smoke):
    """Arithmetic-coded files: the Huffman corpus ``huffman`` and the smoke
    frames ``smoke`` transcoded (same DCT coefficients), and edits of them."""
    tc = transcoder()
    files = {}
    for name in ("jpeg_gray", "jpeg_444_q75", "jpeg_422_q75", "jpeg_420_q75", "jpeg_411",
                 "jpeg_440", "jpeg_adobe_rgb", "jpeg_adobe_rgb_420", "jpeg_odd_17x9_420",
                 "jpeg_odd_1x33_420", "jpeg_q1_tables", "jpeg_sof1_dqt16"):
        files[name.replace("jpeg_", "jpeg_arith_") + ".jpg"] = tc(huffman[name + ".jpg"])
    base = huffman["jpeg_420_q95.jpg"]
    files["jpeg_arith_dac.jpg"] = tc(base, "dac", 2, 6, 12)
    files["jpeg_arith_dac_zero.jpg"] = tc(base, "dac", 0, 0, 1)
    files["jpeg_arith_restart_rows.jpg"] = tc(huffman["jpeg_restart_rows.jpg"], "restart-rows", 1)
    files["jpeg_arith_restart_blocks.jpg"] = tc(huffman["jpeg_restart_blocks.jpg"], "restart", 2)
    files["jpeg_arith_separate_scans.jpg"] = tc(base, "separate", "restart", 4)
    # Table slots above 3: in the DAC the encoder writes, and at the defaults.
    files["jpeg_arith_slots_dac.jpg"] = tc(base, "slots", 5, 9, "dac", 1, 3, 20)
    files["jpeg_arith_slots_default.jpg"] = strip_everywhere(tc(base, "slots", 7, 15),
                                                             0xCC)
    big = huffman["jpeg_progressive.jpg"]
    files["jpeg_arith_prog.jpg"] = tc(big, "progressive")
    files["jpeg_arith_prog_gray.jpg"] = tc(huffman["jpeg_gray.jpg"], "progressive")
    files["jpeg_arith_prog_restart.jpg"] = tc(huffman["jpeg_420_q75.jpg"], "progressive",
                                              "restart", 3)
    files["jpeg_arith_prog_adobe_rgb.jpg"] = tc(huffman["jpeg_adobe_rgb.jpg"], "progressive")
    files["jpeg_arith_prog_411.jpg"] = tc(huffman["jpeg_411.jpg"], "progressive")

    def cut(data, scan, share=0.5):
        """``data`` cut inside the entropy-coded data of scan ``scan``."""
        sos = marker_positions(data, {0xDA})[scan]
        start = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
        end = min(i for i in marker_positions(data, set(range(0x01, 0xFF)) - set(range(0xD0, 0xD8)))
                  if i >= start)
        return data[:start + int((end - start) * share)]

    # Cut progressive files: libjpeg-turbo's smoothing estimates what is
    # missing. libjpeg's script for YCbCr: DC first (scan 0), AC first (1-4),
    # AC refinement of Y (5), DC refinement (6), AC refinements (7-9); for
    # gray: DC, two AC bands, AC refinement (3), DC refinement, AC refinement.
    prog = files["jpeg_arith_prog.jpg"]
    files["jpeg_arith_prog_truncated_dc.jpg"] = cut(prog, 0)
    files["jpeg_arith_prog_truncated_ac.jpg"] = cut(prog, 4)
    files["jpeg_arith_prog_truncated_dc_refine.jpg"] = cut(prog, 6)
    files["jpeg_arith_prog_truncated_gray.jpg"] = cut(files["jpeg_arith_prog_gray.jpg"], 3)
    seq = files["jpeg_arith_420_q75.jpg"]
    files["jpeg_arith_truncated.jpg"] = cut(seq, 0, 0.6)
    flipped = bytearray(seq)
    at = scan_data_start(seq) + 40
    flipped[at] ^= 0x10 if flipped[at] != 0xEF else 0x01
    files["jpeg_arith_byte_flipped.jpg"] = bytes(flipped)
    # Restart markers out of order: the second and third swapped.
    rst = bytearray(files["jpeg_arith_restart_blocks.jpg"])
    r = marker_positions(bytes(rst), set(range(0xD0, 0xD8)))
    rst[r[1] + 1], rst[r[2] + 1] = rst[r[2] + 1], rst[r[1] + 1]
    files["jpeg_arith_restart_swapped.jpg"] = bytes(rst)
    dac = bytearray(seq)
    dac[marker_positions(seq, {0xCC})[0] + 4] = 0x20  # the first DAC index: 32
    files["jpeg_arith_dac_index32.jpg"] = bytes(dac)
    # Lossless and hierarchical processes, which libjpeg refuses: SOFn edited.
    for name, data, marker in (("jpeg_sof3.jpg", huffman["jpeg_444_q75.jpg"], 0xC3),
                               ("jpeg_sof5.jpg", huffman["jpeg_444_q75.jpg"], 0xC5),
                               ("jpeg_arith_sof11.jpg", seq, 0xCB)):
        d = bytearray(data)
        d[marker_positions(data, {0xC0, 0xC9})[0] + 1] = marker
        files[name] = bytes(d)
    files["smoke_000_arith.jpg"] = tc(smoke["smoke_000.jpg"])
    files["smoke_001_arith.jpg"] = tc(smoke["smoke_001.jpg"])
    files["smoke_000_arith_prog.jpg"] = tc(smoke["smoke_000.jpg"], "progressive")
    return files


def smoke_jpegs():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import SyntheticScene, render_scene_views

    rng = np.random.default_rng(SMOKE_SEED)
    scene = SyntheticScene(rng, n_points=SMOKE_POINTS, n_frames=SMOKE_FRAMES,
                           image_size=(640, 480), span=SMOKE_SPAN)
    views = render_scene_views(scene, rng, image_size=(640, 480), frames=[0, 1])
    return {f"smoke_{i:03d}.jpg": pil_jpeg(np.clip(np.round(v * 255), 0, 255).astype(np.uint8),
                                           quality=90)
            for i, v in enumerate(views)}


# ---------- PNG (hand writer) ----------

def chunk(tag, body, crc=None):
    c = zlib.crc32(tag + body) if crc is None else crc
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", c & 0xFFFFFFFF)


def ihdr(w, h, depth, ctype, interlace=0):
    return chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))


def pack_row(values, depth):
    """Samples (uint) of one row to bytes at `depth` bits each, MSB first."""
    if depth == 8:
        return bytes(np.asarray(values, np.uint8))
    if depth == 16:
        return np.asarray(values, ">u2").tobytes()
    out, acc, nb = bytearray(), 0, 0
    for v in values:
        acc = (acc << depth) | int(v)
        nb += depth
        if nb == 8:
            out.append(acc)
            acc, nb = 0, 0
    if nb:
        out.append(acc << (8 - nb))
    return bytes(out)


def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def filter_rows(rows, bpp, filters):
    """Filtered scanlines: each row's filter type from `filters(y)`."""
    out, prev = bytearray(), bytes(len(rows[0]))
    for y, row in enumerate(rows):
        f = filters(y)
        out.append(f)
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, paeth(a, b, c))[f]
            out.append((x - pred) & 0xFF)
        prev = row
    return bytes(out)


def zstream(raw, mode="default", wbits=15):
    if mode == "stored":
        c = zlib.compressobj(0, zlib.DEFLATED, wbits)
    elif mode == "fixed":
        c = zlib.compressobj(9, zlib.DEFLATED, wbits, 9, zlib.Z_FIXED)
    else:
        c = zlib.compressobj(9, zlib.DEFLATED, wbits)
    return c.compress(raw) + c.flush()


def png(samples, depth, ctype, *, filters=lambda y: y % 5, mode="default", wbits=15,
        pre=(), split=None, idat_crc=None, post=(), adler=None):
    """A PNG of `samples` ((h, w) or (h, w, c) unsigned ints)."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    flat = s.reshape(h, w, -1)
    rows = [pack_row(flat[y].reshape(-1), depth) for y in range(h)]
    bpp = max(1, flat.shape[2] * depth // 8)
    z = zstream(filter_rows(rows, bpp, filters), mode, wbits)
    if adler is not None:
        z = z[:-4] + struct.pack(">I", adler)
    parts = [b"\x89PNG\r\n\x1a\n", ihdr(w, h, depth, ctype), *pre]
    pieces = [z] if split is None else [z[i:i + split] for i in range(0, len(z), split)] + [b""]
    for k, piece in enumerate(pieces):
        parts.append(chunk(b"IDAT", piece, idat_crc if k == 0 else None))
    parts += [*post, chunk(b"IEND", b"")]
    return b"".join(parts)


def adam7(samples, depth, ctype):
    """An Adam7-interlaced PNG (filter 0 in every reduced row)."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    flat = s.reshape(h, w, -1)
    raw = bytearray()
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                           (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)):
        sub = flat[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        for y in range(sub.shape[0]):
            raw += b"\x00" + pack_row(sub[y].reshape(-1), depth)
    return b"".join([b"\x89PNG\r\n\x1a\n", ihdr(w, h, depth, ctype, 1),
                     chunk(b"IDAT", zstream(bytes(raw))), chunk(b"IEND", b"")])


def png_files():
    rng = np.random.default_rng(3)
    rgb = texture(24, 32, seed=4).astype(np.uint32)
    g8 = gray_of(texture(24, 32, seed=5)).astype(np.uint32)
    rgb16 = rgb * 257 + rng.integers(0, 256, rgb.shape)
    g16 = g8 * 257 + rng.integers(0, 256, g8.shape)
    alpha = rng.integers(0, 256, g8.shape)
    gama = chunk(b"gAMA", struct.pack(">I", 45455))
    files = {}
    for depth in (1, 2, 4):
        files[f"png_gray{depth}.png"] = png(g8 >> (8 - depth), depth, 0)
    files["png_gray8.png"] = png(g8, 8, 0)
    files["png_gray16.png"] = png(g16, 16, 0)
    files["png_gray8_trns.png"] = png(g8, 8, 0, pre=[chunk(b"tRNS", struct.pack(">H", 40))])
    files["png_gray2_trns.png"] = png(g8 >> 6, 2, 0, pre=[chunk(b"tRNS", struct.pack(">H", 1))])
    files["png_gray16_trns.png"] = png(g16, 16, 0, pre=[chunk(b"tRNS", struct.pack(">H", 1000))])
    files["png_gray_alpha8.png"] = png(np.stack([g8, alpha], -1), 8, 4)
    files["png_gray_alpha16.png"] = png(np.stack([g16, alpha * 257], -1), 16, 4)
    files["png_rgb8.png"] = png(rgb, 8, 2)
    files["png_rgb16.png"] = png(rgb16, 16, 2)
    files["png_rgb8_trns.png"] = png(rgb, 8, 2, pre=[chunk(b"tRNS", struct.pack(">HHH", 10, 20, 30))])
    files["png_rgba8.png"] = png(np.concatenate([rgb, alpha[..., None]], -1), 8, 6)
    files["png_rgba16.png"] = png(np.concatenate([rgb16, alpha[..., None] * 257], -1), 16, 6)
    files["png_rgb8_gray_pixels.png"] = png(np.repeat(g8[..., None], 3, -1), 8, 2)
    # Palettes: from the texture's colours, at 1, 2, 4 and 8 bits.
    for depth in (1, 2, 4, 8):
        n = 1 << depth
        pal = rng.integers(0, 256, (n, 3))
        idx = rng.integers(0, n, g8.shape)
        plte = chunk(b"PLTE", bytes(pal.astype(np.uint8).reshape(-1)))
        files[f"png_palette{depth}.png"] = png(idx, depth, 3, pre=[plte])
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    idx = rng.integers(0, 256, g8.shape)
    plte = chunk(b"PLTE", bytes(pal.reshape(-1)))
    trns = chunk(b"tRNS", bytes(rng.integers(0, 256, 200).astype(np.uint8)))
    files["png_palette8_trns.png"] = png(idx, 8, 3, pre=[plte, trns])
    files["png_palette8_short_plte.png"] = png(idx, 8, 3, pre=[chunk(b"PLTE", bytes(pal[:100].reshape(-1)))])
    files["png_palette8_gamma.png"] = png(idx, 8, 3, pre=[gama, plte])
    # Gamma: libpng mixes colour in linear light when the file's gamma is significant.
    files["png_rgb8_gamma.png"] = png(rgb, 8, 2, pre=[gama])
    files["png_rgb8_srgb.png"] = png(rgb, 8, 2, pre=[chunk(b"sRGB", b"\x00")])
    files["png_rgb8_gamma_1.png"] = png(rgb, 8, 2, pre=[chunk(b"gAMA", struct.pack(">I", 100000))])
    files["png_rgb8_gamma_after_plte.png"] = png(rgb, 8, 2, pre=[
        chunk(b"PLTE", bytes(pal[:16].reshape(-1))), gama])
    files["png_rgb8_gamma_bad_crc.png"] = png(rgb, 8, 2, pre=[
        chunk(b"gAMA", struct.pack(">I", 45455), crc=1234)])
    files["png_rgba8_gamma.png"] = png(np.concatenate([rgb, alpha[..., None]], -1), 8, 6, pre=[gama])
    files["png_rgb16_gamma.png"] = png(rgb16, 16, 2, pre=[gama])
    files["png_rgb16_sbit_gamma.png"] = png(rgb16, 16, 2, pre=[chunk(b"sBIT", b"\x0a\x0a\x0a"), gama])
    files["png_rgb16_srgb.png"] = png(rgb16, 16, 2, pre=[chunk(b"sRGB", b"\x01")])
    # Filters, one type forced in every row, and zlib streams.
    for f in range(5):
        files[f"png_filter{f}.png"] = png(rgb, 8, 2, filters=lambda y, f=f: f)
    files["png_filter4_gray2.png"] = png(g8 >> 6, 2, 0, filters=lambda y: 4)
    files["png_zlib_stored.png"] = png(rgb, 8, 2, mode="stored")
    files["png_zlib_fixed.png"] = png(rgb, 8, 2, mode="fixed")
    files["png_zlib_window512.png"] = png(g8, 8, 0, wbits=9)
    files["png_split_idat.png"] = png(rgb, 8, 2, split=97)
    files["png_ancillary_bad_crc.png"] = png(g8, 8, 0, pre=[chunk(b"tEXt", b"k\x00v", crc=7)])
    files["png_trailing_chunks.png"] = png(g8, 8, 0, post=[chunk(b"tEXt", b"after\x00idat")])
    big = np.asarray(texture(120, 160, seed=6, noise=0.0), np.uint32)
    files["png_rgb8_160x120.png"] = png(big, 8, 2)
    # Files that libpng refuses, or reads as something other than the image.
    files["png_adam7.png"] = adam7(rgb, 8, 2)
    files["png_adam7_gray.png"] = adam7(g8, 8, 0)
    files["png_idat_bad_crc.png"] = png(g8, 8, 0, idat_crc=1)
    files["png_bad_adler.png"] = png(g8, 8, 0, adler=0x12345678)
    whole = files["png_rgb8.png"]
    files["png_truncated.png"] = whole[:len(whole) // 2]
    files["png_palette_no_plte.png"] = png(idx, 8, 3)
    return files


# ---------- PNM ----------

def pnm_files():
    rgb = texture(16, 24, seed=7)
    g = gray_of(rgb)
    return {
        "pnm_gray.pgm": b"P5\n24 16\n255\n" + g.tobytes(),
        "pnm_gray_comments_max200.pgm": b"P5\n# a comment\n24 # width\n16\n#\n200\n"
                                        + (g.astype(np.uint16) * 200 // 255).astype(np.uint8).tobytes(),
        "pnm_rgb.ppm": b"P6\n24 16\n255\n" + rgb.tobytes(),
        "pnm_rgb_comments_max100.ppm": b"P6 # colour\n24 16 # size\n100\n"
                                       + (rgb.astype(np.uint16) * 100 // 255).astype(np.uint8).tobytes(),
    }


def main():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from fastmatch_tpu.utils import imageio as jax_imageio

    huffman, smoke = jpeg_files(), smoke_jpegs()
    files = {**huffman, **png_files(), **pnm_files(), **smoke, **arith_files(huffman, smoke)}
    os.makedirs(OUT, exist_ok=True)
    for name in os.listdir(OUT):
        os.remove(os.path.join(OUT, name))
    refs = {}
    inv = np.float32(1.0) / np.float32(255.0)
    for name, data in sorted(files.items()):
        path = os.path.join(OUT, name)
        with open(path, "wb") as fh:
            fh.write(data)
        try:
            img = jax_imageio.load_gray(path)
        except IOError as e:
            refs[f"rc:{name}"] = np.int32(int(str(e).rsplit(" ", 1)[-1]))
            continue
        codes = np.round(img * 255).astype(np.uint8)
        if img.size > 160 * 120:
            refs[f"sha256:{name}"] = np.array(f"{img.shape[0]}x{img.shape[1]}:"
                                              + hashlib.sha256(img.tobytes()).hexdigest())
        elif np.array_equal(codes.astype(np.float32) * inv, img):
            refs[name] = codes
        else:
            refs[f"f32:{name}"] = img
    # libpng read row by row without interlace handling returns the Adam7
    # passes' rows, not the image: the port refuses these files.
    for interlaced, plain in (("png_adam7.png", "png_rgb8.png"),
                              ("png_adam7_gray.png", "png_gray8.png")):
        assert interlaced in refs and not np.array_equal(refs[interlaced], refs[plain])
    np.savez_compressed(os.path.join(OUT, "references.npz"), **refs)
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"{len(files)} files, {sum(k.startswith('rc:') for k in refs)} refused, "
          f"{total} bytes in {OUT}")


if __name__ == "__main__":
    main()
