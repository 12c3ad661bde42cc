"""Write the WebP corpus of the port's WebP tests and of chip_smoke.py
phase 18: files written by Pillow (`save(..., "WEBP")`), by this
machine's libwebp encoder through ctypes for the options Pillow does not
expose (the simple loop filter, token partitions, segments, sharpness,
sharp YUV, near-lossless, raw and filtered alpha), and by hand (VP8X
containers, animations whose first frame is smaller than the canvas, ALPH
chunks with each filter, truncated and corrupt cuts), and a
`manifest.json` with each file's SHA-256 and
- for the files the port reads, the SHA-256 of the JAX package's RGB
  decode (`mapping_tpu.data.loader.load_image`, Pillow's convert("RGB"))
  and its shape;
- for the files the port refuses, the cause its ValueError names, and
  whether the JAX package reads the file all the same (`jax_reads`, with
  its decode's SHA-256).

Run from the root of the repository, where Pillow (with WebP) and the
system's libwebp are installed:

    python tests/fixtures/webp_corpus/make_corpus.py
"""

import ctypes
import ctypes.util
import hashlib
import io
import json
import os
import struct
import sys
import warnings
from pathlib import Path

import numpy as np
from PIL import Image, features

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from mapping_tpu.data.loader import load_image  # noqa: E402


def tile(h, w, seed):
    """A tile-like picture: gradients, noise, a bright block and a few
    sharp edges (so that the lossy coder uses 4x4 modes and coefficients
    in every band)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([40 + 120 * x / max(w, 1), 60 + 100 * y / max(h, 1),
                    90 + 60 * np.sin(x / 5.0 + y / 7.0)], -1)
    img += rng.randint(0, 30, (h, w, 3))
    img[h // 4:h // 2 + 1, w // 3:w // 2 + 1] = rng.randint(170, 255, 3)
    img[(x + 2 * y) % 23 < 2] = 20
    return np.clip(img, 0, 255).astype(np.uint8)


def alpha_plane(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = 128 + 100 * np.cos(x / 6.0) * np.sin(y / 9.0) + rng.randint(0, 9,
                                                                  (h, w))
    a[: h // 3, : w // 3] = 255
    a[-(h // 4):, -(w // 4):] = 0
    return np.clip(a, 0, 255).astype(np.uint8)


def building_tile(side, seed):
    """A 300^2-style tile for chip_smoke.py phase 18's predict_on_dir: a
    smooth ground, faint noise and bright rectangles (small as lossless)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:side, 0:side]
    img = np.stack([60 + 40 * x / side, 70 + 30 * y / side,
                    np.full((side, side), 55.0)], -1)
    img += rng.randint(0, 3, (side, side, 3))
    for _ in range(rng.randint(3, 9)):
        bh, bw = rng.randint(20, 70, 2)
        y0, x0 = rng.randint(5, side - 75, 2)
        img[y0:y0 + bh, x0:x0 + bw] = rng.randint(170, 255, 3)
        img[y0:y0 + 2, x0:x0 + bw] -= 40
    return np.clip(img, 0, 255).astype(np.uint8)


def palette_tile(h, w, colours, seed):
    rng = np.random.RandomState(seed)
    palette = rng.randint(0, 256, (colours, 3)).astype(np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    index = ((x // 3 + y // 5) + rng.randint(0, 2, (h, w))) % colours
    return palette[index]


def pil(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


# ------------------------------------------------- the system's encoder

class _Config(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR")
                 else ctypes.c_int) for n in (
        "lossless quality method image_hint target_size target_PSNR "
        "segments sns_strength filter_strength filter_sharpness "
        "filter_type autofilter alpha_compression alpha_filtering "
        "alpha_quality pass show_compressed preprocessing partitions "
        "partition_limit emulate_jpeg_size thread_level low_memory "
        "near_lossless exact use_delta_palette use_sharp_yuv qmin "
        "qmax").split()]


class _Picture(ctypes.Structure):
    _fields_ = [
        ("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("y", ctypes.c_void_p), ("u", ctypes.c_void_p),
        ("v", ctypes.c_void_p), ("y_stride", ctypes.c_int),
        ("uv_stride", ctypes.c_int), ("a", ctypes.c_void_p),
        ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
        ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int),
        ("pad2", ctypes.c_uint32 * 3), ("writer", ctypes.c_void_p),
        ("custom_ptr", ctypes.c_void_p), ("extra_info_type", ctypes.c_int),
        ("extra_info", ctypes.c_void_p), ("stats", ctypes.c_void_p),
        ("error_code", ctypes.c_int), ("progress_hook", ctypes.c_void_p),
        ("user_data", ctypes.c_void_p), ("pad3", ctypes.c_uint32 * 3),
        ("pad4", ctypes.c_void_p), ("pad5", ctypes.c_void_p),
        ("pad6", ctypes.c_uint32 * 8), ("memory_", ctypes.c_void_p),
        ("memory_argb_", ctypes.c_void_p), ("pad7", ctypes.c_void_p * 2)]


class _Writer(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)),
                ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32)]


_ABI = 0x020F  # WEBP_ENCODER_ABI_VERSION of /usr/include/webp/encode.h


def libwebp(img, **options):
    """`img` (RGB or RGBA) encoded by the system's libwebp with WebPConfig
    `options` (the ones Pillow's save does not expose)."""
    lib = ctypes.CDLL(ctypes.util.find_library("webp"))
    config, pic, writer = _Config(), _Picture(), _Writer()
    assert lib.WebPConfigInitInternal(ctypes.byref(config), 0,
                                      ctypes.c_float(75.0), _ABI)
    for k, v in options.items():
        setattr(config, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(config)), options
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), _ABI)
    h, w, c = img.shape
    pic.width, pic.height = w, h
    pic.use_argb = int(bool(options.get("lossless")))
    buf = np.ascontiguousarray(img)
    importer = lib.WebPPictureImportRGBA if c == 4 else \
        lib.WebPPictureImportRGB
    assert importer(ctypes.byref(pic), buf.ctypes.data_as(ctypes.c_void_p),
                    w * c)
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p)
    pic.custom_ptr = ctypes.cast(ctypes.byref(writer), ctypes.c_void_p)
    ok = lib.WebPEncode(ctypes.byref(config), ctypes.byref(pic))
    data = ctypes.string_at(writer.mem, writer.size)
    lib.WebPPictureFree(ctypes.byref(pic))
    lib.WebPMemoryWriterClear(ctypes.byref(writer))
    assert ok, pic.error_code
    return data


# ------------------------------------------------------------ containers

def chunk(fourcc, payload):
    return fourcc + struct.pack("<I", len(payload)) + payload + \
        b"\x00" * (len(payload) & 1)


def riff(*chunks):
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def chunks(data):
    """{fourcc: payload} of a simple or VP8X file (first of each)."""
    out, pos = {}, 12
    while pos + 8 <= len(data):
        fourcc, size = data[pos:pos + 4], struct.unpack_from("<I", data,
                                                             pos + 4)[0]
        out.setdefault(fourcc, data[pos + 8:pos + 8 + size])
        pos += 8 + size + (size & 1)
    return out


def vp8x(flags, w, h):
    return chunk(b"VP8X", bytes([flags, 0, 0, 0])
                 + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little"))


def anmf(x, y, w, h, payload_chunks, duration=100, bits=0):
    return chunk(b"ANMF", (x // 2).to_bytes(3, "little")
                 + (y // 2).to_bytes(3, "little")
                 + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little")
                 + duration.to_bytes(3, "little") + bytes([bits])
                 + b"".join(payload_chunks))


def forward_filter(a, kind):
    """libwebp's alpha filters (filters.c), forward: deltas the decoder's
    unfilter turns back into `a` (0 none, 1 horizontal, 2 vertical, 3
    gradient)."""
    a = a.astype(np.int32)
    h, w = a.shape
    out = np.empty_like(a)
    for y in range(h):
        for x in range(w):
            if kind == 0:
                pred = 0
            elif y == 0:
                pred = a[0, x - 1] if x else 0
            elif x == 0:
                pred = a[y - 1, 0]
            elif kind == 1:
                pred = a[y, x - 1]
            elif kind == 2:
                pred = a[y - 1, x]
            else:
                pred = min(255, max(0, a[y, x - 1] + a[y - 1, x]
                                   - a[y - 1, x - 1]))
            out[y, x] = (a[y, x] - pred) & 0xFF
    return out.astype(np.uint8)


def alph(a, kind, compressed, pre=0):
    """An ALPH payload: header byte, then the filtered plane raw or as a
    headerless VP8L stream (a lossless image whose green is the plane,
    its 5-byte header dropped)."""
    deltas = forward_filter(a, kind)
    head = bytes([int(compressed) | kind << 2 | pre << 4])
    if not compressed:
        return head + deltas.tobytes()
    green = np.zeros(a.shape + (3,), np.uint8)
    green[..., 1] = deltas
    stream = chunks(pil(green, lossless=True, quality=100, method=6))[b"VP8L"]
    return head + stream[5:]


def payload_cut(data, frac):
    """`data` with its last chunk's payload cut to `frac` of its length,
    the chunk's and the RIFF's sizes fixed up: the bitstream runs out."""
    pos = last = 12
    while pos + 8 <= len(data):
        last = pos
        size = struct.unpack_from("<I", data, pos + 4)[0]
        pos += 8 + size + (size & 1)
    size = struct.unpack_from("<I", data, last + 4)[0]
    n = int(size * frac)
    out = bytearray(data[:last + 8 + n] + b"\0" * (n & 1))
    out[last + 4:last + 8] = struct.pack("<I", n)
    out[4:8] = struct.pack("<I", len(out) - 8)
    return bytes(out)


def lossy_with_alpha(img, a, kind, compressed, pre=0, flags=0x10):
    return riff(vp8x(flags, img.shape[1], img.shape[0]),
                chunk(b"ALPH", alph(a, kind, compressed, pre)),
                chunk(b"VP8 ", chunks(pil(img, quality=80))[b"VP8 "]))


# ------------------------------------------------------------------ cases

def _cases():
    """(name, bytes, refused cause or None)."""
    t300 = tile(300, 300, 1)
    odd = tile(299, 301, 2)
    mid = tile(99, 101, 2)  # odd sizes, for the option variants
    small = tile(33, 17, 3)
    for q in (5, 50, 75, 100):
        yield f"lossy_q{q}_300.webp", pil(t300, quality=q), None
    yield "lossy_q95_300.webp", pil(t300, quality=95), None
    yield "lossy_q75_m0_300.webp", pil(t300, quality=75, method=0), None
    yield "lossy_q75_m6_300.webp", pil(t300, quality=75, method=6), None
    yield "lossy_q95_301x299.webp", pil(odd, quality=95), None
    yield "lossy_17x33.webp", pil(small, quality=80), None
    yield "lossy_1x1.webp", pil(tile(1, 1, 4), quality=80), None
    yield "lossy_2x3.webp", pil(tile(3, 2, 5), quality=90), None
    lossy_opts = {
        "simple_filter": dict(filter_type=0, filter_strength=70),
        "simple_filter_sharp5": dict(filter_type=0, filter_strength=40,
                                     filter_sharpness=5),
        "strong_filter_sharp3": dict(filter_type=1, filter_strength=90,
                                     filter_sharpness=3),
        "strong_filter_sharp7": dict(filter_type=1, filter_strength=100,
                                     filter_sharpness=7),
        "no_filter": dict(filter_strength=0, autofilter=0),
        "partitions2": dict(partitions=1),
        "partitions4": dict(partitions=2),
        "partitions8": dict(partitions=3, quality=90),
        "segments1": dict(segments=1),
        "segments2": dict(segments=2, sns_strength=100),
        "segments4_sns100": dict(segments=4, sns_strength=100, quality=40),
        "sharp_yuv": dict(use_sharp_yuv=1),
        "dithered": dict(preprocessing=4, quality=30),
        "q0_m0": dict(quality=0.0, method=0),
    }
    for name, opts in lossy_opts.items():
        yield f"lossy_{name}.webp", libwebp(t300 if "partitions" in name
                                            else mid, **opts), None
    # chip_smoke.py phase 18's predict_on_dir tiles
    for i in range(8):
        yield f"tile300_lossy_{i}.webp", pil(
            building_tile(300, 100 + i), quality=(60, 75, 85, 95)[i % 4],
            method=(0, 4, 6)[i % 3]), None
        yield f"tile300_lossless_{i}.webp", pil(building_tile(300, 200 + i),
                                                lossless=True), None
    # lossless
    yield "lossless_300.webp", pil(t300, lossless=True), None
    yield "lossless_q0_m0_99x101.webp", pil(mid, lossless=True, quality=0,
                                            method=0), None
    yield "lossless_q100_m6_99x101.webp", pil(mid, lossless=True,
                                              quality=100, method=6), None
    yield "lossless_17x33.webp", pil(small, lossless=True), None
    yield "lossless_1x1.webp", pil(tile(1, 1, 6), lossless=True), None
    for colours in (2, 4, 16, 256):
        yield f"lossless_palette{colours}.webp", pil(
            palette_tile(45, 61, colours, colours), lossless=True), None
    yield "lossless_near60.webp", libwebp(mid, lossless=1, near_lossless=60,
                                          quality=80), None
    yield "lossless_rgba_exact.webp", pil(
        np.dstack([mid, alpha_plane(99, 101, 7)]), lossless=True,
        exact=True), None
    yield "lossless_rgba.webp", pil(np.dstack([small, alpha_plane(33, 17,
                                                                  8)]),
                                    lossless=True), None
    # lossy with alpha
    rgba = np.dstack([mid, alpha_plane(99, 101, 9)])
    yield "alpha_pil_q100.webp", pil(rgba, quality=80, alpha_quality=100), \
        None
    yield "alpha_pil_q40.webp", pil(rgba, quality=80, alpha_quality=40), None
    for f in (0, 1, 2):
        yield f"alpha_libwebp_filtering{f}.webp", libwebp(
            rgba, alpha_filtering=f, alpha_quality=100), None
    yield "alpha_libwebp_raw.webp", libwebp(rgba, alpha_compression=0), None
    a = alpha_plane(33, 17, 10)
    for kind in range(4):
        for compressed in (False, True):
            yield (f"alpha_{['none', 'horizontal', 'vertical', 'gradient'][kind]}"
                   f"_{'lossless' if compressed else 'raw'}.webp",
                   lossy_with_alpha(small, a, kind, compressed), None)
    yield "alpha_preprocessed_bit.webp", lossy_with_alpha(small, a, 3, True,
                                                          pre=1), None
    # VP8X with metadata
    exif = Image.Exif()
    exif[0x0112] = 6  # Orientation: rotate 90 (not applied to a WebP)
    yield "vp8x_icc_exif_xmp.webp", pil(t300, quality=80,
                                        icc_profile=b"\0" * 140,
                                        exif=exif.tobytes(),
                                        xmp=b"<x:xmpmeta/>"), None
    yield "vp8x_lossless_exif.webp", pil(small, lossless=True,
                                         exif=exif.tobytes()), None
    vp8 = chunks(pil(small, quality=80))[b"VP8 "]
    vp8l = chunks(pil(small, lossless=True))[b"VP8L"]
    yield "vp8x_unknown_chunk.webp", riff(vp8x(0, 17, 33),
                                          chunk(b"ZZZZ", b"abc"),
                                          chunk(b"VP8 ", vp8),
                                          chunk(b"META", b"12345")), None
    # animations: Pillow's encoder, and hand-built first frames that do
    # not fill the canvas
    frames = [Image.fromarray(tile(64, 80, s)) for s in (11, 12)]
    for kind, kw in (("lossy", dict(quality=80)), ("lossless",
                                                   dict(lossless=True))):
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True,
                       append_images=frames[1:], duration=100, **kw)
        yield f"anim_two_frames_{kind}.webp", buf.getvalue(), None
    anim = chunk(b"ANIM", struct.pack("<IH", 0xFF336699, 0))
    big = chunks(pil(tile(40, 50, 13), quality=80))[b"VP8 "]
    yield "anim_small_first_frame_vp8.webp", riff(
        vp8x(0x02, 60, 70), anim, anmf(6, 10, 17, 33, [chunk(b"VP8 ", vp8)]),
        anmf(0, 0, 50, 40, [chunk(b"VP8 ", big)])), None
    yield "anim_small_first_frame_vp8l.webp", riff(
        vp8x(0x02, 40, 50), anim, anmf(20, 14, 17, 33,
                                       [chunk(b"VP8L", vp8l)])), None
    yield "anim_small_first_frame_alpha.webp", riff(
        vp8x(0x12, 30, 40), anim,
        anmf(4, 2, 17, 33, [chunk(b"ALPH", alph(a, 2, True)),
                            chunk(b"VP8 ", vp8)])), None
    yield "anim_frame_outside_canvas.webp", riff(
        vp8x(0x02, 20, 30), anim, anmf(4, 0, 17, 33,
                                       [chunk(b"VP8 ", vp8)])), \
        "animation frame outside its canvas"
    # containers either package refuses
    lossy = pil(t300, quality=75)
    lossless = pil(small, lossless=True)
    alpha = lossy_with_alpha(small, a, 1, True)
    for frac in (0.05, 0.5, 0.95):
        for name, data in (("lossy", lossy), ("lossless", lossless),
                           ("alpha", alpha)):
            yield (f"cut_{name}_{int(frac * 100)}.webp",
                   data[:int(len(data) * frac)],
                   "truncated WebP file" if len(data) * frac >= 20
                   else "first chunk is not VP8")
    # the bitstream itself cut, the container's sizes made to agree
    for name, data, fracs in (("lossy", lossy, (0.5, 0.9)),
                              ("lossless", lossless, (0.5, 0.9)),
                              ("alpha", alpha, (0.6,))):
        for frac in fracs:
            yield (f"cut_stream_{name}_{int(frac * 100)}.webp",
                   payload_cut(data, frac), None)
    yield "riff_size_short.webp", lossy[:4] + struct.pack(
        "<I", len(lossy) - 8 - 100) + lossy[8:], "past the RIFF size"
    yield "trailing_bytes.webp", lossy + b"junk" * 100, None
    stray = bytearray(riff(vp8x(0, 17, 33), chunk(b"VP8 ", vp8)) + b"xyz")
    stray[4:8] = struct.pack("<I", len(stray) - 8)
    yield "stray_bytes_after_chunks.webp", bytes(stray), "stray bytes"
    yield "first_chunk_iccp.webp", riff(chunk(b"ICCP", b"\0" * 20),
                                        chunk(b"VP8 ", vp8)), \
        "first chunk is not VP8"
    yield "vp8x_unknown_flag.webp", riff(vp8x(0x01, 17, 33),
                                         chunk(b"VP8 ", vp8)), \
        "unknown VP8X flag bits"
    yield "vp8x_wrong_canvas.webp", riff(vp8x(0, 18, 33),
                                         chunk(b"VP8 ", vp8)), "canvas"
    yield "alph_before_vp8l.webp", riff(vp8x(0x10, 17, 33),
                                        chunk(b"ALPH", alph(a, 0, False)),
                                        chunk(b"VP8L", vp8l)), \
        "ALPH chunk before a VP8L"
    bad_alph = b"\xc1" + alph(a, 0, False)[1:]  # reserved bits set
    yield "alph_reserved_bits.webp", riff(
        vp8x(0x10, 17, 33), chunk(b"ALPH", bad_alph),
        chunk(b"VP8 ", vp8)), "ALPH header"
    yield "alph_ignored_without_flag.webp", riff(
        vp8x(0x00, 17, 33), chunk(b"ALPH", bad_alph),
        chunk(b"VP8 ", vp8)), None
    yield "alph_raw_short.webp", riff(
        vp8x(0x10, 17, 33), chunk(b"ALPH", alph(a, 0, False)[:-5]),
        chunk(b"VP8 ", vp8)), "ALPH data: data cut short"
    inter = bytearray(vp8)
    inter[0] |= 1
    yield "vp8_interframe.webp", riff(chunk(b"VP8 ", bytes(inter))), \
        "not a key frame"
    hidden = bytearray(vp8)
    hidden[0] &= ~0x10
    yield "vp8_not_shown.webp", riff(chunk(b"VP8 ", bytes(hidden))), \
        "not shown"
    version = bytearray(vp8l)
    version[4] |= 0x20
    yield "vp8l_version1.webp", riff(chunk(b"VP8L", bytes(version))), \
        "VP8L header"
    huge = bytearray(vp8[:40])
    huge[0:3] = ((20 << 5) | 0x10).to_bytes(3, "little")  # shown, key frame
    huge[6:10] = struct.pack("<HH", 16383, 16383)
    yield "header_16383x16383.webp", riff(chunk(b"VP8 ", bytes(huge))), \
        "implausible image size"
    # corrupt bitstreams of the right length
    rng = np.random.RandomState(14)
    for name, data, at in (("lossy", lossy, (0.3, 0.6)),
                           ("lossless", pil(mid, lossless=True), (0.2,
                                                                  0.7)),
                           ("lossless_small", lossless, (0.4, 0.8)),
                           ("alpha", alpha, (0.1, 0.3))):
        for frac in at:
            cut = bytearray(data)
            pos = int(len(cut) * frac)
            cut[pos:pos + 4] = bytes(rng.randint(0, 256, 4).astype(np.uint8))
            yield f"corrupt_{name}_{int(frac * 100)}.webp", bytes(cut), None


def _digest(rgb):
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def main():
    warnings.simplefilter("ignore")
    import PIL

    from mapping_tpu_torch.utils import webp

    oracle = f"Pillow {PIL.__version__} (libwebp {features.version('webp')})"
    manifest = {}
    for old in HERE.glob("*.webp"):
        old.unlink()
    for name, data, refused in _cases():
        path = HERE / name
        path.write_bytes(data)
        entry = {"sha256": hashlib.sha256(data).hexdigest()}
        try:
            rgb = load_image(str(path))
        except Exception:  # the JAX package does not read it either
            rgb = None
        try:
            webp.decode(data)
            port_refuses = None
        except ValueError as e:
            port_refuses = str(e)
        if refused is None and port_refuses is not None:
            # a corrupt cut the port refuses: record it by its cause
            refused = port_refuses
        if refused:
            entry["refused"] = refused
            if rgb is not None:
                entry["jax_reads"] = _digest(rgb)
        else:
            entry.update(shape=list(rgb.shape), decode_sha256=_digest(rgb),
                         oracle=oracle)
        manifest[name] = entry
    with open(HERE / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(HERE / n) for n in manifest)
    print(f"{len(manifest)} files, {total} bytes")


if __name__ == "__main__":
    main()
