"""TIFF tiles as the JAX package's loader reads them, and a small writer for
fixtures.

The JAX loader reads a file that libjpeg and libpng decline through Pillow
(`mapping_tpu/data/loader.py` `load_image`: `Image.open(path).convert("RGB")`),
which reads an uncompressed TIFF with its own unpackers and hands a
compressed one to libtiff. `decode` gives the same (H, W, 3) uint8 RGB byte
for byte, without either library:

- classic TIFF and BigTIFF, either byte order; the first IFD only (later
  pages are ignored, as Pillow's `open` ignores them); unknown tags (a
  GeoTIFF's among them) are skipped;
- strips and tiles (tiles are decoded whole and clipped at the right and
  bottom edges), PlanarConfiguration 1 and 2, FillOrder 1 and 2 (the bits
  of every stored byte reversed before the decode);
- compression none (1), LZW (5), Deflate (8, 32946) and PackBits (32773):
  LZW and PackBits in host C++ (csrc/tiff_codecs.cpp, libtiff's decoders,
  the GIL released), Deflate through the standard library's zlib;
  predictor 2 (horizontal differencing, a wrapping cumulative sum along
  each row of each sample) at 8 and 16 bits after LZW or Deflate; libtiff
  ignores the Predictor tag on uncompressed and PackBits data, and so
  does this;
- the sample layouts of Pillow's `OPEN_INFO` that convert("RGB") reads as
  below (probed against Pillow 12.1.0 with libtiff 4.7.1):
  - MinIsBlack and MinIsWhite grey at 1, 2, 4 and 8 bits, scaled to 0-255
    (x 255, 85, 17), MinIsWhite inverted (255 - v); signed 8-bit grey
    (SampleFormat 2) read as its unsigned bytes, as Pillow reads it;
  - 16-bit grey (little-endian MinIsBlack or MinIsWhite, big-endian
    MinIsBlack; never inverted, Pillow's "I;16"), clipped at 255;
  - grey with unassociated alpha (8 bits): the grey;
  - RGB at 8 bits with 0, 1, 2 or 3 extra samples, and at 16 bits with 0
    or 1 (16-bit samples give their high byte): unspecified or
    unassociated extras dropped; associated alpha (ExtraSamples 1)
    un-premultiplied as Pillow's "RGBa" unpacker does, c = min(255,
    c * 255 // a) and 0 where a = 0 (on the high bytes at 16 bits);
  - palette at 1, 2, 4 and 8 bits (and 8 bits with one unspecified or
    unassociated extra sample), the 16-bit colormap cut to its high byte
    (Pillow's b // 256).
- the Orientation tag applied last, as Pillow's loader applies it
  (ImageOps.exif_transpose): mirrored, rotated or transposed;
- JPEG (7), as libtiff's JPEG codec reads it for Pillow: each strip or
  tile an abbreviated JPEG stream read with the file's JPEGTables, its
  colour space the Photometric's whatever JFIF or Adobe markers say
  (YCbCr (6), 3 samples, converted to RGB by libjpeg as Pillow asks with
  JPEGCOLORMODE_RGB; RGB (2) and grey (1, and MinIsWhite 0, inverted by
  Pillow) passed through), component 0 sampled as YCbCrSubsampling says
  (without the tag, as the first stream's frame says where libtiff's
  JPEGFixupTagsSubsampling can tell, else 2x2) and every other 1x1, every
  strip or tile coded at its own size, but a last strip coded taller,
  whose top rows are kept; FillOrder ignored (libtiff's TIFF_NOBITREV).
  `decode` gives such a file's host half, `JpegTiles`: the entropy decode
  of each stream (utils/jpeg), whose pixel stage `native_decode.assemble`
  runs for a whole batch, one `jpeg_pixels` launch per geometry on a card.
  A lossless (SOF3) strip or tile decodes wholly on the host
  (`jpeg.read`, the end of its data a fake EOI as libtiff gives it) and is
  pasted beside the others; with YCbCr (6) it is refused, as libjpeg
  converts no colour in lossless mode and libtiff fails.

Refused with a ValueError that names the feature: the compressions
old-style JPEG (6), CCITT (2, 3, 4), LZMA, ZSTD, WebP and any other;
old-style LZW; predictor 3 and predictor 2 below 8 bits; floating-point
samples and signed ones but 8-bit grey; YCbCr but with JPEG, CMYK, CIELab
and any other photometric; 12- and 32-bit samples; JPEG with planar data
(Pillow reads planar RGB; libtiff reads planar YCbCr another way), other
than 8-bit samples, extra samples, sampling factors other than the TIFF's
or a strip or tile coded at another size (libtiff leaves rows of its
buffer in the image for a stream coded shorter); any other layout (which
Pillow, and so the JAX loader, refuses too); a header over
`jpeg.MAX_PIXELS` pixels, before anything is allocated; data cut short.

`encode` writes the kinds the fixtures need, JPEG among them, so that the
card's machine (which has no Pillow) can make TIFF tiles; nothing on the
serving or training path writes TIFF.
"""

import ctypes
import struct
import zlib
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from mapping_tpu_torch.kernels.build import CSRC
from mapping_tpu_torch.utils import jpeg
from mapping_tpu_torch.utils.jpeg import MAX_PIXELS
from mapping_tpu_torch.utils.native_lib import NativeLib

MAGIC = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")

# tags
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILL_ORDER, STRIP_OFFSETS, SAMPLES, ROWS_PER_STRIP = 266, 273, 277, 278
STRIP_COUNTS, PLANAR, PREDICTOR, COLORMAP = 279, 284, 317, 320
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT, ORIENTATION = 338, 339, 274
JPEG_TABLES, YCBCR_SUBSAMPLING = 347, 530
_READ = {WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER,
         STRIP_OFFSETS, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS, PLANAR,
         PREDICTOR, COLORMAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS,
         TILE_COUNTS, EXTRA_SAMPLES, SAMPLE_FORMAT, ORIENTATION,
         JPEG_TABLES, YCBCR_SUBSAMPLING}

#: field type -> struct code (integer types, and UNDEFINED bytes for
#: JPEGTables; the other tags read are all integers)
_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 16: "Q",
          17: "q", 13: "I", 18: "Q"}
#: field type -> bytes a value (to skip the others)
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
          11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}

#: none, LZW, Deflate (two codes), PackBits and JPEG
COMPRESSIONS = (1, 5, 8, 32946, 32773, 7)
_REFUSED_COMPRESSIONS = {
    2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
    6: "old-style JPEG", 32809: "ThunderScan",
    34676: "SGILog", 34677: "SGILog24", 34925: "LZMA", 50000: "ZSTD",
    50001: "WebP"}
_REFUSED_PHOTOMETRICS = {4: "transparency mask", 5: "CMYK", 6: "YCbCr",
                         8: "CIELab", 9: "ICCLab", 10: "ITULab",
                         32844: "LogL", 32845: "LogLuv"}


def _register(lib):
    ptr = ctypes.c_void_p
    for name in ("tiff_lzw_decode", "tiff_packbits_decode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr, ctypes.c_long, ptr, ctypes.c_long]


_lib = NativeLib("tiff_codecs.cpp", "tiff_codecs", _register, src_dir=CSRC)
load = _lib.load


def _native(name, src: bytes, want: int) -> np.ndarray:
    out = np.empty(want, np.uint8)
    buf = np.frombuffer(src, np.uint8)
    rc = getattr(load(), name)(buf.ctypes.data, len(src), out.ctypes.data,
                               want)
    if rc:
        raise ValueError(f"corrupt or short {name.split('_')[1]} data "
                         f"(code {rc})")
    return out


def lzw_decode(src: bytes, want: int) -> np.ndarray:
    """`want` bytes of a TIFF LZW stream (csrc/tiff_codecs.cpp)."""
    return _native("tiff_lzw_decode", src, want)


def packbits_decode(src: bytes, want: int) -> np.ndarray:
    """`want` bytes of a PackBits stream (csrc/tiff_codecs.cpp)."""
    return _native("tiff_packbits_decode", src, want)


# ------------------------------------------------- plain decoders (oracles)

def lzw_decode_plain(src: bytes, want: int) -> np.ndarray:
    """`lzw_decode` in plain Python, the C++ decoder's test oracle (see
    csrc/tiff_codecs.cpp for the rules)."""
    table = [bytes([c]) for c in range(256)] + [b"", b""]
    out = bytearray()
    pos = bits = data = 0
    width, prev = 9, None

    def read():
        nonlocal pos, bits, data
        while bits < width:
            if pos >= len(src):
                return None
            data = ((data << 8) | src[pos]) & 0xFFFFFFFF
            pos += 1
            bits += 8
        bits -= width
        return (data >> bits) & ((1 << width) - 1)

    while len(out) < want:
        code = read()
        if code is None or code == 257:
            break
        if code == 256:
            while code == 256:
                del table[258:]
                width = 9
                code = read()
            if code is None or code == 257:
                break
            if code > 256:
                raise ValueError("corrupt LZW data (code -1)")
            out += table[code]
            prev = code
            continue
        if prev is None:
            raise ValueError("corrupt LZW data (code -1)")
        if code > len(table):
            raise ValueError("corrupt LZW data (code -2)")
        if len(table) >= 4096 + 1024:
            raise ValueError("corrupt LZW data (code -3)")
        first = table[code][:1] if code < len(table) else table[prev][:1]
        table.append(table[prev] + first)
        if len(table) > (1 << width) - 2 and width < 12:
            width += 1
        out += table[code]
        prev = code
    if len(out) < want:
        raise ValueError("corrupt or short LZW data (code -4)")
    return np.frombuffer(bytes(out[:want]), np.uint8)


def packbits_decode_plain(src: bytes, want: int) -> np.ndarray:
    """`packbits_decode` in plain Python, the C++ decoder's test oracle."""
    out = bytearray()
    pos = 0
    while pos < len(src) and len(out) < want:
        n = src[pos] - 256 if src[pos] > 127 else src[pos]
        pos += 1
        if n == -128:
            continue
        if n < 0:
            if pos >= len(src):
                break
            out += src[pos:pos + 1] * min(1 - n, want - len(out))
            pos += 1
        else:
            run = min(n + 1, want - len(out))
            if len(src) - pos < run:
                break
            out += src[pos:pos + run]
            pos += run
    if len(out) < want:
        raise ValueError("corrupt or short PackBits data (code -4)")
    return np.frombuffer(bytes(out), np.uint8)


# ---------------------------------------------------------------- reading

def is_tiff(data: bytes) -> bool:
    return bytes(data[:4]) in MAGIC


def _ifd(data: bytes) -> Tuple[str, Dict[int, tuple]]:
    """(byte order "<" or ">", {tag: values}) of the first IFD, the
    integer tags this module reads."""
    order = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\x00", b"\x00+")
    if big and order == ">":  # Pillow 12.1.0 takes it for a classic TIFF
        raise ValueError("big-endian BigTIFF is not one the JAX loader's "
                         "Pillow reads")
    try:
        if big:
            size, zero, first = struct.unpack(order + "HHQ", data[4:16])
            if size != 8 or zero:
                raise ValueError("bad BigTIFF header")
            count, = struct.unpack(order + "Q", data[first:first + 8])
            entry, at, inline = 20, first + 8, 8
        else:
            first, = struct.unpack(order + "I", data[4:8])
            count, = struct.unpack(order + "H", data[first:first + 2])
            entry, at, inline = 12, first + 2, 4
    except struct.error as e:
        raise ValueError("truncated TIFF header") from e
    if at + count * entry > len(data):
        raise ValueError("truncated TIFF directory")
    tags = {}
    word = "Q" if big else "I"
    for k in range(count):
        head = at + k * entry
        tag, kind, n = struct.unpack(order + "HH" + word,
                                     data[head:head + 4 + inline])
        if tag not in _READ or tag in tags:
            continue
        if kind not in _TYPES:
            raise ValueError(f"TIFF tag {tag} of type {kind}")
        nbytes = n * _SIZES[kind]
        where = head + 4 + inline
        if nbytes > inline:
            where, = struct.unpack(order + word, data[where:where + inline])
        if where + nbytes > len(data):
            raise ValueError(f"truncated TIFF tag {tag}")
        tags[tag] = struct.unpack(f"{order}{n}{_TYPES[kind]}",
                                  data[where:where + nbytes])
    return order, tags


def _one(tags, tag, default):
    values = tags.get(tag)
    return values[0] if values else default


#: (photometric, bits, extra samples) -> how the samples become RGB, for
#: the layouts of Pillow's OPEN_INFO this module reads
_LAYOUTS = {}
for _b in (1, 2, 4, 8):
    _LAYOUTS[(0, (_b,), ())] = ("grey", True)
    _LAYOUTS[(1, (_b,), ())] = ("grey", False)
    _LAYOUTS[(3, (_b,), ())] = ("palette", None)
_LAYOUTS[(1, (8, 8), (2,))] = ("grey", False)
_LAYOUTS[(3, (8, 8), (0,))] = ("palette", None)
_LAYOUTS[(3, (8, 8), (2,))] = ("palette", None)
for _extra in ((), (0,), (1,), (2,), (999,), (0, 0), (1, 0), (2, 0),
               (0, 0, 0), (1, 0, 0), (2, 0, 0)):
    _LAYOUTS[(2, (8,) * (3 + len(_extra)), _extra)] = ("rgb",
                                                      _extra[:1] == (1,))
for _extra in ((), (0,), (1,), (2,)):
    _LAYOUTS[(2, (16,) * (3 + len(_extra)), _extra)] = ("rgb",
                                                       _extra == (1,))
for _b in (8, 16):  # RGBA without ExtraSamples
    _LAYOUTS[(2, (_b,) * 4, ())] = ("rgb", False)
_LAYOUTS[(0, (16,), ())] = ("grey", True)
_LAYOUTS[(1, (16,), ())] = ("grey", False)
#: fill order 2 exists in Pillow's table for these layouts only
_FILL2 = {(p, (b,), ()) for p in (0, 1, 3) for b in (1, 2, 4, 8)} | {
    (2, (8, 8, 8), ())}


def _bits(tags):
    """BitsPerSample, one a sample, as Pillow reads it against
    SamplesPerPixel."""
    bits = tags.get(BITS, (1,))
    spp = _one(tags, SAMPLES, 1)
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        raise ValueError("unknown TIFF data organization")
    return bits


def _layout(order, tags):
    """Pillow's key for the file (TiffImagePlugin._setup), checked: the
    layout's entry in `_LAYOUTS` and the bits, samples per pixel and
    photometric."""
    photo = _one(tags, PHOTOMETRIC, 0)
    fill = _one(tags, FILL_ORDER, 1)
    fmt = tags.get(SAMPLE_FORMAT, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    extra = tags.get(EXTRA_SAMPLES, ())
    if photo in _REFUSED_PHOTOMETRICS:
        raise ValueError(f"{_REFUSED_PHOTOMETRICS[photo]} TIFF is not "
                         f"supported by the port's reader")
    if photo not in (0, 1, 2, 3):
        raise ValueError(f"TIFF photometric {photo} is not supported by "
                         f"the port's reader")
    if 3 in fmt:
        raise ValueError("floating-point TIFF samples are not supported "
                         "by the port's reader")
    bits = _bits(tags)
    if max(bits) > 8 and max(bits) != 16 or min(bits) != max(bits):
        raise ValueError(f"{max(bits)}-bit TIFF samples are not supported "
                         f"by the port's reader" if min(bits) == max(bits)
                         else f"TIFF samples of mixed bits {bits}")
    key = (photo, bits, extra)
    signed = fmt == (2,)
    if signed and not (photo == 1 and bits == (8,) and extra == ()):
        raise ValueError("signed TIFF samples are not supported by the "
                         "port's reader")
    if fmt not in ((1,), (2,)) or key not in _LAYOUTS:
        raise ValueError(f"TIFF layout photometric {photo}, bits {bits}, "
                         f"extra samples {extra}, sample format {fmt} is "
                         f"not one the JAX loader's Pillow reads")
    if bits == (16,) and (order, photo) == (">", 0):
        raise ValueError("big-endian 16-bit MinIsWhite TIFF is not one "
                         "the JAX loader's Pillow reads")
    if fill == 2 and not (key in _FILL2 or (key, order) == (
            (1, (16,), ()), "<")) or fill not in (1, 2):
        raise ValueError(f"TIFF fill order {fill} with {key} is not one "
                         f"the JAX loader's Pillow reads")
    return key, _LAYOUTS[key], fill


#: the planar (PlanarConfiguration 2) layouts Pillow's libtiff path reads
#: right (probed): for RGB with an unspecified extra sample or none
#: declared, or five or six samples, it fails or gives other pixels
_LIBTIFF_PLANAR = {(2, (8,) * 3, ()), (2, (16,) * 3, ()), (1, (8, 8), (2,)),
                   (3, (8, 8), (2,)),
                   (2, (8,) * 4, (1,)), (2, (8,) * 4, (2,)),
                   (2, (8,) * 4, (999,)), (2, (16,) * 4, (1,)),
                   (2, (16,) * 4, (2,))}


def _raw_unpacker(photo, bits, extra, fill, planar):
    """Pillow reads an uncompressed TIFF with its own raw unpackers, and
    has none for some layouts that libtiff's path reads: fill order 2 of
    8-bit MinIsWhite grey and of 1-, 2- and 4-bit palettes; planar 2 (one
    unpacker a plane, by the rawmode's letter) of anything but 8-bit RGB
    with no extra sample or with alpha that is not associated."""
    if fill == 2 and (photo, bits) in ((0, (8,)), (3, (1,)), (3, (2,)),
                                       (3, (4,))):
        raise ValueError("uncompressed TIFF of fill order 2 with this "
                         "layout is not one the JAX loader's Pillow reads")
    if planar == 2 and len(bits) > 1 and not (
            photo == 2 and bits in ((8, 8, 8), (8,) * 4)
            and extra in ((), (2,), (999,))):
        raise ValueError("uncompressed planar TIFF with this layout is not "
                         "one the JAX loader's Pillow reads")


_REVERSED = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)],
                     np.uint8)


def _chunks(tags, h, w, spp, bits, planar):
    """Yield (plane, y0, x0, rows, columns, row bytes, offset, byte count
    or None, rows stored) of each strip or tile: rows x columns samples of
    one plane (planar 2) or all (planar 1); a tile stores all its rows, a
    strip only those in the image."""
    per = bits * (1 if planar == 2 else spp)  # bits a pixel in a chunk
    tiled = STRIP_OFFSETS not in tags
    if not tiled:
        offsets = tags[STRIP_OFFSETS]
        counts = tags.get(STRIP_COUNTS)
        rps = min(_one(tags, ROWS_PER_STRIP, h), h) or h
        cw, ch = w, rps
    elif TILE_OFFSETS in tags:
        offsets = tags[TILE_OFFSETS]
        counts = tags.get(TILE_COUNTS)
        cw, ch = _one(tags, TILE_WIDTH, 0), _one(tags, TILE_LENGTH, 0)
        if not (0 < cw and 0 < ch and cw * ch <= MAX_PIXELS):
            raise ValueError(f"implausible TIFF tile size {ch}x{cw}")
    else:
        raise ValueError("TIFF without strips or tiles")
    down, across = -(-h // ch), -(-w // cw)
    planes = spp if planar == 2 else 1
    if len(offsets) < planes * down * across:
        raise ValueError("TIFF with too few strips or tiles")
    if counts is not None and len(counts) < len(offsets):
        raise ValueError("TIFF with too few strip or tile byte counts")
    row_bytes = -(-cw * per // 8)
    k = 0
    for plane in range(planes):
        for y0 in range(0, h, ch):
            for x0 in range(0, w, cw):
                yield (plane, y0, x0, ch, cw, row_bytes, offsets[k],
                       None if counts is None else counts[k],
                       ch if tiled else min(ch, h - y0))
                k += 1


def _decompress(raw, compression, want, rows_needed, row_bytes):
    """The chunk's stored bytes -> its `want` bytes (the whole strip or
    tile), or for uncompressed data the rows the image needs."""
    if compression == 1:  # Pillow's raw unpacker reads only the rows used
        if len(raw) < rows_needed * row_bytes:
            raise ValueError("TIFF data cut short")
        return np.frombuffer(raw, np.uint8)
    if compression == 5:
        if raw[:2] == b"\x00\x01":
            raise ValueError("old-style LZW TIFF is not supported by the "
                             "port's reader")
        return lzw_decode(raw, want)
    if compression == 32773:
        return packbits_decode(raw, want)
    try:
        out = zlib.decompressobj().decompress(raw, want)
    except zlib.error as e:
        raise ValueError(f"corrupt Deflate TIFF data: {e}") from e
    if len(out) < want:
        raise ValueError("TIFF Deflate data cut short")
    return np.frombuffer(out, np.uint8)


def _samples(chunk, rows, cols, row_bytes, bits, n, order):
    """(rows, cols, n) sample values of a chunk's rows (uint8, or uint16
    at 16 bits)."""
    chunk = chunk[:rows * row_bytes].reshape(rows, row_bytes)
    if bits == 16:
        return chunk.view(order + "u2")[:, :cols * n].reshape(
            rows, cols, n).astype(np.uint16)
    if bits == 8:
        return chunk[:, :cols * n].reshape(rows, cols, n)
    unpacked = np.unpackbits(chunk, axis=1)[:, :cols * n * bits].reshape(
        rows, cols * n, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (unpacked * weights).sum(axis=2, dtype=np.uint8).reshape(
        rows, cols, n)


def _part_size(part):
    """(height, width) of a `jpeg.read` result."""
    if isinstance(part, np.ndarray):
        return part.shape[:2]
    return part.geometry.height, part.geometry.width


class JpegTiles(NamedTuple):
    """The host half of a JPEG-compressed TIFF: each strip's or tile's
    `jpeg.read` result at its top-left corner (y0, x0) (a DCT stream's
    `jpeg.Coefficients`, a lossless one's (h, w, 3) uint8 RGB), and what
    turns their pixels into the JAX loader's: the stored size (before
    Orientation), the Orientation, and whether the grey is MinIsWhite
    (inverted). `native_decode.assemble` runs the pixel stage of a
    batch's DCT parts, one call per geometry, then `paste`s them and the
    lossless parts, and `finish`es."""

    height: int
    width: int
    orientation: int
    invert: bool
    parts: Tuple[Tuple[int, int, object], ...]

    @property
    def size(self):
        """(H, W) of the image as read, after Orientation."""
        if self.orientation in (5, 6, 7, 8):
            return self.width, self.height
        return self.height, self.width

    def paste(self, canvas, positions, rgb):
        """Parts' RGB `rgb` (n, h, w, 3), at `positions` [(y0, x0)], into
        `canvas` (height, width, 3), clipped at its right and bottom edges;
        one copy where the parts make a whole block of the grid (the
        tiles of a file, its strips but a short last one)."""
        n, ph, pw = rgb.shape[:3]
        ys = sorted({y for y, _ in positions})
        xs = sorted({x for _, x in positions})
        if positions == [(y, x) for y in ys for x in xs] \
                and ys == list(range(ys[0], ys[0] + ph * len(ys), ph)) \
                and xs == list(range(xs[0], xs[0] + pw * len(xs), pw)):
            rgb = rgb.reshape(len(ys), len(xs), ph, pw, 3).permute(
                0, 2, 1, 3, 4).reshape(1, len(ys) * ph, len(xs) * pw, 3)
            positions = [(ys[0], xs[0])]
        for (y, x), part in zip(positions, rgb):
            rows = min(part.shape[0], self.height - y)
            cols = min(part.shape[1], self.width - x)
            canvas[y:y + rows, x:x + cols] = part[:rows, :cols]

    def finish(self, canvas):
        """The pasted (height, width, 3) uint8 tensor as the JAX loader
        reads the file: MinIsWhite inverted, then Orientation applied."""
        if self.invert:
            canvas = 255 - canvas
        if self.orientation in (5, 6, 7, 8):
            canvas = canvas.transpose(0, 1)
        rows, cols = _FLIPS.get(self.orientation, (False, False))
        dims = [d for d, flip in ((0, rows), (1, cols)) if flip]
        return canvas.flip(dims) if dims else canvas


#: the layouts of a JPEG-compressed TIFF the port reads -> the colour
#: space of its streams: libtiff has libjpeg convert YCbCr to RGB (Pillow
#: sets JPEGCOLORMODE_RGB) and passes the others' samples through
_JPEG_COLOURS = {(6, (8, 8, 8), ()): "ycc", (2, (8, 8, 8), ()): "rgb",
                 (1, (8,), ()): "gray", (0, (8,), ()): "gray"}


def _jpeg_layout(order, tags):
    """(layout key, colour) of a JPEG-compressed TIFF, checked as Pillow
    and libtiff check it."""
    photo = _one(tags, PHOTOMETRIC, 0)
    bits = _bits(tags)
    if set(bits) != {8}:
        raise ValueError(f"{max(bits)}-bit JPEG-compressed TIFF is not "
                         f"supported by the port's reader")
    if len(bits) > 1 and _one(tags, PLANAR, 1) != 1:
        raise ValueError("planar JPEG-compressed TIFF (PlanarConfiguration "
                         "2) is not supported by the port's reader")
    if photo == 6:  # Pillow's key: no fill order 2, unsigned samples
        key = (photo, bits, tags.get(EXTRA_SAMPLES, ()))
        if _one(tags, FILL_ORDER, 1) != 1 or set(tags.get(
                SAMPLE_FORMAT, (1,))) != {1}:
            raise ValueError("this YCbCr TIFF layout is not one the JAX "
                             "loader's Pillow reads")
    else:
        key = _layout(order, tags)[0]
    if key not in _JPEG_COLOURS:
        raise ValueError(f"JPEG-compressed TIFF of photometric {key[0]}, "
                         f"bits {key[1]}, extra samples {key[2]} is not "
                         f"supported by the port's reader")
    return key, _JPEG_COLOURS[key]


def _fixup_sampling(stream, spp):
    """libtiff's JPEGFixupTagsSubsampling, for a YCbCr file without a
    YCbCrSubsampling tag: component 0's sampling factors in the frame
    header of the first strip or tile, where every other component is
    1 x 1 and both factors are 1, 2 or 4; else the tag's default 2 x 2.
    The marker walk is libtiff's own (JPEGFixupTagsSubsamplingSec): bytes
    up to an 0xFF skipped, SOI, APPn, COM, DQT, DHT, DRI and SOS passed
    over, any other marker the end."""
    pos, n = 0, len(stream)
    while True:
        i = stream.find(b"\xff", pos)
        j = i + 1
        while 0 < j < n and stream[j] == 0xFF:
            j += 1
        if i < 0 or j >= n:
            return 2, 2
        marker, pos = stream[j], j + 1
        if marker == 0xD8:
            continue
        if marker in (0xC4, 0xDA, 0xDB, 0xDD, 0xFE) or 0xE0 <= marker <= 0xEF:
            length = int.from_bytes(stream[pos:pos + 2], "big")
            if pos + 2 > n or length < 2:
                return 2, 2
            pos += length
            continue
        if marker not in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
            return 2, 2
        body = stream[pos:pos + 8 + 3 * spp]
        if len(body) < 8 + 3 * spp or int.from_bytes(body[:2], "big") \
                != 8 + 3 * spp:
            return 2, 2
        h, v = body[9] >> 4, body[9] & 15
        if any(body[9 + 3 * k] != 0x11 for k in range(1, spp)) \
                or h not in (1, 2, 4) or v not in (1, 2, 4):
            return 2, 2
        return h, v


def _read_jpeg(data, order, tags, h, w):
    """The host half of a JPEG-compressed TIFF (compression 7)."""
    (photo, _, _), colour = _jpeg_layout(order, tags)
    tables = tags.get(JPEG_TABLES)
    tables = bytes(tables) if tables else None
    tiled = STRIP_OFFSETS not in tags
    parts = []
    sampling = (1, 1)
    for k, (_, y0, x0, _, cw, _, start, count, stored) in enumerate(
            _chunks(tags, h, w, 1, 8, 1)):
        if count is None:
            raise ValueError("compressed TIFF without byte counts")
        stream = data[start:start + count]
        if photo == 6 and k == 0:
            sampling = tags.get(YCBCR_SUBSAMPLING) or _fixup_sampling(
                stream, 3)
            if len(sampling) != 2:
                raise ValueError(f"TIFF YCbCrSubsampling {sampling}")
        # libtiff's JPEGPreDecode reads a last strip coded taller than the
        # image's rows, and keeps its top rows; every other strip or tile
        # must be coded at its own size
        last = not tiled and y0 + stored == h
        part = jpeg.read(
            stream, tables=tables, color=colour, sampling=sampling,
            size=None if last else (stored, cw), fake_eoi=True)
        ph, pw = _part_size(part)
        if last and (pw != cw or ph < stored):
            raise ValueError(f"JPEG strip or tile of {ph}x{pw} where the "
                             f"TIFF's is {stored}x{cw}")
        parts.append((y0, x0, part))
    return JpegTiles(h, w, _one(tags, ORIENTATION, 1), photo == 0,
                     tuple(parts))


def decode(data: bytes):
    """TIFF bytes -> (H, W, 3) uint8 RGB, the JAX loader's pixels (see the
    module's docstring); for a JPEG-compressed file its host half,
    `JpegTiles`, whose pixel stage `native_decode.assemble` runs."""
    data = bytes(data)
    if not is_tiff(data):
        raise ValueError("not a TIFF file")
    order, tags = _ifd(data)
    w, h = _one(tags, WIDTH, 0), _one(tags, HEIGHT, 0)
    if not (0 < h and 0 < w and h * w <= MAX_PIXELS):
        raise ValueError(f"implausible image size {h}x{w}")
    compression = _one(tags, COMPRESSION, 1)
    if compression not in COMPRESSIONS:
        name = _REFUSED_COMPRESSIONS.get(compression,
                                         f"compression {compression}")
        raise ValueError(f"{name}-compressed TIFF is not supported by the "
                         f"port's reader")
    if compression == 7:
        return _read_jpeg(data, order, tags, h, w)
    (photo, bits_all, extra), (kind, flag), fill = _layout(order, tags)
    spp, bits = len(bits_all), bits_all[0]
    planar = _one(tags, PLANAR, 1) if spp > 1 else 1
    if planar not in (1, 2):
        raise ValueError(f"TIFF planar configuration {planar}")
    predictor = _one(tags, PREDICTOR, 1) if compression in (5, 8, 32946) \
        else 1
    if predictor == 3:
        raise ValueError("floating-point predictor (3) TIFF is not "
                         "supported by the port's reader")
    if predictor == 2 and bits not in (8, 16):
        raise ValueError(f"TIFF predictor 2 at {bits} bits (libtiff "
                         f"refuses it)")
    if predictor not in (1, 2):
        raise ValueError(f"TIFF predictor {predictor}")
    if compression == 1:
        _raw_unpacker(photo, bits_all, extra, fill, planar)
    elif planar == 2 and (photo, bits_all, extra) not in _LIBTIFF_PLANAR:
        raise ValueError("planar TIFF with this layout is not one the JAX "
                         "loader's Pillow reads (its libtiff path gives "
                         "zeros or fails)")
    out = np.empty((h, w, spp), np.uint16 if bits == 16 else np.uint8)
    n = 1 if planar == 2 else spp
    for plane, y0, x0, ch, cw, row_bytes, start, count, stored in _chunks(
            tags, h, w, spp, bits, planar):
        rows = min(ch, h - y0)
        if compression == 1:  # Pillow's raw unpacker ignores the count
            count = rows * row_bytes
        elif count is None:
            raise ValueError("compressed TIFF without byte counts")
        raw = data[start:start + count]
        if fill == 2 and not (compression == 1 and planar == 2):
            # (Pillow's per-plane raw unpackers do not reverse the bits)
            raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
        chunk = _decompress(raw, compression, stored * row_bytes, rows,
                            row_bytes)
        s = _samples(chunk, rows, cw, row_bytes, bits, n, order)
        if predictor == 2:
            s = np.cumsum(s, axis=1, dtype=s.dtype)
        cols = min(cw, w - x0)
        out[y0:y0 + rows, x0:x0 + cols, plane:plane + n] = s[:, :cols]
    return _orient(_to_rgb(out, kind, flag, bits, tags),
                   _one(tags, ORIENTATION, 1))


#: Orientation -> (rows reversed, columns reversed), after the transpose
#: of 5-8
_FLIPS = {2: (False, True), 3: (True, True), 4: (True, False),
          6: (False, True), 7: (True, True), 8: (True, False)}


def _orient(rgb, orientation):
    """Pillow's ImageOps.exif_transpose, which its TIFF reader applies on
    load: Orientation 2-8 mirrored, rotated or transposed."""
    if orientation in (5, 6, 7, 8):
        rgb = rgb.transpose(1, 0, 2)
    rows, cols = _FLIPS.get(orientation, (False, False))
    return np.ascontiguousarray(rgb[::-1 if rows else 1,
                                    ::-1 if cols else 1])


def _to_rgb(s, kind, flag, bits, tags):
    if kind == "palette":
        cmap = np.asarray(tags.get(COLORMAP, ()), np.uint32)
        n = 1 << bits
        if cmap.size != 3 * n:
            raise ValueError("TIFF palette image without a colormap of "
                             f"{3 * n} entries")
        lut = (cmap.reshape(3, n).T // 256).astype(np.uint8)
        return lut[s[..., 0]]
    if kind == "grey":
        g = s[..., 0]
        if bits == 16:
            g = np.minimum(g, 255).astype(np.uint8)
        elif bits < 8:
            g = g * np.uint8(255 // ((1 << bits) - 1))
        if flag and bits != 16:  # MinIsWhite
            g = 255 - g
        return np.repeat(g[..., None], 3, axis=-1)
    rgb = s[..., :3]
    if bits == 16:
        rgb = (rgb >> 8).astype(np.uint8)
    if flag:  # associated alpha, un-premultiplied (Pillow's "RGBa")
        a = s[..., 3:4]
        a = (a >> 8).astype(np.int32) if bits == 16 else a.astype(np.int32)
        un = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 0, 0, un).astype(np.uint8)
    return np.ascontiguousarray(rgb)


# ---------------------------------------------------------------- writing

def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first, early change) of `data`, Clear first and EOI
    last; a Clear where the table reaches 4,094 entries."""
    out = bytearray()
    acc = nbits = 0
    width = 9

    def put(code):
        nonlocal acc, nbits
        acc = (acc << width) | code
        nbits += width
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1

    def _widen():
        # the decoder adds an entry on the code just written, and may
        # widen before it reads the Clear or EOI that follows
        nonlocal width
        if nxt + 1 > (1 << width) - 1 and width < 12:
            width += 1

    table = {bytes([c]): c for c in range(256)}
    put(256)
    nxt, w = 258, b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        if nxt >= 4094:
            _widen()
            put(256)
            table = {bytes([k]): k for k in range(256)}
            nxt, width = 258, 9
        else:
            table[wc] = nxt
            nxt += 1
            if nxt > (1 << width) - 1:
                width += 1
        w = bytes([c])
    if w:
        put(table[w])
        _widen()
    put(257)
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits of `data`: runs of 3 or more repeated bytes, literals
    else, at most 128 bytes a packet."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


_WRITERS = {"none": (1, bytes), "lzw": (5, lzw_encode),
            "deflate": (8, lambda b: zlib.compress(b, 6)),
            "adobe_deflate": (32946, lambda b: zlib.compress(b, 6)),
            "packbits": (32773, packbits_encode), "jpeg": (7, None)}
#: YCbCrSubsampling -> the JPEG encoder's sampling
_SAMPLINGS = {(1, 1): "4:4:4", (2, 1): "4:2:2", (2, 2): "4:2:0",
              (1, 2): "4:4:0"}


def _pack(s, bits, order):
    """(rows, cols, n) samples -> (rows, row bytes) as stored."""
    rows = s.shape[0]
    if bits == 16:
        return s.astype(order + "u2").reshape(rows, -1).view(np.uint8)
    if bits == 8:
        return s.astype(np.uint8).reshape(rows, -1)
    shifts = np.arange(bits - 1, -1, -1)
    flat = s.reshape(rows, -1)[..., None]
    return np.packbits(((flat >> shifts) & 1).astype(np.uint8).reshape(
        rows, -1), axis=1)


def _jpeg_chunk(block, photo, quality, subsampling, tables,
                restart_interval, jfif, adobe):
    """One strip's or tile's JPEG stream (see `encode`)."""
    samples = block.astype(np.uint8)
    if samples.shape[2] == 1:
        samples = samples[..., 0]
    return jpeg.encode(
        samples, quality, _SAMPLINGS[tuple(subsampling)] if photo == 6
        else "4:4:4", restart_interval, color="ycc" if photo == 6 else "rgb",
        tables=not tables, jfif=jfif, adobe=adobe)


def encode(pixels: np.ndarray, compression: str = "none", *,
           photometric: Optional[int] = None, bits: int = 8,
           predictor: int = 1, tile: Optional[Tuple[int, int]] = None,
           rows_per_strip: Optional[int] = None, planar: int = 1,
           byteorder: str = "<", bigtiff: bool = False,
           colormap: Optional[np.ndarray] = None, extra_samples=(),
           sample_format: int = 1, fill_order: int = 1,
           orientation: Optional[int] = None, pages=(), quality: int = 90,
           subsampling=(2, 2), subsampling_tag=True,
           jpeg_tables: bool = True, restart_interval: int = 0,
           jfif: bool = False, adobe: Optional[int] = None) -> bytes:
    """A TIFF of `pixels`, (H, W) or (H, W, n) sample values (uint8, or
    uint16 at 16 bits; 0 to 2^bits - 1 below 8), written as given:
    `compression` one of none, lzw, deflate, adobe_deflate, packbits,
    jpeg;
    strips of `rows_per_strip` rows (all rows by default) or tiles of
    `tile` = (width, length), multiples of 16; predictor 2 (horizontal
    differencing, LZW and Deflate); PlanarConfiguration `planar`;
    `byteorder` "<" (II) or ">" (MM); BigTIFF; a `colormap` (3, 2^bits)
    of 16-bit values for photometric 3; ExtraSamples; SampleFormat;
    FillOrder 2 (every stored byte's bits reversed); an Orientation tag;
    `pages`, further arrays written as IFDs after the first with the same
    settings. The photometric defaults to RGB for 3 or more samples and
    MinIsBlack else.

    JPEG (compression 7) is written as libtiff writes it: each strip or
    tile an abbreviated baseline stream of `utils/jpeg.encode` at
    `quality` (no JFIF or Adobe marker unless `jfif` or `adobe` asks for
    one, a restart marker every `restart_interval` MCUs), its tables in
    JPEGTables (or, without `jpeg_tables`, in every stream); 8-bit grey
    (photometric 1 or 0), RGB coded as it is (2), or RGB pixels coded as
    YCbCr (6) with luma sampled `subsampling` (h, v), which the
    YCbCrSubsampling tag gives (`subsampling_tag` True), leaves out
    (False) or contradicts (a pair); with planar 2, one grey stream a
    plane."""
    order = byteorder
    code, pack = _WRITERS[compression]
    images = [np.asarray(pixels)] + [np.asarray(p) for p in pages]
    out = bytearray(b"II" if order == "<" else b"MM")
    off_fmt = "Q" if bigtiff else "I"
    out += struct.pack(order + ("HHHQ" if bigtiff else "HI"),
                       *((43, 8, 0, 0) if bigtiff else (42, 0)))
    link = len(out) - (8 if bigtiff else 4)  # where the IFD offset goes
    for img in images:
        if img.ndim == 2:
            img = img[..., None]
        h, w, spp = img.shape
        photo = photometric if photometric is not None else (
            2 if spp >= 3 else 1)
        planes = ([img[..., k:k + 1] for k in range(spp)]
                  if planar == 2 and spp > 1 else [img])
        if tile is not None:
            cw, ch = tile
        else:
            cw, ch = w, rows_per_strip or h
        offsets, counts = [], []
        for plane in planes:
            for y0 in range(0, h, ch):
                for x0 in range(0, w, cw):
                    block = plane[y0:y0 + ch, x0:x0 + cw]
                    if tile is not None:  # whole tiles, zero padded
                        full = np.zeros((ch, cw, block.shape[2]),
                                        block.dtype)
                        full[:block.shape[0], :block.shape[1]] = block
                        block = full
                    if pack is None:
                        stored = _jpeg_chunk(block, photo, quality,
                                             subsampling, jpeg_tables,
                                             restart_interval, jfif, adobe)
                    else:
                        if predictor == 2:
                            block = np.diff(block.astype(np.int64), axis=1,
                                            prepend=0).astype(block.dtype)
                        stored = pack(_pack(block, bits, order).tobytes())
                    if fill_order == 2 and pack is not None:
                        # (libtiff reverses no JPEG data: TIFF_NOBITREV)
                        stored = _REVERSED[np.frombuffer(stored, np.uint8)] \
                            .tobytes()
                    offsets.append(len(out))
                    counts.append(len(stored))
                    out += stored
                    if len(out) % 2:
                        out += b"\x00"
        entries = [(WIDTH, 4, [w]), (HEIGHT, 4, [h]),
                   (BITS, 3, [bits] * spp), (COMPRESSION, 3, [code]),
                   (PHOTOMETRIC, 3, [photo]), (SAMPLES, 3, [spp]),
                   (PLANAR, 3, [planar])]
        if fill_order != 1:
            entries.append((FILL_ORDER, 3, [fill_order]))
        if orientation is not None:
            entries.append((ORIENTATION, 3, [orientation]))
        if predictor != 1:
            entries.append((PREDICTOR, 3, [predictor]))
        if colormap is not None:
            entries.append((COLORMAP, 3, [int(v) for v in
                                          np.asarray(colormap).ravel()]))
        if extra_samples:
            entries.append((EXTRA_SAMPLES, 3, list(extra_samples)))
        if sample_format != 1:
            entries.append((SAMPLE_FORMAT, 3, [sample_format] * spp))
        if pack is None and jpeg_tables:
            entries.append((JPEG_TABLES, 7, list(jpeg.tables_only(
                quality, 1 if planar == 2 or spp == 1 else 3))))
        if pack is None and photo == 6 and subsampling_tag is not False:
            entries.append((YCBCR_SUBSAMPLING, 3, list(
                subsampling if subsampling_tag is True else subsampling_tag)))
        long_type = 16 if bigtiff else 4
        if tile is not None:
            entries += [(TILE_WIDTH, 4, [cw]), (TILE_LENGTH, 4, [ch]),
                        (TILE_OFFSETS, long_type, offsets),
                        (TILE_COUNTS, long_type, counts)]
        else:
            entries += [(STRIP_OFFSETS, long_type, offsets),
                        (ROWS_PER_STRIP, 4, [ch]),
                        (STRIP_COUNTS, long_type, counts)]
        entries.sort()
        inline = 8 if bigtiff else 4
        # values that do not fit in an entry go before the IFD
        placed = []
        for tag, kind, values in entries:
            body = struct.pack(f"{order}{len(values)}{_TYPES[kind]}",
                               *values)
            if len(body) > inline:
                where = len(out)
                out += body + (b"\x00" if len(body) % 2 else b"")
                body = struct.pack(order + off_fmt, where)
            placed.append((tag, kind, len(values), body.ljust(inline,
                                                              b"\x00")))
        ifd = len(out)
        struct.pack_into(order + off_fmt, out, link, ifd)
        out += struct.pack(order + ("Q" if bigtiff else "H"), len(placed))
        for tag, kind, n, body in placed:
            out += struct.pack(order + "HH" + ("Q" if bigtiff else "I"),
                               tag, kind, n) + body
        link = len(out)
        out += bytes(8 if bigtiff else 4)
    return bytes(out)
