"""BMP and DIB tiles as the JAX package's loader reads them.

The JAX loader reads a file that libjpeg and libpng decline through Pillow
(`mapping_tpu/data/loader.py` `load_image`: `Image.open(path).convert("RGB")`),
and Pillow reads BMP with its `BmpImagePlugin`. `decode` gives the same
(H, W, 3) uint8 RGB byte for byte, without Pillow: the headers and the raw
rows here in numpy, run-length data in host C++ (csrc/bmp_decode.cpp, the
GIL released). The rules, read from Pillow 12.1.0's plugin and probed
against it:

- a file is a BMP where it starts with "BM" (the data offset at byte 10,
  the info header at 14), and a headerless DIB where its first u32 is an
  info header size, 12, 40, 52, 56, 64, 108 or 124 (Pillow tries DIB right
  after BMP, before any other format); a DIB's palette and pixels follow
  its header;
- headers: 12 (OS/2 v1: 16-bit width and height, 3-byte palette entries,
  no compression) and 40 to 124 (32-bit width; the rows are top-down where
  byte 7 of the header after its size is 0xFF, and the height is then
  2^32 minus the stored value, whatever its sign says);
- depths 1, 4, 8 (palette), 16 (5-5-5, each channel scaled as
  v x 255 // 31), 24 (BGR) and 32 (BGRX: the fourth byte is ignored);
  rows padded to 4 bytes;
- compression raw, RLE8 and RLE4 (csrc/bmp_decode.cpp, with Pillow's
  quirks: a delta escape reads four bytes, a run is clipped to its row,
  an RLE4 absolute count halves, data that stops before the image is full
  is refused), and BITFIELDS with Pillow's masks only: at 32 bits BGRX,
  XBGR, BGXR, ABGR, RGBA, BGRA, BGAR and all-zero (read as BGRA), at 24
  bits BGR, at 16 bits 5-6-5 (green v x 255 // 63) and 5-5-5; under a
  40-byte header the three masks follow the header, under 52 and 56 they
  are in it (56: with an alpha mask); alpha is dropped, not premultiplied;
- the palette: `colors` entries (1 << bits where the field is 0) right
  after the header (and masks), 4 bytes each (3 under a 12-byte header).
  A palette that is exactly the grey ramp 0, 1, 2, ... (black and white
  for 2 entries) makes the image grey ("L") or bilevel ("1"), and Pillow
  then reads the samples with an 8-bit ("L") or 1-bit ("1") raw mode
  whatever the depth; any other palette goes through "P", where an index
  past the palette reads black. A data offset that points right after the
  header is moved past the palette (4 bytes an entry, whatever the
  header);
- truncated pixel data is refused (Pillow raises "image file is
  truncated"); bytes after the rows are ignored.

Refused with a ValueError that names the cause, as Pillow refuses it:
another header size, a depth or compression other than those above (JPEG
and PNG compression by name), a mask set Pillow does not list, a palette
of 0 or over 65,536 entries or, for "P", of over 256, RLE data on a
bilevel or 16-bit-and-up image, a delta escape cut short, a zero width or
height, pixel or RLE data that ends before the image is full, and a
header over `jpeg.MAX_PIXELS` pixels, before anything is allocated.

Pillow maps the rows of an 8-bit "L" or "P" image from a file instead of
decoding them, which reads the same bytes, but for one layout no real
file has: a grey-ramp palette below 8 bits whose stride is narrower than
the image's width in bytes. The mapped rows then overlap; `decode`
follows the file reading (the JAX loader's), where Pillow reading the
same bytes from memory (the JAX daemon) puts them apart.
"""

import ctypes
import struct

import numpy as np

from mapping_tpu_torch.kernels.build import CSRC
from mapping_tpu_torch.utils.jpeg import MAX_PIXELS
from mapping_tpu_torch.utils.native_lib import NativeLib

HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)
RAW, RLE8, RLE4, BITFIELDS, JPEG, PNG = range(6)

#: BmpImagePlugin.MASK_MODES: (bits, masks) -> Pillow's raw mode
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
#: the byte of each of R, G, B in a pixel of the 24- and 32-bit raw modes
_CHANNELS = {"BGR": (2, 1, 0), "BGRX": (2, 1, 0), "XBGR": (3, 2, 1),
             "BGXR": (3, 1, 0), "ABGR": (3, 2, 1), "RGBA": (0, 1, 2),
             "BGRA": (2, 1, 0), "BGAR": (3, 1, 0)}
#: bits a pixel of each raw mode
_RAW_BITS = {"P;1": 1, "P;4": 4, "P": 8, "1": 1, "L": 8, "BGR;15": 16,
             "BGR;16": 16, "BGR": 24}
_DEPTHS = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}


def _register(lib):
    ptr = ctypes.c_void_p
    lib.bmp_rle_decode.restype = ctypes.c_long
    lib.bmp_rle_decode.argtypes = [ptr, ctypes.c_long, ctypes.c_long,
                                   ctypes.c_long, ctypes.c_long,
                                   ctypes.c_int, ptr, ctypes.c_long]


_lib = NativeLib("bmp_decode.cpp", "bmp_decode", _register, src_dir=CSRC)
load = _lib.load


def is_bmp(data: bytes) -> bool:
    """Whether Pillow opens the bytes as a BMP ("BM") or a DIB (the first
    u32 an info header size)."""
    return data[:2] == b"BM" or (
        len(data) >= 4 and struct.unpack_from("<I", data)[0] in HEADER_SIZES)


def _u32(data, at, what):
    if at + 4 > len(data):
        raise ValueError(f"a BMP {what} cut short")
    return struct.unpack_from("<I", data, at)[0]


def _header(data):
    """(fields, position after the header and masks, data offset or 0)."""
    if data[:2] == b"BM":
        if len(data) < 14:
            raise ValueError("a BMP file header cut short")
        offset, at = _u32(data, 10, "file header"), 14
    else:
        offset, at = 0, 0
    size = _u32(data, at, "info header")
    if size not in HEADER_SIZES:
        raise ValueError(f"an unsupported BMP header size ({size})")
    h = data[at + 4:at + size]
    if len(h) < size - 4:
        raise ValueError("a BMP info header cut short")
    at += size
    if size == 12:
        width, height, _, bits = struct.unpack_from("<4H", h)
        return dict(size=size, width=width, height=height, bits=bits,
                    compression=RAW, colors=0, top_down=False,
                    entry=3), at, offset
    top_down = h[7] == 0xFF
    width, height, _, bits, compression = struct.unpack_from("<IIHHI", h)
    if top_down:
        height = 2 ** 32 - height
    fields = dict(size=size, width=width, height=height, bits=bits,
                  compression=compression, colors=struct.unpack_from(
                      "<I", h, 28)[0], top_down=top_down, entry=4)
    if compression == BITFIELDS:
        if len(h) >= 48:
            masks = struct.unpack_from("<3I", h, 36)
            masks += struct.unpack_from("<I", h, 48) if len(h) >= 52 else (0,)
        else:  # a 40-byte header: three masks after it
            masks = tuple(_u32(data, at + 4 * i, "mask") for i in range(3))
            masks += (0,)
            at += 12
        fields["masks"] = masks
    return fields, at, offset


def _raw_mode(f):
    """Pillow's raw mode of the pixels, or a ValueError where it refuses
    the layout."""
    bits, compression = f["bits"], f["compression"]
    if bits not in _DEPTHS:
        raise ValueError(f"an unsupported BMP depth ({bits} bits)")
    mode = _DEPTHS[bits]
    if compression == BITFIELDS:
        masks = f["masks"] if bits == 32 else f["masks"][:3]
        if (bits, masks) not in _MASK_MODES:
            raise ValueError(f"unsupported BMP bitfields {bits} bits "
                             f"{tuple(hex(m) for m in masks)}")
        return _MASK_MODES[(bits, masks)]
    if compression in (RAW, RLE8, RLE4):
        return mode
    if compression in (JPEG, PNG):
        raise ValueError("BMP with {} compression".format(
            "JPEG" if compression == JPEG else "PNG"))
    raise ValueError(f"an unsupported BMP compression ({compression})")


def _palette(data, at, f):
    """(grey mode "L" or "1", or an (n, 3) RGB palette; position after
    it), as Pillow reads the palette of a 1-, 4- or 8-bit image."""
    colors, entry = f["colors"], f["entry"]
    if not 0 < colors <= 65536:
        raise ValueError(f"an unsupported BMP palette size ({colors})")
    raw = data[at:at + entry * colors]
    at += len(raw)
    values = (0, 255) if colors == 2 else range(colors)
    if all(raw[i * entry:i * entry + 3] == bytes([v & 255] * 3)
           for i, v in enumerate(values)):
        return ("1" if colors == 2 else "L"), at
    n = len(raw) // entry
    if n > 256:
        raise ValueError(f"a BMP palette of {n} colours (over 256)")
    bgr = np.frombuffer(raw[:n * entry], np.uint8).reshape(n, entry)
    return bgr[:, 2::-1], at


def _rows(data, offset, width, height, bits, stride, top_down, mapped):
    """(height, line bytes) uint8 of raw rows as Pillow reads them: each
    row its `bits` x width bits, bottom-up unless top_down. Pillow's raw
    decoder puts rows `stride` bytes apart (at least a line) and needs no
    padding after the last; where it maps the file instead (`mapped`: an
    8-bit raw mode equal to the image's, "L" or "P", from a file holding
    height x stride bytes after the offset), row k starts at k x stride
    whatever the line's length, and bytes past the file read zero."""
    line = (width * bits + 7) // 8
    if mapped and offset + height * stride <= len(data):
        need, step = (height - 1) * stride + line, stride
    else:
        step = max(stride, line)
        need = (height - 1) * step + line
        if offset + need > len(data):
            raise ValueError("BMP pixel data cut short")
    buf = np.frombuffer(data[offset:offset + need].ljust(need, b"\0"),
                        np.uint8)
    rows = np.lib.stride_tricks.as_strided(buf, (height, line), (step, 1))
    return rows if top_down else rows[::-1]


def _unpack(rows, mode, width):
    """(H, W, 3) uint8 RGB, or (H, W) samples for the palette and grey
    modes, of raw rows in Pillow's raw mode."""
    if mode in ("P;1", "1", "P;4"):
        bits = 4 if mode == "P;4" else 1
        samples = np.unpackbits(rows, axis=1) if bits == 1 else np.stack(
            [rows >> 4, rows & 15], -1).reshape(len(rows), -1)
        samples = samples[:, :width]
        return samples * np.uint8(255) if mode == "1" else samples
    if mode in ("P", "L"):
        return rows[:, :width]
    if mode in ("BGR;15", "BGR;16"):
        v = rows[:, :2 * width].astype(np.uint32)
        v = v[:, 0::2] | v[:, 1::2] << 8
        if mode == "BGR;15":
            r, g, b = (v >> 10 & 31) * 255 // 31, (v >> 5 & 31) * 255 // 31, \
                (v & 31) * 255 // 31
        else:
            r, g, b = (v >> 11 & 31) * 255 // 31, (v >> 5 & 63) * 255 // 63, \
                (v & 31) * 255 // 31
        return np.stack([r, g, b], -1).astype(np.uint8)
    size = 3 if mode == "BGR" else 4
    px = rows[:, :size * width].reshape(len(rows), width, size)
    return np.ascontiguousarray(px[..., list(_CHANNELS[mode])])


def _rle(data, offset, f, width, height):
    """(H, W) samples of RLE8 / RLE4 data, as Pillow's BmpRleDecoder
    reads them."""
    total = width * height
    cap = total + 255 * (width + 1) + width + 256
    out = np.empty(cap, np.uint8)
    src = np.frombuffer(data, np.uint8)
    n = load().bmp_rle_decode(src.ctypes.data, len(src), offset, width,
                              total, int(f["compression"] == RLE4),
                              out.ctypes.data, cap)
    if n == -1:
        raise ValueError("a BMP RLE delta escape cut short")
    if n < total:
        raise ValueError("BMP RLE data ends before the image is full")
    rows = out[:total].reshape(height, width)
    return rows if f["top_down"] else rows[::-1]


def decode(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a BMP or DIB file, as the JAX loader reads
    it."""
    data = bytes(data)
    f, at, offset = _header(data)
    width, height, bits = f["width"], f["height"], f["bits"]
    if width == 0 or height == 0:
        raise ValueError(f"a BMP of {width}x{height} pixels")
    if width * height > MAX_PIXELS:
        raise ValueError(f"implausible image size {height}x{width} (over "
                         f"{MAX_PIXELS} pixels)")
    colors = f["colors"] or 1 << bits
    f["colors"] = colors
    if offset == 14 + f["size"] and bits <= 8:
        offset += 4 * colors
    mode = _raw_mode(f)
    palette = None
    if mode in ("P;1", "P;4", "P"):
        palette, at = _palette(data, at, f)
        if isinstance(palette, str):  # a grey ramp: "L" or "1"
            mode, palette = palette, None
    offset = offset or at
    if f["compression"] in (RLE8, RLE4):
        if mode not in ("P;1", "P;4", "P", "L"):
            image = "bilevel" if mode == "1" else f"{bits}-bit"
            raise ValueError(f"BMP RLE data on a {image} image")
        samples = _rle(data, offset, f, width, height)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        samples = _unpack(_rows(data, offset, width, height,
                                _RAW_BITS.get(mode, 32), stride,
                                f["top_down"], mode in ("L", "P")),
                          mode, width)
    if samples.ndim == 3:
        return samples
    if palette is None:  # grey or bilevel
        return np.repeat(samples[..., None], 3, -1)
    table = np.zeros((256, 3), np.uint8)
    table[:len(palette)] = palette
    return table[samples]
