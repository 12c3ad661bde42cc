"""A small PNG reader and writer on the standard library's zlib and numpy.

The reader decodes every PNG kind: greyscale at 1, 2, 4, 8 and 16 bits,
palette images (with or without tRNS), greyscale with alpha, RGB and RGBA
at 8 and 16 bits, each plain or Adam7-interlaced, with any of the five
row filters. It gives the 8-bit samples that the JAX package's loader
reads (libpng where that library takes the file, cpp/decode.cpp; Pillow
where it declines, alpha and 16-bit files): low-bit grey scaled to 0-255,
palettes looked up (an index past the palette is black), 16-bit grey
clipped at 255 (Pillow's "I;16") and 16-bit colour and alpha images cut
to their high bytes (Pillow's "RGB;16B", "LA;16B", "RGBA;16B"). Gamma and
colour-profile chunks are ignored. The loader uses it for PNG files when
the native decoder (cpp/decode.cpp, which needs the libpng and libjpeg
headers) did not build, and for the target masks. The writer writes the
8-bit greyscale masks of `prep.targets` (the JAX package writes them with
imageio) and the RGB overlays of `utils.visualize` (the JAX package
writes them with Pillow): no row filters, zlib level 6.
"""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> (samples per pixel, the bit depths it may have)
_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
          4: (2, (8, 16)), 6: (4, (8, 16))}
#: Adam7: each pass's first column, first row, column step and row step
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _paeth_row(row, prev, bpp):
    """Undo the Paeth filter in place, byte by byte (each byte depends on
    its reconstructed left neighbour)."""
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def _average_row(row, prev, bpp):
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        row[i] = (row[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw, h: int, stride: int, bpp: int) -> np.ndarray:
    """(h, stride) uint8 of `h` filtered rows of `stride` bytes, `bpp`
    bytes a pixel (at least 1) for the filters' left neighbour."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: running sum of each byte lane along the row
            # (stride is a whole number of bpp: bpp is 1 below 8 bits)
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):
            cur = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(cur, prev.tolist(),
                                                        bpp)
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def _samples(rows, w, depth, channels):
    """Unfiltered rows (h, stride) -> (h, w, channels) samples (uint8, or
    uint16 at 16 bits), big-endian as stored."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(h, -1)[:, :w * channels].reshape(
            h, w, channels).astype(np.uint16)
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[..., None]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with C = 1, 2, 3 or 4 samples (grey,
    grey+alpha, RGB, RGBA; a palette image gives RGB), 8 bits each as the
    JAX package's loader reads them (see the module's docstring)."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("bad PNG IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3 or not 3 <= len(body) <= 768:
                raise ValueError("bad PNG PLTE chunk")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, method, filters, interlace = header
    if colour not in _TYPES or depth not in _TYPES[colour][1]:
        raise ValueError(f"bad PNG: bit depth {depth} with colour type "
                         f"{colour}")
    if w == 0 or h == 0 or method or filters or interlace > 1:
        raise ValueError(f"bad PNG header {header}")
    if colour == 3 and palette is None:
        raise ValueError("PNG palette image without PLTE")
    channels = _TYPES[colour][0]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"bad PNG image data: {e}") from e
    bits = depth * channels
    bpp = max(1, bits // 8)
    if interlace:
        out = np.zeros((h, w, channels), np.uint16 if depth == 16
                       else np.uint8)
        pos = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:  # an empty pass has no rows at all
                continue
            stride = -(-pw * bits // 8)
            n = ph * (stride + 1)
            out[y0::dy, x0::dx] = _samples(
                _unfilter(raw[pos:pos + n], ph, stride, bpp), pw, depth,
                channels)
            pos += n
        if pos != len(raw):
            raise ValueError("PNG image data has the wrong length")
    else:
        out = _samples(_unfilter(raw, h, -(-w * bits // 8), bpp), w, depth,
                       channels)
    if colour == 3:  # an index past the palette is black
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette
        return table[out[..., 0]]
    if depth < 8:  # grey scaled to 0-255: x 255, 85 or 17
        return out * np.uint8(255 // ((1 << depth) - 1))
    if depth == 16:
        if colour == 0:  # Pillow's "I;16", clipped at 255
            return np.minimum(out, 255).astype(np.uint8)
        return (out >> 8).astype(np.uint8)
    return out


def to_rgb(pixels: np.ndarray) -> np.ndarray:
    """(H, W, C) as `decode_png` returns it -> (H, W, 3) RGB, the way
    PIL's convert("RGB") maps grey (replicated) and alpha (dropped)."""
    c = pixels.shape[-1]
    if c in (1, 2):
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


def to_gray(pixels: np.ndarray) -> np.ndarray:
    """(H, W, C) as `decode_png` returns it -> (H, W) uint8, the way PIL's
    convert("L") maps them: grey kept, alpha dropped, RGB weighted by
    ITU-R 601-2 (L = (19595 R + 38470 G + 7471 B + 2^15) >> 16)."""
    if pixels.shape[-1] in (1, 2):
        return np.ascontiguousarray(pixels[..., 0])
    rgb = pixels[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def read_png_rgb(path) -> np.ndarray:
    with open(path, "rb") as f:
        return to_rgb(decode_png(f.read()))


def read_png_gray(path) -> np.ndarray:
    with open(path, "rb") as f:
        return to_gray(decode_png(f.read()))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(pixels: np.ndarray) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> PNG bytes, no row filters."""
    if pixels.dtype != np.uint8 or pixels.ndim not in (2, 3) or (
            pixels.ndim == 3 and pixels.shape[-1] != 3):
        raise ValueError(f"encode_png: needs (H, W) or (H, W, 3) uint8, got "
                         f"{pixels.shape} {pixels.dtype}")
    h, w = pixels.shape[:2]
    colour = 0 if pixels.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           pixels.reshape(h, -1)], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png_gray(path, mask: np.ndarray):
    """(H, W) uint8 -> an 8-bit greyscale PNG file."""
    if np.asarray(mask).ndim != 2:
        raise ValueError(f"write_png_gray: needs (H, W), got {mask.shape}")
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(mask)))


def write_png_rgb(path, pixels: np.ndarray):
    """(H, W, 3) uint8 -> an 8-bit RGB PNG file."""
    pixels = np.asarray(pixels)
    if pixels.ndim != 3:
        raise ValueError(f"write_png_rgb: needs (H, W, 3), got "
                         f"{pixels.shape}")
    with open(path, "wb") as f:
        f.write(encode_png(pixels))
