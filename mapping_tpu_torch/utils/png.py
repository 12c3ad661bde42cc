"""A small PNG reader and writer on the standard library's zlib and numpy.

The reader decodes what a tile dataset holds: 8-bit greyscale, greyscale
with alpha, RGB and RGBA, not interlaced, with any of the five row
filters. Anything else (palettes, 16-bit samples, Adam7) raises. The
loader uses it for PNG files when the native decoder (cpp/decode.cpp,
which needs the libpng and libjpeg headers) did not build, and for the
target masks. The writer writes the 8-bit greyscale masks of
`prep.targets` (the JAX package writes them with imageio) and the RGB
overlays of `utils.visualize` (the JAX package writes them with Pillow):
no row filters, zlib level 6.
"""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> samples per pixel, for 8-bit images
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


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


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
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
        elif kind == 1:  # Sub: running sum of each channel along the row
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
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


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with C = 1, 2, 3 or 4 samples as
    stored (grey, grey+alpha, RGB, RGBA)."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {colour}, "
            f"interlace {interlace} (8-bit grey, grey+alpha, RGB or RGBA "
            f"without interlacing only)")
    bpp = _CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp)
    return pixels.reshape(h, w, bpp)


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
