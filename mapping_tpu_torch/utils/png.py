"""A small PNG reader and writer on the standard library's zlib and numpy.

The reader decodes every PNG kind: greyscale at 1, 2, 4, 8 and 16 bits,
palette images (with or without tRNS), greyscale with alpha, RGB and RGBA
at 8 and 16 bits, each plain or Adam7-interlaced, with any of the five
row filters. It gives the 8-bit samples that the JAX package's loader
reads (libpng where that library takes the file, cpp/decode.cpp; Pillow
where it declines, alpha and 16-bit files): low-bit grey scaled to 0-255,
palettes looked up (an index past the palette is black), 16-bit grey
clipped at 255 (Pillow's "I;16") and 16-bit colour and alpha images cut
to their high bytes (Pillow's "RGB;16B", "LA;16B", "RGBA;16B"). The
loader uses it for PNG files when the native decoder (cpp/decode.cpp,
which needs the libpng and libjpeg headers) did not build, and for the
target masks. The writer writes the 8-bit greyscale masks of
`prep.targets` (the JAX package writes them with imageio) and the RGB
overlays of `utils.visualize` (the JAX package writes them with Pillow):
no row filters, zlib level 6.

Gamma. libpng's simplified API (`png_image_finish_read` to 8-bit RGB or
grey, which the JAX loader uses for files without alpha, tRNS or 16-bit
samples: grey at 1-8 bits and palette files read as RGB or grey, 8-bit
RGB read as RGB) converts a file whose gamma is not sRGB's to sRGB. Pillow
ignores gamma, so the files the JAX loader hands to Pillow (alpha, tRNS,
16 bits, a colour or palette file read as grey) keep their samples.
libpng 1.6.39's rule, derived by probing it with 0-255 ramps and drawn
chunk sequences, and held on every probed table (`tests/fixtures/png_gamma`,
tests/test_torch_png.py):
- the file gamma g is the gAMA chunk's value (gamma x 100000) where it
  stands before PLTE and the first IDAT, has 4 bytes, a good CRC and
  16 <= g <= 625,000,000; otherwise there is none and nothing changes;
- a valid sRGB chunk (1 byte, intent 0-3, good CRC) sets g = 45455 in
  either order with gAMA (a later gAMA that differs is ignored);
- the colour space turns invalid, and a gAMA after that is ignored, on
  a gAMA out of range, a second gAMA (the first stays), a second cHRM, a
  cHRM whose chromaticities are out of range (an x or y outside
  [0, 1], y > 1 - x, white y < 0.00005), an sRGB with intent > 3, an
  sRGB or an iCCP after an sRGB, and an iCCP that libpng's profile
  checks reject (`_icc_rejected`); an accepted iCCP changes nothing;
- correction happens iff round(2.2 g) lies outside [95000, 105000]
  (png_gamma_threshold), with the exponent
  e = round(1e15 / g / 220000) (png_reciprocal2 against the sRGB screen
  gamma 2.2), and the table
  t[v] = floor(255 (v / 255)^(e / 100000) + 0.5) for 0 < v < 255, t[0] = 0,
  t[255] = 255, is the identity when e lies within [95000, 105000]
  (png_build_8bit_table); so g in [43182, 47847] reads unchanged;
- the table maps every 8-bit sample: low-bit grey after its expansion to
  0-255, a palette's entries.
Not modelled: libpng's check that a cHRM's chromaticities (in range)
make an invertible matrix, which can also invalidate the colour space
before a gAMA (a drawn cHRM with red x = 0.00005 did, in the probe).
"""

import math
import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> (samples per pixel, the bit depths it may have)
_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
          4: (2, (8, 16)), 6: (4, (8, 16))}
#: Adam7: each pass's first column, first row, column step and row step
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes):
    """(kind, body, CRC as stored) of each chunk up to IEND."""
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        crc = data[pos + 8 + length:pos + 12 + length]
        yield kind, body, crc
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


class Decoded(NamedTuple):
    """A PNG's 8-bit samples as `decode_png` gives them, and what the JAX
    loader's libpng read does to them (see the module's docstring)."""

    pixels: np.ndarray
    colour: int  # the IHDR colour type
    #: libpng's 256-entry gamma table for an RGB read, or None where
    #: libpng leaves the file's samples as they are or does not read it
    gamma: Optional[np.ndarray]


#: gAMA values libpng accepts (png_colorspace_set_gamma)
GAMMA_RANGE = (16, 625_000_000)
#: png_gamma_significant: a fixed-point factor within 5 % of 1 is none
_NEAR_ONE = (95_000, 105_000)
_SRGB_GAMMA = 45455  # PNG_GAMMA_sRGB_INVERSE
_GAMMA_CHUNKS = (b"gAMA", b"sRGB", b"cHRM")


def _significant(fixed: int) -> bool:
    return not _NEAR_ONE[0] <= fixed <= _NEAR_ONE[1]


def gamma_table(g: int) -> Optional[np.ndarray]:
    """libpng 1.6's 8-bit table from a file gamma `g` (x 100000) to sRGB,
    or None where it corrects nothing (png_gamma_threshold,
    png_reciprocal2, png_build_8bit_table and png_gamma_8bit_correct, in
    their floating-point forms)."""
    if not _significant(math.floor(g * 220000 / 100000 + .5)):
        return None
    exponent = math.floor(1e15 / g / 220000 + .5)
    if not _significant(exponent):
        return None
    table = [0] + [math.floor(255 * math.pow(v / 255., exponent * .00001)
                              + .5) for v in range(1, 255)] + [255]
    return np.array(table, np.uint8)


def _chrm_in_range(body: bytes) -> bool:
    wx, wy, rx, ry, gx, gy, bx, by = struct.unpack(">8I", body)
    one = 100000
    return (all(0 <= x <= one and 0 <= y <= one - x
                for x, y in ((rx, ry), (gx, gy), (bx, by)))
            and 0 <= wx <= one and 5 <= wy <= one - wx)


def _icc_rejected(body: bytes, colour: int) -> bool:
    """Whether libpng's iCCP handling (png_handle_iCCP and its
    png_icc_check_* helpers) invalidates the colour space: a chunk of 92
    bytes or more whose profile inflates to under 132 bytes or to less
    than its declared length, declares under 132 or over 8,000,000 bytes,
    lacks the 'acsp' signature, has a colour space other than 'RGB ' on a
    colour type or 'GRAY' on a grey one, an abstract or device-link class,
    a PCS other than XYZ or Lab, a rendering intent of 0xFFFF or more, too
    many tags or a tag outside the profile, or a version above 3 with a
    length not a multiple of 4; a bad keyword or compression method. Data
    past the declared length is allowed. A shorter chunk changes nothing
    ("too short": libpng reads the first 81 bytes, then wants 11 more).
    libpng checks an iCCP chunk's CRC only after all this."""
    if len(body) < 92:
        return False
    name = body[:81].split(b"\0", 1)[0]
    if not 1 <= len(name) <= 79 or len(body) < len(name) + 2 \
            or body[len(name) + 1] != 0:
        return True  # a bad keyword or compression method
    try:
        profile = zlib.decompressobj().decompress(body[len(name) + 2:])
    except zlib.error:
        return True
    if len(profile) < 132:
        return True
    length, klass, space, pcs = struct.unpack(">I8x4s4s4s", profile[:24])
    intent = struct.unpack(">I", profile[64:68])[0]
    tags = struct.unpack(">I", profile[128:132])[0]
    if not 132 <= length <= 8_000_000 or length != len(profile) \
            or (profile[8] > 3 and length & 3) or intent >= 0xFFFF \
            or tags > 357913930 or length < 132 + 12 * tags \
            or profile[36:40] != b"acsp" \
            or space != (b"RGB " if colour & 2 else b"GRAY") \
            or klass in (b"abst", b"link") or pcs not in (b"XYZ ", b"Lab "):
        return True
    for i in range(tags):
        start, size = struct.unpack(">II", profile[136 + 12 * i:
                                                  144 + 12 * i])
        if start > length or size > length - start:
            return True
    return False


def _file_gamma(chunks, colour) -> Optional[int]:
    """The file gamma libpng's reader settles on from the chunks before
    the first IDAT (kind, body, CRC), or None (see the module's
    docstring)."""
    gamma, invalid, from_gama, from_srgb, chrm = None, False, False, False, \
        False
    for kind, body, crc in chunks:
        if kind == b"PLTE":
            return gamma  # gAMA, sRGB, cHRM and iCCP are out of place now
        if kind == b"iCCP":
            if len(body) >= 14 and not invalid:
                invalid = from_srgb or _icc_rejected(body, colour)
            continue
        if kind not in _GAMMA_CHUNKS or struct.pack(
                ">I", zlib.crc32(kind + body)) != crc:
            continue  # a gAMA, sRGB or cHRM with a bad CRC is dropped
        if kind == b"gAMA" and len(body) == 4:
            g = struct.unpack(">I", body)[0]
            if not GAMMA_RANGE[0] <= g <= GAMMA_RANGE[1] or from_gama:
                invalid = True
            elif not invalid and not (from_srgb and _significant(
                    math.floor(gamma * 100000 / g + .5))):
                gamma, from_gama = g, True  # sRGB's value is not overwritten
        elif kind == b"sRGB" and len(body) == 1 and not invalid:
            if from_srgb or body[0] > 3:
                invalid = True
            else:
                gamma, from_srgb = _SRGB_GAMMA, True
        elif kind == b"cHRM" and len(body) == 32 and not invalid \
                and max(struct.unpack(">8I", body)) <= 0x7FFFFFFF:
            if chrm or not _chrm_in_range(body):
                invalid = True
            chrm = True
    return gamma


def read_png(data: bytes) -> Decoded:
    """PNG bytes -> `Decoded`: the samples (see `decode_png`), the colour
    type, and the gamma table libpng would apply to an RGB read."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, palette, idat, before = None, None, [], []
    trns = False
    for kind, body, crc in _chunks(data):
        if not idat:
            before.append((kind, body, crc))
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("bad PNG IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3 or not 3 <= len(body) <= 768:
                raise ValueError("bad PNG PLTE chunk")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = True
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
    # libpng reads (and corrects) only files without alpha and 16 bits
    libpng = colour in (0, 2, 3) and depth <= 8 and not trns
    g = _file_gamma(before, colour) if libpng else None
    table = gamma_table(g) if g is not None else None
    if colour == 3:  # an index past the palette is black
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette
        return Decoded(lut[out[..., 0]], colour, table)
    if depth < 8:  # grey scaled to 0-255: x 255, 85 or 17
        return Decoded(out * np.uint8(255 // ((1 << depth) - 1)), colour,
                       table)
    if depth == 16:
        if colour == 0:  # Pillow's "I;16", clipped at 255
            return Decoded(np.minimum(out, 255).astype(np.uint8), colour,
                           None)
        return Decoded((out >> 8).astype(np.uint8), colour, None)
    return Decoded(out, colour, table)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with C = 1, 2, 3 or 4 samples (grey,
    grey+alpha, RGB, RGBA; a palette image gives RGB), 8 bits each as
    stored (see the module's docstring), before any gamma correction."""
    return read_png(data).pixels


def to_rgb(image: Decoded) -> np.ndarray:
    """(H, W, 3) RGB of a `read_png` result as the JAX loader reads it:
    libpng's gamma table applied where libpng reads the file, and Pillow's
    convert("RGB") else (grey replicated, alpha dropped)."""
    pixels = image.pixels
    if pixels.shape[-1] in (1, 2):
        rgb = np.repeat(pixels[..., :1], 3, axis=-1)
    else:
        rgb = np.ascontiguousarray(pixels[..., :3])
    return rgb if image.gamma is None else image.gamma[rgb]


def to_gray(image: Decoded) -> np.ndarray:
    """(H, W) uint8 of a `read_png` result as the JAX `load_target` reads
    it: libpng's grey read (gamma-corrected) for a grey file without
    alpha, tRNS or 16 bits, and Pillow's convert("L") else: grey kept,
    alpha dropped, RGB weighted by ITU-R 601-2
    (L = (19595 R + 38470 G + 7471 B + 2^15) >> 16)."""
    pixels = image.pixels
    if pixels.shape[-1] in (1, 2):
        grey = np.ascontiguousarray(pixels[..., 0])
        if image.colour == 0 and image.gamma is not None:
            return image.gamma[grey]
        return grey
    rgb = pixels[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def read_png_rgb(path) -> np.ndarray:
    with open(path, "rb") as f:
        return to_rgb(read_png(f.read()))


def read_png_gray(path) -> np.ndarray:
    with open(path, "rb") as f:
        return to_gray(read_png(f.read()))


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
