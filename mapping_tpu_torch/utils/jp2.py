"""JPEG 2000 tiles (JP2 files and raw J2K codestreams) as the JAX package's
loader reads them.

The JAX loader reads a file that libjpeg and libpng decline through Pillow
(`mapping_tpu/data/loader.py` `load_image`: `Image.open(path).convert("RGB")`),
whose `Jpeg2KImagePlugin` reads the header in Python and decodes with
openjpeg 2.5 tile by tile, then unpacks each tile to its mode in C. `decode`
gives the same (H, W, 3) uint8 RGB byte for byte, without Pillow or
openjpeg: the container and the unpacking here, the codestream in host C++
(csrc/jp2_decode.cpp, the GIL released), which ends at per-subband
coefficient planes before the wavelet and the colour transform rebuild
the components. The rules, probed against Pillow 12.1.0 and its openjpeg
2.5.4:

- a file is JPEG 2000 where it starts with FF 4F FF 51 (a raw codestream)
  or with the JP2 signature box (Pillow's `_accept`), the `jpx ` brand too;
- Pillow's mode: from SIZ for a codestream (1 component: L, or I;16 above
  8 bits; 2: LA; 3: RGB; 4: RGBA; more: refused); from the jp2h box for
  JP2 (ihdr as for SIZ, with bit depth 255 counting as above 8; a colr
  read while ihdr says 4 components makes it CMYK when its method is 1 and
  its colour space 12; a pclr of entries of at most 8 bits over L or LA
  makes it P or PA, with Pillow's palette, which keeps each colour once, in
  order, so a repeated entry shifts the later ones down; an index past the
  palette reads black). Pillow's box reader and its walk over the main
  header for a COM marker refuse what they cannot read;
- openjpeg's JP2 reading: the signature, ftyp second, boxes before jp2h
  skipped, jp2h with ihdr (its size that of SIZ), the first colr (method 1:
  16 sRGB, 17 grey, 18 sYCC, 12 CMYK, 24 e-sYCC; any other colr, an ICC
  profile or none leave the colour space unspecified), pclr, cmap, cdef and
  bpcc checked as openjpeg checks them and otherwise ignored (tile decoding
  applies none of them), and the codestream from jp2c to the end of the
  file, an extended or a zero box length included;
- the unpacking, per decoded tile (a tile with no data stays zero): the
  component of precision p shifted to 8 bits, (v + 2^(p-9)) >> (p - 8)
  above 8 bits and v << (8 - p) below, a signed one offset by 2^(p-1),
  kept to 8 bits (so 255.5 and up wraps to 0); I;16 shifted to 16 bits
  then clipped at 255 by convert("RGB"); alpha dropped, not premultiplied;
  a component subsampled (3 or 4 components only; with fewer Pillow
  refuses) read at (y // dy) * (w // dx) + x // dx of the tile's buffer,
  tile-relative and floored as Pillow's unpacker reads it; sYCC through
  Pillow's integer YCbCr table, for colr 18 and for an unspecified colour
  space whose first component is whole and whose second or third is
  subsampled; CMYK through
  Pillow's cmyk2rgb (the rule of kernels/jpeg.py's CMYK path); a mode,
  colour space and component count with no unpacker in Pillow's table
  (a grey colr over three components, sRGB over one, e-sYCC) refused; a
  grey colr over four components reads as sRGB.

Refused with a ValueError that names the cause: HTJ2K, more than 4
components, a precision above 16 bits (openjpeg reads up to 31; Pillow
unpacks them, a gap), an image over `jpeg.MAX_PIXELS` pixels (before
anything is allocated), everything Pillow's header reading refuses, and
every codestream openjpeg fails on (csrc/jp2_decode.cpp).
"""

import ctypes
import struct
from typing import NamedTuple, Optional

import numpy as np

from mapping_tpu_torch.kernels.build import CSRC
from mapping_tpu_torch.utils.jpeg import MAX_PIXELS
from mapping_tpu_torch.utils.native_lib import NativeLib

J2K_SIGNATURE = b"\xff\x4f\xff\x51"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
#: csrc/jp2_decode.cpp's float path must not contract a*b + c into an FMA
FLAGS = ("-ffp-contract=off",)
MAX_COMPONENTS = 4
MAX_PRECISION = 16

GRAY, SRGB, SYCC, CMYK, EYCC, UNSPECIFIED = ("gray", "srgb", "sycc", "cmyk",
                                            "eycc", "unspecified")
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 12: CMYK, 24: EYCC}


def _register(lib):
    ptr = ctypes.c_void_p
    lib.jp2_header.restype = ctypes.c_int
    lib.jp2_header.argtypes = [ptr, ctypes.c_long, ptr, ctypes.c_int,
                               ctypes.c_char_p, ctypes.c_int]
    lib.jp2_decode.restype = ctypes.c_int
    lib.jp2_decode.argtypes = [ptr, ctypes.c_long, ptr, ptr, ptr,
                               ctypes.c_char_p, ctypes.c_int]


_lib = NativeLib("jp2_decode.cpp", "jp2_decode", _register, src_dir=CSRC,
                 flags=FLAGS)
load = _lib.load


def is_jp2(data: bytes) -> bool:
    return data.startswith((J2K_SIGNATURE, JP2_SIGNATURE))


class _Refused(Exception):
    """Pillow's header reading raises (SyntaxError, OSError, struct.error,
    ValueError...): the JAX loader does not read the file."""


# ------------------------------------------------ Pillow's header reading

class _BoxReader:
    """PIL.Jpeg2KImagePlugin.BoxReader over data[pos:] (or over a box's
    bytes, `length` set)."""

    def __init__(self, data, pos=0, length=-1):
        self.data, self.pos = data, pos
        self.has_length, self.length = length >= 0, length
        self.remaining = -1

    def _can_read(self, n):
        if self.has_length and self.pos + n > self.length:
            return False
        if self.remaining >= 0:
            return n <= self.remaining
        return True

    def read(self, n):
        if not self._can_read(n):
            raise _Refused("a JP2 box cut short")
        out = self.data[self.pos:self.pos + n]
        if len(out) < n:
            raise _Refused("a JP2 box cut short")
        self.pos += n
        if self.remaining > 0:
            self.remaining -= n
        return out

    def fields(self, fmt):
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))

    def sub(self):
        size = self.remaining
        return _BoxReader(self.read(size), 0, size)

    def has_next(self):
        return (self.pos + self.remaining < self.length if self.has_length
                else True)

    def next_box(self):
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise _Refused("a JP2 box of a bad length")
        self.remaining = lbox - hlen
        return tbox


class _Palette:
    """PIL.ImagePalette built by `getcolor`, one colour at a time."""

    def __init__(self, mode):
        self.mode, self.data, self.colors = mode, bytearray(), {}

    def getcolor(self, color):
        if self.mode == "RGBA" and len(color) == 3:
            color += (255,)
        if color in self.colors:
            return
        n = len(self.mode)
        index = len(self.data) // n
        if index >= 256:
            raise _Refused("a JP2 palette of more than 256 colours")
        self.colors[color] = index
        if index * n < len(self.data):
            self.data[index * n:index * n + n] = bytes(color)
        else:
            self.data += bytes(color)

    def rgb(self) -> np.ndarray:
        """(256, 3) uint8: the entries putpalette keeps, black past them."""
        n = len(self.mode)
        count = len(self.data) // n
        table = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(bytes(self.data[:count * n]),
                                np.uint8).reshape(count, n)
        table[:count] = entries[:, :3]
        return table


def _walk_comment(data, pos):
    """Jpeg2KImageFile._parse_comment from `pos`: the main header's markers
    walked by their lengths up to SOT, EOC or a COM."""
    while True:
        marker = data[pos:pos + 2]
        pos += len(marker)
        if not marker:
            return
        if len(marker) < 2:
            raise _Refused("a JPEG 2000 main header cut inside a marker")
        if marker[1] in (0x90, 0xD9):
            return
        hdr = data[pos:pos + 2]
        pos += len(hdr)
        if len(hdr) < 2:
            raise _Refused("a JPEG 2000 main header cut inside a marker")
        length = struct.unpack(">H", hdr)[0]
        if marker[1] == 0x64:
            return
        pos = max(pos + length - 2, 0)


class _Pillow(NamedTuple):
    mode: str
    size: tuple
    palette: Optional[_Palette]


def _pillow_header(data) -> _Pillow:
    """Jpeg2KImageFile._open: the mode, the size and the palette."""
    if data.startswith(J2K_SIGNATURE):
        hdr = data[4:6]
        if len(hdr) < 2:
            raise _Refused("a JPEG 2000 SIZ marker cut short")
        lsiz = struct.unpack(">H", hdr)[0]
        end = 6 + lsiz - 2 if lsiz >= 2 else len(data)
        siz = data[4:end]
        if len(siz) < 38:
            raise _Refused("a JPEG 2000 SIZ marker cut short")
        (_, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _,
         csiz) = struct.unpack_from(">HHIIIIIIIIH", siz)
        if csiz == 1:
            if len(siz) < 39:
                raise _Refused("a JPEG 2000 SIZ marker cut short")
            mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
        else:
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}.get(csiz)
            if mode is None:
                raise _Refused("a JPEG 2000 image of more than 4 components")
        _walk_comment(data, min(end, len(data)))
        return _Pillow(mode, (xsiz - xosiz, ysiz - yosiz), None)
    reader = _BoxReader(data, len(JP2_SIGNATURE))
    header = None
    while reader.has_next():
        tbox = reader.next_box()
        if tbox == b"jp2h":
            header = reader.sub()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    size = mode = nc = None
    palette = None
    while header.has_next():
        tbox = header.next_box()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1:
                mode = "I;16" if (bpc & 0x7F) > 8 else "L"
            elif nc in (2, 3, 4):
                mode = {2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                palette = _Palette("RGBA" if npc == 4 else "RGB")
                for _ in range(ne):
                    palette.getcolor(tuple(header.fields(">" + "B" * npc)))
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_box() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise _Refused("a malformed JP2 header")
    after = data[reader.pos:reader.pos + 12]
    if after.endswith(b"jp2c\xff\x4f\xff\x51"):
        pos = reader.pos + 12
        hdr = data[pos:pos + 2]
        if len(hdr) < 2:
            raise _Refused("a JPEG 2000 SIZ marker cut short")
        _walk_comment(data, max(pos + struct.unpack(">H", hdr)[0], 0))
    return _Pillow(mode, size, palette)


# ---------------------------------------------- openjpeg's JP2 reading

class _Jp2(NamedTuple):
    codestream: int       # offset of the codestream in the file
    color_space: str
    size: tuple           # ihdr's (width, height)


def _openjpeg_jp2(data) -> _Jp2:
    """opj_jp2_read_header: the boxes openjpeg reads, its refusals, the
    colour space it reports and where the codestream starts."""
    pos, state = 0, 0  # 1 signature, 2 ftyp, 4 jp2h
    enumcs, colr_seen, size = None, False, None
    pclr = cmap = cdef = False
    ncomps = None
    while True:
        if len(data) - pos < 8:
            raise ValueError("a JP2 file without a codestream box")
        length, kind = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if length == 0:
            length = len(data) - pos
        elif length == 1:
            if len(data) - pos < 16:
                raise ValueError("a JP2 box cut short")
            hi, length = struct.unpack_from(">II", data, pos + 8)
            if hi:
                raise ValueError("a JP2 box past 4 GiB")
            hlen = 16
        if kind == b"jp2c":
            if not state & 4:
                raise ValueError("a JP2 codestream box before jp2h")
            break
        if length < hlen:
            raise ValueError("a JP2 box of a bad length")
        body = data[pos + hlen:pos + length]
        if kind == b"jP  ":
            if len(body) != 4 or body != b"\r\n\x87\n":
                raise ValueError("a bad JP2 signature box")
            state |= 1
        elif kind == b"ftyp":
            if state != 1:
                raise ValueError("a JP2 ftyp box out of place")
            if len(body) < 8 or len(body) % 4:
                raise ValueError("a JP2 ftyp box of a bad length")
            state |= 2
        elif kind == b"jp2h":
            if not state & 2:
                raise ValueError("a JP2 jp2h box before ftyp")
            if len(body) < length - hlen:
                raise ValueError("a JP2 jp2h box cut short")
            sub, has_ihdr = 0, False
            while sub < len(body):
                if len(body) - sub < 8:
                    raise ValueError("a JP2 header box cut short")
                blen, bkind = struct.unpack_from(">I4s", body, sub)
                bh = 8
                if blen == 1:
                    if len(body) - sub < 16:
                        raise ValueError("a JP2 header box cut short")
                    hi, blen = struct.unpack_from(">II", body, sub + 8)
                    bh = 16
                    if hi:
                        raise ValueError("a JP2 box past 4 GiB")
                elif blen == 0:
                    raise ValueError("a JP2 header box of no length")
                if blen < bh or blen > len(body) - sub:
                    raise ValueError("a JP2 header box of a bad length")
                b = body[sub + bh:sub + blen]
                if bkind == b"ihdr":
                    if len(b) != 14:
                        raise ValueError("a JP2 ihdr box of a bad size")
                    if not has_ihdr:
                        h, w, nc, _ = struct.unpack_from(">IIHB", b)
                        if nc == 0 or nc > 16384 or w == 0 or h == 0:
                            raise ValueError("a JP2 ihdr box of no pixels")
                        size, ncomps = (w, h), nc
                    has_ihdr = True
                elif bkind == b"colr":
                    if len(b) < 3:
                        raise ValueError("a JP2 colr box cut short")
                    if not colr_seen and b[0] in (1, 2):
                        if b[0] == 1:
                            if len(b) < 7:
                                raise ValueError("a JP2 colr box cut short")
                            enumcs = struct.unpack_from(">I", b, 3)[0]
                        colr_seen = True
                elif bkind == b"pclr":
                    _check_pclr(b, pclr)
                    pclr = True
                elif bkind == b"cmap":
                    if not pclr:
                        raise ValueError("a JP2 cmap box before pclr")
                    if cmap:
                        raise ValueError("two JP2 cmap boxes")
                    cmap = True
                elif bkind == b"cdef":
                    if cdef or len(b) < 2:
                        raise ValueError("a bad JP2 cdef box")
                    n = struct.unpack_from(">H", b)[0]
                    if n == 0 or len(b) < 2 + 6 * n:
                        raise ValueError("a bad JP2 cdef box")
                    cdef = True
                elif bkind == b"bpcc":
                    if ncomps is not None and len(b) != ncomps:
                        raise ValueError("a JP2 bpcc box of a bad size")
                sub += blen
            if not has_ihdr:
                raise ValueError("a JP2 jp2h box without ihdr")
            state |= 4
        elif kind == b"colr" and state & 4:
            # a colr outside jp2h counts once the header is read
            if len(body) >= 3 and not colr_seen and body[0] in (1, 2):
                if body[0] == 1:
                    if len(body) < 7:
                        raise ValueError("a JP2 colr box cut short")
                    enumcs = struct.unpack_from(">I", body, 3)[0]
                colr_seen = True
        else:
            if not state & 1:
                raise ValueError("a JP2 file that does not start with jP")
            if not state & 2:
                raise ValueError("a JP2 box before ftyp")
            if length - hlen > len(data) - pos - hlen:
                raise ValueError("a JP2 box cut short")
        pos += length
    cs = _ENUMCS.get(enumcs, UNSPECIFIED) if colr_seen and enumcs else \
        UNSPECIFIED
    return _Jp2(pos + hlen, cs, size)


def _check_pclr(b, seen):
    if seen or len(b) < 3:
        raise ValueError("a bad JP2 pclr box")
    ne, nch = struct.unpack_from(">HB", b)
    if ne == 0 or ne > 1024 or nch == 0 or len(b) < 3 + nch:
        raise ValueError("a bad JP2 pclr box")
    per = sum(((d & 0x7F) + 8) // 8 for d in b[3:3 + nch])
    if 3 + nch + ne * per > len(b):
        raise ValueError("a JP2 pclr box cut short")


# ------------------------------------------------------ the codestream

class _Geometry(NamedTuple):
    x0: int
    y0: int
    x1: int
    y1: int
    tile: tuple           # (x0, y0, w, h) of the tile grid
    tiles: tuple          # (across, down)
    comps: tuple          # ((dx, dy, prec, sgnd), ...)


def _header(lib, cs: bytes) -> _Geometry:
    info = np.zeros(11 + 4 * 16384, np.int32)
    err = ctypes.create_string_buffer(256)
    if lib.jp2_header(cs, len(cs), info.ctypes.data, len(info), err, 256):
        raise ValueError(err.value.decode())
    v = [int(x) & 0xFFFFFFFF for x in info[:11]]
    comps = tuple(tuple(int(x) for x in info[11 + 4 * c:15 + 4 * c])
                  for c in range(v[4]))
    return _Geometry(v[0], v[1], v[2], v[3], tuple(v[5:9]), tuple(v[9:11]),
                     comps)


def _ceil(a, b):
    return -(-a // b)


def _decode_planes(lib, cs: bytes, g: _Geometry):
    planes = []
    for dx, dy, _, _ in g.comps:
        planes.append(np.zeros((_ceil(g.y1, dy) - _ceil(g.y0, dy),
                                _ceil(g.x1, dx) - _ceil(g.x0, dx)), np.int32))
    ptrs = (ctypes.c_void_p * len(planes))(*[p.ctypes.data for p in planes])
    ntiles = g.tiles[0] * g.tiles[1]
    done = np.zeros(ntiles, np.uint8)
    order = np.zeros(ntiles + 1, np.int32)
    err = ctypes.create_string_buffer(256)
    if lib.jp2_decode(cs, len(cs), ptrs, done.ctypes.data, order.ctypes.data,
                      err, 256):
        raise ValueError(err.value.decode())
    return planes, [int(t) for t in order[:int(done.sum())]]


# ------------------------------------------------- Pillow's unpacking

def _ycc_tables():
    """Pillow's ConvertYCbCr.c tables: k * 64 * (i - 128) + 0.5, cut
    toward zero as a C cast cuts it (probed over every Y, Cb, Cr)."""
    i = np.arange(256, dtype=np.float64) - 128
    return tuple(np.trunc(i * k * 64 + 0.5).astype(np.int32)
                 for k in (1.402, -0.34414, -0.71414, 1.772))


_R_CR, _G_CB, _G_CR, _B_CB = _ycc_tables()


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """Pillow's ImagingConvertYCbCr2RGB of (..., 3) uint8."""
    y = ycc[..., 0].astype(np.int32)
    cb, cr = ycc[..., 1], ycc[..., 2]
    rgb = np.stack([y + (_R_CR[cr] >> 6), y + ((_G_CB[cb] + _G_CR[cr]) >> 6),
                    y + (_B_CB[cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's Convert.c cmyk2rgb of (..., 4) uint8: R = K' - MULDIV255(C,
    K') with K' = 255 - K."""
    v = cmyk.astype(np.int32)
    nk = 255 - v[..., 3:4]
    t = v[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


#: Pillow's j2k_unpackers: (mode, colour space, components, subsampling)
_UNPACKERS = (
    ("L", GRAY, 1, False, "gray_l"), ("P", SRGB, 1, False, "gray_l"),
    ("PA", SRGB, 2, False, "graya_la"), ("I;16", GRAY, 1, False, "gray_i"),
    ("LA", GRAY, 2, False, "graya_la"), ("RGB", GRAY, 1, False, "gray_rgb"),
    ("RGB", GRAY, 2, False, "gray_rgb"), ("RGB", SRGB, 3, True, "srgb_rgb"),
    ("RGB", SYCC, 3, True, "sycc_rgb"), ("RGB", SRGB, 4, True, "srgb_rgb"),
    ("RGB", SYCC, 4, True, "sycc_rgb"), ("RGBA", GRAY, 1, False, "gray_rgb"),
    ("RGBA", GRAY, 2, False, "graya_la"), ("RGBA", SRGB, 3, True,
                                           "srgb_rgb"),
    ("RGBA", SYCC, 3, True, "sycc_rgb"), ("RGBA", GRAY, 4, True,
                                          "srgba_rgba"),
    ("RGBA", SRGB, 4, True, "srgba_rgba"),
    ("RGBA", SYCC, 4, True, "sycca_rgba"), ("CMYK", CMYK, 4, True,
                                            "srgba_rgba"))


def _unpacker(mode, color_space, comps):
    n = len(comps)
    if color_space == UNSPECIFIED:
        color_space = GRAY if n <= 2 else SRGB
        if (n >= 3 and comps[0][:2] == (1, 1)
                and (comps[1][:2] != (1, 1) or comps[2][:2] != (1, 1))):
            color_space = SYCC
    subsampled = any(dx != 1 or dy != 1 for dx, dy, _, _ in comps)
    for m, cs, k, sub, name in _UNPACKERS:
        if (m == mode and cs == color_space and k == n
                and (sub or not subsampled)):
            return name
    raise ValueError(f"a JPEG 2000 {mode} image of {n} components in "
                     f"{color_space} colour, which Pillow does not unpack")


def _csiz(prec):
    c = (prec + 7) >> 3
    return 4 if c == 3 else c


def _shift(word, prec, sgnd, bits=8):
    """j2ku_shift of offset + word into `bits` bits."""
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
        return ((word + offset) >> -shift) & ((1 << bits) - 1)
    return ((word + offset) << shift) & ((1 << bits) - 1)


def _tile_words(plane, g, comp, rect):
    """A component's samples of a tile as openjpeg writes them (int8 / int16
    / int32, read back unsigned): a (h, w) int64 array."""
    dx, dy, prec, _ = comp
    x0, y0, x1, y1 = rect
    cx0, cy0 = _ceil(g.x0, dx), _ceil(g.y0, dy)
    block = plane[_ceil(y0, dy) - cy0:_ceil(y1, dy) - cy0,
                  _ceil(x0, dx) - cx0:_ceil(x1, dx) - cx0]
    return block.astype(np.int64) & ((1 << (8 * _csiz(prec))) - 1)


def _unpack_tile(name, planes, g, rect, out):
    """Pillow's unpacker `name` over one tile into `out` (its mode's
    storage: (H, W) for L / P / I;16, (H, W, 4) otherwise)."""
    x0, y0, x1, y1 = rect
    w, h = x1 - x0, y1 - y0
    ox, oy = x0 - g.x0, y0 - g.y0
    comps = g.comps
    if name in ("gray_l", "gray_i"):
        words = _tile_words(planes[0], g, comps[0], rect)
        bits = 16 if name == "gray_i" else 8
        out[oy:oy + h, ox:ox + w] = _shift(words, comps[0][2], comps[0][3],
                                           bits)
        return
    if name in ("gray_rgb", "graya_la"):
        v = _shift(_tile_words(planes[0], g, comps[0], rect), comps[0][2],
                   comps[0][3])
        dst = out[oy:oy + h, ox:ox + w]
        dst[..., 0] = dst[..., 1] = dst[..., 2] = v
        dst[..., 3] = 255 if name == "gray_rgb" else _shift(
            _tile_words(planes[1], g, comps[1], rect), comps[1][2],
            comps[1][3])
        return
    # the sRGB family: components at Pillow's floored, tile-relative
    # offsets into the tile's buffer
    n = 4 if name in ("srgba_rgba", "sycca_rgba") else 3
    buf = b"".join(
        _tile_words(planes[c], g, comps[c], rect).astype(
            {1: "<u1", 2: "<u2", 4: "<u4"}[_csiz(comps[c][2])]).tobytes()
        for c in range(len(comps)))
    flat = np.frombuffer(buf, np.uint8).astype(np.int64)
    yy, xx = np.mgrid[0:h, 0:w]
    start = 0
    dst = out[oy:oy + h, ox:ox + w]
    for c in range(n):
        dx, dy, prec, sgnd = comps[c]
        size = _csiz(prec)
        at = start + size * ((yy // dy) * (w // dx) + xx // dx)
        if int(at.max()) + size > len(buf):
            # past what openjpeg wrote: Pillow reads stale memory there
            raise ValueError("a JPEG 2000 subsampled component that Pillow "
                             "reads past its tile's data")
        word = sum(flat[at + k] << (8 * k) for k in range(size))
        dst[..., c] = _shift(word, prec, sgnd)
        start += size * (w // dx) * (h // dy)
    if n == 3:
        dst[..., 3] = 255
    if name.startswith("sycc"):
        dst[..., :3] = ycbcr_to_rgb(dst[..., :3].astype(np.uint8))


def _to_rgb(mode, image, palette) -> np.ndarray:
    """convert("RGB") of the unpacked image."""
    if mode == "L":
        return np.repeat(image.astype(np.uint8)[..., None], 3, -1)
    if mode == "I;16":
        v = np.minimum(image, 255).astype(np.uint8)
        return np.repeat(v[..., None], 3, -1)
    if mode == "P":
        return palette.rgb()[image]
    if mode == "PA":
        return palette.rgb()[image[..., 0]]
    if mode == "CMYK":
        return cmyk_to_rgb(image.astype(np.uint8))
    return np.ascontiguousarray(image[..., :3].astype(np.uint8))


def decode(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JP2 file or J2K codestream, as the JAX
    loader reads it; ValueError for what this reader refuses."""
    data = bytes(data)
    if not is_jp2(data):
        raise ValueError("not a JPEG 2000 file")
    try:
        pil = _pillow_header(data)
    except _Refused as e:
        raise ValueError(f"{e} (Pillow does not open it)") from None
    if data.startswith(J2K_SIGNATURE):
        cs, color_space, ihdr_size = data, UNSPECIFIED, None
    else:
        jp2 = _openjpeg_jp2(data)
        cs, color_space, ihdr_size = (data[jp2.codestream:], jp2.color_space,
                                      jp2.size)
    lib = load()
    g = _header(lib, cs)
    w, h = g.x1 - g.x0, g.y1 - g.y0
    if w * h > MAX_PIXELS:
        raise ValueError(f"a JPEG 2000 image of {w}x{h} pixels, past the "
                         f"limit")
    if ihdr_size is not None and ihdr_size != (w, h):
        raise ValueError("a JP2 ihdr size that differs from SIZ")
    if len(g.comps) > MAX_COMPONENTS:
        raise ValueError("a JPEG 2000 image of more than 4 components")
    if any(prec > MAX_PRECISION for _, _, prec, _ in g.comps):
        raise ValueError("a JPEG 2000 precision above 16 bits")
    if pil.size[0] * pil.size[1] > MAX_PIXELS or pil.size != (w, h):
        raise ValueError("a JPEG 2000 header size that differs from SIZ")
    name = _unpacker(pil.mode, color_space, g.comps)
    planes, order = _decode_planes(lib, cs, g)
    if pil.mode in ("L", "P", "I;16"):
        image = np.zeros((h, w), np.int64)
    else:
        image = np.zeros((h, w, 4), np.int64)
    tw, th = g.tile[2], g.tile[3]
    for t in order:
        p, q = t % g.tiles[0], t // g.tiles[0]
        rect = (max(g.tile[0] + p * tw, g.x0), max(g.tile[1] + q * th, g.y0),
                min(g.tile[0] + (p + 1) * tw, g.x1),
                min(g.tile[1] + (q + 1) * th, g.y1))
        _unpack_tile(name, planes, g, rect, image)
    return _to_rgb(pil.mode, image, pil.palette)
