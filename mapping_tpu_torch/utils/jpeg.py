"""Baseline JPEG on the host: the marker parser and entropy decode of the
port's decoder, and a baseline encoder that writes test and rehearsal
tiles.

The port decodes a JPEG in two parts. `read_coefficients` parses the
markers here and runs the Huffman decode of each scan in C++
(csrc/jpeg_entropy.cpp, built with g++ into build/, called through ctypes
with the GIL released), giving int16 coefficient blocks and the quant
tables; the pixel stage (dequantise, IDCT, upsampling, colour) is
`kernels/jpeg.pixels`, CUDA kernels for a CUDA target and plain PyTorch for
a CPU one. Together they give libjpeg-turbo's default decode (the JAX
package's `cpp/decode.cpp`: `JDCT_ISLOW`, fancy upsampling) bit for bit.

The parser follows libjpeg's rules (jdmarker.c, jdinput.c, jdapimin.c):
APPn and COM segments are skipped, APP0 "JFIF" and APP14 "Adobe" are read
for the colour space, quant tables are latched at their component's first
scan, missing Huffman tables are the standard ones (as libjpeg-turbo loads
them for motion-JPEG frames), and a stream that ends early decodes with
zeros for the missing data. It refuses, with a ValueError naming the
feature, what the port's decoder does not take: progressive,
lossless, hierarchical and arithmetic-coded streams, samples other than
8-bit, other than 1 or 3 components (CMYK / YCCK), and sampling factors
whose ratio to the largest is not 1 or 2 in each direction.

`encode` writes a baseline JFIF file (libjpeg's colour conversion,
downsampling, integer forward DCT and quality-scaled standard tables, the
standard Huffman tables): 4:4:4, 4:2:2, 4:2:0 or 4:4:0 (1x2) sampling, and
restart markers. Pillow and libjpeg read its files; they are not
byte-identical to Pillow's.
"""

import ctypes
import struct
from typing import NamedTuple, Tuple

import numpy as np

from mapping_tpu_torch.kernels.build import CSRC
from mapping_tpu_torch.utils.native_lib import NativeLib

SOI = b"\xff\xd8"
#: zigzag index -> natural (row-major) index
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
#: the largest image side libjpeg takes (JPEG_MAX_DIMENSION)
MAX_SIDE = 65500
#: a header claiming more pixels than this is refused before anything is
#: allocated (~134 MP, the JAX decoder's limit)
MAX_PIXELS = 1 << 27

# the IJG / Annex K tables, natural order
STD_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA_QUANT = np.full(64, 99)
STD_CHROMA_QUANT[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
#: (class, id) -> (bits[1..16], values): Annex K.3, as libjpeg's
#: std_huff_tables loads them
STD_HUFFMAN = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
             _AC_LUMA_VALS),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
             _AC_CHROMA_VALS),
}

_REFUSED_SOF = {
    0xC2: "progressive JPEG (SOF2)",
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)",
    0xC6: "hierarchical progressive JPEG (SOF6)",
    0xC7: "hierarchical lossless JPEG (SOF7)",
    0xC9: "arithmetic-coded JPEG (SOF9)",
    0xCA: "arithmetic-coded progressive JPEG (SOF10)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive JPEG (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless JPEG (SOF15)",
}

def _register(lib):
    ptr = ctypes.c_void_p
    lib.jpeg_decode_scan.restype = ctypes.c_int
    lib.jpeg_decode_scan.argtypes = [
        ptr, ctypes.c_long, ctypes.c_int, ptr, ptr, ptr, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ptr, ptr]
    lib.jpeg_encode_scan.restype = ctypes.c_long
    lib.jpeg_encode_scan.argtypes = [
        ptr, ctypes.c_int, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ptr, ctypes.c_long]


_lib = NativeLib("jpeg_entropy.cpp", "jpeg_entropy", _register,
                 src_dir=CSRC)
load = _lib.load


class Geometry(NamedTuple):
    """What the pixel stage needs to know of an image, and all that a
    batch must share: size, sampling factors (h, v) per component, and
    the colour space ("gray", "ycc" or "rgb")."""

    height: int
    width: int
    factors: Tuple[Tuple[int, int], ...]
    color: str

    @property
    def hmax(self):
        return max(h for h, _ in self.factors)

    @property
    def vmax(self):
        return max(v for _, v in self.factors)

    @property
    def mcus(self):
        """(rows, columns) of interleaved MCUs."""
        return (-(-self.height // (8 * self.vmax)),
                -(-self.width // (8 * self.hmax)))

    @property
    def blocks(self):
        """(rows, columns) of coefficient blocks per component, padded to
        whole MCUs."""
        my, mx = self.mcus
        return tuple((my * v, mx * h) for h, v in self.factors)

    @property
    def first_block(self):
        """Each component's first block in an image's coefficients."""
        out, n = [], 0
        for by, bx in self.blocks:
            out.append(n)
            n += by * bx
        return tuple(out)

    @property
    def n_blocks(self):
        return sum(by * bx for by, bx in self.blocks)

    @property
    def sampled(self):
        """(rows, columns) of real samples per component: libjpeg's
        downsampled_height and downsampled_width."""
        return tuple((-(-self.height * v // self.vmax),
                      -(-self.width * h // self.hmax))
                     for h, v in self.factors)

    @property
    def ratios(self):
        """(horizontal, vertical) upsampling factor per component."""
        return tuple((self.hmax // h, self.vmax // v)
                     for h, v in self.factors)


class Coefficients(NamedTuple):
    """The host half of a decode: the geometry, the quant tables latched
    per component (int32, natural order) and the quantised coefficients
    ((n_blocks, 64) int16, natural order, components one after another,
    blocks row-major)."""

    geometry: Geometry
    quant: np.ndarray
    coef: np.ndarray


def is_jpeg(data: bytes) -> bool:
    return bytes(data[:2]) == SOI


class _Component(NamedTuple):
    ident: int
    h: int
    v: int
    tq: int


class _Stream:
    """The state of a marker walk over one file."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u8(self):
        if self.pos >= len(self.data):
            raise ValueError("JPEG ends inside a marker segment")
        self.pos += 1
        return self.data[self.pos - 1]

    def u16(self):
        return (self.u8() << 8) | self.u8()

    def segment(self):
        """The body of a marker segment whose length comes next."""
        n = self.u16()
        if n < 2 or self.pos + n - 2 > len(self.data):
            raise ValueError("JPEG ends inside a marker segment")
        body = self.data[self.pos:self.pos + n - 2]
        self.pos += n - 2
        return body

    def next_marker(self):
        """jdmarker.c next_marker: skip to the next 0xFF + code; None at
        the end of the data."""
        data, n = self.data, len(self.data)
        while True:
            i = data.find(b"\xff", self.pos)
            if i < 0:
                self.pos = n
                return None
            j = i + 1
            while j < n and data[j] == 0xFF:
                j += 1
            if j >= n:
                self.pos = n
                return None
            self.pos = j + 1
            if data[j] != 0:
                return data[j]


def _huffman_arrays(tables):
    """(bits (8, 17), values (8, 256)) uint8 arrays: DC tables 0-3, then
    AC tables 0-3, the standard ones where the stream defines none."""
    bits = np.zeros((8, 17), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    for cls in (0, 1):
        for ident in range(4):
            b, v = tables.get((cls, ident)) or STD_HUFFMAN.get(
                (cls, ident), ((0,) * 16, b""))
            bits[4 * cls + ident, 1:] = b
            vals[4 * cls + ident, :len(v)] = np.frombuffer(v, np.uint8)
    return bits, vals


def _colour(components, jfif, adobe):
    """jdapimin.c default_decompress_parms for 1 and 3 components."""
    if len(components) == 1:
        return "gray"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    if tuple(c.ident for c in components) == (82, 71, 66):  # 'R' 'G' 'B'
        return "rgb"
    return "ycc"


def _sof(body, marker):
    if marker in _REFUSED_SOF:
        raise ValueError(f"{_REFUSED_SOF[marker]} is not supported by the "
                         f"port's baseline decoder")
    if len(body) < 6:
        raise ValueError("JPEG SOF segment too short")
    precision, height, width, n = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"{precision}-bit samples are not supported by the "
                         f"port's baseline decoder (8-bit only)")
    if len(body) != 6 + 3 * n:
        raise ValueError("JPEG SOF segment has the wrong length")
    if height == 0 or width == 0 or n == 0:
        raise ValueError(f"JPEG image of size {height}x{width} with {n} "
                         f"components (a DNL marker is not supported)")
    if height > MAX_SIDE or width > MAX_SIDE:
        raise ValueError(f"JPEG image {height}x{width} exceeds {MAX_SIDE}")
    if height * width > MAX_PIXELS:
        raise ValueError(f"implausible image size {height}x{width}")
    if n == 4:
        raise ValueError("4-component JPEG (CMYK / YCCK) is not supported "
                         "by the port's baseline decoder")
    if n not in (1, 3):
        raise ValueError(f"{n}-component JPEG is not supported by the "
                         f"port's baseline decoder")
    comps = []
    for i in range(n):
        ident, hv, tq = body[6 + 3 * i:9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4):
            raise ValueError(f"JPEG sampling factors {h}x{v} out of range")
        comps.append(_Component(ident, h, v, tq))
    if n == 1:  # one component: its own MCU, no upsampling
        comps = [comps[0]._replace(h=1, v=1)]
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    for c in comps:
        if hmax % c.h or vmax % c.v or hmax // c.h > 2 or vmax // c.v > 2:
            factors = ", ".join(f"{d.h}x{d.v}" for d in comps)
            raise ValueError(f"JPEG sampling factors {factors} are not "
                             f"supported by the port's baseline decoder "
                             f"(each must be 1 or 2 times smaller than the "
                             f"largest in each direction)")
    return height, width, comps


def _dqt(body, quant):
    i = 0
    while i < len(body):
        pq, tq = body[i] >> 4, body[i] & 15
        i += 1
        if tq > 3 or pq > 1:
            raise ValueError(f"bad JPEG DQT table {tq} of precision {pq}")
        n = 64 * (pq + 1)
        if i + n > len(body):
            raise ValueError("JPEG DQT segment too short")
        raw = np.frombuffer(body[i:i + n], ">u2" if pq else np.uint8)
        table = np.zeros(64, np.int32)
        # libjpeg-turbo's SIMD builds keep the table as int16
        table[NATURAL] = raw.astype(np.int32).astype(np.int16)
        quant[tq] = table
        i += n


def _dht(body, tables):
    i = 0
    while i < len(body):
        if i + 17 > len(body):
            raise ValueError("JPEG DHT segment too short")
        tc, th = body[i] >> 4, body[i] & 15
        counts = tuple(body[i + 1:i + 17])
        total = sum(counts)
        i += 17
        if tc > 1 or th > 3 or total > 256 or i + total > len(body):
            raise ValueError("bad JPEG DHT segment")
        tables[(tc, th)] = (counts, bytes(body[i:i + total]))
        i += total


def read_coefficients(data: bytes) -> Coefficients:
    """Parse a baseline JPEG and Huffman-decode its scans: the host half
    of the port's decoder. Raises ValueError for what it refuses or
    cannot parse; a stream that ends inside the entropy-coded data
    decodes as libjpeg decodes it (zeros for what is missing)."""
    data = bytes(data)
    if not is_jpeg(data):
        raise ValueError("not a JPEG file (no SOI marker)")
    stream = _Stream(data)
    stream.pos = 2
    quant, latched, huffman = {}, {}, {}
    restart = 0
    jfif, adobe = False, None
    frame = None
    geometry = coef = None
    scanned = set()
    buf = np.frombuffer(data, np.uint8)
    lib = None
    while True:
        marker = stream.next_marker()
        if marker is None or marker == 0xD9:  # end of data or EOI
            if coef is None:
                raise ValueError("JPEG has no image data (no scan)")
            break
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            body = stream.segment()
            if frame is not None:
                raise ValueError("JPEG has two SOF markers")
            frame = _sof(body, marker)
        elif marker == 0xC4:
            _dht(stream.segment(), huffman)
        elif marker == 0xDB:
            _dqt(stream.segment(), quant)
        elif marker == 0xDD:
            body = stream.segment()
            if len(body) != 2:
                raise ValueError("bad JPEG DRI segment")
            restart = struct.unpack(">H", body)[0]
        elif marker == 0xE0:
            body = stream.segment()
            jfif = jfif or (len(body) >= 14 and body[:5] == b"JFIF\0")
        elif marker == 0xEE:
            body = stream.segment()
            if len(body) >= 12 and body[:5] == b"Adobe":
                adobe = body[11]
        elif 0xE1 <= marker <= 0xEF or marker in (0xFE, 0xCC, 0xDC):
            stream.segment()  # APPn, COM, DAC, DNL
        elif 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pass  # parameterless (RSTn, TEM)
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame (SOS before "
                                 "SOF)")
            height, width, comps = frame
            if geometry is None:
                geometry = Geometry(
                    height, width, tuple((c.h, c.v) for c in comps),
                    _colour(comps, jfif, adobe))
                coef = np.zeros((geometry.n_blocks, 64), np.int16)
                lib = load()
            body = stream.segment()
            pos = _scan(lib, buf, stream.pos, body, geometry, comps, quant,
                        latched, huffman, restart, coef, scanned)
            stream.pos = pos
            if len(scanned) == len(comps) and len(body) == 4 + 2 * len(
                    comps):
                break  # one interleaved scan: the image is complete
        elif marker == 0xD8:
            raise ValueError("JPEG has a second SOI marker")
        else:
            raise ValueError(f"unknown JPEG marker 0xFF{marker:02X}")
    q = np.stack([latched.get(i, np.ones(64, np.int32))
                  for i in range(len(geometry.factors))])
    return Coefficients(geometry, q, coef)


def _scan(lib, buf, start, body, geometry, comps, quant, latched, huffman,
          restart, coef, scanned):
    """Huffman-decode one scan whose entropy-coded data starts at byte
    `start`; returns where the marker walk resumes."""
    n = body[0] if body else 0
    if not 1 <= n <= 4 or len(body) != 4 + 2 * n:
        raise ValueError("bad JPEG SOS segment")
    ids = [c.ident for c in comps]
    desc = []
    for k in range(n):
        ident, tables = body[1 + 2 * k], body[2 + 2 * k]
        if ident not in ids:
            raise ValueError(f"JPEG scan names an unknown component "
                             f"{ident}")
        ci = ids.index(ident)
        if ci not in latched:
            if comps[ci].tq not in quant:
                raise ValueError(f"JPEG quant table {comps[ci].tq} is not "
                                 f"defined")
            latched[ci] = quant[comps[ci].tq]
        scanned.add(ci)
        dc, ac = tables >> 4, tables & 15
        for cls, ident in ((0, dc), (1, ac)):
            if (cls, ident) not in huffman and ident > 1:
                raise ValueError(f"JPEG Huffman table {ident} is not "
                                 f"defined")
        c = comps[ci]
        desc += [c.h, c.v, geometry.blocks[ci][1], geometry.first_block[ci],
                 dc, ac]
    if n == 1:  # non-interleaved: one block per MCU over the real blocks
        ch, cw = geometry.sampled[ids.index(body[1])]
        mcus_y, mcus_x = -(-ch // 8), -(-cw // 8)
    else:
        if sum(comps[ids.index(body[1 + 2 * k])].h
               * comps[ids.index(body[1 + 2 * k])].v
               for k in range(n)) > 10:
            raise ValueError("JPEG sampling factors too large for an "
                             "interleaved scan (more than 10 blocks an MCU)")
        mcus_y, mcus_x = geometry.mcus
    bits, vals = _huffman_arrays(huffman)
    desc = np.asarray(desc, np.int32)
    state = np.zeros(3, np.int64)
    rc = lib.jpeg_decode_scan(
        buf.ctypes.data + start, len(buf) - start, n, desc.ctypes.data,
        bits.ctypes.data, vals.ctypes.data, mcus_x, mcus_y, restart,
        coef.ctypes.data, state.ctypes.data)
    if rc == -1:
        raise ValueError("bad JPEG Huffman table")
    if rc != 0:
        raise ValueError(f"JPEG scan decode failed ({rc})")
    end, marker = start + int(state[0]), int(state[1])
    if marker and buf[end - 1] == marker:
        end -= 2  # the marker the reader stopped at is walked again
    return end


# --- the encoder -----------------------------------------------------------

_SAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2),
             "4:4:0": (1, 2)}


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c jpeg_quality_scaling + jpeg_add_quant_table with
    force_baseline: values in 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int32)


def _rgb_to_ycc(rgb):
    """jccolor.c rgb_ycc_convert (SCALEBITS 16)."""
    def fix(x):
        return int(x * 65536 + 0.5)

    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b
          + (128 << 16) + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b
          + (128 << 16) + half - 1) >> 16
    return y, cb, cr


def _downsample(plane, h, v):
    """jcsample.c: 2x2 averages with the bias 1, 2, 1, 2 along a row, 2x1
    with 0, 1, ...; 1x2 rounds half up (int_downsample)."""
    if (h, v) == (1, 1):
        return plane
    if (h, v) == (1, 2):
        return (plane[0::2] + plane[1::2] + 1) >> 1
    cols = plane.shape[1] // 2
    bias = np.arange(cols) % 2
    if (h, v) == (2, 1):
        return (plane[:, 0::2] + plane[:, 1::2] + bias) >> 1
    return (plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2]
            + plane[1::2, 1::2] + 1 + bias) >> 2


def _fdct_islow(blocks):
    """jfdctint.c jpeg_fdct_islow on (N, 8, 8) int64 level-shifted
    samples: the DCT scaled up by 8."""
    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_pass(d, first):
        # d: list of 8 arrays along the transformed axis
        tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
        tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
        tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
        tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        out = [None] * 8
        if first:
            out[0] = (tmp10 + tmp11) * 4
            out[4] = (tmp10 - tmp11) * 4
            shift = 11
        else:
            out[0] = descale(tmp10 + tmp11, 2)
            out[4] = descale(tmp10 - tmp11, 2)
            shift = 15
        z1 = (tmp12 + tmp13) * 4433
        out[2] = descale(z1 + tmp13 * 6270, shift)
        out[6] = descale(z1 - tmp12 * 15137, shift)
        z1, z2 = tmp4 + tmp7, tmp5 + tmp6
        z3, z4 = tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * 9633
        tmp4, tmp5 = tmp4 * 2446, tmp5 * 16819
        tmp6, tmp7 = tmp6 * 25172, tmp7 * 12299
        z1, z2 = z1 * -7373, z2 * -20995
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
        out[7] = descale(tmp4 + z1 + z3, shift)
        out[5] = descale(tmp5 + z2 + z4, shift)
        out[3] = descale(tmp6 + z2 + z3, shift)
        out[1] = descale(tmp7 + z1 + z4, shift)
        return out

    rows = one_pass([blocks[:, :, k] for k in range(8)], True)
    blocks = np.stack(rows, axis=2)
    cols = one_pass([blocks[:, k, :] for k in range(8)], False)
    return np.stack(cols, axis=1)


def _quantise(plane, table):
    """A (rows, cols) component plane, a multiple of 8 each way ->
    (blocks, 64) int16 quantised coefficients, row-major blocks."""
    r, c = plane.shape
    blocks = (plane.reshape(r // 8, 8, c // 8, 8).transpose(0, 2, 1, 3)
              .reshape(-1, 8, 8) - 128)
    dct = _fdct_islow(blocks).reshape(-1, 64)
    div = (table * 8).astype(np.int64)
    mag = (np.abs(dct) + div // 2) // div
    return (np.sign(dct) * mag).astype(np.int16)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def encode(rgb_u8, quality: int = 95, sampling: str = "4:2:0",
           restart_interval: int = 0) -> bytes:
    """A baseline JFIF file of an (H, W, 3) uint8 RGB image, or of an
    (H, W) uint8 grey one (then `sampling` is ignored): quality-scaled IJG
    tables, the standard Huffman tables, luma sampled 1x1 ("4:4:4"), 2x1
    ("4:2:2"), 2x2 ("4:2:0") or 1x2 ("4:4:0") against 1x1 chroma, and a
    restart marker every `restart_interval` MCUs (0: none)."""
    img = np.asarray(rgb_u8)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode needs (H, W, 3) or (H, W) uint8, got "
                         f"{img.dtype} {img.shape}")
    height, width = img.shape[:2]
    if not (0 < height <= MAX_SIDE and 0 < width <= MAX_SIDE):
        raise ValueError(f"cannot encode an image of {height}x{width}")
    if sampling not in _SAMPLING:
        raise ValueError(f"unknown sampling {sampling!r}; expected one of "
                         f"{sorted(_SAMPLING)}")
    if not 0 <= restart_interval <= 0xFFFF:
        raise ValueError(f"restart interval {restart_interval} out of range")
    gray = img.ndim == 2
    factors = ((1, 1),) if gray else (_SAMPLING[sampling], (1, 1), (1, 1))
    geometry = Geometry(height, width, factors, "gray" if gray else "ycc")
    my, mx = geometry.mcus
    ph, pw = my * 8 * geometry.vmax, mx * 8 * geometry.hmax
    pad = [(0, ph - height), (0, pw - width)] + [(0, 0)] * (img.ndim - 2)
    padded = np.pad(img, pad, mode="edge")
    planes = ([padded.astype(np.int64)] if gray
              else list(_rgb_to_ycc(padded)))
    tables = [quality_table(STD_LUMA_QUANT, quality),
              quality_table(STD_CHROMA_QUANT, quality)]
    coef = []
    for ci, plane in enumerate(planes):
        rh, rv = geometry.ratios[ci]
        coef.append(_quantise(_downsample(plane, rh, rv), tables[min(ci, 1)]))
    return _jfif(geometry, tables[:1 if gray else 2], np.concatenate(coef),
                 restart_interval)


def _jfif(geometry: Geometry, tables, coef: np.ndarray,
          restart_interval: int) -> bytes:
    """A baseline JFIF file of quantised coefficients ((n_blocks, 64)
    int16, natural order, laid out as `read_coefficients` gives them):
    component 0 with quant table 0 (`tables`, natural order; 16-bit where
    a value exceeds 255) and Huffman tables 0, the others with table 1,
    the standard Huffman tables, one interleaved scan."""
    factors = geometry.factors
    coef = np.ascontiguousarray(coef, np.int16)
    if coef.shape != (geometry.n_blocks, 64):
        raise ValueError(f"coefficients {coef.shape} do not fit {geometry}")
    comps = np.asarray(
        [[h, v, geometry.blocks[ci][1], geometry.first_block[ci],
          min(ci, 1), min(ci, 1)] for ci, (h, v) in enumerate(factors)],
        np.int32)
    bits, vals = _huffman_arrays({})
    cap = coef.size * 4 + 1024
    out = np.zeros(cap, np.uint8)
    my, mx = geometry.mcus
    # a grey image's one-component scan runs over its blocks, which are
    # its MCUs here
    n = load().jpeg_encode_scan(
        coef.ctypes.data, len(factors), comps.ctypes.data, bits.ctypes.data,
        vals.ctypes.data, mx, my, restart_interval, out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError(f"JPEG entropy coding failed ({n})")
    head = [SOI, _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\0\0")]
    for t, table in enumerate(tables):
        table = np.asarray(table)[NATURAL]
        wide = int(table.max() > 255)
        head.append(_segment(0xDB, bytes([(wide << 4) | t]) + table.astype(
            ">u2" if wide else np.uint8).tobytes()))
    sof = struct.pack(">BHHB", 8, geometry.height, geometry.width,
                      len(factors))
    for ci, (h, v) in enumerate(factors):
        sof += bytes([ci + 1, (h << 4) | v, min(ci, 1)])
    head.append(_segment(0xC0, sof))
    for (cls, ident), (counts, values) in sorted(STD_HUFFMAN.items()):
        if ident < len(tables):
            head.append(_segment(0xC4, bytes([(cls << 4) | ident, *counts])
                                 + values))
    if restart_interval:
        head.append(_segment(0xDD, struct.pack(">H", restart_interval)))
    sos = bytes([len(factors)])
    for ci in range(len(factors)):
        sos += bytes([ci + 1, (min(ci, 1) << 4) | min(ci, 1)])
    head.append(_segment(0xDA, sos + b"\x00\x3f\x00"))
    return b"".join(head) + out[:n].tobytes() + b"\xff\xd9"
