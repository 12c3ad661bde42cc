"""JPEG on the host: the marker parser and entropy decode of the port's
decoder, and a baseline encoder that writes test and rehearsal tiles.

The port decodes a JPEG in two parts. `read_coefficients` parses the
markers here and runs the entropy decode of each scan in C++
(csrc/jpeg_entropy.cpp, built with g++ into build/, called through ctypes
with the GIL released), giving int16 coefficient blocks and the quant
tables; the pixel stage (dequantise, IDCT, upsampling, colour) is
`kernels/jpeg.pixels`, a CUDA kernel for a CUDA target and plain PyTorch
for a CPU one. Together they give what the JAX package's loader reads bit
for bit: libjpeg-turbo's default decode (`cpp/decode.cpp`: `JDCT_ISLOW`,
fancy upsampling, block smoothing), and for CMYK / YCCK files, which
libjpeg will not turn into RGB, Pillow's reading of libjpeg's CMYK.

It takes baseline and extended sequential Huffman streams (SOF0, SOF1),
progressive Huffman streams (SOF2, jdphuff.c: spectral selection and
successive approximation, end-of-band runs), and arithmetic-coded
sequential and progressive streams (SOF9, SOF10, jdarith.c, with the DAC
segment's conditioning); 1, 3 or 4 components; any integral sampling
ratio with at most 10 blocks an MCU in an interleaved scan. The parser
follows libjpeg's rules (jdmarker.c, jdinput.c, jdapimin.c): APPn and COM
segments are skipped, APP0 "JFIF" and APP14 "Adobe" are read for the
colour space, quant tables are latched at their component's first scan,
missing Huffman tables of a sequential stream are the standard ones (as
libjpeg-turbo loads them for motion-JPEG frames), and a stream that ends
early decodes with zeros for the missing data, reading what libjpeg's
source managers give past the end (fake EOI markers); a progressive image
whose AC coefficients are not all known gets libjpeg-turbo 2.1's block
smoothing (jdcoefct.c). It refuses, with a ValueError naming the feature,
lossless and hierarchical streams, samples other than 8-bit, the DNL
marker, 2 components and more than 10 blocks an MCU. A JPEG-compressed
TIFF's strips and tiles are abbreviated streams read as libtiff reads
them: `read_coefficients` takes the file's JPEGTables, and the colour
space, sampling and size the TIFF gives.

`encode` writes a baseline JFIF file (libjpeg's colour conversion,
downsampling, integer forward DCT and quality-scaled standard tables, the
standard Huffman tables): 4:4:4, 4:2:2, 4:2:0 or 4:4:0 (1x2) sampling, and
restart markers; or, for TIFF fixtures, an abbreviated stream (its tables
in `tables_only`), RGB coded as it is, and chosen JFIF and Adobe markers.
Pillow and libjpeg read its files; they are not byte-identical to
Pillow's.
"""

import ctypes
import struct
from typing import NamedTuple, Optional, Tuple

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

#: frame types the decoder takes: (progressive, arithmetic-coded)
_SOF = {0xC0: (False, False), 0xC1: (False, False), 0xC2: (True, False),
        0xC9: (False, True), 0xCA: (True, True)}
_REFUSED_SOF = {
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)",
    0xC6: "hierarchical progressive JPEG (SOF6)",
    0xC7: "hierarchical lossless JPEG (SOF7)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive JPEG (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless JPEG (SOF15)",
}
#: the components of a colour space a caller may give
_COMPONENTS = {"gray": 1, "ycc": 3, "rgb": 3}
#: the arithmetic conditioning values a stream starts with (jdmarker.c):
#: DC L, DC U and AC Kx of each of the 16 tables
_ARITH_DEFAULT = (0,) * 16 + (1,) * 16 + (5,) * 16
#: natural positions of coefficients 0-9 in zigzag order, the ones block
#: smoothing estimates (jdcoefct.c Q01_POS ...)
SMOOTHED = NATURAL[:10]


def _register(lib):
    ptr = ctypes.c_void_p
    lib.jpeg_decode_scan.restype = ctypes.c_int
    lib.jpeg_decode_scan.argtypes = [
        ptr, ctypes.c_long, ctypes.c_int, ptr, ptr, ptr, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ptr, ptr]
    lib.jpeg_decode_progressive.restype = ctypes.c_int
    lib.jpeg_decode_progressive.argtypes = [
        ptr, ctypes.c_long, ctypes.c_int, ptr, ptr, ptr, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ptr, ptr, ptr]
    lib.jpeg_decode_arith.restype = ctypes.c_int
    lib.jpeg_decode_arith.argtypes = [
        ptr, ctypes.c_long, ctypes.c_int, ptr, ptr, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ptr, ptr, ptr]
    lib.jpeg_smooth.restype = None
    lib.jpeg_smooth.argtypes = [ptr, ptr, ctypes.c_int, ptr, ctypes.c_int,
                                ptr, ptr, ptr, ctypes.c_long]
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
    h: int  # the sampling factors the pixel stage uses (1 x 1 for grey)
    v: int
    tq: int
    frame_v: int  # the SOF's v factor: an iMCU row's block rows


class _Frame(NamedTuple):
    height: int
    width: int
    comps: Tuple[_Component, ...]
    progressive: bool
    arithmetic: bool

    @property
    def imcu_rows(self):
        """libjpeg's total_iMCU_rows, from the SOF's factors."""
        return -(-self.height // (8 * max(c.frame_v for c in self.comps)))


class _Stream:
    """The state of a marker walk over one file. Past the end of the data
    it reads what libjpeg's source managers give there: fake EOI markers,
    0xFF 0xD9 over and over, so that a segment cut short is read as
    libjpeg reads it."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _bytes(self, n):
        data, pos = self.data, self.pos
        self.pos += n
        body = data[pos:pos + n]
        if len(body) < n:
            start = max(pos, len(data)) - len(data)
            fake = b"\xff\xd9" * ((n - len(body) + start) // 2 + 1)
            body += fake[start % 2:start % 2 + n - len(body)]
        return body

    def u8(self):
        return self._bytes(1)[0]

    def u16(self):
        return (self.u8() << 8) | self.u8()

    def segment(self):
        """The body of a marker segment whose length comes next."""
        n = self.u16()
        if n < 2:
            raise ValueError("bad JPEG marker segment length")
        return self._bytes(n - 2)

    def next_marker(self):
        """jdmarker.c next_marker: skip to the next 0xFF + code; None at
        the end of the data."""
        data, n = self.data, len(self.data)
        if self.pos >= n:  # the fake EOI
            return None
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
    """jdapimin.c default_decompress_parms: the colour space of 1, 3 and
    4 components. Four are CMYK, or YCCK under an Adobe marker whose
    transform is not 0."""
    if len(components) == 1:
        return "gray"
    if len(components) == 4:
        return "cmyk" if adobe is None or adobe == 0 else "ycck"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    if tuple(c.ident for c in components) == (82, 71, 66):  # 'R' 'G' 'B'
        return "rgb"
    return "ycc"


def _sof(body, marker, sampling=None, size=None):
    if marker in _REFUSED_SOF:
        raise ValueError(f"{_REFUSED_SOF[marker]} is not supported by the "
                         f"port's decoder")
    progressive, arithmetic = _SOF[marker]
    if len(body) < 6:
        raise ValueError("JPEG SOF segment too short")
    precision, height, width, n = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"{precision}-bit samples are not supported by the "
                         f"port's decoder (8-bit only)")
    if len(body) != 6 + 3 * n:
        raise ValueError("JPEG SOF segment has the wrong length")
    if height == 0 or width == 0 or n == 0:
        raise ValueError(f"JPEG image of size {height}x{width} with {n} "
                         f"components (a DNL marker is not supported)")
    if height > MAX_SIDE or width > MAX_SIDE:
        raise ValueError(f"JPEG image {height}x{width} exceeds {MAX_SIDE}")
    if height * width > MAX_PIXELS:
        raise ValueError(f"implausible image size {height}x{width}")
    if size is not None and (height, width) != tuple(size):
        raise ValueError(f"JPEG strip or tile of {height}x{width} where the "
                         f"TIFF's is {size[0]}x{size[1]}")
    if n not in (1, 3, 4):
        raise ValueError(f"{n}-component JPEG is not supported by the "
                         f"port's decoder (1, 3 or 4 components)")
    comps = []
    for i in range(n):
        ident, hv, tq = body[6 + 3 * i:9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4):
            raise ValueError(f"JPEG sampling factors {h}x{v} out of range")
        comps.append(_Component(ident, h, v, tq, v))
    if sampling is not None:
        # libtiff's JPEGPreDecode: component 0 sampled as the TIFF says,
        # every other 1 x 1
        got = [(c.h, c.v) for c in comps]
        if got != [tuple(sampling)] + [(1, 1)] * (n - 1):
            factors = ", ".join(f"{h}x{v}" for h, v in got)
            raise ValueError(f"JPEG sampling factors {factors} where the "
                             f"TIFF has {sampling[0]}x{sampling[1]} (and "
                             f"1x1 for the other components)")
    if n == 1:  # one component: its own MCU, no upsampling
        comps = [comps[0]._replace(h=1, v=1)]
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    for c in comps:  # jdsample.c: integral upsampling ratios only
        if hmax % c.h or vmax % c.v:
            factors = ", ".join(f"{d.h}x{d.v}" for d in comps)
            raise ValueError(f"JPEG sampling factors {factors} are not "
                             f"supported: fractional upsampling ratio")
    return _Frame(height, width, tuple(comps), progressive, arithmetic)


def _dqt(body, quant):
    """quant[t] = (the table as the IDCT reads it, as smoothing reads it),
    natural order, int32."""
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
        table[NATURAL] = raw
        # libjpeg-turbo's SIMD builds keep the IDCT's table as int16
        quant[tq] = (table.astype(np.int16).astype(np.int32), table)
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


def _dac(body, conditioning):
    """jdmarker.c get_dac: arithmetic conditioning values."""
    if len(body) % 2:
        raise ValueError("bad JPEG DAC segment length")
    for i in range(0, len(body), 2):
        index, val = body[i], body[i + 1]
        if index >= 32:
            raise ValueError(f"bad JPEG DAC table index {index}")
        if index >= 16:
            conditioning[32 + index - 16] = val
        else:
            low, high = val & 15, val >> 4
            if low > high:
                raise ValueError(f"bad JPEG DAC value {val}")
            conditioning[index], conditioning[16 + index] = low, high


class _Decode:
    """What a decode carries from scan to scan."""

    def __init__(self, frame, geometry):
        self.frame = frame
        self.geometry = geometry
        self.coef = np.zeros((geometry.n_blocks, 64), np.int16)
        self.latched = {}  # component -> its quant tables, once scanned
        self.scanned = set()
        n = len(frame.comps)
        # jdphuff.c / jdarith.c coef_bits: each coefficient's Al so far
        # (-1: none yet), and as it stood before the component's last scan
        self.bits = np.full((n, 64), -1, np.int64)
        self.prev_bits = np.zeros((n, 64), np.int64)
        self.scans = 0
        self.complete = False  # no scan may follow
        self.last_good = 0  # jdmaster.c last_good_iMCU_row


def _tables(data, quant, huffman):
    """An abbreviated table-specification stream (SOI, DQT and DHT
    segments, EOI: a TIFF's JPEGTables) read into `quant` and `huffman`,
    as libjpeg reads it before an abbreviated image stream. Its DAC and
    DRI values are not kept: the image's SOI resets them."""
    if not is_jpeg(data):
        raise ValueError("bogus JPEGTables (no SOI marker)")
    stream = _Stream(bytes(data))
    stream.pos = 2
    while True:
        marker = stream.next_marker()
        if marker is None or marker == 0xD9:
            return
        if marker == 0xDB:
            _dqt(stream.segment(), quant)
        elif marker == 0xC4:
            _dht(stream.segment(), huffman)
        elif 0xE0 <= marker <= 0xEF or marker in (0xFE, 0xCC, 0xDD):
            stream.segment()
        else:  # libtiff: "Bogus JPEGTables field"
            raise ValueError(f"bogus JPEGTables (marker 0xFF{marker:02X} "
                             f"in a tables-only stream)")


def read_coefficients(data: bytes, *, tables: bytes = None,
                      color: str = None, sampling=None,
                      size=None) -> Coefficients:
    """Parse a JPEG and entropy-decode its scans: the host half of the
    port's decoder. Raises ValueError for what it refuses or cannot
    parse; a stream that ends inside the entropy-coded data decodes as
    libjpeg decodes it (zeros for what is missing, and libjpeg's block
    smoothing of a progressive image's missing coefficients).

    A strip or tile of a JPEG-compressed TIFF is read as libtiff reads it:
    `tables` is the file's JPEGTables stream, read first; `color` ("gray",
    "ycc" or "rgb") is the colour space the TIFF's Photometric gives,
    whatever JFIF or Adobe markers say, and the stream must have its
    number of components; `sampling` (h, v) is component 0's sampling
    factors as the TIFF gives them, every other component's being 1 x 1
    (libtiff's JPEGPreDecode); `size` (height, width) is the strip's or
    tile's, which the frame must have. These are checked at the frame
    header, before anything is allocated."""
    data = bytes(data)
    if not is_jpeg(data):
        raise ValueError("not a JPEG file (no SOI marker)")
    stream = _Stream(data)
    stream.pos = 2
    quant, huffman = {}, {}
    if tables is not None:
        _tables(tables, quant, huffman)
    conditioning = np.array(_ARITH_DEFAULT, np.uint8)
    restart = 0
    jfif, adobe = False, None
    frame = state = None
    buf = np.frombuffer(data, np.uint8)
    while True:
        marker = stream.next_marker()
        if marker is None or marker == 0xD9:  # end of data or EOI
            if state is None:
                raise ValueError("JPEG has no image data (no scan)")
            break
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            body = stream.segment()
            if frame is not None:
                raise ValueError("JPEG has two SOF markers")
            frame = _sof(body, marker, sampling, size)
            if color is not None and len(frame.comps) != _COMPONENTS[color]:
                raise ValueError(f"{len(frame.comps)}-component JPEG where "
                                 f"the TIFF has {_COMPONENTS[color]}")
        elif marker == 0xC4:
            _dht(stream.segment(), huffman)
        elif marker == 0xDB:
            _dqt(stream.segment(), quant)
        elif marker == 0xCC:
            _dac(stream.segment(), conditioning)
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
        elif 0xE1 <= marker <= 0xEF or marker in (0xFE, 0xDC):
            stream.segment()  # APPn, COM, and DNL, which libjpeg skips
        elif 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pass  # parameterless (RSTn, TEM)
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame (SOS before "
                                 "SOF)")
            if state is None:
                comps = frame.comps
                state = _Decode(frame, Geometry(
                    frame.height, frame.width, tuple((c.h, c.v)
                                                     for c in comps),
                    color or _colour(comps, jfif, adobe)))
            body = stream.segment()
            if state.complete:  # jdinput.c: JERR_EOI_EXPECTED
                raise ValueError("JPEG has a scan after its image's only "
                                 "one (EOI expected)")
            stream.pos = _scan(load(), buf, stream.pos, body, state, quant,
                               huffman, conditioning, restart)
            # a sequential image whose first scan holds every component
            # has no other scan: libjpeg reads on to EOI for markers only
            state.complete = not frame.progressive and state.scans == 1 \
                and len(body) == 4 + 2 * len(frame.comps)
        elif marker == 0xD8:
            raise ValueError("JPEG has a second SOI marker")
        else:
            raise ValueError(f"unknown JPEG marker 0xFF{marker:02X}")
    geometry = state.geometry
    n = len(geometry.factors)
    q = np.stack([state.latched[i][0] if i in state.latched
                  else np.ones(64, np.int32) for i in range(n)])
    coef = state.coef
    if frame.progressive:
        coef = _smooth(state, coef)
    return Coefficients(geometry, q, coef)


def _scan(lib, buf, start, body, state, quant, huffman, conditioning,
          restart):
    """Entropy-decode one scan whose coded data starts at byte `start`;
    returns where the marker walk resumes."""
    frame, geometry = state.frame, state.geometry
    comps = frame.comps
    n = body[0] if body else 0
    if not 1 <= n <= 4 or len(body) != 4 + 2 * n:
        raise ValueError("bad JPEG SOS segment")
    ss, se, ah, al = body[1 + 2 * n], body[2 + 2 * n], \
        body[3 + 2 * n] >> 4, body[3 + 2 * n] & 15
    ids = [c.ident for c in comps]
    members, desc = [], []
    for k in range(n):
        ident, tables = body[1 + 2 * k], body[2 + 2 * k]
        if ident not in ids:
            raise ValueError(f"JPEG scan names an unknown component "
                             f"{ident}")
        ci = ids.index(ident)
        if ci not in state.latched:
            if comps[ci].tq not in quant:
                raise ValueError(f"JPEG quant table {comps[ci].tq} is not "
                                 f"defined")
            state.latched[ci] = quant[comps[ci].tq]
        state.scanned.add(ci)
        members.append(ci)
        dc, ac = tables >> 4, tables & 15
        c = comps[ci]
        desc += [c.h, c.v, geometry.blocks[ci][1], geometry.first_block[ci],
                 dc, ac]
    state.scans += 1
    if n == 1:  # non-interleaved: one block per MCU over the real blocks
        ch, cw = geometry.sampled[members[0]]
        mcus_y, mcus_x = -(-ch // 8), -(-cw // 8)
        imcu = comps[members[0]].frame_v
    else:
        if sum(comps[ci].h * comps[ci].v for ci in members) > 10:
            raise ValueError("JPEG sampling factors too large for an "
                             "interleaved scan (more than 10 blocks an MCU)")
        mcus_y, mcus_x = geometry.mcus
        imcu = 1
    if frame.progressive:
        _progression(state, members, ss, se, ah, al)
    desc = np.asarray(desc, np.int32)
    out = np.zeros(4, np.int64)
    left = max(len(buf) - start, 0)
    coef = state.coef
    if frame.arithmetic:
        params = np.array([frame.progressive, ss, se, ah, al, imcu],
                          np.int32)
        rc = lib.jpeg_decode_arith(
            buf.ctypes.data + start, left, n, desc.ctypes.data,
            conditioning.ctypes.data, mcus_x, mcus_y, restart,
            params.ctypes.data, coef.ctypes.data, out.ctypes.data)
    else:
        if frame.progressive:  # jdphuff.c: only the tables the scan reads
            if ss == 0:
                needed = [] if ah else [(0, t) for t in desc[4::6]]
            else:
                needed = [(1, t) for t in desc[5::6]]
            for cls, ident in needed:
                if (cls, int(ident)) not in huffman:
                    raise ValueError(f"JPEG Huffman table {ident} is not "
                                     f"defined")
        else:
            for cls, ident in [(0, t) for t in desc[4::6]] + [
                    (1, t) for t in desc[5::6]]:
                if (cls, int(ident)) not in huffman and ident > 1:
                    raise ValueError(f"JPEG Huffman table {ident} is not "
                                     f"defined")
        bits, vals = _huffman_arrays(huffman)
        if frame.progressive:
            params = np.array([ss, se, ah, al, imcu], np.int32)
            rc = lib.jpeg_decode_progressive(
                buf.ctypes.data + start, left, n,
                desc.ctypes.data, bits.ctypes.data, vals.ctypes.data,
                mcus_x, mcus_y, restart, params.ctypes.data,
                coef.ctypes.data, out.ctypes.data)
        else:
            rc = lib.jpeg_decode_scan(
                buf.ctypes.data + start, left, n,
                desc.ctypes.data, bits.ctypes.data, vals.ctypes.data, mcus_x,
                mcus_y, restart, coef.ctypes.data, out.ctypes.data)
    if rc == -1:
        raise ValueError("bad JPEG Huffman table")
    if rc == -3:
        raise ValueError("bad JPEG DC coefficient (past an int)")
    if rc != 0:
        raise ValueError(f"JPEG scan decode failed ({rc})")
    if frame.progressive and out[3] >= 0:
        state.last_good = int(out[3])
    end, marker = start + int(out[0]), int(out[1])
    if marker and end <= len(buf) and buf[end - 1] == marker:
        end -= 2  # the marker the reader stopped at is walked again
    return end


def _progression(state, members, ss, se, ah, al):
    """jdphuff.c / jdarith.c start_pass: a progressive scan's parameters
    (ValueError where libjpeg stops with JERR_BAD_PROGRESSION), and the
    coefficient bits it brings (an inconsistent order, libjpeg's warning,
    is decoded as it comes)."""
    bad = (se != 0 if ss == 0 else (ss > se or se > 63 or len(members) != 1))
    bad = bad or (ah != 0 and al != ah - 1) or al > 13
    if bad:
        raise ValueError(f"bad progressive JPEG scan (Ss={ss}, Se={se}, "
                         f"Ah={ah}, Al={al})")
    for ci in members:
        lo, hi = min(ss, 1), max(se, 9)
        state.prev_bits[ci, lo:hi + 1] = (state.bits[ci, lo:hi + 1]
                                          if state.scans > 1 else 0)
        state.bits[ci, ss:se + 1] = al


def _smooth(state, coef):
    """The coefficients as libjpeg-turbo's output pass reads them: block
    smoothing (csrc/jpeg_entropy.cpp jpeg_smooth) where jdcoefct.c
    smoothing_ok allows it: every component's quant table latched with
    nonzero values at the 10 smoothed positions, its DC at least partly
    known, and some of the 9 AC coefficients not known to full
    precision. A complete file is not smoothed."""
    n = len(state.frame.comps)
    useful = False
    for ci in range(n):
        if ci not in state.latched:
            return coef
        if not state.latched[ci][1][SMOOTHED].all():
            return coef
        if state.bits[ci, 0] < 0:
            return coef
        useful = useful or bool((state.bits[ci, 1:10] != 0).any())
    if not useful:
        return coef
    bits = np.ascontiguousarray(state.bits[:, :10], np.int32)
    prev = (np.ascontiguousarray(state.prev_bits[:, :10], np.int32)
            if state.scans > 1 else np.full((n, 10), -1, np.int32))
    g = state.geometry
    info = np.array([[g.first_block[ci], g.blocks[ci][1],
                      -(-g.sampled[ci][1] // 8), -(-g.sampled[ci][0] // 8),
                      c.frame_v] for ci, c in enumerate(state.frame.comps)],
                    np.int32)
    quant = np.ascontiguousarray(np.stack(
        [state.latched[ci][1] for ci in range(n)]), np.int32)
    out = coef.copy()
    load().jpeg_smooth(coef.ctypes.data, out.ctypes.data, n,
                       info.ctypes.data, state.frame.imcu_rows,
                       quant.ctypes.data, bits.ctypes.data,
                       prev.ctypes.data, state.last_good)
    return out


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
           restart_interval: int = 0, *, color: str = "ycc",
           tables: bool = True, jfif: bool = True,
           adobe: Optional[int] = None) -> bytes:
    """A baseline JPEG of an (H, W, 3) uint8 RGB image, or of an (H, W)
    uint8 grey one (then `sampling` and `color` are ignored): quality-scaled
    IJG tables, the standard Huffman tables, luma sampled 1x1 ("4:4:4"),
    2x1 ("4:2:2"), 2x2 ("4:2:0") or 1x2 ("4:4:0") against 1x1 chroma, and
    a restart marker every `restart_interval` MCUs (0: none).

    `color` "ycc" converts to YCbCr; "rgb" codes R, G and B as they are
    (4:4:4 only). A JFIF APP0 segment unless `jfif` is false, and an Adobe
    APP14 one of transform `adobe` where given. Without `tables` the
    stream is abbreviated, its DQT and DHT segments left out: a JPEG TIFF
    strip or tile whose tables are `tables_only(...)`."""
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
    if color not in ("ycc", "rgb") or (color == "rgb" and not gray
                                        and sampling != "4:4:4"):
        raise ValueError(f"cannot encode colour {color!r} at {sampling}")
    color = "gray" if gray else color
    factors = ((1, 1),) if gray else (_SAMPLING[sampling], (1, 1), (1, 1))
    geometry = Geometry(height, width, factors, color)
    my, mx = geometry.mcus
    ph, pw = my * 8 * geometry.vmax, mx * 8 * geometry.hmax
    pad = [(0, ph - height), (0, pw - width)] + [(0, 0)] * (img.ndim - 2)
    padded = np.pad(img, pad, mode="edge").astype(np.int64)
    if gray:
        planes = [padded]
    elif color == "ycc":
        planes = list(_rgb_to_ycc(padded))
    else:
        planes = [padded[..., i] for i in range(3)]
    quant = quality_tables(quality, len(factors))
    coef = []
    for ci, plane in enumerate(planes):
        rh, rv = geometry.ratios[ci]
        coef.append(_quantise(_downsample(plane, rh, rv), quant[min(ci, 1)]))
    return _jfif(geometry, quant, np.concatenate(coef), restart_interval,
                 tables=tables, jfif=jfif, adobe=adobe)


def quality_tables(quality: int, components: int):
    """The quant tables `encode` uses: luma, and chroma where the image
    has more than one component."""
    base = (STD_LUMA_QUANT, STD_CHROMA_QUANT)[:1 if components == 1 else 2]
    return [quality_table(b, quality) for b in base]


def _table_segments(tables) -> bytes:
    """DQT segments of `tables` (natural order; 16-bit where a value
    exceeds 255) and DHT segments of the standard Huffman tables they
    go with."""
    head = []
    for t, table in enumerate(tables):
        table = np.asarray(table)[NATURAL]
        wide = int(table.max() > 255)
        head.append(_segment(0xDB, bytes([(wide << 4) | t]) + table.astype(
            ">u2" if wide else np.uint8).tobytes()))
    for (cls, ident), (counts, values) in sorted(STD_HUFFMAN.items()):
        if ident < len(tables):
            head.append(_segment(0xC4, bytes([(cls << 4) | ident, *counts])
                                 + values))
    return b"".join(head)


def tables_only(quality: int, components: int) -> bytes:
    """The abbreviated table-specification stream (SOI, DQT, DHT, EOI) of
    `encode(..., tables=False)` images of that quality and number of
    components: a TIFF's JPEGTables."""
    return SOI + _table_segments(quality_tables(quality, components)) \
        + b"\xff\xd9"


def _jfif(geometry: Geometry, quant, coef: np.ndarray,
          restart_interval: int, *, tables: bool = True, jfif: bool = True,
          adobe: Optional[int] = None) -> bytes:
    """A baseline JPEG of quantised coefficients ((n_blocks, 64) int16,
    natural order, laid out as `read_coefficients` gives them): component
    0 with quant table 0 (`quant`, natural order) and Huffman tables 0,
    the others with table 1, the standard Huffman tables, one interleaved
    scan; component ids R, G, B for an RGB geometry, 1, 2, 3 else. The
    markers as `encode` describes them."""
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
    head = [SOI]
    if jfif:
        head.append(_segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\0\0"))
    if adobe is not None:
        head.append(_segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                             + bytes([adobe])))
    if tables:
        head.append(_table_segments(quant))
    ids = b"RGB" if geometry.color == "rgb" else bytes([1, 2, 3])
    sof = struct.pack(">BHHB", 8, geometry.height, geometry.width,
                      len(factors))
    for ci, (h, v) in enumerate(factors):
        sof += bytes([ids[ci], (h << 4) | v, min(ci, 1)])
    head.append(_segment(0xC0, sof))
    if restart_interval:
        head.append(_segment(0xDD, struct.pack(">H", restart_interval)))
    sos = bytes([len(factors)])
    for ci in range(len(factors)):
        sos += bytes([ids[ci], (min(ci, 1) << 4) | min(ci, 1)])
    head.append(_segment(0xDA, sos + b"\x00\x3f\x00"))
    return b"".join(head) + out[:n].tobytes() + b"\xff\xd9"
