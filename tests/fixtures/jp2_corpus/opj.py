"""openjpeg 2.5, the library Pillow ships and decodes JPEG 2000 with, driven
through ctypes: an encoder for the options Pillow's `save` does not expose
(code-block styles, SOP / EPH, POC, tile-parts, ROI, subsampled
components, any precision), and Pillow's own decode loop
(`opj_read_tile_header` / `opj_decode_tile_data` per tile) for probing
what the JAX loader's decode sees before Pillow unpacks it.

Only the corpus script and the tests use it, where Pillow is installed;
the port never does. The layout of `opj_cparameters_t` is checked against
the defaults `opj_set_default_encoder_parameters` writes (`check_layout`),
and the corpus checks each written file's SIZ / COD by parsing it.
"""

import ctypes
import struct
import os
import tempfile
from ctypes import (CFUNCTYPE, POINTER, Structure, byref, c_char, c_char_p,
                    c_int, c_int32, c_uint16, c_uint32, c_void_p, c_float)
from pathlib import Path

import numpy as np

J2K, JP2 = 0, 2
PROG = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
CLRSPC = {"unknown": -1, "unspecified": 0, "srgb": 1, "gray": 2, "sycc": 3,
          "eycc": 4, "cmyk": 5}


class Poc(Structure):
    _fields_ = [(n, c_uint32) for n in (
        "resno0", "compno0", "layno1", "resno1", "compno1", "layno0",
        "precno0", "precno1")] + [
        ("prg1", c_int), ("prg", c_int), ("progorder", c_char * 5),
        ("tile", c_uint32), ("tx0", c_int32), ("tx1", c_int32),
        ("ty0", c_int32), ("ty1", c_int32)] + [(n, c_uint32) for n in (
            "layS", "resS", "compS", "prcS", "layE", "resE", "compE", "prcE",
            "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t", "res_t",
            "comp_t", "prc_t", "tx0_t", "ty0_t")]


class CParameters(Structure):
    _fields_ = [
        ("tile_size_on", c_int), ("cp_tx0", c_int), ("cp_ty0", c_int),
        ("cp_tdx", c_int), ("cp_tdy", c_int), ("cp_disto_alloc", c_int),
        ("cp_fixed_alloc", c_int), ("cp_fixed_quality", c_int),
        ("cp_matrice", c_void_p), ("cp_comment", c_char_p), ("csty", c_int),
        ("prog_order", c_int), ("POC", Poc * 32), ("numpocs", c_uint32),
        ("tcp_numlayers", c_int), ("tcp_rates", c_float * 100),
        ("tcp_distoratio", c_float * 100), ("numresolution", c_int),
        ("cblockw_init", c_int), ("cblockh_init", c_int), ("mode", c_int),
        ("irreversible", c_int), ("roi_compno", c_int), ("roi_shift", c_int),
        ("res_spec", c_int), ("prcw_init", c_int * 33),
        ("prch_init", c_int * 33), ("infile", c_char * 4096),
        ("outfile", c_char * 4096), ("index_on", c_int),
        ("index", c_char * 4096), ("image_offset_x0", c_int),
        ("image_offset_y0", c_int), ("subsampling_dx", c_int),
        ("subsampling_dy", c_int), ("decod_format", c_int),
        ("cod_format", c_int), ("jpwl_epc_on", c_int),
        ("jpwl_hprot_MH", c_int), ("jpwl_hprot_TPH_tileno", c_int * 16),
        ("jpwl_hprot_TPH", c_int * 16), ("jpwl_pprot_tileno", c_int * 16),
        ("jpwl_pprot_packno", c_int * 16), ("jpwl_pprot", c_int * 16),
        ("jpwl_sens_size", c_int), ("jpwl_sens_addr", c_int),
        ("jpwl_sens_range", c_int), ("jpwl_sens_MH", c_int),
        ("jpwl_sens_TPH_tileno", c_int * 16), ("jpwl_sens_TPH", c_int * 16),
        ("cp_cinema", c_int), ("max_comp_size", c_int), ("cp_rsiz", c_int),
        ("tp_on", c_char), ("tp_flag", c_char), ("tcp_mct", c_char),
        ("jpip_on", c_int), ("mct_data", c_void_p), ("max_cs_size", c_int),
        ("rsiz", c_uint16)]


class CompParm(Structure):
    _fields_ = [(n, c_uint32) for n in (
        "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class ImageComp(Structure):
    _fields_ = [(n, c_uint32) for n in (
        "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
        "resno_decoded", "factor")] + [("data", POINTER(c_int32)),
                                       ("alpha", c_uint16)]


class Image(Structure):
    _fields_ = [("x0", c_uint32), ("y0", c_uint32), ("x1", c_uint32),
                ("y1", c_uint32), ("numcomps", c_uint32),
                ("color_space", c_int), ("comps", POINTER(ImageComp)),
                ("icc_profile_buf", c_void_p), ("icc_profile_len", c_uint32)]


MSG = CFUNCTYPE(None, c_char_p, c_void_p)


def library_path():
    import PIL

    libs = Path(PIL.__file__).resolve().parents[1] / "pillow.libs"
    found = sorted(libs.glob("libopenjp2-*.so*"))
    if not found:
        raise FileNotFoundError("no openjpeg shipped with Pillow here")
    return found[0]


_LIB = None


def lib():
    global _LIB
    if _LIB is None:
        L = ctypes.CDLL(str(library_path()))
        L.opj_image_create.restype = POINTER(Image)
        L.opj_image_create.argtypes = [c_uint32, POINTER(CompParm), c_int]
        L.opj_image_destroy.argtypes = [POINTER(Image)]
        L.opj_create_compress.restype = c_void_p
        L.opj_create_compress.argtypes = [c_int]
        L.opj_create_decompress.restype = c_void_p
        L.opj_create_decompress.argtypes = [c_int]
        L.opj_destroy_codec.argtypes = [c_void_p]
        L.opj_set_default_encoder_parameters.argtypes = [
            POINTER(CParameters)]
        L.opj_setup_encoder.restype = c_int
        L.opj_setup_encoder.argtypes = [c_void_p, POINTER(CParameters),
                                        POINTER(Image)]
        L.opj_encoder_set_extra_options.restype = c_int
        L.opj_encoder_set_extra_options.argtypes = [c_void_p,
                                                    POINTER(c_char_p)]
        L.opj_stream_create_default_file_stream.restype = c_void_p
        L.opj_stream_create_default_file_stream.argtypes = [c_char_p, c_int]
        L.opj_stream_destroy.argtypes = [c_void_p]
        L.opj_start_compress.restype = c_int
        L.opj_start_compress.argtypes = [c_void_p, POINTER(Image), c_void_p]
        L.opj_encode.restype = c_int
        L.opj_encode.argtypes = [c_void_p, c_void_p]
        L.opj_end_compress.restype = c_int
        L.opj_end_compress.argtypes = [c_void_p, c_void_p]
        L.opj_set_default_decoder_parameters.argtypes = [c_void_p]
        L.opj_setup_decoder.restype = c_int
        L.opj_setup_decoder.argtypes = [c_void_p, c_void_p]
        L.opj_read_header.restype = c_int
        L.opj_read_header.argtypes = [c_void_p, c_void_p,
                                      POINTER(POINTER(Image))]
        L.opj_read_tile_header.restype = c_int
        L.opj_read_tile_header.argtypes = [
            c_void_p, c_void_p, POINTER(c_uint32), POINTER(c_uint32),
            POINTER(c_int32), POINTER(c_int32), POINTER(c_int32),
            POINTER(c_int32), POINTER(c_uint32), POINTER(c_int)]
        L.opj_decode_tile_data.restype = c_int
        L.opj_decode_tile_data.argtypes = [c_void_p, c_uint32, c_void_p,
                                           c_uint32, c_void_p]
        L.opj_end_decompress.restype = c_int
        L.opj_end_decompress.argtypes = [c_void_p, c_void_p]
        for name in ("opj_set_error_handler", "opj_set_warning_handler",
                     "opj_set_info_handler"):
            getattr(L, name).restype = c_int
            getattr(L, name).argtypes = [c_void_p, MSG, c_void_p]
        _LIB = L
    return _LIB


def check_layout():
    """Raise unless the defaults land where CParameters says they do."""
    p = CParameters()
    lib().opj_set_default_encoder_parameters(byref(p))
    got = (p.numresolution, p.cblockw_init, p.cblockh_init, p.roi_compno,
           p.subsampling_dx, p.subsampling_dy, p.decod_format, p.cod_format,
           p.prog_order, p.tcp_numlayers, p.tp_on)
    want = (6, 64, 64, -1, 1, 1, -1, -1, 0, 0, b"\0")
    if got != want:
        raise RuntimeError(f"opj_cparameters_t layout differs: {got}")


_KEEP = []
_IGNORE = MSG(lambda msg, _: None)


def _quiet(codec, messages):
    def handler(msg, _):
        messages.append(msg.decode(errors="replace").strip())
    cb = MSG(handler)
    _KEEP.append(cb)
    L = lib()
    L.opj_set_error_handler(codec, cb, None)
    L.opj_set_warning_handler(codec, _IGNORE, None)
    L.opj_set_info_handler(codec, _IGNORE, None)


def encode(planes, *, jp2=False, color_space="unspecified", prec=8,
           sgnd=False, dx=None, dy=None, origin=(0, 0), tile=None,
           tile_origin=(0, 0), levels=5, cblk=(64, 64), precincts=None,
           prog="LRCP", layers=None, irreversible=False, mode=0, csty=0,
           mct=None, roi=None, tp=None, pocs=(), extra=()):
    """Codestream (or JP2) bytes of `planes`, a list of 2-D integer
    arrays, one a component (each at its own subsampled size).

    `prec` and `sgnd` may be one value or one per component; `dx`/`dy`
    the components' subsampling; `origin` the image offset on the
    reference grid; `tile` (w, h) and `tile_origin` the tile grid;
    `levels` the decomposition levels; `cblk` (w, h); `precincts` a list
    of (w, h) from the highest resolution down; `layers` the rates of the
    quality layers (None: one lossless layer); `mode` the code-block
    style bits; `csty` 2 for SOP, 4 for EPH; `roi` (component, shift);
    `tp` a tile-part flag ('R', 'L' or 'C'); `pocs` tuples (tile, resno0,
    compno0, layno1, resno1, compno1, progression)."""
    L = lib()
    n = len(planes)
    prec = [prec] * n if np.isscalar(prec) else list(prec)
    sgnd = [sgnd] * n if np.isscalar(sgnd) else list(sgnd)
    dx = dx or [1] * n
    dy = dy or [1] * n
    parms = (CompParm * n)()
    for i, p in enumerate(planes):
        h, w = p.shape
        parms[i] = CompParm(dx[i], dy[i], w, h, origin[0], origin[1],
                            prec[i], prec[i], int(sgnd[i]))
    img = L.opj_image_create(n, parms, CLRSPC[color_space])
    im = img.contents
    im.x0, im.y0 = origin
    # the reference grid: the largest extent of any component
    im.x1 = max(origin[0] + planes[i].shape[1] * dx[i] - (dx[i] - 1)
                for i in range(n))
    im.y1 = max(origin[1] + planes[i].shape[0] * dy[i] - (dy[i] - 1)
                for i in range(n))
    for i, p in enumerate(planes):
        flat = np.ascontiguousarray(p, np.int32).reshape(-1)
        ctypes.memmove(im.comps[i].data, flat.ctypes.data, flat.nbytes)
    p = CParameters()
    L.opj_set_default_encoder_parameters(byref(p))
    if layers is None:
        p.tcp_numlayers = 1
        p.tcp_rates[0] = 0
    else:
        p.tcp_numlayers = len(layers)
        for i, r in enumerate(layers):
            p.tcp_rates[i] = r
    p.cp_disto_alloc = 1
    p.numresolution = levels + 1
    p.cblockw_init, p.cblockh_init = cblk
    p.prog_order = PROG[prog]
    p.irreversible = int(irreversible)
    p.mode = mode
    p.csty = csty
    if precincts:
        p.csty |= 1
        p.res_spec = len(precincts)
        for i, (pw, ph) in enumerate(precincts):
            p.prcw_init[i], p.prch_init[i] = pw, ph
    if tile:
        p.tile_size_on = 1
        p.cp_tdx, p.cp_tdy = tile
        p.cp_tx0, p.cp_ty0 = tile_origin
    p.image_offset_x0, p.image_offset_y0 = origin
    p.tcp_mct = bytes([int(n >= 3 if mct is None else mct)])
    if roi:
        p.roi_compno, p.roi_shift = roi
    if tp:
        p.tp_on, p.tp_flag = b"\x01", tp.encode()
    for i, (t, r0, c0, l1, r1, c1, prg) in enumerate(pocs):
        q = p.POC[i]
        q.tile, q.resno0, q.compno0, q.layno1, q.resno1, q.compno1 = (
            t, r0, c0, l1, r1, c1)
        q.prg1 = q.prg = PROG[prg]
        q.progorder = prg.encode()
    p.numpocs = len(pocs)
    codec = L.opj_create_compress(JP2 if jp2 else J2K)
    messages = []
    _quiet(codec, messages)
    fd, path = tempfile.mkstemp(suffix=".jp2" if jp2 else ".j2k")
    os.close(fd)
    stream = None
    try:
        if not L.opj_setup_encoder(codec, byref(p), img):
            raise RuntimeError(f"opj_setup_encoder: {messages}")
        if extra:
            opts = (c_char_p * (len(extra) + 1))(
                *[e.encode() for e in extra], None)
            if not L.opj_encoder_set_extra_options(codec, opts):
                raise RuntimeError(f"extra options {extra}: {messages}")
        stream = L.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = (L.opj_start_compress(codec, img, stream)
              and L.opj_encode(codec, stream)
              and L.opj_end_compress(codec, stream))
        L.opj_stream_destroy(stream)
        stream = None
        if not ok:
            raise RuntimeError(f"openjpeg could not encode: {messages}")
        return Path(path).read_bytes()
    finally:
        if stream:
            L.opj_stream_destroy(stream)
        L.opj_destroy_codec(codec)
        L.opj_image_destroy(img)
        os.unlink(path)


def decode_tiles(data, jp2=None):
    """Pillow's decode loop over `data`: (image header, [(tile index,
    (x0, y0, x1, y1), tile bytes)]) where the bytes are what
    `opj_decode_tile_data` writes, or raises RuntimeError with
    openjpeg's errors."""
    L = lib()
    if jp2 is None:
        jp2 = not data.startswith(b"\xff\x4f\xff\x51")
    codec = L.opj_create_decompress(JP2 if jp2 else J2K)
    messages = []
    _quiet(codec, messages)
    params = ctypes.create_string_buffer(1 << 16)
    L.opj_set_default_decoder_parameters(params)
    fd, path = tempfile.mkstemp()
    os.write(fd, data)
    os.close(fd)
    stream = L.opj_stream_create_default_file_stream(path.encode(), 1)
    img = POINTER(Image)()
    try:
        if not L.opj_setup_decoder(codec, params):
            raise RuntimeError(f"setup: {messages}")
        if not L.opj_read_header(stream, codec, byref(img)):
            raise RuntimeError(f"header: {messages}")
        im = img.contents
        head = {"x0": im.x0, "y0": im.y0, "x1": im.x1, "y1": im.y1,
                "color_space": im.color_space,
                "comps": [{k: getattr(im.comps[i], k) for k in (
                    "dx", "dy", "w", "h", "x0", "y0", "prec", "sgnd")}
                    for i in range(im.numcomps)]}
        tiles = []
        while True:
            idx, size, n = c_uint32(), c_uint32(), c_uint32()
            x0, y0, x1, y1 = c_int32(), c_int32(), c_int32(), c_int32()
            go = c_int()
            if not L.opj_read_tile_header(codec, stream, byref(idx),
                                          byref(size), byref(x0), byref(y0),
                                          byref(x1), byref(y1), byref(n),
                                          byref(go)):
                raise RuntimeError(f"tile header: {messages}")
            if not go.value:
                break
            buf = ctypes.create_string_buffer(max(size.value, 1))
            if not L.opj_decode_tile_data(codec, idx.value, buf, size.value,
                                          stream):
                raise RuntimeError(f"tile data: {messages}")
            tiles.append((idx.value, (x0.value, y0.value, x1.value,
                                      y1.value), buf.raw[:size.value]))
        if not L.opj_end_decompress(codec, stream):
            raise RuntimeError(f"end: {messages}")
        return head, tiles
    finally:
        L.opj_stream_destroy(stream)
        L.opj_destroy_codec(codec)
        if img:
            L.opj_image_destroy(img)
        os.unlink(path)


# ------------------------------------------------------- JP2 containers

SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"


def box(kind, payload, xl=False, zero=False):
    """A JP2 box: its length in 4 bytes, or 1 and an 8-byte XLBox, or 0
    ("to the end of the file")."""
    if zero:
        return b"\0\0\0\0" + kind + payload
    if xl:
        return struct.pack(">I4sQ", 1, kind, len(payload) + 16) + payload
    return struct.pack(">I4s", len(payload) + 8, kind) + payload


def ihdr(w, h, nc, bpc):
    return box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))


def colr(enumcs=None, icc=None):
    if icc is not None:
        return box(b"colr", bytes([2, 0, 0]) + icc)
    return box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))


def pclr(entries, depths):
    """entries: (n, c) integers; depths: the c bit depths (0-based as the
    box stores them: depth - 1, bit 7 for signed)."""
    entries = np.asarray(entries)
    out = struct.pack(">HB", len(entries), entries.shape[1]) + bytes(depths)
    for row in entries:
        for v, dd in zip(row, depths):
            nbytes = ((dd & 0x7f) + 8) // 8
            out += int(v).to_bytes(nbytes, "big")
    return box(b"pclr", out)


def cmap(triples):
    return box(b"cmap", b"".join(struct.pack(">HBB", c, t, p)
                                 for c, t, p in triples))


def cdef(triples):
    return box(b"cdef", struct.pack(">H", len(triples)) + b"".join(
        struct.pack(">HHH", *t) for t in triples))


def jp2(codestream, header_boxes, brand=b"jp2 ", before=(), after=(),
        jp2c_xl=False, jp2c_zero=False):
    """A JP2 file around `codestream`: the signature, ftyp, boxes
    `before` jp2h, jp2h of `header_boxes`, boxes `after` it, jp2c."""
    ftyp = box(b"ftyp", brand + b"\0\0\0\0" + brand)
    return (SIGNATURE + ftyp + b"".join(before) +
            box(b"jp2h", b"".join(header_boxes)) + b"".join(after) +
            box(b"jp2c", codestream, xl=jp2c_xl, zero=jp2c_zero))


# ------------------------------------------- one code-block, by hand

class BitWriter:
    """Packet-header bits, with a stuffed 0 after each 0xFF byte."""

    def __init__(self):
        self.out, self.buf, self.ct = bytearray(), 0, 8

    def bit(self, b):
        if self.ct == 0:
            self._byteout()
        self.ct -= 1
        self.buf |= (b & 1) << self.ct

    def _byteout(self):
        self.out.append(self.buf & 0xFF)
        self.ct = 7 if self.buf == 0xFF else 8
        self.buf = 0

    def bits(self, v, n):
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def flush(self):
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


def _passes_code(w, n):
    if n == 1:
        w.bit(0)
    elif n == 2:
        w.bits(0b10, 2)
    elif n <= 5:
        w.bits(0b11, 2)
        w.bits(n - 3, 2)
    elif n <= 36:
        w.bits(0b1111, 4)
        w.bits(n - 6, 5)
    else:
        w.bits(0b111111111, 9)
        w.bits(n - 37, 7)


def _floorlog2(n):
    return n.bit_length() - 1


def segment_passes(passes, cblksty):
    """openjpeg's split of a code-block's passes into segments."""
    out, left, first, prev = [], passes, True, None
    while left > 0:
        if cblksty & 4:
            most = 1
        elif cblksty & 1:
            most = 10 if first else (2 if prev in (1, 10) else 1)
        else:
            most = 109
        out.append(min(most, left))
        left -= out[-1]
        first, prev = False, most
    return out


def one_code_block(w, h, zero_planes, segments, cblksty=0, prec=16,
                   qmfbid=1):
    """A codestream of one w x h grey code-block (no wavelet levels, one
    layer) whose packet says `zero_planes` and `segments` [(passes,
    bytes)]: any bytes, so openjpeg's tier 1 reads them as they are."""
    bw = BitWriter()
    bw.bit(1)   # the packet is not empty
    bw.bit(1)   # the code-block is included in layer 0
    for _ in range(zero_planes):
        bw.bit(0)
    bw.bit(1)
    _passes_code(bw, sum(p for p, _ in segments))
    need = max(max(1, len(d)).bit_length() - _floorlog2(p)
               for p, d in segments)
    inc = max(0, need - 3)
    bw.bits((1 << inc) - 1, inc)
    bw.bit(0)
    for p, d in segments:
        bw.bits(len(d), 3 + inc + _floorlog2(p))
    body = bw.flush() + b"".join(d for _, d in segments)
    cbw = max(2, (w - 1).bit_length())
    cbh = max(2, (h - 1).bit_length())
    while cbw + cbh > 12:
        if cbw > cbh:
            cbw -= 1
        else:
            cbh -= 1
    siz = struct.pack(">HHIIIIIIIIH", 41, 0, w, h, 0, 0, w, h, 0, 0, 1) + \
        bytes([prec - 1, 1, 1])
    cod = struct.pack(">HBBHBBBBBB", 12, 0, 0, 1, 0, 0, cbw - 2, cbh - 2,
                      cblksty, qmfbid)
    qcd = (struct.pack(">HBB", 4, 0x40, prec << 3) if qmfbid == 1 else
           struct.pack(">HBH", 5, 0x42, prec << 11))
    sot = b"\xff\x90" + struct.pack(">HHIBB", 10, 0, 14 + len(body), 0, 1)
    return (b"\xff\x4f\xff\x51" + siz + b"\xff\x52" + cod + b"\xff\x5c" + qcd
            + sot + b"\xff\x93" + body + b"\xff\xd9")
