"""libzstd through ctypes, for the fixtures and the tests only (the port
decodes ZSTD itself, csrc/zstd_decode.cpp): the copy that Pillow's libtiff
uses (`pillow.libs/libzstd-*.so*`, libzstd 1.5.7 in Pillow 12.1.0), else
the system's libzstd.so.1.

`tiff_decode` drives ZSTD_decompressStream as libtiff 4.7.1's ZSTDDecode
does, which makes it the JAX loader's reading of a strip; `compress`
writes frames with ZSTD_compressStream2."""

import ctypes
import ctypes.util
import glob
import os


class _Buffer(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _find():
    try:
        import PIL
        found = sorted(glob.glob(os.path.join(
            os.path.dirname(PIL.__file__), os.pardir, "pillow.libs",
            "libzstd-*.so*")))
    except ImportError:
        found = []
    return found[0] if found else ctypes.util.find_library("zstd")


_lib = None


def lib():
    global _lib
    if _lib is None:
        z = ctypes.CDLL(_find())
        vp, sz, buf = ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(
            _Buffer)
        for name, res, args in (
                ("ZSTD_versionString", ctypes.c_char_p, []),
                ("ZSTD_createDStream", vp, []),
                ("ZSTD_freeDStream", sz, [vp]),
                ("ZSTD_initDStream", sz, [vp]),
                ("ZSTD_decompressStream", sz, [vp, buf, buf]),
                ("ZSTD_isError", ctypes.c_uint, [sz]),
                ("ZSTD_getErrorName", ctypes.c_char_p, [sz]),
                ("ZSTD_createCCtx", vp, []), ("ZSTD_freeCCtx", sz, [vp]),
                ("ZSTD_CCtx_setParameter", sz, [vp, ctypes.c_int,
                                                ctypes.c_int]),
                ("ZSTD_CCtx_setPledgedSrcSize", sz, [vp, ctypes.c_ulonglong]),
                ("ZSTD_compressStream2", sz, [vp, buf, buf, ctypes.c_int]),
                ("ZSTD_compressBound", sz, [sz])):
            fn = getattr(z, name)
            fn.restype, fn.argtypes = res, args
        _lib = z
    return _lib


def version():
    return lib().ZSTD_versionString().decode()


def tiff_decode(src: bytes, occ: int):
    """(bytes, None), or (None, libzstd's error or "not enough data"):
    libtiff's ZSTDDecode of `occ` bytes."""
    z = lib()
    stream = z.ZSTD_createDStream()
    z.ZSTD_initDStream(stream)
    sbuf = ctypes.create_string_buffer(bytes(src), max(len(src), 1))
    obuf = ctypes.create_string_buffer(max(occ, 1))
    inp = _Buffer(ctypes.cast(sbuf, ctypes.c_void_p), len(src), 0)
    out = _Buffer(ctypes.cast(obuf, ctypes.c_void_p), occ, 0)
    try:
        while True:
            r = z.ZSTD_decompressStream(stream, ctypes.byref(out),
                                        ctypes.byref(inp))
            if z.ZSTD_isError(r):
                return None, z.ZSTD_getErrorName(r).decode()
            if not (r and inp.pos < inp.size and out.pos < out.size):
                break
        if out.pos < occ:
            return None, "not enough data"
        return obuf.raw[:occ], None
    finally:
        z.ZSTD_freeDStream(stream)


def content(src: bytes, limit: int = 1 << 22) -> bytes:
    """The first frame of `src` decoded whole (at most `limit` bytes)."""
    z = lib()
    stream = z.ZSTD_createDStream()
    z.ZSTD_initDStream(stream)
    sbuf = ctypes.create_string_buffer(bytes(src), max(len(src), 1))
    obuf = ctypes.create_string_buffer(limit)
    inp = _Buffer(ctypes.cast(sbuf, ctypes.c_void_p), len(src), 0)
    out = _Buffer(ctypes.cast(obuf, ctypes.c_void_p), limit, 0)
    try:
        while True:
            r = z.ZSTD_decompressStream(stream, ctypes.byref(out),
                                        ctypes.byref(inp))
            if z.ZSTD_isError(r):
                raise ValueError(z.ZSTD_getErrorName(r).decode())
            if r == 0:
                return obuf.raw[:out.pos]
            if inp.pos == inp.size or out.pos == out.size:
                raise ValueError("frame cut short or over the limit")
    finally:
        z.ZSTD_freeDStream(stream)


#: ZSTD_cParameter values
LEVEL, WINDOW_LOG, CONTENT_SIZE, CHECKSUM = 100, 101, 200, 201


def compress(data: bytes, level=3, checksum=False, window_log=None,
             pledged=True, chunk=None) -> bytes:
    """One frame of `data` by ZSTD_compressStream2: fed whole (the frame
    then carries its content size) or in `chunk`s flushed in turn (blocks
    end at each flush; without `pledged`, no content size)."""
    z = lib()
    cctx = z.ZSTD_createCCtx()
    try:
        for key, value in ((LEVEL, level), (CHECKSUM, int(checksum)),
                           (WINDOW_LOG, window_log or 0)):
            r = z.ZSTD_CCtx_setParameter(cctx, key, value)
            if z.ZSTD_isError(r):
                raise ValueError(z.ZSTD_getErrorName(r).decode())
        if pledged:
            z.ZSTD_CCtx_setPledgedSrcSize(cctx, len(data))
        cap = z.ZSTD_compressBound(len(data)) + 4096
        obuf = ctypes.create_string_buffer(cap)
        out = _Buffer(ctypes.cast(obuf, ctypes.c_void_p), cap, 0)
        sbuf = ctypes.create_string_buffer(bytes(data), max(len(data), 1))
        base = ctypes.cast(sbuf, ctypes.c_void_p).value
        step = chunk or max(len(data), 1)
        pos = 0
        while True:
            end = min(len(data), pos + step)
            inp = _Buffer(base + pos, end - pos, 0)
            mode = 2 if end == len(data) else 1  # ZSTD_e_end, ZSTD_e_flush
            while True:
                r = z.ZSTD_compressStream2(cctx, ctypes.byref(out),
                                           ctypes.byref(inp), mode)
                if z.ZSTD_isError(r):
                    raise ValueError(z.ZSTD_getErrorName(r).decode())
                if r == 0 and inp.pos == inp.size:
                    break
            pos = end
            if end == len(data):
                return obuf.raw[:out.pos]
    finally:
        z.ZSTD_freeCCtx(cctx)
