"""Image decoding for the loader: the native libjpeg/libpng decoder, and
the standard-library PNG reader where that does not build.

Counterpart of mapping_tpu/utils/native_decode.py: the same ctypes surface
(`decode_probe`, `decode_image`, and `decode_probe_mem` /
`decode_image_mem` for the serving daemon's request bodies) over the repository's cpp/decode.cpp,
built with g++ into build/. The calls release the GIL for the whole
decode, so the loader's decode threads scale with host cores. Without the
native library a PNG goes through utils/png.py and a JPEG raises, naming
the library that did not build: there is no other JPEG decoder here.
"""

import ctypes

import numpy as np

from mapping_tpu_torch.utils import png
from mapping_tpu_torch.utils.native_lib import (NativeLib,
                                                NativeLibraryUnavailable)


def _register(lib):
    lib.decode_probe.restype = ctypes.c_int
    lib.decode_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.decode_image.restype = ctypes.c_int
    lib.decode_image.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.decode_probe_mem.restype = ctypes.c_int
    lib.decode_probe_mem.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.decode_image_mem.restype = ctypes.c_int
    lib.decode_image_mem.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ctypes.c_int]


_lib = NativeLib("decode.cpp", "decode", _register, link=("-ljpeg", "-lpng"))
load = _lib.load
available = _lib.available

#: a header claiming more pixels than this is refused (~134 MP)
_MAX_PIXELS = 1 << 27


def _native(lib, path):
    """(H, W, 3) uint8, or None where the library declines the file (an
    alpha channel or 16-bit samples, which it leaves to PIL in the JAX
    package)."""
    path_b = str(path).encode()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.decode_probe(path_b, ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    if not (0 < h.value and 0 < w.value
            and h.value * w.value <= _MAX_PIXELS):
        raise ValueError(f"{path}: implausible size {h.value}x{w.value}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    dh, dw = ctypes.c_int(), ctypes.c_int()
    rc = lib.decode_image(path_b, out.ctypes.data_as(ctypes.c_char_p),
                          out.nbytes, 3, ctypes.byref(dh), ctypes.byref(dw))
    if rc != 0:
        return None
    if (dh.value, dw.value) != (h.value, w.value):
        raise ValueError(f"{path}: the file changed size while it was read")
    return out


def decode_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG or PNG file."""
    with open(path, "rb") as f:
        is_png = f.read(len(png.SIGNATURE)) == png.SIGNATURE
    try:
        lib = load()
    except NativeLibraryUnavailable as e:
        if is_png:
            return png.read_png_rgb(path)
        raise RuntimeError(
            f"{path}: decoding this file needs the native decoder "
            f"(cpp/decode.cpp with libjpeg and libpng), which is not "
            f"available here; only PNG decodes without it") from e
    out = _native(lib, path)
    if out is None and is_png:
        return png.read_png_rgb(path)
    if out is None:
        raise ValueError(f"{path}: the native decoder cannot read it")
    return out


def decode_rgb_bytes(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of in-memory JPEG or PNG bytes (a request
    body), by the same rules as `decode_rgb`: the native decoder, else a
    PNG through utils/png.py; anything else raises ValueError."""
    data = bytes(data)
    is_png = data.startswith(png.SIGNATURE)
    try:
        lib = load()
    except NativeLibraryUnavailable as e:
        if is_png:
            return png.to_rgb(png.decode_png(data))
        raise ValueError(
            "decoding these bytes needs the native decoder (cpp/decode.cpp "
            "with libjpeg and libpng), which is not available here; only "
            "PNG decodes without it") from e
    h, w = ctypes.c_int(), ctypes.c_int()
    out = None
    if len(data) >= 8 and lib.decode_probe_mem(
            data, len(data), ctypes.byref(h), ctypes.byref(w)) == 0:
        if not (0 < h.value and 0 < w.value
                and h.value * w.value <= _MAX_PIXELS):
            raise ValueError(f"implausible image size {h.value}x{w.value}")
        out = np.empty((h.value, w.value, 3), np.uint8)
        if lib.decode_image_mem(data, len(data),
                                out.ctypes.data_as(ctypes.c_char_p),
                                out.nbytes, 3) != 0:
            out = None
    if out is None and is_png:
        return png.to_rgb(png.decode_png(data))
    if out is None:
        raise ValueError("the native decoder cannot read these bytes")
    return out
