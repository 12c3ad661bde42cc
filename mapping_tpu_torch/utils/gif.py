"""GIF tiles as the JAX package's loader reads them.

The JAX loader reads a file that libjpeg and libpng decline through Pillow
(`mapping_tpu/data/loader.py` `load_image`: `Image.open(path).convert("RGB")`),
which reads a GIF's first frame with its `GifImagePlugin`. `decode` gives
the same (H, W, 3) uint8 RGB byte for byte, without Pillow: the blocks
here, the LZW data in host C++ (csrc/gif_decode.cpp, the GIL released).
The rules, read from Pillow 12.1.0's plugin and probed against it:

- "GIF87a" or "GIF89a", then the logical screen (width, height, flags) and
  the global colour table (3 << bits bytes);
- blocks up to the first image descriptor: extensions (graphic control,
  comment, application, plain text, any label) are skipped sub-block by
  sub-block, and only a graphic control block's transparency index is
  kept; a byte that starts no block is skipped; after an application
  block named NETSCAPE2.0 one more sub-block is read before the skip, so
  an empty one there does not end the extension;
- frame 0 only: its rectangle may lie anywhere; where it passes the
  screen, the image grows to hold it. A rectangle of width 0 at x = 0
  reads as the whole image (Pillow's tile extent rule);
- a colour table that is exactly the ramp (i, i, i) for every entry is
  dropped: the local table where it is not a ramp, else the global one
  where it is not (Pillow's frame is grey then, but its palette, a copy of
  the global table, turns it back to "P" on load), else none, and the
  indices are the grey levels; an index past the table's end reads
  black;
- pixels outside the rectangle hold the transparency index where a
  graphic control block gives one, else index 0, read through the table
  (transparency changes nothing else: convert("RGB") ignores it);
- interlaced rows in the four passes; minimum code sizes 0 to 12, as
  Pillow's decoder takes them (csrc/gif_decode.cpp).

Refused with a ValueError that names the cause, as Pillow refuses the file:
a screen descriptor, colour table, extension, image descriptor or data
cut short or malformed, no image before the trailer, a code size past 12,
a broken LZW stream, data that ends before the rectangle is full (Pillow's
"image file is truncated"; an early end code counts, since Pillow's
decoder waits for more data after it), a rectangle of no pixels, and an
image over `jpeg.MAX_PIXELS` pixels, before anything is allocated.
"""

import ctypes
import struct

import numpy as np

from mapping_tpu_torch.kernels.build import CSRC
from mapping_tpu_torch.utils.jpeg import MAX_PIXELS
from mapping_tpu_torch.utils.native_lib import NativeLib

SIGNATURES = (b"GIF87a", b"GIF89a")

#: csrc/gif_decode.cpp's error codes
_ERRORS = {-1: "GIF image data cut short", -2: "a broken GIF LZW stream",
           -3: "a GIF LZW code size past 12"}


def _register(lib):
    ptr = ctypes.c_void_p
    lib.gif_lzw_decode.restype = ctypes.c_int
    lib.gif_lzw_decode.argtypes = [ptr, ctypes.c_long, ctypes.c_long,
                                   ctypes.c_int, ctypes.c_int, ptr,
                                   ctypes.c_long, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int]


_lib = NativeLib("gif_decode.cpp", "gif_decode", _register, src_dir=CSRC)
load = _lib.load


def is_gif(data: bytes) -> bool:
    return data[:6] in SIGNATURES


def _table(raw):
    """(n, 3) uint8 colour table, or None where it is the grey ramp
    Pillow drops; a table cut inside an entry is refused."""
    if len(raw) % 3:
        raise ValueError("a GIF colour table cut short")
    table = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    ramp = np.arange(len(table))[:, None]
    return None if (table == ramp).all() else table


class _Reader:
    """Pillow's file reads: short reads return what is there."""

    def __init__(self, data):
        self.data, self.pos = data, 0

    def read(self, n):
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def sub_block(self):
        """GifImageFile.data: a sub-block's bytes, or None for size 0."""
        s = self.read(1)
        return self.read(s[0]) if s and s[0] else None


def _first_frame(data):
    """(width, height, colour table or None, transparency or None,
    rectangle, interlaced, code size, data position), as GifImageFile
    reads frame 0."""
    r = _Reader(data)
    s = r.read(13)
    if len(s) < 11:
        raise ValueError("a GIF screen descriptor cut short")
    width, height = struct.unpack_from("<HH", s, 6)
    table = None
    if s[10] & 128:
        if len(s) < 12:
            raise ValueError("a GIF screen descriptor cut short")
        table = _table(r.read(3 << ((s[10] & 7) + 1)))
    transparency = None
    while True:
        s = r.read(1)
        if not s or s == b";":
            raise ValueError("no image in the GIF file")
        if s == b"!":
            label = r.read(1)
            if not label:
                raise ValueError("a GIF extension cut short")
            block = r.sub_block()
            if label[0] == 249 and block is not None:
                if len(block) < 3 or (block[0] & 1 and len(block) < 4):
                    raise ValueError("a short GIF graphic control block")
                if block[0] & 1:
                    transparency = block[3]
            elif label[0] == 254:
                while block:
                    block = r.sub_block()
                continue
            elif label[0] == 255 and block is not None \
                    and block.startswith(b"NETSCAPE2.0"):
                r.sub_block()  # the loop count, read apart
            while r.sub_block():
                pass
        elif s == b",":
            s = r.read(9)
            if len(s) < 9:
                raise ValueError("a GIF image descriptor cut short")
            x0, y0, w, h, flags = struct.unpack("<4HB", s)
            local = False
            if flags & 128:
                local = _table(r.read(3 << ((flags & 7) + 1)))
            bits = r.read(1)
            if not bits:
                raise ValueError("a GIF image descriptor cut short")
            if local is not False and local is not None:
                table = local
            return (max(width, x0 + w), max(height, y0 + h), table,
                    transparency, (x0, y0, w, h), bool(flags & 64), bits[0],
                    r.pos)


def decode(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a GIF file's first frame, as the JAX loader
    reads it."""
    data = bytes(data)
    if not is_gif(data):
        raise ValueError("not a GIF file")
    width, height, table, transparency, (x0, y0, w, h), interlaced, bits, \
        pos = _first_frame(data)
    if width * height > MAX_PIXELS:
        raise ValueError(f"implausible image size {height}x{width} (over "
                         f"{MAX_PIXELS} pixels)")
    if x0 == 0 and w == 0:  # Pillow's extent (0, y0, 0, y1): the image
        x0, y0, w, h = 0, 0, width, height
    if w == 0 or h == 0:
        raise ValueError(f"a GIF frame of {w}x{h} pixels")
    image = np.full((height, width), transparency or 0, np.uint8)
    src = np.frombuffer(data, np.uint8)
    rc = load().gif_lzw_decode(src.ctypes.data, len(src), pos, bits,
                               int(interlaced), image.ctypes.data, width,
                               x0, y0, w, h)
    if rc:
        raise ValueError(_ERRORS.get(rc, f"GIF decode code {rc}"))
    if table is None:
        return np.repeat(image[..., None], 3, -1)
    full = np.zeros((256, 3), np.uint8)
    full[:len(table)] = table[:256]
    return full[image]
