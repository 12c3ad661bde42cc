"""WebP tiles as the JAX package's loader reads them.

The JAX loader reads a file that libjpeg and libpng decline through Pillow
(`mapping_tpu/data/loader.py` `load_image`: `Image.open(path).convert("RGB")`),
and Pillow reads every WebP file through libwebp's `WebPAnimDecoder` (RGBA,
not premultiplied, so the RGB never depends on the alpha). `decode` gives
the same (H, W, 3) uint8 RGB byte for byte, without Pillow or libwebp: the
container here, the bitstreams in host C++ (csrc/webp_decode.cpp, the GIL
released). The rules, probed against Pillow 12.1.0 with libwebp 1.6.0:

- Pillow opens a file only where bytes 12-16 (the first chunk) are "VP8 ",
  "VP8L" or "VP8X"; then libwebp's demuxer: the RIFF size at least 8, the
  file at least that long (bytes past it are ignored), every chunk inside
  it, nothing but whole chunks to its end;
- simple files: the first VP8 or VP8L chunk is the image, later chunks are
  ignored (an ALPH among them too);
- VP8X: its flags (alpha 0x10, animation 0x02, ICC 0x20, EXIF 0x08, XMP
  0x04; any other bit is refused) and canvas; ICCP, EXIF, XMP and unknown
  chunks are skipped (Pillow applies none of them on convert("RGB"): an
  EXIF Orientation is not applied to a WebP, unlike a TIFF's); a still
  image's frame must fill the canvas; its ALPH chunk is decoded only where
  the alpha flag is set (and must then decode), and one before a VP8L
  chunk is refused;
- animations (ANIM, then ANMF frames): the first frame only, drawn as
  libwebp's anim_decode.c draws a key frame: the canvas cleared to zero,
  the frame decoded into its rectangle (offset 2 x the stored value, size
  the bitstream's) without blending, so pixels outside it read (0, 0, 0);
  the frame must lie inside the canvas;
- the bitstreams: VP8L (lossless) and VP8 key frames (lossy) with libwebp's
  fancy upsampling to RGB, their frame headers checked as libwebp's
  WebPGetFeatures checks them; ALPH compressed (a VP8L stream) or raw, with
  each filter; see csrc/webp_decode.cpp.

Refused with a ValueError that names the cause: a first chunk Pillow does
not open; a file shorter than its RIFF size (a truncated file: libwebp's
demuxer declines it, so the JAX loader raises too); a chunk running past
the RIFF size or stray bytes after the last chunk; unknown VP8X flag bits;
a frame that does not fit its canvas; a bad VP8 or VP8L header (not a key
frame, not shown, profile above 3, a first partition as long as the chunk);
a canvas or frame over `jpeg.MAX_PIXELS` pixels, before anything is
allocated; and any bitstream that libwebp fails (data cut short, an invalid
prefix code, a transform read twice, a copy outside the image, an ALPH
header with unknown bits).
"""

import ctypes
import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np

from mapping_tpu_torch.kernels.build import CSRC
from mapping_tpu_torch.utils.jpeg import MAX_PIXELS
from mapping_tpu_torch.utils.native_lib import NativeLib

_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_IMAGE_AREA = 1 << 32
ALPHA_FLAG, ANIMATION_FLAG = 0x10, 0x02
_VALID_FLAGS = 0x3E  # alpha, animation, ICC, EXIF, XMP
_OPENED = (b"VP8 ", b"VP8L", b"VP8X")  # Pillow's WebPImagePlugin._accept

#: csrc/webp_decode.cpp's error codes
_ERRORS = {
    -1: "data cut short",
    -2: "an invalid prefix code",
    -3: "a transform read twice",
    -4: "colour cache bits outside 1..11",
    -5: "a copy outside the image",
    -6: "an ALPH header with unknown method, preprocessing or reserved bits",
    -7: "partition sizes past the data",
    -8: "out of memory",
}


def _register(lib):
    ptr = ctypes.c_void_p
    for name in ("webp_vp8l_decode", "webp_vp8_decode", "webp_alpha_decode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr, ctypes.c_long, ptr, ctypes.c_int, ctypes.c_int]


_lib = NativeLib("webp_decode.cpp", "webp_decode", _register, src_dir=CSRC)
load = _lib.load


def is_webp(data: bytes) -> bool:
    """A RIFF file of form WEBP (Pillow opens it only where `decode` does
    not refuse its first chunk)."""
    return len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WEBP"


class _Frame(NamedTuple):
    kind: bytes                      # b"VP8 " or b"VP8L"
    payload: bytes                   # the chunk's payload with its padding
    width: int
    height: int
    alpha: Optional[bytes] = None    # an ALPH payload to decode
    x: int = 0
    y: int = 0


def _features(kind: bytes, payload: bytes, declared: int) -> Tuple[int, int]:
    """Width and height of a VP8 or VP8L chunk, checked as libwebp's
    WebPGetFeatures checks them."""
    if kind == b"VP8L":
        if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
            raise ValueError("a bad VP8L header (signature or version)")
        bits = int.from_bytes(payload[1:5], "little")
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError("a bad VP8 frame header (too short or no start "
                         "code)")
    tag = payload[0] | payload[1] << 8 | payload[2] << 16
    if tag & 1:
        raise ValueError("a VP8 frame that is not a key frame")
    if (tag >> 1) & 7 > 3:
        raise ValueError("a VP8 profile above 3")
    if not (tag >> 4) & 1:
        raise ValueError("a VP8 frame that is not shown")
    if tag >> 5 >= declared:
        raise ValueError("a VP8 first partition as long as its chunk")
    w = int.from_bytes(payload[6:8], "little") & 0x3FFF
    h = int.from_bytes(payload[8:10], "little") & 0x3FFF
    if not w or not h:
        raise ValueError("a VP8 frame of zero width or height")
    return w, h


class _Demuxer:
    """libwebp's demux.c over a whole file (WebPDemux, never partial):
    the canvas and the first frame."""

    def __init__(self, data: bytes):
        if len(data) < 16 or data[12:16] not in _OPENED:
            raise ValueError("a WebP file whose first chunk is not VP8, "
                             "VP8L or VP8X (Pillow does not open it)")
        if len(data) < 20:
            raise ValueError("a truncated WebP file (no chunk header)")
        riff_size = struct.unpack_from("<I", data, 4)[0]
        if riff_size < 8 or riff_size > _MAX_CHUNK_PAYLOAD:
            raise ValueError(f"an implausible RIFF size {riff_size}")
        self.end = riff_size + 8
        if len(data) < self.end:
            raise ValueError(f"a truncated WebP file ({len(data)} bytes of "
                             f"a RIFF size of {self.end})")
        self.data = data[:self.end]
        self.pos = 12
        self.flags = 0
        self.frame = None
        self.canvas = None

    def _left(self):
        return self.end - self.pos

    def _header(self):
        fourcc = self.data[self.pos:self.pos + 4]
        size = struct.unpack_from("<I", self.data, self.pos + 4)[0]
        if size > _MAX_CHUNK_PAYLOAD:
            raise ValueError(f"an implausible {fourcc!r} chunk size")
        padded = size + (size & 1)
        if padded > self._left() - 8:
            raise ValueError(f"a {fourcc!r} chunk past the RIFF size")
        return fourcc, size, padded

    def _after_chunk(self):
        """False at the RIFF's end; stray bytes there are refused."""
        if self.pos == self.end:
            return False
        if self._left() < 8:
            raise ValueError("stray bytes after the last WebP chunk")
        return True

    def _store_frame(self, min_size=0):
        """StoreFrame: an optional ALPH chunk, then a VP8 or VP8L chunk."""
        if self._left() < 8 or self._left() < min_size:
            raise ValueError("a truncated WebP frame")
        alpha = image = None
        while True:
            start = self.pos
            fourcc, size, padded = self._header()
            if fourcc == b"ALPH" and alpha is None:
                alpha = self.data[start + 8:start + 8 + size]
            elif fourcc in (b"VP8 ", b"VP8L") and image is None:
                if fourcc == b"VP8L" and alpha is not None:
                    raise ValueError("an ALPH chunk before a VP8L image")
                payload = self.data[start + 8:start + 8 + padded]
                image = (fourcc, payload, *_features(fourcc, payload, size))
            else:
                break
            self.pos = start + 8 + padded
            if not self._after_chunk():
                break
        return alpha, image

    def first_frame(self):
        """(canvas width, canvas height, the first `_Frame`)."""
        if self._left() < 8:
            raise ValueError("a RIFF size too small for a chunk")
        first = self.data[12:16]
        if first == b"VP8X":
            self._vp8x()
        else:
            alpha, image = self._store_frame()
            self.canvas = image[2:4]
            self.frame = _Frame(*image)
        if self.frame is None:
            raise ValueError("a WebP file with no image")
        return (*self.canvas, self.frame)

    def _vp8x(self):
        _, size, padded = self._header()
        if size < 10:
            raise ValueError("a VP8X chunk shorter than 10 bytes")
        payload = self.data[self.pos + 8:self.pos + 18]
        self.flags = payload[0]
        w = int.from_bytes(payload[4:7], "little") + 1
        h = int.from_bytes(payload[7:10], "little") + 1
        if w * h >= _MAX_IMAGE_AREA:
            raise ValueError(f"an implausible canvas {w}x{h}")
        self.canvas = (w, h)
        self.pos += 8 + padded
        if self._left() < 8:
            raise ValueError("a VP8X file with no chunk after its header")
        if self.flags & ~_VALID_FLAGS:
            raise ValueError(f"unknown VP8X flag bits 0x{self.flags:02x}")
        animated = bool(self.flags & ANIMATION_FLAG)
        anim = False
        first = None
        while True:
            start = self.pos
            fourcc, size, padded = self._header()
            if fourcc == b"VP8X":
                raise ValueError("a second VP8X chunk")
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim or animated:
                    raise ValueError("a still image in an animation")
                if self.frame is not None:
                    raise ValueError("a second image in a still WebP")
                alpha, image = self._store_frame()
                if image is None:
                    raise ValueError("an ALPH chunk with no image")
                if not self.flags & ALPHA_FLAG:
                    alpha = None  # libwebp ignores it without the flag
                self.frame = _Frame(*image, alpha=alpha)
                if (self.frame.width, self.frame.height) != self.canvas:
                    raise ValueError(
                        f"a {self.frame.width}x{self.frame.height} image on "
                        f"a {self.canvas[0]}x{self.canvas[1]} canvas")
            elif fourcc == b"ANIM":
                if padded < 6:
                    raise ValueError("an ANIM chunk shorter than 6 bytes")
                anim = True
                self.pos = start + 8 + padded
            elif fourcc == b"ANMF":
                if not anim:
                    raise ValueError("an ANMF chunk before ANIM")
                frame = self._anmf(padded)
                if frame is not None and animated and first is None:
                    first = frame
            else:  # ICCP, EXIF, XMP and unknown chunks
                self.pos = start + 8 + padded
            if not self._after_chunk():
                break
        if animated:
            self.frame = first

    def _anmf(self, padded):
        if padded < 16:
            raise ValueError("an ANMF chunk shorter than 16 bytes")
        head = self.data[self.pos + 8:self.pos + 24]
        x = 2 * int.from_bytes(head[0:3], "little")
        y = 2 * int.from_bytes(head[3:6], "little")
        w = int.from_bytes(head[6:9], "little") + 1
        h = int.from_bytes(head[9:12], "little") + 1
        if w * h >= _MAX_IMAGE_AREA:
            raise ValueError(f"an implausible ANMF frame {w}x{h}")
        self.pos += 8 + 16
        body = self.pos
        alpha, image = self._store_frame(padded - 16)
        if self.pos - body > padded - 16:
            raise ValueError("an ANMF frame's chunks past the frame")
        if image is None:
            if alpha is not None:
                raise ValueError("an ANMF frame with alpha and no image")
            return None
        frame = _Frame(*image, alpha=alpha, x=x, y=y)
        if (x + frame.width > self.canvas[0]
                or y + frame.height > self.canvas[1]):
            raise ValueError("an animation frame outside its canvas")
        return frame


def _check(rc, what):
    if rc:
        raise ValueError(f"corrupt {what} data: "
                         f"{_ERRORS.get(rc, f'code {rc}')}")


def _frame_rgb(frame: _Frame) -> np.ndarray:
    lib = load()
    w, h = frame.width, frame.height
    src = np.frombuffer(frame.payload, np.uint8)
    if frame.kind == b"VP8L":
        argb = np.empty(h * w, np.uint32)
        _check(lib.webp_vp8l_decode(src.ctypes.data, len(src),
                                    argb.ctypes.data, w, h), "VP8L")
        return argb.view(np.uint8).reshape(h, w, 4)[..., 2::-1].copy()
    rgb = np.empty((h, w, 3), np.uint8)
    _check(lib.webp_vp8_decode(src.ctypes.data, len(src), rgb.ctypes.data,
                               w, h), "VP8")
    if frame.alpha is not None:  # decoded so that a bad one is refused
        alpha = np.empty(h * w, np.uint8)
        a = np.frombuffer(frame.alpha, np.uint8)
        _check(lib.webp_alpha_decode(a.ctypes.data, len(a),
                                     alpha.ctypes.data, w, h), "ALPH")
    return rgb


def decode(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a WebP file, as the JAX loader reads it."""
    width, height, frame = _Demuxer(bytes(data)).first_frame()
    for w, h in ((width, height), (frame.width, frame.height)):
        if w * h > MAX_PIXELS:
            raise ValueError(f"implausible image size {h}x{w} (over "
                             f"{MAX_PIXELS} pixels)")
    rgb = _frame_rgb(frame)
    if (frame.width, frame.height, frame.x, frame.y) == (width, height, 0, 0):
        return rgb
    canvas = np.zeros((height, width, 3), np.uint8)
    canvas[frame.y:frame.y + frame.height,
           frame.x:frame.x + frame.width] = rgb
    return canvas
