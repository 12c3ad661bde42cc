"""Image decoding for the loader, the daemon and the artifact: JPEG through
the port's own decoder, PNG through libpng or the standard-library reader,
TIFF, WebP, BMP, GIF and JPEG 2000 through the port's own readers.

Counterpart of mapping_tpu/utils/native_decode.py, which decodes both
formats with libjpeg and libpng (cpp/decode.cpp). Here:
- a JPEG decodes through the port's decoder on every machine (baseline,
  progressive and arithmetic-coded; 1, 3 or 4 components): the markers
  and the entropy decode on the host (utils/jpeg.py over
  csrc/jpeg_entropy.cpp, which releases the GIL), then the pixel stage of
  kernels/jpeg.py on the target device: the CUDA kernel `jpeg_pixels` for
  a CUDA target, the plain PyTorch version for a CPU one. The result equals
  the JAX package's load_image bit for bit (libjpeg-turbo's default
  decode; for CMYK and YCCK, Pillow's reading of it). A lossless (SOF3)
  JPEG decodes wholly on the host (utils/jpeg.read), as Pillow's
  libjpeg-turbo 3.1.3 reads it for the JAX loader. libjpeg is not used;
- a PNG decodes through cpp/decode.cpp's libpng where that library builds
  (`load`, `available`) and takes the file, else through utils/png.py,
  which reads every PNG kind and applies libpng's gamma conversion where
  libpng would: the two give the same bytes;
- a TIFF decodes through utils/tiff.py on every machine (strips and tiles;
  none, LZW, Deflate, PackBits, LZMA, ZSTD and JPEG; the sample layouts
  Pillow reads, its float and integer ones among them),
  as the JAX loader reads it through Pillow; a JPEG-compressed one's
  strips or tiles go through the JPEG decoder's two halves, their pixel
  stage on the target device (lossless strips or tiles decode on the
  host and are pasted beside them);
- a WebP decodes through utils/webp.py on every machine (lossless VP8L,
  lossy VP8 with libwebp's fancy upsampling, alpha, VP8X and the first
  frame of an animation; the bitstreams in csrc/webp_decode.cpp), wholly
  on the host, as the JAX loader reads it through Pillow;
- a BMP or a headerless DIB decodes through utils/bmp.py (every header,
  depth, palette, RLE8 / RLE4 in csrc/bmp_decode.cpp and Pillow's
  bitfields) and a GIF's first frame through utils/gif.py (LZW in
  csrc/gif_decode.cpp), on the host, as the JAX loader reads them through
  Pillow;
- a JPEG 2000 file (JP2 or a raw J2K codestream) decodes through
  utils/jp2.py (the codestream in csrc/jp2_decode.cpp: tier 2, tier 1,
  the inverse wavelet and the colour transform, as openjpeg 2.5 decodes
  them; Pillow's unpacking in numpy), on the host, as the JAX loader reads
  it through Pillow.

`decode_rgb` / `decode_rgb_bytes` give host arrays (a JPEG's pixel stage
then runs on the CPU). `read_image` gives the host half of a decode (a
JPEG's coefficients, a JPEG TIFF's `tiff.JpegTiles`, or a lossless JPEG's,
PNG's or other TIFF's pixels) and `assemble` turns a batch of them into
one (B, H, W, 3) uint8 tensor on a device, one pixel-stage call per JPEG
geometry for all the batch's JPEGs and JPEG-TIFF parts;
`decode_rgb_batch` is the two together.
"""

import ctypes
import threading
from collections import defaultdict

import numpy as np
import torch

from mapping_tpu_torch.kernels import jpeg as jpeg_pixels
from mapping_tpu_torch.utils import bmp, gif, jp2, jpeg, png, tiff, webp
from mapping_tpu_torch.utils.resize import resize_bilinear_u8
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


def _png_native(data: bytes):
    """(H, W, 3) uint8 of PNG bytes through libpng, or None where the
    library is missing or declines the file (an alpha channel or 16-bit
    samples, which it leaves to PIL in the JAX package)."""
    try:
        lib = load()
    except NativeLibraryUnavailable:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.decode_probe_mem(data, len(data), ctypes.byref(h),
                            ctypes.byref(w)) != 0:
        return None
    if not (0 < h.value and 0 < w.value
            and h.value * w.value <= jpeg.MAX_PIXELS):
        raise ValueError(f"implausible image size {h.value}x{w.value}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.decode_image_mem(data, len(data),
                            out.ctypes.data_as(ctypes.c_char_p), out.nbytes,
                            3) != 0:
        return None
    return out


def read_bytes(data: bytes):
    """The host half of decoding image bytes: a JPEG's
    `jpeg.Coefficients`, a JPEG-compressed TIFF's `tiff.JpegTiles`, or a
    lossless JPEG's, PNG's, other TIFF's, WebP's, BMP's (or DIB's), GIF's
    or JPEG 2000's (H, W, 3) uint8 pixels. Anything else raises
    ValueError."""
    data = bytes(data)
    if jpeg.is_jpeg(data):
        return jpeg.read(data)
    if data.startswith(png.SIGNATURE):
        out = _png_native(data)
        return out if out is not None else png.to_rgb(png.read_png(data))
    if tiff.is_tiff(data):
        return tiff.decode(data)
    if webp.is_webp(data):
        return webp.decode(data)
    if bmp.is_bmp(data):
        return bmp.decode(data)
    if gif.is_gif(data):
        return gif.decode(data)
    if jp2.is_jp2(data):
        return jp2.decode(data)
    raise ValueError("not a JPEG, PNG, TIFF, WebP, BMP or GIF image, nor a "
                     "JPEG 2000 file")


def read_image(path):
    """`read_bytes` of a file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return read_bytes(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e


def to_rgb(item) -> np.ndarray:
    """(H, W, 3) uint8 host pixels of a `read_bytes` result (a JPEG's
    pixel stage in plain PyTorch on the CPU)."""
    if isinstance(item, np.ndarray):
        return item
    return assemble([item], "cpu")[0].numpy()


def decode_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG, PNG, TIFF, WebP, BMP, GIF or JPEG
    2000 file, on the host."""
    return to_rgb(read_image(path))


def decode_rgb_bytes(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of in-memory JPEG, PNG, TIFF, WebP, BMP, GIF or
    JPEG 2000 bytes (a request body), on the host; anything else raises
    ValueError."""
    return to_rgb(read_bytes(data))


def image_size(item):
    """(H, W) of a `read_bytes` result."""
    if isinstance(item, np.ndarray):
        return item.shape[:2]
    if isinstance(item, tiff.JpegTiles):
        return item.size
    return item.geometry.height, item.geometry.width


def _put(out, idx, rgb, size):
    """`rgb` (n, h, w, 3) into `out` at the batch positions `idx`, resized
    to `size` on the host where it has another size."""
    if tuple(rgb.shape[1:3]) != size:
        rgb = torch.from_numpy(np.stack([resize_bilinear_u8(im, size)
                                         for im in rgb.cpu().numpy()])).to(
            out.device)
    out[torch.as_tensor(idx, device=out.device)] = rgb


def assemble(items, device, size=None) -> torch.Tensor:
    """(B, H, W, 3) uint8 on `device` from `read_bytes` results: the pixel
    stage of the JPEGs and of the JPEG-compressed TIFFs' strips and tiles
    runs on `device` (`jpeg_pixels` on a card), one call per geometry
    for the whole batch, the coefficients copied from pinned host memory;
    a TIFF's parts (lossless ones as the host decoded them) are then
    pasted, clipped and oriented on `device`.
    Without `size` every image must have one size; with it, an image of
    another size is resized to `size` on the host (utils/resize, Pillow's
    bilinear), as the JAX loader resizes a batch of mixed sizes."""
    items = list(items)
    device = torch.device(device)
    if not items:
        raise ValueError("no images to assemble")
    sizes = {tuple(image_size(it)) for it in items}
    if size is None:
        if len(sizes) > 1:
            raise ValueError(f"images of several sizes {sorted(sizes)}; "
                             f"give a size to resize them to")
        size = sizes.pop()
    size = tuple(size)
    out = torch.empty((len(items),) + size + (3,), dtype=torch.uint8,
                      device=device)
    groups = defaultdict(list)  # geometry -> [(item, part or None)]
    lossless = defaultdict(list)  # item -> its lossless parts
    host, host_idx = [], []
    for i, it in enumerate(items):
        if isinstance(it, np.ndarray):
            host.append(it)
            host_idx.append(i)
        elif isinstance(it, tiff.JpegTiles):
            for k, (_, _, c) in enumerate(it.parts):
                if isinstance(c, np.ndarray):  # a lossless part's pixels
                    lossless[i].append(k)
                else:
                    groups[c.geometry].append((i, k))
        else:
            groups[it.geometry].append((i, None))
    if host:
        out[torch.as_tensor(host_idx, device=device)] = torch.from_numpy(
            np.stack([it if it.shape[:2] == size
                      else resize_bilinear_u8(it, size) for it in host])).to(
            device)
    pin = device.type == "cuda"
    canvases = {}

    def canvas_of(i):
        if i not in canvases:
            it = items[i]
            canvases[i] = torch.empty((it.height, it.width, 3),
                                      dtype=torch.uint8, device=device)
        return canvases[i]

    for geometry, members in groups.items():
        parts = [items[i] if k is None else items[i].parts[k][2]
                 for i, k in members]
        coef = torch.empty((len(parts), geometry.n_blocks, 64),
                           dtype=torch.int16, pin_memory=pin)
        quant = torch.empty((len(parts), len(geometry.factors), 64),
                            dtype=torch.int32, pin_memory=pin)
        for n, c in enumerate(parts):
            coef[n].numpy()[...] = c.coef
            quant[n].numpy()[...] = c.quant
        rgb = jpeg_pixels.pixels(coef.to(device, non_blocking=pin),
                                 quant.to(device, non_blocking=pin),
                                 geometry)
        whole = [n for n, (_, k) in enumerate(members) if k is None]
        if whole:
            _put(out, [members[n][0] for n in whole],
                 rgb if len(whole) == len(members) else rgb[whole], size)
        tiled = defaultdict(list)  # an item's parts are consecutive
        for n, (i, k) in enumerate(members):
            if k is not None:
                tiled[i].append(n)
        for i, ns in tiled.items():
            it = items[i]
            it.paste(canvas_of(i),
                     [it.parts[members[n][1]][:2] for n in ns],
                     rgb[ns[0]:ns[-1] + 1])
    for i, ks in lossless.items():
        it = items[i]
        for k in ks:
            y0, x0, part = it.parts[k]
            it.paste(canvas_of(i), [(y0, x0)],
                     torch.from_numpy(part[None]).to(device))
    for i, canvas in canvases.items():
        _put(out, [i], items[i].finish(canvas)[None], size)
    return out


class DeviceDecoder:
    """`assemble` for a producer thread (a loader's prefetch, the
    artifact's look-ahead, the daemon's handlers): on a card the pixel
    stage runs on a stream of its own, so it waits for no other work
    queued there. The call returns (images, ready), `ready` an event
    recorded after the pixel stage and already synchronised, so that the producer's
    decode time runs to the kernels' end; the consumer hands the batch to
    its own stream with `take`. On the CPU `ready` is None."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = None
        self._lock = threading.Lock()

    def stream(self):
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def __call__(self, items, size=None):
        if self.device.type != "cuda":
            return assemble(items, self.device, size), None
        stream = self.stream()
        with torch.cuda.stream(stream):
            images = assemble(items, self.device, size)
            ready = torch.cuda.Event()
            ready.record(stream)
        ready.synchronize()
        return images, ready


def take(images, ready=None):
    """A batch (or tile) from `DeviceDecoder`, made safe for the
    consumer's current stream: it waits on `ready`, and the allocator
    learns that the stream uses the batch. A host batch (a tensor or an
    array) passes as it is."""
    if isinstance(images, torch.Tensor) and images.is_cuda:
        stream = torch.cuda.current_stream(images.device)
        if ready is not None:
            stream.wait_event(ready)
        images.record_stream(stream)
    return images


def decode_rgb_batch(paths, device, size=None) -> torch.Tensor:
    """(B, H, W, 3) uint8 tensor on `device` of image files: `read_image`
    of each, then `assemble`."""
    return assemble([read_image(p) for p in paths], device, size)


def releases_gil(path) -> bool:
    """Whether decoding this file runs in native code that releases the
    GIL (so decode threads scale), by its name: a JPEG's Huffman decode
    always (a lossless one's whole decode, scans and colour, in
    csrc/jpeg_entropy.cpp), a TIFF's decompression always (LZW and PackBits in
    csrc/tiff_codecs.cpp, ZSTD in csrc/zstd_decode.cpp, Deflate in zlib,
    LZMA in liblzma, JPEG in csrc/jpeg_entropy.cpp, the samples in numpy),
    a WebP's bitstream always
    (csrc/webp_decode.cpp), a GIF's LZW always (csrc/gif_decode.cpp), a
    BMP's always (RLE in csrc/bmp_decode.cpp, raw rows in numpy copies), a
    JPEG 2000 codestream always (csrc/jp2_decode.cpp), a PNG where libpng
    serves; the standard-library PNG reader holds the GIL between its
    numpy calls."""
    return str(path).lower().endswith(
        (".jpg", ".jpeg", ".tif", ".tiff", ".webp", ".bmp", ".dib", ".gif",
         ".jp2", ".j2k", ".jpc", ".jpf", ".jpx", ".j2c")) or available()
