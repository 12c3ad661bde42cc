"""Image decoding for the loader, the daemon and the artifact: JPEG through
the port's own decoder, PNG through libpng or the standard-library reader.

Counterpart of mapping_tpu/utils/native_decode.py, which decodes both
formats with libjpeg and libpng (cpp/decode.cpp). Here:
- a JPEG decodes through the port's decoder on every machine (baseline,
  progressive and arithmetic-coded; 1, 3 or 4 components): the markers
  and the entropy decode on the host (utils/jpeg.py over
  csrc/jpeg_entropy.cpp, which releases the GIL), then the pixel stage of
  kernels/jpeg.py on the target device: the CUDA kernel `jpeg_pixels` for
  a CUDA target, the plain PyTorch version for a CPU one. The result equals
  the JAX package's load_image bit for bit (libjpeg-turbo's default
  decode; for CMYK and YCCK, Pillow's reading of it). libjpeg is not used;
- a PNG decodes through cpp/decode.cpp's libpng where that library builds
  (`load`, `available`) and takes the file, else through utils/png.py,
  which reads every PNG kind.

`decode_rgb` / `decode_rgb_bytes` give host arrays (a JPEG's pixel stage
then runs on the CPU). `read_image` gives the host half of a decode (a
JPEG's coefficients, or a PNG's pixels) and `assemble` turns a batch of
them into one (B, H, W, 3) uint8 tensor on a device, one pixel-stage call
per JPEG geometry; `decode_rgb_batch` is the two together.
"""

import ctypes
import threading
from collections import defaultdict

import numpy as np
import torch

from mapping_tpu_torch.kernels import jpeg as jpeg_pixels
from mapping_tpu_torch.utils import jpeg, png
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
    `jpeg.Coefficients`, or a PNG's (H, W, 3) uint8 pixels. Anything else
    raises ValueError."""
    data = bytes(data)
    if jpeg.is_jpeg(data):
        return jpeg.read_coefficients(data)
    if data.startswith(png.SIGNATURE):
        out = _png_native(data)
        return out if out is not None else png.to_rgb(png.decode_png(data))
    raise ValueError("not a JPEG or PNG image")


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
    return jpeg_pixels.pixels(torch.from_numpy(item.coef)[None],
                              torch.from_numpy(item.quant)[None],
                              item.geometry)[0].numpy()


def decode_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG or PNG file, on the host."""
    return to_rgb(read_image(path))


def decode_rgb_bytes(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of in-memory JPEG or PNG bytes (a request
    body), on the host; anything else raises ValueError."""
    return to_rgb(read_bytes(data))


def image_size(item):
    """(H, W) of a `read_bytes` result."""
    if isinstance(item, np.ndarray):
        return item.shape[:2]
    return item.geometry.height, item.geometry.width


def assemble(items, device, size=None) -> torch.Tensor:
    """(B, H, W, 3) uint8 on `device` from `read_bytes` results: the JPEGs'
    pixel stage runs on `device` (`jpeg_pixels` on a card), one call per
    geometry, their coefficients copied from pinned host memory. Without
    `size` every image must have one size; with it, an image of another
    size is resized to `size` on the host (utils/resize, Pillow's
    bilinear), as the JAX loader resizes a batch of mixed sizes."""
    from mapping_tpu_torch.utils.resize import resize_bilinear_u8

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
    groups = defaultdict(list)
    host, host_idx = [], []
    for i, it in enumerate(items):
        if isinstance(it, np.ndarray):
            host.append(it if it.shape[:2] == size
                        else resize_bilinear_u8(it, size))
            host_idx.append(i)
        else:
            groups[it.geometry].append(i)
    if host:
        out[torch.as_tensor(host_idx, device=device)] = torch.from_numpy(
            np.stack(host)).to(device)
    pin = device.type == "cuda"
    for geometry, idx in groups.items():
        coef = torch.empty((len(idx), geometry.n_blocks, 64),
                           dtype=torch.int16, pin_memory=pin)
        quant = torch.empty((len(idx), len(geometry.factors), 64),
                            dtype=torch.int32, pin_memory=pin)
        for k, i in enumerate(idx):
            coef[k].numpy()[...] = items[i].coef
            quant[k].numpy()[...] = items[i].quant
        rgb = jpeg_pixels.pixels(coef.to(device, non_blocking=pin),
                                 quant.to(device, non_blocking=pin),
                                 geometry)
        if (geometry.height, geometry.width) != size:
            host = rgb.cpu().numpy()
            rgb = torch.from_numpy(np.stack(
                [resize_bilinear_u8(im, size) for im in host])).to(device)
        out[torch.as_tensor(idx, device=device)] = rgb
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
    always, a PNG where libpng serves; the standard-library PNG reader
    holds the GIL between its numpy calls."""
    return str(path).lower().endswith((".jpg", ".jpeg")) or available()
