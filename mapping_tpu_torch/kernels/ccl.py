"""Wrappers of the CUDA connected-component kernels (csrc/ccl.cu).

`label_raw` replaces the TPU kernel `_ccl_kernel`
(mapping_tpu/ops/ccl_pallas.py:127) and `renumber` the renumbering stage
of `_ccl_renumber_kernel` (ccl_pallas.py:141); `renumber(label_raw(m))` is
`label_pallas(m)`. Both take CUDA tensors only and raise on anything else:
the plain versions of the same contracts, for CPU tensors and for
comparison, are `_label_raw` and `_renumber` in mapping_tpu_torch/ops/ccl.py,
and `connected_components` there chooses between the two by device.

What bounds the kernels on an H100, and what the design does about it, is
set out at the top of csrc/ccl.cu: they are memory-bound, at roughly 1 B of
mask in, 4 B of labels out and the union-find's parent traffic per pixel
(about 1.8 M pixels for a serving batch of 20 tiles at 300^2). `renumber`
runs over a grid of 1024-pixel chunks of every image at once: a count of
each chunk's roots (ballot + popc, with the prefix inside the chunk), a
per-image scan of the chunk counts, and a gather that computes each
pixel's rank from those (`renumber_plan` sizes its scratch).

Each wrapper launches on the current stream, never synchronises, allocates
its outputs and scratch with torch.empty, and adds one to `LAUNCHES[name]`
each time it launches its kernel.
"""

import ctypes

import torch

from mapping_tpu_torch.kernels.build import CSRC, build_shared_library

LIBRARY = "mapping_ccl"
SOURCES = [CSRC / "ccl.cu"]
LAUNCHES = {"ccl_label_raw": 0, "ccl_renumber": 0}
CHUNK = 1024  # pixels of a renumbering chunk (kChunk in csrc/ccl.cu)

_library = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def library():
    """(ctypes library, Built): compiles csrc/ccl.cu on first use."""
    global _library
    if _library is None:
        built = build_shared_library(LIBRARY, SOURCES)
        lib = ctypes.CDLL(str(built.path))
        for fn in (lib.ccl_label_raw, lib.ccl_renumber):
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _library = (lib, built)
    return _library


def _check(x: torch.Tensor, dtypes, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: needs a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {x.dtype} not in {dtypes}")
    if x.dim() != 3:
        raise ValueError(f"{what}: needs (N, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous tensor")
    if x.shape[1] * x.shape[2] >= 2 ** 31:
        raise ValueError(f"{what}: H * W must fit in int32")


def _launch(fn, name, src, scratch, out):
    n, h, w = src.shape
    if src.numel() == 0:
        return
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, h, w,
                 stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def label_raw(mask: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool/uint8 CUDA mask -> (N, H, W) int32 labels: 1 + the
    row-major index of each component's minimal pixel, background 0."""
    _check(mask, (torch.bool, torch.uint8), "label_raw")
    parent = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    labels = torch.empty_like(parent)
    _launch(library()[0].ccl_label_raw, "ccl_label_raw", mask, parent, labels)
    return labels


def renumber_plan(n, h, w):
    """(words, chunks, scratch) of `renumber` on (n, h, w) labels: 32-pixel
    words and CHUNK-pixel chunks per image, and the int32 scratch: one
    root-bit word and one in-chunk prefix per word, one count and one
    prefix per chunk."""
    words, chunks = -(-h * w // 32), -(-h * w // CHUNK)
    return words, chunks, 2 * n * (words + chunks)


def renumber(labels: torch.Tensor) -> torch.Tensor:
    """`label_raw` output -> consecutive 1..K per image in
    scipy.ndimage.label order (by minimal pixel); background stays 0.

    The input must be what `label_raw` (or the plain `_label_raw`) returns:
    every label is 1 + the index of a pixel that carries that same label.
    The kernel looks that pixel up without a bounds check, so any other
    int32 map reads outside the scratch or gives wrong ranks."""
    _check(labels, (torch.int32,), "renumber")
    scratch = torch.empty(renumber_plan(*labels.shape)[2], dtype=torch.int32,
                          device=labels.device)
    out = torch.empty_like(labels)
    _launch(library()[0].ccl_renumber, "ccl_renumber", labels, scratch, out)
    return out
