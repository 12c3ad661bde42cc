"""Wrappers of the CUDA connected-component kernels (csrc/ccl.cu).

`label_raw` replaces the TPU kernel `_ccl_kernel`
(mapping_tpu/ops/ccl_pallas.py:127) and `renumber` the renumbering stage
of `_ccl_renumber_kernel` (ccl_pallas.py:141); `renumber(label_raw(m))` is
`label_pallas(m)`, and `label(m)` computes the same with the renumbering's
root count fused into the labelling's last pass. All take CUDA tensors only
and raise on anything else: the plain versions of the same contracts, for
CPU tensors and for comparison, are `_label_raw` and `_renumber` in
mapping_tpu_torch/ops/ccl.py (`label`'s is `_renumber(_label_raw(...))`),
and `connected_components` there chooses between the two by device.

The design is set out at the top of csrc/ccl.cu. `label_raw` is a
block-based union-find: each block labels a TILE_H x TILE_W tile of one
image in shared memory, then one thread per pixel of the tiles' top rows
and left columns unites across the borders in global memory, then every
pixel resolves its root (`label_plan` sizes the grids). `renumber` runs
over a grid of 1024-pixel chunks of every image at once: a count of each
chunk's roots (ballot + popc, with the prefix inside the chunk), a
per-image scan of the chunk counts, and a gather that computes each
pixel's rank from those (`renumber_plan` sizes its scratch). `label` runs
the tile and border passes, a resolve that also writes the chunk counts,
then the scan and the gather: five launches for the main path's mask ->
consecutive labels, where `renumber(label_raw(m))` takes six. At a serving
batch (20 tiles of 300^2, 1.8 M pixels) the kernels are bound by launch
and load latency, not by their ~1 B of mask in and 4 B of labels out per
pixel.

Each wrapper launches on the current stream, never synchronises, allocates
its outputs and scratch with torch.empty, and adds one to `LAUNCHES[name]`
each time it launches its kernel; `label` adds one to both counts, since
it does the work of both.
"""

import ctypes
from typing import NamedTuple

import torch

from mapping_tpu_torch.kernels.build import CSRC, build_shared_library

LIBRARY = "mapping_ccl"
SOURCES = [CSRC / "ccl.cu"]
LAUNCHES = {"ccl_label_raw": 0, "ccl_renumber": 0}
CHUNK = 1024  # pixels of a renumbering chunk (kChunk in csrc/ccl.cu)
TILE_H, TILE_W = 32, 64  # a labelling tile (kTileH, kTileW in csrc/ccl.cu)

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
        for fn in (lib.ccl_label_raw, lib.ccl_renumber, lib.ccl_label):
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


def _launch(fn, names, src, scratch, out):
    n, h, w = src.shape
    if src.numel() == 0:
        return
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, h, w,
                 stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed with error "
                           f"{err}")
    for name in names:
        LAUNCHES[name] += 1


class LabelPlan(NamedTuple):
    """Grids of the labelling on (n, h, w) masks. Tiles of TILE_H x TILE_W
    pixels, `tiles_y` x `tiles_x` per image, cover every pixel once; tile t
    of image i is block i * tiles + t of the tile pass, at row
    (t // tiles_x) * TILE_H and column (t % tiles_x) * TILE_W. The border
    pass runs `border` threads per tile, thread k on the top row's pixel k
    (k < TILE_W) or the left column's pixel k - TILE_W; `shared_bytes` is
    a tile block's static shared memory; `work` the int32 workspace of
    `label`: parents, raw labels, then `renumber`'s scratch."""

    tiles_y: int
    tiles_x: int
    tiles: int
    border: int
    shared_bytes: int
    work: int


def label_plan(n, h, w):
    """The LabelPlan of `label_raw` and `label` on (n, h, w) masks."""
    tiles_y, tiles_x = -(-h // TILE_H), -(-w // TILE_W)
    # mask bytes, one 64-bit foreground word per row, an int32 parent each
    shared = TILE_H * TILE_W + TILE_H * 8 + TILE_H * TILE_W * 4
    return LabelPlan(tiles_y, tiles_x, tiles_y * tiles_x, TILE_H + TILE_W,
                     shared, 2 * n * h * w + renumber_plan(n, h, w)[2])


def label_raw(mask: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool/uint8 CUDA mask -> (N, H, W) int32 labels: 1 + the
    row-major index of each component's minimal pixel, background 0."""
    _check(mask, (torch.bool, torch.uint8), "label_raw")
    parent = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    labels = torch.empty_like(parent)
    _launch(library()[0].ccl_label_raw, ("ccl_label_raw",), mask, parent,
            labels)
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
    _launch(library()[0].ccl_renumber, ("ccl_renumber",), labels, scratch,
            out)
    return out


def label(mask: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool/uint8 CUDA mask -> (N, H, W) int32 labels numbered
    1..K per image in scipy.ndimage.label order, background 0: the same as
    `renumber(label_raw(mask))`, in five launches instead of six."""
    _check(mask, (torch.bool, torch.uint8), "label")
    work = torch.empty(label_plan(*mask.shape).work, dtype=torch.int32,
                       device=mask.device)
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    _launch(library()[0].ccl_label, ("ccl_label_raw", "ccl_renumber"), mask,
            work, out)
    return out
