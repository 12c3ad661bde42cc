"""Wrapper of the CUDA filter-gradient kernel (csrc/conv_dw.cu).

`conv_dw` replaces the TPU kernel `_dw_kernel` (tools/dw_probe.py:70,
through `dw_pallas`): the weight gradient of a stride-1 SAME conv with an
odd k x k kernel and as many output as input channels, from bfloat16
activations x and output gradients dy, in float32. It takes CUDA tensors
only and raises on anything else; the plain version of the same contract,
for CPU tensors and for comparison, is `conv_dw_plain` in
mapping_tpu_torch/ops/conv_dw.py.

The kernel is persistent and warp-specialised: about one block per SM, a
producer warp feeding a ring of shared-memory stages with TMA loads of the
x halo tile and the dy tile, three consumer warpgroups holding the output
strips as wgmma accumulators, and the reduction over N * H * W split over
the blocks (split-K), summed in a second pass. `plan` chooses the launch:
the channel box (the products' N), the dy tile and ring depth that fit in
shared memory, the output groups that fit in registers, and the slices of
the pixel tiles. The wrapper allocates the partial sums and the output
with torch.empty, launches on the current stream without synchronising,
and adds one to `LAUNCHES["conv_dw"]` each time it launches. The tensor
maps are encoded on the host at every call (a few microseconds of host
time). What bounds the kernel is set out at the top of csrc/conv_dw.cu.
"""

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from mapping_tpu_torch.kernels.build import CSRC, build_shared_library

LIBRARY = "mapping_conv_dw"
SOURCES = [CSRC / "conv_dw.cu"]
LAUNCHES = {"conv_dw": 0}

# the kernel's constants (csrc/conv_dw.cu): consumer warpgroups per block,
# row taps (dh) a consumer warpgroup holds, the alignment of stage regions
_CONSUMERS = 3
_DH = 3
_ALIGN = 1024
_MAX_SHARED = 232448  # bytes of shared memory a block may use on sm_90
_MAX_BOX = 256  # TMA box dimension limit
_MAX_STAGES = 4

_library = None


class Plan(NamedTuple):
    """A launch of csrc/conv_dw.cu; the fields up to `units` are its `Plan`
    struct, in order."""

    n: int
    h: int
    w: int
    c: int
    k: int
    cb: int  # channels per TMA box = N of the products
    bh: int  # dy tile rows
    bw: int  # dy tile columns
    stages: int
    tiles_x: int
    tiles_y: int
    slices: int  # pixel-tile runs, one block of each output group per run
    groups: int  # output groups: n-blocks x runs of _CONSUMERS units
    dh_chunk: int  # min(k, _DH): row taps of a unit
    units: int  # pieces (64 of the k * c rows of a dh) x chunks of dh_chunk
    #             row taps: one unit per consumer warpgroup
    shared: int  # dynamic shared memory bytes of a block


_PLAN_FIELDS = Plan._fields.index("units") + 1  # the C struct's fields


def reset_launches():
    LAUNCHES["conv_dw"] = 0


def library():
    """(ctypes library, Built): compiles csrc/conv_dw.cu on first use."""
    global _library
    if _library is None:
        built = build_shared_library(LIBRARY, SOURCES)
        lib = ctypes.CDLL(str(built.path))
        lib.conv_dw_bf16.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        lib.conv_dw_bf16.restype = ctypes.c_int
        _library = (lib, built)
    return _library


def _round_up(v, m):
    return -(-v // m) * m


def channel_box(c):
    """Channels per TMA box and N of the products: the largest of 64, 32,
    16 that divides c. Its bytes (128, 64, 32) are the swizzle width."""
    return next(cb for cb in (64, 32, 16) if c % cb == 0)


def stage_bytes(c, k, bh, bw):
    """Shared bytes of one ring stage: for each channel box an x region
    (the halo tile and one zero row), then one dy region (k - 1 zero rows,
    rounded up to 1024 bytes, the dy tile and k zero rows), each
    1024-aligned."""
    cb = channel_box(c)
    x_region = _round_up((bh + k) * (bw + k - 1) * cb * 2, _ALIGN)
    pad = _round_up((k - 1) * bw * cb * 2, _ALIGN)
    dy_region = _round_up(pad + (bh + k) * bw * cb * 2, _ALIGN)
    return c // cb * x_region + dy_region


def _pow2_at_least(v):
    return 1 << max(0, v - 1).bit_length()


def _tile(h, w, c, k):
    """(bh, bw, stages): the most dy pixels a stage can hold with a ring of
    at least 3 stages (else 2), then the fewest bytes a stage; None when
    not even 2 stages of 16 pixels fit."""
    best = None
    for bw in (32, 16, 8):
        if bw > max(8, _pow2_at_least(w)) or bw + k - 1 > _MAX_BOX:
            continue
        bh = max(1, 16 // bw)
        while bh * bw <= 256 and bh <= max(_pow2_at_least(h), 16 // bw) \
                and bh + k - 1 <= _MAX_BOX:
            size = stage_bytes(c, k, bh, bw)
            stages = min(_MAX_STAGES, (_MAX_SHARED - _ALIGN) // (size + 16))
            key = (stages >= 3, bh * bw, -size)
            if stages >= 2 and (best is None or key > best[0]):
                best = (key, (bh, bw, stages))
            bh *= 2
    return None if best is None else best[1]


@functools.lru_cache(maxsize=256)
def plan(n, h, w, c, k, sms) -> Optional[Plan]:
    """The launch on a card with `sms` multiprocessors: one block per
    multiprocessor in all, split over the output groups; None when the
    shape needs more shared memory than a block has."""
    tile = _tile(h, w, c, k)
    if tile is None:
        return None
    bh, bw, stages = tile
    cb = channel_box(c)
    dh_chunk = min(k, _DH)
    units = -(-k * c // 64) * -(-k // dh_chunk)
    groups = -(-units // _CONSUMERS) * (c // cb)
    tiles_x, tiles_y = -(-w // bw), -(-h // bh)
    slices = max(1, min(n * tiles_x * tiles_y, sms // groups))
    shared = stages * (stage_bytes(c, k, bh, bw) + 16) + _ALIGN
    return Plan(n, h, w, c, k, cb, bh, bw, stages, tiles_x, tiles_y, slices,
                groups, dh_chunk, units, shared)


def _check(x: torch.Tensor, dy: torch.Tensor, k: int):
    if x.dim() != 4 or dy.shape != x.shape:
        raise ValueError(f"conv_dw: x and dy must be (N, C, H, W) of one "
                         f"shape, got {tuple(x.shape)} and {tuple(dy.shape)}")
    if x.dtype != torch.bfloat16 or dy.dtype != torch.bfloat16:
        raise TypeError(f"conv_dw: needs bfloat16, got {x.dtype}, {dy.dtype}")
    c = x.shape[1]
    if k < 1 or k % 2 == 0:
        raise ValueError(f"conv_dw: k must be odd, got {k}")
    if c % 16 or c == 0:
        raise ValueError(f"conv_dw: channels must be a multiple of 16, got {c}")
    if plan(x.shape[0], x.shape[2], x.shape[3], c, k, 1) is None:
        raise ValueError(f"conv_dw: C={c}, k={k} needs more shared memory "
                         f"than a block has")
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"conv_dw: needs CUDA tensors on one device, got "
                         f"{x.device} and {dy.device}")


def conv_dw(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """dW of the stride-1 SAME k x k conv whose input is x and whose output
    gradient is dy, both (N, C, H, W) bfloat16 on a card -> (C, C, k, k)
    float32 in torch's weight layout (C_out, C_in, k, k). Inputs not in
    channels_last memory are copied into it."""
    _check(x, dy, k)
    n, c, h, w = x.shape
    out = torch.empty((c, c, k, k), dtype=torch.float32, device=x.device)
    if n * h * w == 0:
        return out.zero_()
    x = x.contiguous(memory_format=torch.channels_last)
    dy = dy.contiguous(memory_format=torch.channels_last)
    if x.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError("conv_dw: x and dy must be 16-byte aligned")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    pl = plan(n, h, w, c, k, sms)
    partial = torch.empty((pl.slices, k * k * c * c), dtype=torch.float32,
                          device=x.device)
    fields = (ctypes.c_int * _PLAN_FIELDS)(*pl[:_PLAN_FIELDS])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = library()[0].conv_dw_bf16(
            x.data_ptr(), dy.data_ptr(), partial.data_ptr(), out.data_ptr(),
            fields, stream)
    if err != 0:
        raise RuntimeError(f"conv_dw: CUDA launch failed with error {err}")
    LAUNCHES["conv_dw"] += 1
    return out
