"""Wrapper of the CUDA filter-gradient kernel (csrc/conv_dw.cu).

`conv_dw` replaces the TPU kernel `_dw_kernel` (tools/dw_probe.py:70,
through `dw_pallas`): the weight gradient of a stride-1 SAME conv with an
odd k x k kernel and as many output as input channels, from bfloat16
activations x and output gradients dy, in float32. It takes CUDA tensors
only and raises on anything else; the plain version of the same contract,
for CPU tensors and for comparison, is `conv_dw_plain` in
mapping_tpu_torch/ops/conv_dw.py.

The wrapper plans the launch (pixel rows per staged tile, accumulator
tiles per warp, how many slices the reduction over N * H * W is split
into), allocates the partial sums and the output with torch.empty, launches
on the current stream without synchronising, and adds one to
`LAUNCHES["conv_dw"]` each time it launches. What bounds the kernel and how
it is built is set out at the top of csrc/conv_dw.cu.
"""

import ctypes

import torch

from mapping_tpu_torch.kernels.build import CSRC, build_shared_library

LIBRARY = "mapping_conv_dw"
SOURCES = [CSRC / "conv_dw.cu"]
LAUNCHES = {"conv_dw": 0}

# the kernel's constants (csrc/conv_dw.cu)
_WARPS, _MAX_FRAGS, _TILE_W, _PAD = 8, 8, 32, 16
_MAX_SHARED = 232448  # bytes of shared memory a block may use on sm_90

_library = None


def reset_launches():
    LAUNCHES["conv_dw"] = 0


def library():
    """(ctypes library, Built): compiles csrc/conv_dw.cu on first use."""
    global _library
    if _library is None:
        built = build_shared_library(LIBRARY, SOURCES)
        lib = ctypes.CDLL(str(built.path))
        lib.conv_dw_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        lib.conv_dw_bf16.restype = ctypes.c_int
        _library = (lib, built)
    return _library


def plan(n, h, w, c, k, sms):
    """(rows, frags_per_warp, groups, slices, shared bytes) of a launch on
    a card with `sms` multiprocessors: about two blocks per multiprocessor
    in all, each slice walking every slices-th pixel tile."""
    rows = max(1, 512 // c)
    n_frags = k * k * (c // 16) ** 2
    frags_per_warp = min(_MAX_FRAGS, -(-n_frags // _WARPS))
    groups = -(-n_frags // (_WARPS * frags_per_warp))
    tiles = n * -(-h // rows) * -(-w // _TILE_W)
    slices = max(1, min(tiles, -(-2 * sms // groups)))
    ph = k // 2
    shared = ((rows + 2 * ph) * (_TILE_W + 2 * ph) + rows * _TILE_W) * (
        c + _PAD) * 2
    return rows, frags_per_warp, groups, slices, shared


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
    if plan(x.shape[0], x.shape[2], x.shape[3], c, k, 1)[4] > _MAX_SHARED:
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
    rows, fpw, _, slices, _ = plan(n, h, w, c, k, sms)
    partial = torch.empty((slices, k * k * c * c), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = library()[0].conv_dw_bf16(
            x.data_ptr(), dy.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n, h, w, c, k, rows, fpw, slices, stream)
    if err != 0:
        raise RuntimeError(f"conv_dw: CUDA launch failed with error {err}")
    LAUNCHES["conv_dw"] += 1
    return out
