"""The least time an NVIDIA H100 SXM could take for each kernel's work.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate,
and the operations it must do over the card's peak rate for their type.
The rates are NVIDIA's data-sheet figures for the H100 SXM at its full
700 W power limit; a card set to a lower limit runs slower under load, so
a share of the bound is stated beside the card's power limit. Each
function takes the shapes a call is given and returns (ms, what bounds it:
"bytes" or "operations").
"""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # dense tensor-core rate


def bound_ms(flops, n_bytes):
    """(ms, "bytes" or "operations") of `flops` bf16 operations and
    `n_bytes` of device-memory traffic."""
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_flops = flops / BF16_FLOPS
    if by_flops > by_bytes:
        return 1e3 * by_flops, "operations"
    return 1e3 * by_bytes, "bytes"


def conv_dw(n, c, h, w, k):
    """K3: x and dy (n, c, h, w) bfloat16 in, (c, c, k, k) float32 out, one
    multiply-add per output per pixel."""
    return bound_ms(2 * k * k * c * c * n * h * w,
                    2 * n * c * h * w * 2 + k * k * c * c * 4)


def ccl_label_raw(n, h, w):
    """K1: a (n, h, w) uint8 mask in, int32 labels out."""
    return bound_ms(0, n * h * w * (1 + 4))


def ccl_renumber(n, h, w):
    """K2: (n, h, w) int32 labels in, int32 labels out."""
    return bound_ms(0, n * h * w * (4 + 4))


def ccl_label(n, h, w):
    """K1 with K2 fused (`kernels.ccl.label`): a (n, h, w) uint8 mask in,
    consecutive int32 labels out."""
    return bound_ms(0, n * h * w * (1 + 4))


INT8_OPS = 1979e12  # dense tensor-core rate


def int8_conv(rows, k, n, in_bytes):
    """The int8 conv of models/quantize.py (not a kernel of this repo:
    `torch._int_mm` over an im2col): `in_bytes` of int8 input and a
    (k, n) int8 kernel read, a (rows, n) int32 accumulator written, and
    one int8 multiply-add per output per contraction element."""
    ops = 2 * rows * k * n
    n_bytes = in_bytes + k * n + rows * n * 4
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, ops / INT8_OPS
    if by_ops > by_bytes:
        return 1e3 * by_ops, "operations"
    return 1e3 * by_bytes, "bytes"


def jpeg_pixels(n, blocks, comps, h, w):
    """The pixel stage (`jpeg_pixels`, the component planes kept on chip):
    coefficients and quant tables in, RGB out. At the serving batch
    (20 tiles of 300^2 at 4:2:0, 2,166 blocks a tile) 5.56 MB in and 5.40
    MB out: 0.0033 ms."""
    return bound_ms(0, n * (blocks * 128 + comps * 256 + 3 * h * w))
