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
