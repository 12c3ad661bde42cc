"""The dW kernel's plain version and wrapper against the JAX dW probe.

`conv_dw_plain` (mapping_tpu_torch/ops/conv_dw.py) is held on the same
bfloat16 inputs against the JAX package's read-once Pallas kernel
`tools.dw_probe.dw_pallas`, run in TPU interpret mode, against its XLA vjp
`dw_xla`, and against torch's conv weight gradient in float32.

Tolerances, each relative to the reference's largest magnitude:
- dw_pallas 1e-4: both sum bfloat16 products in float32, in other orders;
- dw_xla 5e-3: its output is rounded to bfloat16;
- torch's float32 conv2d_weight 1e-5: the same float32 sums.
The JAX kernel needs its row chunk to divide H and asserts k = 3 halos, so
the k = 5 case is held against dw_xla and torch only.

The CUDA wrapper itself runs only on a card (chip_smoke.py); here it must
refuse CPU tensors and shapes outside the kernel's contract.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mapping_tpu_torch.kernels import conv_dw as K
from mapping_tpu_torch.ops.conv_dw import conv_dw_plain
from mapping_tpu_torch.tools import dw_probe
from tools.dw_probe import dw_pallas, dw_xla

torch.set_num_threads(2)


def _inputs(shape, seed):
    """NCHW `shape` -> (x, dy) as bfloat16 NHWC jax arrays and the same
    values as bfloat16 NCHW torch tensors."""
    n, c, h, w = shape
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        j = jnp.asarray(rng.randn(n, h, w, c).astype(np.float32), jnp.bfloat16)
        t = torch.from_numpy(np.array(j.astype(jnp.float32))).permute(
            0, 3, 1, 2).to(torch.bfloat16)
        out.append((j, t))
    return out


def _torch_layout(hwio):
    return torch.from_numpy(np.array(hwio, np.float32).transpose(3, 2, 0, 1))


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def test_plain_matches_pallas_in_interpret_mode():
    (xj, xt), (dyj, dyt) = _inputs((2, 32, 16, 8), seed=0)
    with pltpu.force_tpu_interpret_mode():
        ref = _torch_layout(dw_pallas(xj, dyj, 3, 3))
    assert _rel(conv_dw_plain(xt, dyt, 3), ref) <= 1e-4


@pytest.mark.parametrize("k,shape", [(3, (2, 32, 16, 8)), (5, (2, 32, 16, 8)),
                                     (3, (1, 64, 7, 11)), (5, (3, 16, 9, 5))])
def test_plain_matches_xla_vjp(k, shape):
    (xj, xt), (dyj, dyt) = _inputs(shape, seed=k)
    ref = _torch_layout(dw_xla(xj, dyj, k, k).astype(jnp.float32))
    assert _rel(conv_dw_plain(xt, dyt, k), ref) <= 5e-3


@pytest.mark.parametrize("k,shape", [(3, (2, 32, 16, 8)), (5, (2, 32, 16, 8)),
                                     (1, (2, 16, 5, 6)), (3, (1, 48, 13, 3))])
def test_plain_matches_torch_weight_gradient(k, shape):
    (_, xt), (_, dyt) = _inputs(shape, seed=10 + k)
    ref = torch.nn.grad.conv2d_weight(xt.float(), (shape[1], shape[1], k, k),
                                      dyt.float(), padding=k // 2)
    assert _rel(conv_dw_plain(xt, dyt, k), ref) <= 1e-5


def test_plain_of_zero_gradient_is_zero():
    (_, xt), _ = _inputs((2, 32, 8, 8), seed=3)
    out = conv_dw_plain(xt, torch.zeros_like(xt), 3)
    assert out.shape == (32, 32, 3, 3) and not out.any()


def test_wrapper_refuses_cpu_tensors():
    (_, xt), (_, dyt) = _inputs((2, 32, 16, 8), seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        K.conv_dw(xt, dyt, 3)


@pytest.mark.parametrize("x_shape,dy_shape,k,dtype,match", [
    ((2, 32, 8, 8), (2, 32, 8, 8), 2, torch.bfloat16, "odd"),
    ((2, 24, 8, 8), (2, 24, 8, 8), 3, torch.bfloat16, "multiple of 16"),
    ((2, 32, 8, 8), (2, 64, 8, 8), 3, torch.bfloat16, "one shape"),
    ((32, 8, 8), (32, 8, 8), 3, torch.bfloat16, "one shape"),
    ((2, 32, 8, 8), (2, 32, 8, 8), 3, torch.float32, "bfloat16"),
    ((1, 512, 8, 8), (1, 512, 8, 8), 7, torch.bfloat16, "shared memory"),
])
def test_wrapper_refuses_shapes_outside_the_contract(x_shape, dy_shape, k,
                                                     dtype, match):
    x = torch.zeros(x_shape, dtype=dtype)
    dy = torch.zeros(dy_shape, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        K.conv_dw(x, dy, k)


#: accumulator registers a consumer thread may hold (csrc/conv_dw.cu's note:
#: 96 at N = 64, beside one A fragment, in a thread's 128 registers)
ACC_BUDGET = 96


@pytest.mark.parametrize("shape,k", [((64, 32, 256, 256), 3),
                                     ((64, 64, 128, 128), 3),
                                     ((20, 128, 128, 128), 3),
                                     ((1, 32, 5, 300), 5),
                                     ((2, 512, 4, 4), 5),
                                     ((8, 16, 64, 64), 3),
                                     ((2, 128, 128, 128), 3),
                                     ((8, 64, 64, 64), 5)])
def test_plan_covers_every_output_tile(shape, k):
    """The launch plan, read the way csrc/conv_dw.cu reads it: every
    (tap, c_in, c_out) output belongs to exactly one (output group,
    warpgroup, row tap of its unit); a warpgroup's accumulators stay in the
    budget; the ring of stages fits in shared memory; TMA boxes are at most
    256 wide and their inner bytes are the swizzle width (at most 128); the
    blocks' pixel-tile runs cover every tile exactly once."""
    n, c, h, w = shape
    pl = K.plan(n, h, w, c, k, sms=132)
    cb, n_boxes = pl.cb, c // pl.cb
    assert cb in (16, 32, 64) and c % cb == 0
    rows = k * c  # rows (box, dw, c_in in box) of one dh
    dh_chunks = -(-k // pl.dh_chunk)
    owned = np.zeros((c, c, k * k), np.int64)  # (c_out, c_in, tap)
    for group in range(pl.groups):
        n_block, run = group % n_boxes, group // n_boxes
        for wg in range(K._CONSUMERS):
            unit = run * K._CONSUMERS + wg
            if unit >= pl.units:
                continue
            piece = unit // dh_chunks
            dh0 = (unit % dh_chunks) * pl.dh_chunk
            for d in range(K._DH):
                dh = dh0 + d
                if d >= pl.dh_chunk or dh >= k:
                    continue
                for r in range(piece * 64, min(piece * 64 + 64, rows)):
                    box, dw = r // (k * cb), r % (k * cb) // cb
                    c_in = box * cb + r % cb
                    owned[n_block * cb:(n_block + 1) * cb, c_in,
                          dh * k + dw] += 1
    assert (owned == 1).all()
    assert pl.units == -(-rows // 64) * dh_chunks
    assert K._DH * cb // 2 <= ACC_BUDGET
    assert 2 <= pl.stages <= 4
    assert pl.shared == pl.stages * (K.stage_bytes(c, k, pl.bh, pl.bw) + 16) \
        + 1024 <= K._MAX_SHARED
    for box in [(cb, pl.bw + k - 1, pl.bh + k - 1, 1), (cb, pl.bw, pl.bh, 1)]:
        assert max(box) <= 256 and box[0] * 2 <= 128
    tiles = n * pl.tiles_x * pl.tiles_y
    assert pl.tiles_x * pl.bw >= w > (pl.tiles_x - 1) * pl.bw
    assert pl.tiles_y * pl.bh >= h > (pl.tiles_y - 1) * pl.bh
    assert pl.bh * pl.bw % 16 == 0 and pl.bw in (8, 16, 32)
    assert pl.groups * pl.slices <= 132 or pl.slices == 1
    runs = [range(tiles * s // pl.slices, tiles * (s + 1) // pl.slices)
            for s in range(pl.slices)]
    assert all(len(r) for r in runs)
    assert sorted(t for r in runs for t in r) == list(range(tiles))


@pytest.mark.parametrize("args,ms,by", [
    ((64, 32, 256, 256, 3), 0.16027, "bytes"),
    ((64, 64, 128, 128, 3), 0.080174, "bytes"),
    ((20, 32, 256, 256, 3), 0.050092, "bytes"),
    ((20, 128, 128, 128, 3), 0.097712, "operations"),
])
def test_conv_dw_bound(args, ms, by):
    """K3's bound: 2 n h w k^2 c^2 operations at 989 TFLOP/s against x and
    dy (bf16) read and dW (float32) written at 3.35 TB/s, e.g. (64, 32, 256,
    256): 0.5369 GB / 3.35 TB/s = 0.160 ms > 77.3 GFLOP / 989 TFLOP/s."""
    from mapping_tpu_torch.kernels import bounds

    got, what = bounds.conv_dw(*args)
    assert what == by and abs(got - ms) <= 1e-4 * ms


@pytest.mark.parametrize("variant", ["pad_co", "pad_cico"])
def test_probe_padding_variants_equal_the_unpadded_gradient(variant):
    (_, xt), (_, dyt) = _inputs((2, 32, 8, 8), seed=5)
    x, dy = xt.float(), dyt.float()
    ref = dw_probe.dw_cudnn(x, dy, 3)
    got = dw_probe.VARIANTS[variant](x, dy, 3)
    assert got.shape == ref.shape and _rel(got, ref) <= 1e-6
