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


@pytest.mark.parametrize("shape,k", [((64, 32, 256, 256), 3),
                                     ((64, 64, 128, 128), 3),
                                     ((20, 128, 128, 128), 3),
                                     ((1, 32, 5, 300), 5),
                                     ((2, 512, 4, 4), 5)])
def test_plan_covers_every_output_tile(shape, k):
    """Every 16 x 16 output tile belongs to one warp, no warp holds more
    than the kernel's 8 accumulators, and a block fits in shared memory."""
    n, c, h, w = shape
    rows, fpw, groups, slices, shared = K.plan(n, h, w, c, k, sms=132)
    n_frags = k * k * (c // 16) ** 2
    assert 1 <= fpw <= K._MAX_FRAGS
    assert (groups - 1) * K._WARPS * fpw < n_frags <= groups * K._WARPS * fpw
    assert 1 <= slices <= n * -(-h // rows) * -(-w // K._TILE_W)
    assert shared <= K._MAX_SHARED


@pytest.mark.parametrize("variant", ["pad_co", "pad_cico"])
def test_probe_padding_variants_equal_the_unpadded_gradient(variant):
    (_, xt), (_, dyt) = _inputs((2, 32, 8, 8), seed=5)
    x, dy = xt.float(), dyt.float()
    ref = dw_probe.dw_cudnn(x, dy, 3)
    got = dw_probe.VARIANTS[variant](x, dy, 3)
    assert got.shape == ref.shape and _rel(got, ref) <= 1e-6
