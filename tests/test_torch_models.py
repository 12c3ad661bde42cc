"""The port's UNetResNet against the JAX package's, on the same weights.

A Flax UNetResNet is initialised, its biases, BatchNorm affine parameters
and running statistics are randomised with numpy, and the tree is carried
into the port with `state_dict_from_flax`. Logits must agree in float32:
1e-4 at ResNet34 and 1e-3 at ResNet101 (deeper stacks accumulate more
rounding, as in tests/test_torch_parity.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapping_tpu.models.torch_convert import convert_unet_resnet
from mapping_tpu.models.unet_resnet import UNetResNet as FlaxUNetResNet
from mapping_tpu_torch.models.convert import state_dict_from_flax
from mapping_tpu_torch.models.fold_bn import fold_batch_stats
from mapping_tpu_torch.models.registry import build_network
from mapping_tpu_torch.models.unet_resnet import AlbuNet, UNetResNet

torch.set_num_threads(2)


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
            continue
        v = np.asarray(v)
        if k == "bias" or k == "mean":
            v = 0.1 * rng.randn(*v.shape)
        elif k == "scale":
            v = 1.0 + 0.1 * rng.randn(*v.shape)
        elif k == "var":
            v = 0.75 + 0.5 * rng.rand(*v.shape)
        out[k] = v.astype(np.float32)
    return out


def _flax_variables(depth, nf, is_deconv, seed, hw=64):
    model = FlaxUNetResNet(encoder_depth=depth, num_classes=2, num_filters=nf,
                           is_deconv=is_deconv, dtype=jnp.float32)
    x = jnp.zeros((1, hw, hw, 3), jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), x, train=False)
    rng = np.random.RandomState(seed)
    return (model, _randomize(variables["params"], rng),
            _randomize(variables["batch_stats"], rng))


def _port(state, depth, nf, is_deconv):
    model = UNetResNet(depth, num_classes=2, num_filters=nf,
                       is_deconv=is_deconv)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model.eval()


def _images(seed, hw=64):
    return np.random.RandomState(seed).randn(2, hw, hw, 3).astype(np.float32)


@pytest.mark.parametrize("depth,nf,is_deconv,tol", [
    (34, 8, True, 1e-4), (34, 8, False, 1e-4), (101, 8, True, 1e-3)])
def test_logits_match_flax(depth, nf, is_deconv, tol):
    flax_model, params, stats = _flax_variables(depth, nf, is_deconv, depth)
    x = _images(depth)
    want = np.asarray(flax_model.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False))
    model = _port(state_dict_from_flax(params, stats, depth, is_deconv),
                  depth, nf, is_deconv)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=tol, rtol=tol)


def test_folded_matches_unfolded():
    _, params, stats = _flax_variables(34, 8, True, 3)
    state = state_dict_from_flax(params, stats, 34, True)
    x = torch.from_numpy(_images(3)).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = _port(state, 34, 8, True)(x)
        folded = fold_batch_stats(_port(state, 34, 8, True))
        got = folded(x)
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in folded.modules())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("depth,is_deconv", [(34, True), (34, False),
                                             (101, True)])
def test_state_dict_round_trip(depth, is_deconv):
    """torch state_dict -> convert_unet_resnet -> state_dict_from_flax
    gives back identical arrays under the same keys."""
    torch.manual_seed(depth)
    model = UNetResNet(depth, num_filters=8, is_deconv=is_deconv)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_unet_resnet(state, depth, is_deconv)
    back = state_dict_from_flax(params, stats, depth, is_deconv)
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k], err_msg=k)


def test_registry():
    net = build_network({"encoder": "ResNet101", "n_filters": 16})
    assert isinstance(net, UNetResNet)
    assert net.final.in_channels == 32  # registry default num_filters
    albu = build_network({"encoder": "AlbuNet", "num_filters": 8})
    assert isinstance(albu, AlbuNet)
    assert sorted(albu.state_dict()) == sorted(
        UNetResNet(34, num_filters=8).state_dict())
    from mapping_tpu_torch.models.vgg import UNet11

    assert isinstance(build_network({"encoder": "VGG11"}), UNet11)
    with pytest.raises(KeyError):
        build_network({"encoder": "ResNet18"})
