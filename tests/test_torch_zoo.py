"""The port's model zoo against the JAX package's, on the same weights.

Each family is initialised in Flax at a small size (narrow widths, two or
three levels, 32^2-36^2 inputs, float32), its biases, BatchNorm affine
parameters and running statistics randomised with numpy, and the tree
carried into the port with `models/convert.py`. Tolerances:
- eval-mode logits: 1e-4 of the largest |logit|;
- one train step (dropout 0, Adam + L2, the weighted loss): loss 1e-4
  relative, every gradient 1e-3 of its tensor's largest magnitude,
  BatchNorm running statistics 1e-4 of theirs;
- Flax -> torch -> Flax: exact;
- served probabilities (the port's BN-folded copy against the JAX
  package's unfolded predict step): 1e-4;
- transposed-conv padding: 1e-5 of the largest output.
"""

import re

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from mapping_tpu.models.registry import build_network as jax_build_network
from mapping_tpu.models.scratch import UNet as FlaxUNet
from mapping_tpu.models.scratch import UNetMultitask as FlaxUNetMultitask
from mapping_tpu.models.torch_convert import convert_unet11, convert_unet_vgg16
from mapping_tpu.models.unetpp import UNetPlusPlus as FlaxUNetPlusPlus
from mapping_tpu.models.vgg import UNet11 as FlaxUNet11
from mapping_tpu.models.vgg import UNetVGG16 as FlaxUNetVGG16
from mapping_tpu.train import losses as jax_losses
from mapping_tpu.train.state import create_train_state
from mapping_tpu.train.state import make_optimizer as jax_make_optimizer
from mapping_tpu.train.step import make_train_step as jax_make_train_step
from mapping_tpu_torch.config import build_config
from mapping_tpu_torch.models import convert
from mapping_tpu_torch.models.fold_bn import fold_batch_stats
from mapping_tpu_torch.models.registry import build_network
from mapping_tpu_torch.models.scratch import UNet, UNetMultitask
from mapping_tpu_torch.models.unet_resnet import AlbuNet, UNetResNet
from mapping_tpu_torch.models.unetpp import UNetPlusPlus
from mapping_tpu_torch.models.vgg import UNet11, UNetVGG16
from mapping_tpu_torch.train import losses
from mapping_tpu_torch.train.state import make_optimizer
from mapping_tpu_torch.train.step import make_train_step
from mapping_tpu_torch.train.trainer import UNetTrainer
from tests.test_torch_models import _randomize
from tests.test_torch_train import _capture

torch.set_num_threads(2)


def _scratch(**kw):
    cfg = dict(conv_kernel=3, pool_kernel=3, pool_stride=2, repeat_blocks=2,
               n_filters=4, batch_norm=True, dropout=0.0, in_channels=3,
               out_channels=2)
    cfg.update(kw)
    return cfg


#: id -> (Flax module, port module, kind of converter, input side)
def _case(name):
    f32 = jnp.float32
    if name == "unet11":
        return FlaxUNet11(num_filters=4, dtype=f32), UNet11(num_filters=4), \
            "vgg11", 32
    if name.startswith("vgg16"):
        deconv = name.endswith("deconv")
        return (FlaxUNetVGG16(num_filters=4, is_deconv=deconv, dtype=f32),
                UNetVGG16(num_filters=4, is_deconv=deconv),
                "vgg16" if deconv else "vgg16_bilinear", 32)
    if name.startswith("scratch"):
        _, bn, pk, ps = name.split("_")
        cfg = _scratch(batch_norm=bn == "bn", pool_kernel=int(pk),
                       pool_stride=int(ps))
        return FlaxUNet(dtype=f32, **cfg), UNet(**cfg), "named", 36
    if name == "multitask":
        cfg = _scratch(nr_outputs=2)
        return (FlaxUNetMultitask(dtype=f32, **cfg), UNetMultitask(**cfg),
                "named", 32)
    if name.startswith("unetpp"):
        deep = name.endswith("deep")
        return (FlaxUNetPlusPlus(n_filters=4, depth=3, deep_supervision=deep,
                                 dtype=f32),
                UNetPlusPlus(n_filters=4, depth=3, deep_supervision=deep),
                "named", 32)
    raise KeyError(name)


FORWARD = (["unet11", "vgg16_deconv", "vgg16_bilinear"]
           + [f"scratch_{bn}_{pk}_{ps}" for bn in ("bn", "nobn")
              for pk, ps in ((3, 2), (2, 2), (3, 3))]
           + ["multitask", "unetpp", "unetpp_deep"])


def _to_torch(kind, params, stats):
    if kind == "vgg11":
        return convert.unet11_state_dict_from_flax(params)
    if kind.startswith("vgg16"):
        return convert.unet_vgg16_state_dict_from_flax(
            params, is_deconv=kind == "vgg16")
    return convert.named_state_dict_from_flax(params, stats)


def _variables(flax_model, hw, seed):
    x = jnp.zeros((1, hw, hw, 3), jnp.float32)
    variables = flax_model.init(jax.random.PRNGKey(seed), x, train=False)
    rng = np.random.RandomState(seed)
    return (_randomize(variables["params"], rng),
            _randomize(variables.get("batch_stats", {}), rng))


def _load(port_model, state):
    port_model.load_state_dict({k: torch.as_tensor(np.array(v))
                                for k, v in state.items()})
    return port_model


def _images(seed, hw, n=2):
    return np.random.RandomState(seed).randn(n, hw, hw, 3).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _maps(out):
    return out if isinstance(out, (list, tuple)) else [out]


@pytest.mark.parametrize("name", FORWARD)
def test_eval_forward_matches_flax(name):
    """Eval-mode float32 logits of every family, within 1e-4 of the
    largest |logit| (each head of UNetMultitask)."""
    flax_model, port_model, kind, hw = _case(name)
    params, stats = _variables(flax_model, hw, seed=len(name))
    x = _images(len(name), hw)
    variables = {"params": params, **({"batch_stats": stats} if stats
                                      else {})}
    want = _maps(flax_model.apply(variables, jnp.asarray(x), train=False))
    model = _load(port_model, _to_torch(kind, params, stats)).eval()
    with torch.no_grad():
        got = _maps(model(_nchw(x)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape[1] == 2
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize("stride", [2, 3])
def test_scratch_upsampling_is_flax_same_transpose(stride):
    """Flax ConvTranspose(3s, stride s, "SAME", no bias) = torch
    ConvTranspose2d(3s, stride s, padding s, bias=False) with the kernel
    flipped (models/convert._deconv): output side s * input side."""
    k = 3 * stride
    rng = np.random.RandomState(stride)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    layer = nn.ConvTranspose(4, (k, k), strides=(stride, stride),
                             padding="SAME", use_bias=False)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    deconv = torch.nn.ConvTranspose2d(3, 4, k, stride=stride, padding=stride,
                                      bias=False)
    deconv.weight.data = torch.from_numpy(convert._deconv(params["kernel"]))
    with torch.no_grad():
        got = deconv(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 5 * stride, 7 * stride, 4)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("pk,ps,hw", [(3, 2, 30), (2, 2, 34), (3, 3, 30)])
def test_scratch_sides_that_do_not_divide_raise_in_both(pk, ps, hw):
    """pool_stride ** repeat_blocks not dividing the side: an upsampled
    map and its skip differ in size, and the concat raises in both
    packages (the JAX module asserts nothing up front)."""
    cfg = _scratch(pool_kernel=pk, pool_stride=ps)
    x = jnp.zeros((1, hw, hw, 3), jnp.float32)
    with pytest.raises(Exception):
        FlaxUNet(dtype=jnp.float32, **cfg).init(jax.random.PRNGKey(0), x)
    with pytest.raises(RuntimeError, match="Sizes of tensors must match"):
        UNet(**cfg).eval()(torch.zeros(1, 3, hw, hw))


# ------------------------------------------------------------ train step

LOSS_PARAMS = {"w0": 50, "sigma": 10, "imsize": (32, 32), "dice_weight": 0.2,
               "bce_weight": 1.0, "smooth": 1, "dice_activation": "softmax"}


def _target(image, seed):
    rng = np.random.RandomState(seed)
    n, hw = image.shape[:2]
    mask = (image.mean(-1) > 0).astype(np.float32)
    dist = rng.randint(0, 12, (n, hw, hw)).astype(np.float32) * (1 - mask)
    size = np.where(mask > 0, rng.randint(2, 30, (n, hw, hw)), 0)
    return np.stack([mask, dist, size.astype(np.float32)], -1)


def _jax_step(flax_model, params, stats, image, target):
    tx = optax.chain(_capture(), jax_make_optimizer(lr=5e-4,
                                                    weight_decay=1e-4))
    state = create_train_state(flax_model, jax.random.PRNGKey(0),
                               (1,) + image.shape[1:], tx)
    state = state.replace(params=params, batch_stats=stats,
                          opt_state=tx.init(params))
    loss_fn = jax_losses.make_loss_fn("weighted", {
        **LOSS_PARAMS, "imsize": image.shape[1:3]})
    step = jax_make_train_step(loss_fn, has_batch_stats=bool(stats))
    state, metrics = step(state, {"image": jnp.asarray(image),
                                  "target": jax.tree_util.tree_map(
                                      jnp.asarray, target)})
    return (float(metrics["loss"]), jax.device_get(state.opt_state[0]),
            jax.device_get(state.batch_stats))


def _close_per_tensor(got, want, tol, what, zero=()):
    """Each tensor within tol of its largest magnitude; those named in
    `zero`, whose exact value is 0, within tol of the largest magnitude of
    all."""
    assert want, what
    top = max(float(np.abs(np.array(r)).max()) for r in want.values())
    for name, ref in want.items():
        if name in zero:
            for side in (got[name], torch.as_tensor(np.array(ref))):
                assert float(side.abs().max()) <= tol * top, name
            continue
        ref = torch.as_tensor(np.array(ref))
        scale = float(ref.abs().max()) or 1.0
        err = float((got[name].float() - ref.float()).abs().max()) / scale
        assert err <= tol, f"{what} {name}: {err:.2e} of its max"


@pytest.mark.parametrize("name,targets", [
    ("unet11", 1), ("vgg16_deconv", 1), ("scratch_bn_3_2", 1),
    ("multitask", 1), ("multitask", 2), ("unetpp", 1)])
def test_train_step_matches_jax(name, targets):
    """One float32 step at dropout 0: the loss (the mean over the heads of
    UNetMultitask, on one shared target or one target per head) 1e-4
    relative, gradients 1e-3 and BatchNorm running statistics 1e-4 of
    each tensor's largest magnitude."""
    flax_model, port_model, kind, hw = _case(name)
    params, stats = _variables(flax_model, hw, seed=7)
    image = _images(7, hw)
    target = [_target(image, s) for s in range(targets)]
    target = target[0] if targets == 1 else target
    want_loss, want_grads, want_stats = _jax_step(flax_model, params, stats,
                                                  image, target)
    model = _load(port_model, _to_torch(kind, params, stats))
    optimizer, scheduler = make_optimizer(model, lr=5e-4, weight_decay=1e-4)
    step = make_train_step(losses.make_loss_fn("weighted", {
        **LOSS_PARAMS, "imsize": (hw, hw)}), model, optimizer, scheduler,
        torch.float32)
    torch_target = (torch.from_numpy(target) if targets == 1
                    else [torch.from_numpy(t) for t in target])
    loss = float(step({"image": torch.from_numpy(image),
                       "target": torch_target})["loss"])
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    grads = {n: p.grad for n, p in model.named_parameters()}
    want = _to_torch(kind, want_grads, want_stats)
    # a conv bias before a train-mode BatchNorm has gradient 0 exactly:
    # both sides hold rounding noise there
    zero = {n for n in grads if re.search(r"conv\d\.bias$", n)
            and re.sub(r"conv(\d)\.bias$", r"bn\1.weight", n) in grads}
    _close_per_tensor(grads, {n: want[n] for n in grads}, 1e-3, "grad",
                      zero)
    running = {k: v for k, v in model.state_dict().items() if "running" in k}
    assert bool(running) == bool(stats)
    if running:
        _close_per_tensor(running, {k: want[k] for k in running}, 1e-4,
                          "stat")


# ------------------------------------------------------------ round trip

def _named_to_flax(state, params, stats):
    """The inverse of convert.named_state_dict_from_flax, on the Flax
    trees' structure."""
    def walk(p, s, prefix):
        out_p, out_s = {}, {}
        for name, leaf in p.items():
            key = prefix + name
            if "kernel" in leaf:
                w = state[key + ".weight"]
                kernel = (np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]
                          if name.startswith("up_sample")
                          else np.transpose(w, (2, 3, 1, 0)))
                out_p[name] = {"kernel": kernel}
                if "bias" in leaf:
                    out_p[name]["bias"] = state[key + ".bias"]
            elif "scale" in leaf:
                out_p[name] = {"scale": state[key + ".weight"],
                               "bias": state[key + ".bias"]}
                out_s[name] = {"mean": state[key + ".running_mean"],
                               "var": state[key + ".running_var"]}
            else:
                out_p[name], sub = walk(leaf, s.get(name, {}), key + ".")
                if sub:
                    out_s[name] = sub
        return out_p, out_s

    return walk(params, stats, "")


def _assert_trees_equal(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


@pytest.mark.parametrize("name", ["unet11", "vgg16_deconv", "vgg16_bilinear",
                                  "scratch_bn_3_2", "scratch_nobn_3_3",
                                  "multitask", "unetpp_deep"])
def test_flax_torch_flax_round_trip_is_exact(name):
    """Flax -> the port's state_dict (which loads strictly into the port's
    module) -> Flax gives back every leaf exactly: through the JAX
    package's own reference converters for the VGG U-Nets, by name for
    the others."""
    flax_model, port_model, kind, hw = _case(name)
    params, stats = _variables(flax_model, hw, seed=3)
    state = _to_torch(kind, params, stats)
    _load(port_model, state)  # strict: same keys and shapes
    if kind == "vgg11":
        back_p, back_s = convert_unet11(state), {}
    elif kind.startswith("vgg16"):
        back_p, back_s = convert_unet_vgg16(state, kind == "vgg16"), {}
    else:
        back_p, back_s = _named_to_flax(state, params, stats)
    _assert_trees_equal(back_p, params)
    _assert_trees_equal(back_s, stats)


# --------------------------------------------------------------- serving

def _trainers(encoder, extra, hw=32):
    from mapping_tpu.train.trainer import UNetTrainer as JaxTrainer

    model_params = {"encoder": encoder, "dtype": "float32", **extra}
    common = dict(model_params=model_params, optimizer_params={"lr": 5e-4},
                  loss_params=LOSS_PARAMS, training_config={"epochs": 1},
                  input_size=(hw, hw))
    return JaxTrainer(**common), UNetTrainer(device="cpu", **common)


@pytest.mark.parametrize("encoder,extra", [
    ("VGG11", {}),
    ("from_scratch", {"n_filters": 4, "repeat_blocks": 2, "dropout": 0.1}),
    ("UNetPlusPlus", {"n_filters": 4, "depth": 3})])
def test_served_probabilities_match_jax(encoder, extra):
    """The port serves a BN-folded copy (its fold pairs bnN with convN,
    bias-free or not), where the JAX package serves the scratch UNet and
    UNet++ unfolded (no `fold_bn` field): the same float32 probabilities
    within 1e-4 from the same weights (BatchNorm statistics randomised),
    with dropout off. The VGG family has no BatchNorm and folds to
    itself."""
    jax_trainer, trainer = _trainers(encoder, extra)
    jax_trainer._ensure_state()
    state = jax_trainer.state
    params = _randomize(jax.device_get(state.params), np.random.RandomState(1))
    stats = _randomize(jax.device_get(state.batch_stats),
                       np.random.RandomState(2))
    jax_trainer.state = state.replace(params=params, batch_stats=stats)
    trainer.load_state_dict(convert.state_dict_for_encoder(
        {"encoder": encoder}, params, stats))
    x = _images(5, 32)
    want = np.asarray(jax_trainer.predict_probs_fn()(jnp.asarray(x)))
    got = trainer.probs_apply_fn()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    folded = trainer.serving_model()
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in folded.modules())
    assert not folded.training
    if encoder == "VGG11":
        for k, v in trainer.state_dict().items():
            assert torch.equal(folded.state_dict()[k], v), k


def test_fold_pairs_bias_free_convs():
    """UNet++'s bias-free convs get the folded bias; the folded module
    equals the unfolded one in eval mode (1e-5 of the largest logit)."""
    torch.manual_seed(0)
    model = UNetPlusPlus(n_filters=4, depth=3).eval()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.2, 0.2)
            m.running_var.uniform_(0.5, 1.5)
    x = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        want = model(x)
        folded = fold_batch_stats(model)
        got = folded(x)
    assert folded.x0_0.conv0.bias is not None
    torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()),
                               rtol=0)


# -------------------------------------------------------------- registry

def _n_params(tree):
    return sum(int(np.prod(np.shape(v)))
               for v in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("encoder,extra,cls", [
    ("VGG11", {}, UNet11), ("VGG16", {}, UNetVGG16),
    ("from_scratch", {}, UNet), ("from_scratch", {"nr_unet_outputs": 2},
                                 UNetMultitask),
    ("UNetPlusPlus", {}, UNetPlusPlus)])
def test_registry_builds_each_family_as_jax_does(encoder, extra, cls):
    """From the config's defaults (the port's build_config and the JAX
    one agree on model_params), each family is the JAX registry's: the
    same class and the same parameter count as the Flax init (UNet++ at
    the CLI's n_filters 16, not the class default 32)."""
    from mapping_tpu.config import build_config as jax_build_config

    overrides = {"encoder": encoder, **extra}
    mp = build_config(None, overrides).unet["model_params"]
    jax_mp = jax_build_config(None, overrides).unet["model_params"]
    assert {k: v for k, v in mp.items()} == dict(jax_mp)
    net = build_network(mp)
    assert type(net) is cls
    flax_model = jax_build_network(dict(jax_mp), dtype=jnp.float32)
    shapes = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    assert sum(p.numel() for p in net.parameters()) == \
        _n_params(shapes["params"])
    assert sum(b.numel() for n, b in net.named_buffers()
               if "running" in n) == _n_params(shapes.get("batch_stats", {}))
    if encoder == "UNetPlusPlus":
        assert net.x0_0.conv0.out_channels == 16


def test_registry_names_every_jax_encoder():
    from mapping_tpu.models.registry import PRETRAINED_NETWORKS as JAX_NETS
    from mapping_tpu_torch.models.registry import PRETRAINED_NETWORKS

    assert sorted(PRETRAINED_NETWORKS) == sorted(JAX_NETS)
    assert isinstance(build_network({"encoder": "AlbuNet", "num_filters": 8}),
                      AlbuNet)
    assert isinstance(build_network({"encoder": "ResNet34"}), UNetResNet)
    with pytest.raises(KeyError, match="from_scratch"):
        build_network({"encoder": "VGG19"})


@pytest.mark.parametrize("is_deconv", [True, False])
def test_vgg_names_are_the_reference_modules(is_deconv):
    """Keys and shapes of the port's UNet11 / UNetVGG16 at the default 32
    filters are the reference torch modules' (tests/torch_ref_models.py),
    so a reference checkpoint loads unchanged."""
    from tests.torch_ref_models import TorchUNet11, TorchUNetVGG16

    pairs = [(TorchUNetVGG16(is_deconv=is_deconv),
              UNetVGG16(is_deconv=is_deconv))]
    if is_deconv:
        pairs.append((TorchUNet11(), UNet11()))
    for ref, port in pairs:
        assert {k: v.shape for k, v in ref.state_dict().items()} == \
            {k: v.shape for k, v in port.state_dict().items()}
