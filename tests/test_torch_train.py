"""The training slice of the port against the JAX package, on the CPU.

Every comparison feeds the same numpy inputs, made from a seed, to the JAX
function and to its port; the JAX side runs as its own tests run it.
Tolerances (stated per test as well):
- losses 1e-5 relative (both float32, sums in other orders);
- BatchNorm running mean and variance after a train-mode forward 1e-5;
- optimizer: parameters after 3 steps fed the same gradients 1e-6;
- one float32 train step of UNetResNet34: loss 1e-4 relative, every
  gradient 1e-3 of its tensor's largest magnitude, BatchNorm running
  statistics 1e-4 of their largest magnitude; the second step's loss 1e-4
  relative. Post-Adam parameters are not compared: Adam's first update is
  lr * sign(g), and near-zero gradients flip sign on rounding noise;
- preprocessing and the augmentation applier: images 1e-5, distances
  1e-4 (resize) and 1e-3 (warp, values up to 300), nearest-neighbour
  channels (mask, size) exactly.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from mapping_tpu.data import augment as jax_augment
from mapping_tpu.data import loader as jax_loader
from mapping_tpu.models.torch_convert import convert_unet_resnet
from mapping_tpu.models.unet_resnet import UNetResNet as FlaxUNetResNet
from mapping_tpu.prep.targets import prepare_image_targets
from mapping_tpu.train import losses as jax_losses
from mapping_tpu.train.state import create_train_state
from mapping_tpu.train.state import make_optimizer as jax_make_optimizer
from mapping_tpu.train.step import (make_eval_step as jax_make_eval_step,
                                    make_predict_step as jax_make_predict_step,
                                    make_train_step as jax_make_train_step)
from mapping_tpu_torch.data import augment
from mapping_tpu_torch.data.loader import (_resize_target, eval_batch_resize,
                                           in_memory_train_flow,
                                           train_batch_resize)
from mapping_tpu_torch.models.convert import state_dict_from_flax
from mapping_tpu_torch.models.resnet import BatchNorm2d
from mapping_tpu_torch.models.unet_resnet import UNetResNet
from mapping_tpu_torch.train import losses
from mapping_tpu_torch.train.state import make_optimizer
from mapping_tpu_torch.train.step import (make_eval_step, make_predict_step,
                                          make_train_step)
from mapping_tpu_torch.train.trainer import UNetTrainer
from tests.fixtures.synthetic import _make_image

torch.set_num_threads(2)

LOSS_PARAMS = {"w0": 50, "sigma": 10, "imsize": (64, 64), "dice_weight": 0.2,
               "bce_weight": 1.0, "smooth": 1, "dice_activation": "softmax"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


# ----------------------------------------------------------------- losses

def _fixture_targets(n=2, hw=128, seed=0):
    """[mask, distance, size] targets of the synthetic fixture's buildings,
    as the JAX package prepares them (prepare_image_targets) and its loader
    reads them (distance truncated, size square-rooted)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        _, anns = _make_image(rng, h=hw, w=hw)
        masks = []
        for ann in anns:
            x0, y0, bw, bh = map(int, ann["bbox"])
            m = np.zeros((hw, hw), np.uint8)
            m[y0:y0 + bh, x0:x0 + bw] = 1
            masks.append(m)
        t = prepare_image_targets(masks, (hw, hw))
        out.append(np.stack([t["mask"].astype(np.float32),
                             t["distances"].astype(np.float32).astype(
                                 np.uint16).astype(np.float32),
                             np.sqrt(t["sizes"]).astype(np.uint16).astype(
                                 np.float32)], -1))
    return np.stack(out)


@pytest.fixture(scope="module")
def loss_inputs():
    target = _fixture_targets()
    logits = np.random.RandomState(1).randn(
        *target.shape[:3], 2).astype(np.float32) * 3
    assert target[..., 0].any() and target[..., 1].max() > 0
    return logits, target


@pytest.mark.parametrize("name", ["ce", "weighted"])
def test_loss_matches_jax(loss_inputs, name):
    """make_loss_fn, both names: 1e-5 relative."""
    logits, target = loss_inputs
    params = {**LOSS_PARAMS, "imsize": target.shape[1:3]}
    want = jax_losses.make_loss_fn(name, params)(jnp.asarray(logits),
                                                 jnp.asarray(target))
    got = losses.make_loss_fn(name, params)(_t(logits), _t(target))
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("part", ["get_weights", "weighted_ce_direct",
                                  "dice", "dice_softmax", "dice_sigmoid",
                                  "mixed_plain_ce"])
def test_loss_parts_match_jax(loss_inputs, part):
    """Each function of train/losses.py: 1e-5 relative (weights
    elementwise)."""
    logits, target = loss_inputs
    lj, tj, lt, tt = (jnp.asarray(logits), jnp.asarray(target), _t(logits),
                      _t(target))
    if part == "get_weights":
        want = np.asarray(jax_losses.get_weights(tj[..., 1:], 50, 10,
                                                 (128, 128)))
        got = losses.get_weights(tt[..., 1:], 50, 10, (128, 128)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert want.max() > 10  # the distance term reaches near objects
        return
    calls = {
        "weighted_ce_direct": (
            lambda m, lg, tg: m.multiclass_weighted_cross_entropy(lg, tg)),
        "dice": lambda m, lg, tg: m.dice_loss(
            (lg[..., 1] > 0) * 0.7, tg[..., 0], smooth=1.0),
        "dice_softmax": lambda m, lg, tg: m.multiclass_dice_loss(
            lg, tg[..., 0], smooth=1.0),
        "dice_sigmoid": lambda m, lg, tg: m.multiclass_dice_loss(
            lg, tg[..., 0], activation="sigmoid", excluded_classes=(0,)),
        "mixed_plain_ce": lambda m, lg, tg: m.mixed_dice_cross_entropy_loss(
            lg, tg, dice_weight=0.3, cross_entropy_weight=0.7),
    }
    want = calls[part](jax_losses, lj, tj)
    got = calls[part](losses, lt, tt)
    assert _rel(got, want) <= 1e-5


# ---------------------------------------------------------------- BatchNorm

def test_batchnorm_running_stats_match_flax():
    """Train-mode BatchNorm on 8 values per channel: outputs and running
    mean and variance 1e-5 from Flax's; torch's own BatchNorm2d keeps the
    unbiased variance and misses by 8/7."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 2, 2, 5).astype(np.float32) * 2 + 1
    mean0 = rng.randn(5).astype(np.float32) * 0.1
    var0 = (0.75 + 0.5 * rng.rand(5)).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(5)).astype(np.float32)
    bias = (0.1 * rng.randn(5)).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    want, updates = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), mutable=["batch_stats"])
    stats = updates["batch_stats"]

    def port(cls):
        m = cls(5, eps=1e-5)
        m.load_state_dict({"weight": _t(scale), "bias": _t(bias),
                           "running_mean": _t(mean0), "running_var": _t(var0),
                           "num_batches_tracked": torch.tensor(0)})
        out = m.train()(_t(x).permute(0, 3, 1, 2))
        return out.detach().permute(0, 2, 3, 1).numpy(), m

    got, m = port(BatchNorm2d)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-5)
    np.testing.assert_allclose(m.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-5)
    _, plain = port(torch.nn.BatchNorm2d)
    assert np.abs(plain.running_var.numpy()
                  - np.asarray(stats["var"])).max() > 1e-3


# ---------------------------------------------------------------- optimizer

class _Small(torch.nn.Module):
    """One of each parameter kind: conv kernel and bias, BatchNorm scale
    and bias, transposed-conv kernel and bias, final conv."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3)
        self.bn = BatchNorm2d(4)
        self.deconv = torch.nn.ConvTranspose2d(4, 4, 4)
        self.final = torch.nn.Conv2d(4, 2, 1)


# flax-style leaf path -> (torch parameter name, layout map)
_SMALL = {("conv", "kernel"): ("conv.weight", (3, 2, 0, 1)),
          ("conv", "bias"): ("conv.bias", None),
          ("bn", "scale"): ("bn.weight", None),
          ("bn", "bias"): ("bn.bias", None),
          ("deconv", "kernel"): ("deconv.weight", (2, 3, 0, 1)),
          ("deconv", "bias"): ("deconv.bias", None),
          ("final", "kernel"): ("final.weight", (3, 2, 0, 1)),
          ("final", "bias"): ("final.bias", None)}


def test_optimizer_matches_optax():
    """Adam with L2 on the three kernels only and a staircase decay (gamma
    0.5 every 2 steps), 3 steps on the same gradients: parameters 1e-6."""
    model = _Small()
    rng = np.random.RandomState(0)
    inv = {}
    tree = {}
    for (mod, leaf), (name, perm) in _SMALL.items():
        p = model.get_parameter(name).detach().numpy()
        inv[(mod, leaf)] = perm and tuple(np.argsort(perm))
        tree.setdefault(mod, {})[leaf] = jnp.asarray(
            p.transpose(inv[(mod, leaf)]) if perm else p)
    tx = jax_make_optimizer(lr=1e-2, gamma=0.5, decay_every_steps=2,
                            weight_decay=0.1)
    opt_state = tx.init(tree)
    optimizer, scheduler = make_optimizer(model, lr=1e-2, gamma=0.5,
                                          decay_every_steps=2,
                                          weight_decay=0.1)
    decayed = {id(p) for p in optimizer.param_groups[0]["params"]}
    assert {n for n, p in model.named_parameters() if id(p) in decayed} == {
        "conv.weight", "deconv.weight", "final.weight"}
    for _ in range(3):
        grads = {}
        for (mod, leaf), (name, perm) in _SMALL.items():
            g = rng.randn(*tree[mod][leaf].shape).astype(np.float32)
            grads.setdefault(mod, {})[leaf] = jnp.asarray(g)
            model.get_parameter(name).grad = _t(
                g.transpose(perm) if perm else g)
        updates, opt_state = tx.update(grads, opt_state, tree)
        tree = optax.apply_updates(tree, updates)
        optimizer.step()
        scheduler.step()
    for (mod, leaf), (name, perm) in _SMALL.items():
        want = np.asarray(tree[mod][leaf])
        np.testing.assert_allclose(
            model.get_parameter(name).detach().numpy(),
            want.transpose(perm) if perm else want, atol=1e-6, err_msg=name)


# ------------------------------------------------------------- train step

def _capture():
    """An optax transformation that keeps the incoming gradients in its
    state and passes them on unchanged."""
    return optax.GradientTransformation(
        init=lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        update=lambda grads, state, params=None: (grads, grads))


def _step_batch(n=2, hw=64, seed=3):
    rng = np.random.RandomState(seed)
    image = rng.randn(n, hw, hw, 3).astype(np.float32)
    mask = (image.mean(-1) > 0).astype(np.float32)
    dist = rng.randint(0, 12, (n, hw, hw)).astype(np.float32) * (1 - mask)
    size = np.where(mask > 0, rng.randint(2, 30, (n, hw, hw)), 0)
    return image, np.stack([mask, dist, size.astype(np.float32)], -1)


@pytest.fixture(scope="module")
def jax_steps():
    """Two JAX train steps of a float32 UNetResNet34 (64^2, batch 2), Adam
    + L2 as configured, with the first step's gradients captured; plus the
    eval loss and probabilities of the initial weights. The weights are a
    seeded torch initialisation carried into Flax (convert_unet_resnet):
    with Flax's own initialisation the deepest encoder blocks, at 4 x 4
    pixels, are so ill-conditioned that float32 gradients of either
    framework differ from a float64 step by up to 3e-2 of their largest
    magnitude."""
    torch.manual_seed(0)
    init = {k: v.numpy() for k, v in UNetResNet(34).state_dict().items()}
    params, stats = convert_unet_resnet(init, 34, True)
    model = FlaxUNetResNet(encoder_depth=34, num_classes=2, num_filters=32,
                           dtype=jnp.float32)
    tx = optax.chain(_capture(), jax_make_optimizer(lr=5e-4,
                                                    weight_decay=1e-4))
    state = create_train_state(model, jax.random.PRNGKey(0), (1, 64, 64, 3),
                               tx)
    state = state.replace(params=params, batch_stats=stats,
                          opt_state=tx.init(params))
    image, target = _step_batch()
    batch = {"image": jnp.asarray(image), "target": jnp.asarray(target)}
    loss_fn = jax_losses.make_loss_fn("weighted", LOSS_PARAMS)
    eval_loss = float(jax_make_eval_step(loss_fn)(state, batch))
    probs = np.asarray(jax_make_predict_step()(state, batch["image"]))
    step = jax_make_train_step(loss_fn)
    state, m1 = step(state, batch)
    grads = jax.device_get(state.opt_state[0])
    stats1 = jax.device_get(state.batch_stats)
    state, m2 = step(state, batch)
    return {"init": init, "image": image, "target": target,
            "losses": [float(m1["loss"]), float(m2["loss"])],
            "grads": grads, "stats1": stats1, "eval_loss": eval_loss,
            "probs": probs}


def _port_model(init):
    model = UNetResNet(34)
    model.load_state_dict({k: _t(v) for k, v in init.items()})
    return model.to(memory_format=torch.channels_last)


def _port_step(jax_steps, remat=False, steps=1):
    model = _port_model(jax_steps["init"])
    optimizer, scheduler = make_optimizer(model, lr=5e-4, weight_decay=1e-4)
    step = make_train_step(losses.make_loss_fn("weighted", LOSS_PARAMS), model,
                           optimizer, scheduler, torch.float32, remat)
    batch = {"image": _t(jax_steps["image"]),
             "target": _t(jax_steps["target"])}
    out = [float(step(batch)["loss"])]
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    for _ in range(steps - 1):
        out.append(float(step(batch)["loss"]))
    return out, grads, stats


def _assert_close_per_tensor(got, want, tol, what):
    worst = 0.0
    for name, ref in want.items():
        ref = torch.as_tensor(np.array(ref))
        scale = float(ref.abs().max()) or 1.0
        err = float((got[name] - ref).abs().max()) / scale
        worst = max(worst, err)
        assert err <= tol, f"{what} {name}: {err:.2e} of its max"
    return worst


def test_train_step_matches_jax(jax_steps):
    """Loss of two steps 1e-4 relative; the first step's gradients 1e-3 and
    running statistics 1e-4 of each tensor's largest magnitude."""
    got_losses, grads, stats = _port_step(jax_steps, steps=2)
    for got, want in zip(got_losses, jax_steps["losses"]):
        assert _rel(got, want) <= 1e-4
    want = state_dict_from_flax(jax_steps["grads"], jax_steps["stats1"], 34)
    _assert_close_per_tensor(grads, {n: want[n] for n in grads}, 1e-3, "grad")
    _assert_close_per_tensor(stats, {n: want[n] for n in stats}, 1e-4, "stat")


def test_remat_step_equals_plain_step(jax_steps):
    """remat re-runs the forward in the backward without touching the
    running statistics again: loss, gradients and statistics of one step
    as without remat (1e-6)."""
    plain = _port_step(jax_steps)
    remat = _port_step(jax_steps, remat=True)
    assert _rel(remat[0][0], plain[0][0]) <= 1e-6
    _assert_close_per_tensor(remat[1], plain[1], 1e-6, "grad")
    _assert_close_per_tensor(remat[2], plain[2], 1e-6, "stat")


def test_eval_and_predict_steps_match_jax(jax_steps):
    """Eval loss 1e-4 relative and probabilities 1e-4, running averages."""
    model = _port_model(jax_steps["init"])
    loss_fn = losses.make_loss_fn("weighted", LOSS_PARAMS)
    batch = {"image": _t(jax_steps["image"]),
             "target": _t(jax_steps["target"])}
    got = make_eval_step(loss_fn, model, torch.float32)(batch)
    assert _rel(got, jax_steps["eval_loss"]) <= 1e-4
    probs = make_predict_step(model, torch.float32)(batch["image"])
    np.testing.assert_allclose(probs.numpy(), jax_steps["probs"], atol=1e-4)


# ------------------------------------------------------------ data path

def _u8_batch(n=3, hw=96, seed=0):
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (n, hw, hw, 3)).astype(np.uint8)
    target = np.stack([rng.randint(0, 2, (n, hw, hw)),
                       rng.randint(0, 300, (n, hw, hw)),
                       rng.randint(0, 100, (n, hw, hw))], -1).astype(np.uint16)
    return image, target


@pytest.mark.parametrize("src,dst", [((96, 96), (64, 64)),
                                     ((300, 300), (256, 256)),
                                     ((37, 50), (64, 41))])
def test_resize_target_matches_jax(src, dst):
    """Nearest channels exactly, bilinear distance 1e-4."""
    rng = np.random.RandomState(sum(src))
    target = rng.randint(0, 300, (2, *src, 3)).astype(np.float32)
    want = np.asarray(jax_loader._resize_target(jnp.asarray(target), dst))
    got = _resize_target(_t(target), dst).numpy()
    np.testing.assert_array_equal(got[..., [0, 2]], want[..., [0, 2]])
    np.testing.assert_allclose(got[..., 1], want[..., 1], atol=1e-4)


def test_train_batch_resize_without_augment_matches_jax():
    """uint8 tiles and uint16 targets: image 1e-5, mask and size exactly,
    distance 1e-4."""
    image, target = _u8_batch()
    want = jax_loader._train_batch_resize(
        jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(target),
        (64, 64), augment=False)
    got = train_batch_resize(None, _t(image), _t(target), (64, 64),
                             augment=False)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]),
                               atol=1e-5)
    wt = np.asarray(want["target"])
    np.testing.assert_array_equal(got["target"].numpy()[..., [0, 2]],
                                  wt[..., [0, 2]])
    np.testing.assert_allclose(got["target"].numpy()[..., 1], wt[..., 1],
                               atol=1e-4)
    ev = eval_batch_resize(_t(image), _t(target), (64, 64))
    jev = jax_loader._eval_batch_resize(jnp.asarray(image),
                                        jnp.asarray(target), (64, 64))
    np.testing.assert_allclose(ev["image"].numpy(), np.asarray(jev["image"]),
                               atol=1e-5)
    np.testing.assert_array_equal(ev["target"].numpy()[..., 0],
                                  np.asarray(jev["target"])[..., 0])


def _jax_apply(image, target, lr, ud, angle, tx, ty):
    """The body of the JAX `_fast_augment_one` with fixed parameters."""
    if lr:
        image, target = image[:, ::-1], target[:, ::-1]
    if ud:
        image, target = image[::-1], target[::-1]
    h, w = image.shape[:2]
    src_y, src_x = jax_augment._affine_grid(
        h, w, jnp.float32(angle), jnp.float32(tx), jnp.float32(ty))
    image = jax_augment._sample(image, src_y, src_x, order=1)
    near = jax_augment._sample(target[..., (0, 2)], src_y, src_x, order=0)
    lin = jax_augment._sample(target[..., 1:2], src_y, src_x, order=1)
    return image, jnp.concatenate([near[..., :1], lin, near[..., 1:]], -1)


@pytest.mark.parametrize("lr,ud,angle,tx,ty", [
    (False, False, 0.0, 0.0, 0.0), (True, False, 0.0, 0.0, 0.0),
    (False, True, 7.3, -0.05, 0.08), (True, True, -9.1, 0.1, -0.1),
    (False, False, 3.7, 0.033, 0.0)])
def test_augment_applier_matches_jax(lr, ud, angle, tx, ty):
    """Fixed flips, angle and translation on 2 images of 48^2: images
    1e-5, distances (0..300) 1e-3, mask and size channels exactly."""
    image, target = _u8_batch(n=2, hw=48, seed=7)
    image = image.astype(np.float32) / 255
    target = target.astype(np.float32)
    want = [_jax_apply(jnp.asarray(image[i]), jnp.asarray(target[i]), lr, ud,
                       angle, tx, ty) for i in range(2)]
    params = {"fliplr": torch.tensor([lr, lr]), "flipud": torch.tensor([ud, ud]),
              "angle": torch.tensor([angle] * 2), "tx": torch.tensor([tx] * 2),
              "ty": torch.tensor([ty] * 2)}
    got_i, got_t = augment.apply_fast_augment(_t(image), _t(target), params)
    want_i = np.stack([np.asarray(w[0]) for w in want])
    want_t = np.stack([np.asarray(w[1]) for w in want])
    np.testing.assert_allclose(got_i.numpy(), want_i, atol=1e-5)
    np.testing.assert_allclose(got_t.numpy()[..., 1], want_t[..., 1],
                               atol=1e-3)
    np.testing.assert_array_equal(got_t.numpy()[..., [0, 2]],
                                  want_t[..., [0, 2]])


def test_augment_sampler_distribution():
    """SomeOf(1-2) of three ops, flips at 0.5: P(fliplr) = P(flipud) = 1/4,
    P(affine) = 1/2, angles within 10 degrees, shifts within 10 %."""
    p = augment.sample_fast_augment(8000, torch.Generator().manual_seed(0))
    affine = p["angle"] != 0
    assert abs(float(p["fliplr"].float().mean()) - 0.25) < 0.02
    assert abs(float(p["flipud"].float().mean()) - 0.25) < 0.02
    assert abs(float(affine.float().mean()) - 0.5) < 0.02
    assert float(p["angle"].abs().max()) <= 10.0
    assert float(p["tx"].abs().max()) <= 0.1
    assert float(p["ty"].abs().max()) <= 0.1
    assert not p["tx"][~affine].any() and not p["ty"][~affine].any()


@pytest.mark.parametrize("src,dst", [((300, 300), (256, 256)),
                                     ((64, 64), (96, 96)), ((50, 37), (37, 50))])
def test_resize_nearest_matches_jax(src, dst):
    x = np.random.RandomState(0).rand(2, *src, 2).astype(np.float32)
    want = np.asarray(jax_augment.resize_nearest(jnp.asarray(x), dst))
    np.testing.assert_array_equal(augment.resize_nearest(_t(x), dst).numpy(),
                                  want)


def test_train_flow_reshuffles_each_pass_and_closes():
    image, target = _u8_batch(n=5, hw=32)
    flow, steps = in_memory_train_flow(image, target, 2, (32, 32),
                                       torch.Generator().manual_seed(0),
                                       device="cpu", augment=False)
    assert steps == 3 and len(flow) == 3
    norm = train_batch_resize(None, _t(image), _t(target), (32, 32),
                              augment=False)["image"]

    def order():
        out = []
        for batch in flow:
            for img in batch["image"]:
                out.append(int(np.argmin([float((img - n).abs().max())
                                          for n in norm])))
        return out

    first, second = order(), order()
    assert sorted(first) == sorted(second) == list(range(5))
    assert first != second
    flow.close()
    with pytest.raises(RuntimeError, match="closed"):
        next(iter(flow))


# ----------------------------------------------------------------- trainer

def _trainer(**kw):
    cfg = dict(model_params={"encoder": "ResNet34", "dtype": "float32"},
               optimizer_params={"lr": 5e-4, "gamma": 0.5,
                                 "weight_decay": 1e-4},
               loss_params=LOSS_PARAMS, training_config={"epochs": 2},
               input_size=(64, 64), device="cpu")
    cfg.update(kw)
    return UNetTrainer(**cfg)


def _flow(seed=0):
    image, target = _u8_batch(n=5, hw=80, seed=seed)
    return in_memory_train_flow(image, target, 2, (64, 64),
                                torch.Generator().manual_seed(seed),
                                device="cpu")


def test_fit_two_epochs():
    """2 epochs of 3 steps on 5 tiles with augmentation: 6 finite losses,
    the rate decayed per epoch on the JAX schedule
    (optax.exponential_decay, staircase, every `steps` optimizer steps), the
    flow closed, and weights that UNetPipeline serves."""
    from mapping_tpu_torch.pipelines import UNetPipeline

    trainer = _trainer()
    flow, steps = _flow()
    trainer.fit((flow, steps))
    assert len(trainer.train_losses) == 6
    assert np.isfinite(trainer.train_losses).all()
    schedule = optax.exponential_decay(5e-4, steps, 0.5, staircase=True)
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(schedule(6)), rel=1e-6)
    assert flow.images is None
    val = eval_batch_resize(*map(_t, _u8_batch(n=2, hw=80, seed=9)), (64, 64))
    assert np.isfinite(trainer.score_validation(([val], 1))["sum"])
    pipe = UNetPipeline({"encoder": "ResNet34", "model_dtype": "float32",
                         "image_h": 64, "image_w": 64,
                         "batch_size_inference": 2},
                        trainer.state_dict(), device="cpu")
    probs = pipe.probs(pipe.preprocess(_u8_batch(n=2, hw=80)[0]))
    assert probs.shape == (2, 64, 64, 2) and torch.isfinite(probs).all()


def test_steps_per_call_runs_the_same_single_steps():
    """training.steps_per_call = 2 groups the same single steps: the same
    losses (1e-6 relative) as one step per call."""
    one = _trainer(training_config={"epochs": 1})
    two = _trainer(training_config={"epochs": 1, "steps_per_call": 2})
    one.fit(_flow(seed=1))
    two.fit(_flow(seed=1))
    assert len(two.train_losses) == 3
    np.testing.assert_allclose(two.train_losses, one.train_losses, rtol=1e-6)


@pytest.mark.parametrize("kw,item", [
    ({"callbacks_config": {"checkpoint_dir": "x"}}, 11),
    ({"mesh": "auto"}, 16),
    ({"pretrained_weights": "resnet.pth"}, 6)])
def test_unported_trainer_settings_raise(kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        _trainer(**kw)


@pytest.mark.parametrize("method,item", [("warm_start", 11),
                                         ("import_torch_checkpoint", 6)])
def test_unported_trainer_methods_raise(method, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        getattr(_trainer(), method)("model.pth")
