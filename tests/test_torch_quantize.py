"""The port's int8 serving quantisation (mapping_tpu_torch/models/
quantize.py) against the JAX package's (mapping_tpu/models/quantize.py),
on the same numpy inputs and weights.

Tolerances:
- int8 weights, weight scales, biases and the int32 accumulator of every
  conv geometry of the JAX tests' CONV_VARIANTS: exact (the accumulator
  against `lax.conv_general_dilated` / `lax.conv_transpose` with
  `preferred_element_type=int32`);
- a layer's rescaled output: 1e-6 (both compute float32(acc) * (w_scale
  * x_scale) + bias);
- activation maxima (`collect_stats`) and the scales made from them: 1e-6
  relative (the float forwards differ in rounding);
- whole quantised networks: the JAX qtable run by the port against the
  JAX quantised forward, max |dp| 1e-5 (6e-8 measured on the CPU); the
  port's own qtable of the same weights, 1e-3 (5.8e-4 measured: its
  activation scales differ from JAX's in the last bit, so an activation
  may round to the next int8 step); the port's own quantisation of a
  BatchNorm scratch UNet
  (which the port folds and JAX serves unfolded) against JAX's: mean
  |dp| < 0.02 and argmax agreement > 0.98 on confident pixels, the JAX
  test's bounds of int8 against float.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from torch import nn as tnn

import mapping_tpu.models.quantize as jq
from mapping_tpu.models.scratch import UNet as FlaxUNet
from mapping_tpu_torch.models import convert
from mapping_tpu_torch.models import quantize as q
from mapping_tpu_torch.models.scratch import UNet
from tests.test_quantize import CONV_VARIANTS, ConvZoo
from tests.test_torch_models import _randomize
from tests.test_torch_zoo import _load, _scratch, _trainers, _variables

torch.set_num_threads(2)

NAMES = [v[0] for v in CONV_VARIANTS]
#: the port's module for each Flax conv of CONV_VARIANTS / ConvZoo
PORT_CONVS = {
    "same3": lambda cin: tnn.Conv2d(cin, 8, 3, padding=1),
    "strided": lambda cin: tnn.Conv2d(cin, 8, 3, stride=2, padding=1),
    "stem": lambda cin: tnn.Conv2d(cin, 8, 7, stride=2, padding=3),
    "deconv_same": lambda cin: tnn.ConvTranspose2d(cin, 8, 4, stride=2,
                                                   padding=1),
    "deconv_v1": lambda cin: tnn.ConvTranspose2d(cin, 8, 3, stride=2,
                                                 padding=1, output_padding=1),
    "one_by_one": lambda cin: tnn.Conv2d(cin, 4, 1),
}


def _flax_conv(name):
    return dict(CONV_VARIANTS)[name]()


def _port_layout(name, w_hwio):
    deconv = name.startswith("deconv")
    return (convert._deconv if deconv else convert._conv)(np.asarray(w_hwio))


def _port_conv(name, cin, params):
    mod = PORT_CONVS[name](cin)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(
            _port_layout(name, params["kernel"])))
        mod.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
    return mod


def _lax_accumulator(mod, qx, w):
    """The JAX package's int32 accumulator of `_qconv` for one Flax conv."""
    def pair(v):
        v = v or (1, 1)
        return (v, v) if isinstance(v, int) else tuple(v)

    strides, kdil = pair(mod.strides), pair(mod.kernel_dilation)
    dn = ("NHWC", "HWIO", "NHWC")
    if isinstance(mod, nn.ConvTranspose):
        return jax.lax.conv_transpose(
            qx, w, strides, jq._pad_attr(mod), rhs_dilation=kdil,
            dimension_numbers=dn, transpose_kernel=False,
            preferred_element_type=jnp.int32)
    return jax.lax.conv_general_dilated(
        qx, w, strides, jq._pad_attr(mod), rhs_dilation=kdil,
        dimension_numbers=dn, preferred_element_type=jnp.int32)


def _random_entry(name, cin, rng):
    """A Flax conv with random float params and a random JAX qtable entry
    (full-range int8 kernel, positive scales, a bias)."""
    mod = _flax_conv(name)
    x = jnp.zeros((1, 12, 12, cin), jnp.float32)
    params = jax.device_get(mod.init(jax.random.PRNGKey(0), x)["params"])
    c_out = params["kernel"].shape[-1]
    entry = {
        "w": rng.randint(-127, 128, params["kernel"].shape).astype(np.int8),
        "w_scale": rng.uniform(1e-3, 2e-2, c_out).astype(np.float32),
        "x_scale": np.float32(rng.uniform(0.01, 0.05)),
        "bias": rng.randn(c_out).astype(np.float32),
    }
    return mod, params, entry


def _to_host(qtable):
    """The qtable's tensors as numpy arrays."""
    return {name: {k: v.detach().cpu().numpy() for k, v in entry.items()}
            for name, entry in qtable.items()}


def _port_entry(name, entry):
    out = {k: torch.as_tensor(np.asarray(v)) for k, v in entry.items()}
    out["w"] = torch.from_numpy(_port_layout(name, entry["w"]))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_int32_accumulator_is_lax_exactly(name):
    """Full-range int8 inputs and kernels (sums up to 127^2 * 784): the
    port's im2col + _int_mm accumulator equals lax's int32 conv, element
    for element."""
    rng = np.random.RandomState(NAMES.index(name))
    cin = 16
    mod, params, entry = _random_entry(name, cin, rng)
    qx = rng.randint(-127, 128, (2, 12, 12, cin)).astype(np.int8)
    want = np.asarray(_lax_accumulator(mod, jnp.asarray(qx),
                                       jnp.asarray(entry["w"])))
    port = q.QuantizedConv(_port_conv(name, cin, params),
                           _port_entry(name, entry))
    got = q.int8_conv(torch.from_numpy(qx), port.w_mat, port.kernel_size,
                      port.c_out, **port.geometry)
    assert got.dtype == torch.int32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", NAMES)
def test_rescaled_output_matches_qconv(name):
    """One layer end to end from float activations: quantise, int8 conv,
    rescale, bias, against the JAX `_qconv`, within 1e-6."""
    rng = np.random.RandomState(10 + NAMES.index(name))
    cin = 8
    mod, params, entry = _random_entry(name, cin, rng)
    x = (rng.randn(2, 12, 12, cin) * 2).astype(np.float32)
    want = np.asarray(jq._qconv(mod, jnp.asarray(x), {
        k: jnp.asarray(v) for k, v in entry.items()}, jnp.float32))
    port = q.QuantizedConv(_port_conv(name, cin, params),
                           _port_entry(name, entry))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_build_qtable_is_jax_bit_for_bit(name):
    """The same float32 kernel and activation maximum: int8 weights,
    weight scale, activation scale and bias equal to JAX's build_qtable,
    bit for bit (the weight in the port's layout)."""
    rng = np.random.RandomState(20 + NAMES.index(name))
    cin = 8
    mod = _flax_conv(name)
    params = jax.device_get(mod.init(jax.random.PRNGKey(1), jnp.zeros(
        (1, 12, 12, cin)))["params"])
    params = {"kernel": (rng.randn(*params["kernel"].shape) * 0.1).astype(
        np.float32), "bias": rng.randn(*params["bias"].shape).astype(
        np.float32)}
    params["kernel"][..., 0] = 0.0  # an all-zero channel takes the EPS
    amax = float(np.float32(rng.uniform(0.5, 3.0)))
    want = jax.device_get(jq.build_qtable({"conv": params},
                                          {"conv": amax})["conv"])
    port_mod = _port_conv(name, cin, params)
    got = _to_host(q.build_qtable(port_mod, {"": amax}))[""]
    np.testing.assert_array_equal(got["w"], _port_layout(name, want["w"]))
    assert got["w"].dtype == np.int8
    for key in ("w_scale", "x_scale", "bias"):
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))


class PortConvZoo(tnn.Module):
    """ConvZoo of tests/test_quantize.py with the port's modules."""

    def __init__(self):
        super().__init__()
        for name, cin in (("same3", 3), ("strided", 8), ("stem", 8),
                          ("deconv_same", 8), ("deconv_v1", 8)):
            setattr(self, name, PORT_CONVS[name](cin))
        self.final = tnn.Conv2d(8, 4, 1)

    def forward(self, x):
        for name in ("same3", "strided", "stem", "deconv_same", "deconv_v1",
                     "final"):
            x = getattr(self, name)(x)
        return x


def _zoo_pair(seed=0):
    x = np.linspace(-2, 2, 2 * 16 * 16 * 3, dtype=np.float32).reshape(
        2, 16, 16, 3)
    model = ConvZoo()
    params = jax.device_get(model.init(jax.random.PRNGKey(seed),
                                       jnp.asarray(x))["params"])
    port = PortConvZoo()
    state = {}
    for name, p in params.items():
        layout = "deconv" if name.startswith("deconv") else "same3"
        state[f"{name}.weight"] = _port_layout(layout, p["kernel"])
        state[f"{name}.bias"] = np.asarray(p["bias"])
    return model, params, _load(port, state).eval(), x


def test_collect_stats_matches_jax():
    """Every conv's input maximum, by name, within 1e-6 relative; the
    first conv's is the image's own (2.0)."""
    model, params, port, x = _zoo_pair()
    want = jq.collect_stats(model, {"params": params}, [jnp.asarray(x)])
    got = q.collect_stats(port, [torch.from_numpy(x).permute(0, 3, 1, 2)])
    assert set(got) == set(want) == set(q.conv_kernel_paths(port))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6)
    assert got["same3"] == 2.0


def test_uncalibrated_conv_stays_float():
    """A conv missing from the stats gets no qtable entry and runs its
    float conv inside the quantised model."""
    _, _, port, x = _zoo_pair()
    images = torch.from_numpy(x).permute(0, 3, 1, 2)
    stats = q.collect_stats(port, [images])
    stats.pop("final")
    qtable = q.build_qtable(port, stats)
    assert "final" not in qtable
    qmodel = q.quantize_model(port, qtable, torch.float32)
    assert isinstance(qmodel.final, tnn.Conv2d)
    assert isinstance(qmodel.same3, q.QuantizedConv)
    assert qmodel(images).shape == (2, 4, 16, 16)


def test_min_dim_keeps_narrow_convs_float():
    """min_dim drops a conv whose kH kW c_in or c_out is below it, as in
    JAX."""
    model, params, port, x = _zoo_pair()
    stats = q.collect_stats(port, [torch.from_numpy(x).permute(0, 3, 1, 2)])
    want = jq.build_qtable(params, stats, min_dim=64)
    got = q.build_qtable(port, stats, min_dim=64)
    assert set(got) == set(want)
    assert "final" not in got and "same3" not in got


def test_int8_conv_pads_rows_and_columns():
    """One output row and a kernel of K = 3 x 3 x 3 and c_out 2 (neither a
    multiple of 8): padded for the card's _int_mm, the result is the
    integer conv all the same."""
    rng = np.random.RandomState(3)
    qx = rng.randint(-127, 128, (1, 3, 3, 3)).astype(np.int8)
    w = rng.randint(-127, 128, (3, 3, 3, 2)).astype(np.int8)
    got = q.int8_conv(torch.from_numpy(qx), q.weight_matrix(
        torch.from_numpy(w)), (3, 3), 2)
    want = np.einsum("hwc,hwco->o", qx[0].astype(np.int64),
                     w.astype(np.int64))
    assert got.shape == (1, 1, 1, 2)
    np.testing.assert_array_equal(got.numpy()[0, 0, 0], want)


def test_int8_conv_chunks_large_batches(monkeypatch):
    """A batch whose im2col passes IM2COL_BYTES is unfolded per chunk and
    gives the same integers."""
    rng = np.random.RandomState(4)
    qx = torch.from_numpy(rng.randint(-127, 128, (5, 8, 8, 8)).astype(
        np.int8))
    w = q.weight_matrix(torch.from_numpy(rng.randint(
        -127, 128, (3, 3, 8, 8)).astype(np.int8)))
    args = ((3, 3), 8)
    kw = dict(pads=((1, 1), (1, 1)))
    whole = q.int8_conv(qx, w, *args, **kw)
    before = q.MATMULS["int_mm"]
    monkeypatch.setattr(q, "IM2COL_BYTES", 2 * 64 * 72)
    chunked = q.int8_conv(qx, w, *args, **kw)
    assert q.MATMULS["int_mm"] - before == 3
    assert torch.equal(whole, chunked)


# ------------------------------------------------------------ whole models

def _scratch_pair(batch_norm, hw=32, seed=0):
    cfg = _scratch(batch_norm=batch_norm, n_filters=8)
    flax_model = FlaxUNet(dtype=jnp.float32, **cfg)
    params, stats = _variables(flax_model, hw, seed)
    port = _load(UNet(**cfg), convert.named_state_dict_from_flax(
        params, stats)).eval()
    return flax_model, params, stats, port


def test_jax_qtable_runs_in_the_port():
    """A BatchNorm-free scratch UNet: the port quantises the same float
    weights into the JAX qtable (int8 weights, scales and biases exact,
    activation scales 1e-6 relative); the JAX qtable carried over by
    `convert.qtable_from_flax` runs in the port within 1e-5 of the JAX
    quantised probabilities, the port's own within 1e-3."""
    flax_model, params, stats, port = _scratch_pair(False)
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    probs_fn, get_packed = jq.quantized_probs_fn(
        flax_model, lambda: params, x, has_batch_stats=False)
    packed = get_packed()
    want = np.asarray(probs_fn(packed, jnp.asarray(x)))
    jax_table = jax.device_get(packed["qtable"])
    carried = convert.qtable_from_flax(
        {"encoder": "from_scratch"}, jax_table, params, stats)
    assert len(carried) == len(jax_table) == len(q.conv_kernel_paths(port))

    own_fn, own_packed = q.quantized_probs_fn(lambda: port,
                                              torch.from_numpy(x))
    own = _to_host(own_packed()["qtable"])
    assert set(own) == set(carried)
    for name, entry in carried.items():
        assert set(own[name]) == set(entry)
        for key in set(entry) - {"x_scale"}:
            np.testing.assert_array_equal(own[name][key], entry[key])
        np.testing.assert_allclose(own[name]["x_scale"], entry["x_scale"],
                                   rtol=1e-6)

    from mapping_tpu_torch.train.trainer import SoftmaxProbs

    module = SoftmaxProbs(q.quantize_model(port, carried, torch.float32),
                          torch.float32)
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    own_probs = own_fn(own_packed(), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(own_probs, want, atol=1e-3)


def test_quantized_scratch_unet_close_to_jax():
    """The JAX test's scratch UNet (8 filters, 2 levels, BatchNorm, 64^2)
    from the same weights: the port quantises its BN-folded copy, JAX the
    unfolded model. Mean |dp| against JAX's quantised probabilities and
    against the port's float ones < 0.02, argmax agreement on confident
    pixels > 0.98."""
    extra = {"n_filters": 8, "repeat_blocks": 2}
    jax_trainer, trainer = _trainers("from_scratch", extra, hw=64)
    jax_trainer._ensure_state()
    state = jax_trainer.state
    params = _randomize(jax.device_get(state.params),
                        np.random.RandomState(1))
    stats = _randomize(jax.device_get(state.batch_stats),
                       np.random.RandomState(2))
    jax_trainer.state = state.replace(params=params, batch_stats=stats)
    trainer.load_state_dict(convert.state_dict_for_encoder(
        {"encoder": "from_scratch"}, params, stats))
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)

    model, get_p, has_bs = jax_trainer.serving_model_fns()
    jfn, jget = jq.quantized_probs_fn(model, get_p, x, has_batch_stats=has_bs)
    want = np.asarray(jfn(jget(), jnp.asarray(x)))
    pfn, pget = q.quantized_probs_fn(trainer.folded_float32,
                                     torch.from_numpy(x))
    got = pfn(pget(), torch.from_numpy(x)).numpy()
    float_probs = trainer.probs_apply_fn()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    for ref in (want, float_probs):
        assert np.mean(np.abs(got - ref)) < 0.02
        confident = np.abs(ref[..., 1] - 0.5) > 0.1
        if confident.any():
            agree = (got[..., 1] > 0.5) == (ref[..., 1] > 0.5)
            assert agree[confident].mean() > 0.98


def test_qtable_from_flax_maps_every_resnet_conv():
    """Every conv path of a JAX ResNet34 U-Net lands on the port module
    the state-dict converter gives it, with the weight laid out as that
    converter lays out the float kernel."""
    from mapping_tpu.models.registry import build_network as jax_build
    from mapping_tpu_torch.models.registry import build_network

    model = jax_build({"encoder": "ResNet34", "num_filters": 4})
    variables = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map(
        lambda s: np.ones(s.shape, np.float32), variables["batch_stats"])
    paths = jq.conv_kernel_paths(params)
    table = {p: {"w": np.clip(np.round(np.asarray(t["kernel"]) * 40),
                              -127, 127).astype(np.int8),
                 "w_scale": np.ones(t["kernel"].shape[-1], np.float32),
                 "x_scale": np.float32(1.0)} for p, t in paths.items()}
    carried = convert.qtable_from_flax({"encoder": "ResNet34"}, table,
                                       params, stats)
    state = convert.state_dict_for_encoder({"encoder": "ResNet34"}, params,
                                           stats)
    port = build_network({"encoder": "ResNet34", "num_filters": 4})
    assert set(carried) == set(q.conv_kernel_paths(port))
    sd = port.state_dict()
    for name, entry in carried.items():
        assert entry["w"].shape == tuple(sd[name + ".weight"].shape), name
        # the int8 values sit where the converter puts the float kernel
        ratio = np.round(state[name + ".weight"] * 40)
        np.testing.assert_array_equal(entry["w"], np.clip(ratio, -127, 127))


# ------------------------------------------------- the serving composition

def test_calib_bounds_honor_batch_size():
    for n, bs in [(30, 16), (32, 16), (10, 16), (33, 16), (16, 16),
                  (7, 0), (5, 2)]:
        assert q._calib_bounds(n, bs) == jq._calib_bounds(n, bs)


def _small_port(seed=0):
    _, _, _, port = _scratch_pair(False, seed=seed)
    return port


def test_calibration_batches_equal_size(monkeypatch):
    """33 images at batch 8: five calibration batches of 8, the last
    overlapping the one before, as in JAX."""
    seen = []
    real = q.collect_stats

    def spy(model, batches, **kw):
        seen.extend(b.shape[0] for b in batches)
        return real(model, batches, **kw)

    monkeypatch.setattr(q, "collect_stats", spy)
    x = torch.rand(33, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    port = _small_port()
    q.quantized_probs_fn(lambda: port, x, calib_batch_size=8)
    assert seen == [8, 8, 8, 8, 8]


def test_snapshot_serves_build_time_weights():
    """Without version_fn the build-time int8 snapshot serves, whatever
    happens to the float weights."""
    holder = {"m": _small_port()}
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    probs_fn, get_packed = q.quantized_probs_fn(lambda: holder["m"], x)
    before = probs_fn(get_packed(), x)
    holder["m"] = _small_port(seed=7)
    assert torch.equal(probs_fn(get_packed(), x), before)


def test_version_fn_recalibrates_on_weight_change():
    """A version bump rebuilds the qtable from the new weights, at once;
    no bump keeps the cached build."""
    holder = {"m": _small_port(), "version": 0}
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(5))
    probs_fn, get_packed = q.quantized_probs_fn(
        lambda: holder["m"], x, version_fn=lambda: holder["version"])
    packed1 = get_packed()
    before = probs_fn(packed1, x)
    holder["m"] = _small_port(seed=7)
    assert get_packed() is packed1
    holder["version"] = 1
    packed2 = get_packed()
    assert packed2 is not packed1
    assert (probs_fn(packed2, x) - before).abs().max() > 1e-4
    assert get_packed() is packed2
    assert get_packed.stats == {"recalibrations": 1,
                                "serving_stale_batches": 0}


def test_async_recalibration_serves_stale_then_swaps():
    """set_async(True): a drift returns the previous snapshot at once,
    counts it, rebuilds on one background thread and converges on the
    final version after a second drift during the rebuild."""
    ports = {0: _small_port(), 1: _small_port(seed=7), 2: _small_port(seed=9)}
    holder = {"version": 0}
    gate = threading.Event()
    gate.set()

    def get_model():
        gate.wait(timeout=30)
        return ports[holder["version"]]

    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(6))
    _, get_packed = q.quantized_probs_fn(
        get_model, x, version_fn=lambda: holder["version"])
    get_packed.set_async(True)
    packed0 = get_packed()
    gate.clear()
    holder["version"] = 1
    t0 = time.monotonic()
    assert get_packed() is packed0 and get_packed() is packed0
    assert time.monotonic() - t0 < 1.0
    assert get_packed.stats == {"recalibrations": 1,
                                "serving_stale_batches": 2}
    holder["version"] = 2
    gate.set()
    key = next(iter(packed0["qtable"]))
    want = q.build_qtable(ports[2], {key: 1.0})[key]["w_scale"]
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not torch.equal(
            get_packed()["qtable"][key]["w_scale"], want):
        time.sleep(0.05)
    assert torch.equal(get_packed()["qtable"][key]["w_scale"], want)
    time.sleep(0.3)
    stale = get_packed.stats["serving_stale_batches"]
    get_packed()
    assert get_packed.stats["serving_stale_batches"] == stale


# ------------------------------------------------ pipelines, daemon, export
# The evaluate workspace of tests/test_torch_evaluate.py: the synthetic
# fixture's 6 val tiles, metadata written by the JAX package and a JAX
# unet.msgpack of a ResNet34 U-Net (64^2 in, float32, device cpu).

QUANT = {"quantized_serving": 1, "quant_calib_images": 4}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    import shutil

    from tests.test_torch_evaluate import make_workspace

    root = tmp_path_factory.mktemp("quantize")
    yield make_workspace(root)
    shutil.rmtree(root)


def _pipelines(ws, name, extra=QUANT):
    """(JAX pipeline, port pipeline) of `unet_weighted` inference from the
    workspace's unet.msgpack."""
    from mapping_tpu.manager import PipelineManager as JaxManager
    from mapping_tpu.pipelines import PIPELINES as JAX_PIPELINES
    from mapping_tpu_torch.config import build_config
    from mapping_tpu_torch.pipelines import PIPELINES
    from tests.test_torch_evaluate import write_config

    config = write_config(ws, name, extra)
    jax_pipe = JAX_PIPELINES["unet_weighted"]["inference"](
        JaxManager(config).config)
    jax_pipe.trainer.load(jax_pipe.trainer_cache_path.replace(
        ".pt", ".msgpack"))
    jax_pipe._weights_loaded = True
    port = PIPELINES["unet_weighted"]["inference"](build_config(config))
    port._ensure_weights()
    return jax_pipe, port, config


def test_pipeline_serves_int8_close_to_jax(workspace):
    """`quantized_serving: 1` in both packages on the same calibration
    images: the port's int8 probabilities against JAX's within the JAX
    test's bounds (mean |dp| < 0.02, confident argmax > 0.98), with every
    conv of the ResNet34 U-Net in the qtable and _int_mm called."""
    jax_pipe, port, _ = _pipelines(workspace, "q_probs")
    calib = port._calibration_images()
    jcalib = jax_pipe._calibration_images()
    np.testing.assert_allclose(calib.numpy(), np.asarray(jcalib),
                               atol=1e-5)
    jfn, jget = jax_pipe._quantized_fns()
    want = np.asarray(jfn(jget(), jnp.asarray(jcalib)))
    probs = port._probs_fn()
    assert isinstance(probs, q.QuantizedProbs)
    before = q.MATMULS["int_mm"]
    got = probs(calib).numpy()
    assert q.MATMULS["int_mm"] > before
    qtable = probs.get_packed()["qtable"]
    assert set(qtable) == set(q.conv_kernel_paths(
        port.trainer.folded_float32()))
    assert len(qtable) == len(jget()["qtable"])
    assert np.mean(np.abs(got - want)) < 0.02
    confident = np.abs(want[..., 1] - 0.5) > 0.1
    assert confident.any()
    agree = (got[..., 1] > 0.5) == (want[..., 1] > 0.5)
    assert agree[confident].mean() > 0.98


def test_evaluate_quantized(workspace):
    """`evaluate -p unet_weighted` with `quantized_serving: 1` runs in the
    port; its AP/AR are within 0.1 of the float evaluate's on the same
    tiles."""
    from mapping_tpu_torch.manager import PipelineManager
    from tests.test_torch_evaluate import write_config

    got = PipelineManager(write_config(workspace, "q_eval", QUANT)).evaluate(
        "unet_weighted", False, None)
    flt = PipelineManager(write_config(workspace, "f_eval", {})).evaluate(
        "unet_weighted", False, None)
    assert json.loads((workspace["root"] / "q_eval" /
                       "prediction.json").read_text())
    for a, b in zip(got, flt):
        assert abs(float(a) - float(b)) <= 0.1


def test_weight_reload_recalibrates_the_pipeline(workspace):
    """A trainer load after the serve program was built serves the new
    weights through a fresh qtable, as in JAX."""
    _, port, _ = _pipelines(workspace, "q_reload")
    serve = port.serve_program()
    images = port._calibration_images()
    before = serve(images)[0]
    state = {k: (v * 0.2 if v.is_floating_point() else v)
             for k, v in port.trainer.state_dict().items()}
    version = port.trainer._state_version
    port.trainer.load_state_dict(state)
    assert port.trainer._state_version == version + 1
    after = serve(images)[0]
    assert not np.array_equal(before, after)
    assert serve.recalibration_stats() == {"recalibrations": 1,
                                           "serving_stale_batches": 0}


def test_daemon_param_source_stats_match_jax(workspace):
    """Both daemons over `quantized_serving: 1`, one request, a trainer
    load, one request (served stale, the rebuild starts in the
    background), the swap, one more request: the same counters at each
    step."""
    import jax as _jax

    from mapping_tpu.infer.daemon import \
        daemon_from_pipeline as jax_daemon_from_pipeline
    from mapping_tpu.train.checkpoint import save_state
    from mapping_tpu_torch.infer.daemon import daemon_from_pipeline
    from mapping_tpu_torch.config import build_config

    jax_pipe, port, config = _pipelines(workspace, "q_daemon")
    tile = workspace["tiles"][0]
    jax_d = jax_daemon_from_pipeline(jax_pipe, jax_pipe.config, port=0,
                                     max_wait_ms=1.0)
    port_d = daemon_from_pipeline(port, build_config(config), port=0,
                                  max_wait_ms=1.0)
    perturbed = str(workspace["root"] / "perturbed.msgpack")
    state = jax_pipe.trainer.state
    save_state(state.replace(params=_jax.tree_util.tree_map(
        lambda v: v * 0.2, state.params)), perturbed)
    try:
        seen = []
        for d in (jax_d, port_d):
            d.batcher.submit(tile, image_id=1, timeout=300)
            seen.append([d.batcher.param_source_stats()])
        jax_pipe.trainer.load(perturbed)
        port.trainer.load(perturbed)
        for d, s in zip((jax_d, port_d), seen):
            d.batcher.submit(tile, image_id=1, timeout=300)
            s.append(d.batcher.param_source_stats())
        assert seen[1] == seen[0]
        assert seen[1] == [{"recalibrations": 0, "serving_stale_batches": 0},
                           {"recalibrations": 1, "serving_stale_batches": 1}]
        # requests served while the rebuild runs count as stale, so the
        # count at the swap depends on the rebuild's time; after the swap
        # it stops growing and no rebuild follows
        for d in (jax_d, port_d):
            deadline = time.monotonic() + 120
            while True:
                d.batcher.submit(tile, image_id=1, timeout=300)
                before = d.batcher.param_source_stats()
                d.batcher.submit(tile, image_id=1, timeout=300)
                if d.batcher.param_source_stats() == before:
                    break
                assert time.monotonic() < deadline, "no swap"
                time.sleep(0.2)
            assert before["recalibrations"] == 1
    finally:
        jax_d.batcher.close()
        port_d.batcher.close()


def test_export_holds_the_int8_program(workspace):
    """`export` with `quantized_serving: 1` writes the int8 program with
    its qtable snapshot (manifest `quantized` true), and its replay is
    bit-equal to the live quantised serve on the CPU."""
    from mapping_tpu_torch import main
    from mapping_tpu_torch.infer.artifact import load_artifact
    from tests.test_torch_artifact import (_assert_replay_equals_live,
                                           _live)
    from tests.test_torch_evaluate import write_config

    config = write_config(workspace, "q_export",
                          {**QUANT, "serve_batch_buckets": "2"})
    out = workspace["root"] / "q_artifact"
    main.main(["--config", config, "export", "-p", "unet_weighted",
               "--dir_path", str(out)])
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["quantized"] is True
    art = load_artifact(str(out))
    tiles = workspace["tiles"][:2]
    _assert_replay_equals_live(art(tiles), _live(config, tiles))
