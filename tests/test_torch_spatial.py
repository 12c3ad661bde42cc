"""Spatial serving of the port (ROADMAP item 16b) against brute force, the
port's single-device serving and the JAX package.

The port splits each image's rows over the devices of a mesh
(parallel/spatial.py); here the devices are CPU replicas (["cpu"] * n),
and the JAX side runs on the root conftest's 8 virtual CPU devices.
Tolerances, each test stating its own too:
- a spatial layer on bands = the unsplit layer, exactly, in float64;
- spatial serving = the port's single-device serving, in float64: the
  forward's probabilities equal (max |dp| <= 1e-10; on the CPU they are
  bit-equal), the gathered target-size probabilities within 1e-10 of
  `resize_bilinear` of the unsplit ones, labels and areas exact, scores
  1e-5 relative (the postprocess reads float32 probabilities, resized in
  another order); the int8 forward's float32 probabilities bit-equal at
  full size and within 1e-6 at the target size;
- against the JAX package's spatial serving: labels equal but where a
  pixel's JAX probability lies within max |port - JAX| (at the target
  size) of the threshold, and where the foregrounds agree, labels equal
  and scores within 1e-4.
"""

import json
import shutil

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from mapping_tpu.infer.serving import FusedServe as JaxFusedServe
from mapping_tpu.infer.sharded import make_spatial_infer as jax_spatial
from mapping_tpu.models import UNet as FlaxUNet
from mapping_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mapping_tpu_torch import pipelines
from mapping_tpu_torch.config import build_config
from mapping_tpu_torch.data.augment import resize_bilinear
from mapping_tpu_torch.infer import daemon as port_daemon
from mapping_tpu_torch.infer.artifact import export_serving_artifact
from mapping_tpu_torch.infer.serving import FusedServe
from mapping_tpu_torch.infer.sharded import (make_sharded_infer,
                                             make_spatial_infer)
from mapping_tpu_torch.manager import PipelineManager, rank_devices
from mapping_tpu_torch.models import convert
from mapping_tpu_torch.models.blocks import Upsample2x
from mapping_tpu_torch.models.fold_bn import fold_batch_stats
from mapping_tpu_torch.models.quantize import (QuantizedProbs, build_qtable,
                                               quantize_model,
                                               quantized_probs_fn)
from mapping_tpu_torch.models.scratch import UNet
from mapping_tpu_torch.models.unet_resnet import UNetResNet
from mapping_tpu_torch.models.unetpp import UNetPlusPlus
from mapping_tpu_torch.models.vgg import UNet11, UNetVGG16
from mapping_tpu_torch.parallel import make_mesh
from mapping_tpu_torch.parallel.spatial import (EXCHANGE, SpatialProgram,
                                                band_rows)
from mapping_tpu_torch.pipelines import PIPELINES
from tests.test_torch_evaluate import make_workspace, write_config
from tests.torch_guards import drop_tmp_path  # noqa: F401 (autouse)

torch.set_num_threads(2)

BANDS = (2, 3, 4, 8)
#: heights that do not divide over the bands: bands of 0 and 1 rows
HEIGHTS = (1, 2, 3, 5, 7, 13, 16, 17)


# --------------------------------------------------------- band layers

class _NHWC(nn.Module):
    """An NCHW layer between the permutes of a serving forward."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, x):
        return self.layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _int8(layer):
    """`layer` with its int8 replacement (models/quantize.py), in float64
    between the int8 products."""
    model = nn.Sequential(layer).eval()
    return quantize_model(model, build_qtable(model, {"0": 2.5}),
                          torch.float64)[0]


LAYERS = {
    "conv3": lambda: nn.Conv2d(3, 4, 3, padding=1),
    "conv7": lambda: nn.Conv2d(3, 4, 7, padding=3),
    "conv3_s2": lambda: nn.Conv2d(3, 4, 3, stride=2, padding=1),
    "conv7_s2": lambda: nn.Conv2d(3, 4, 7, stride=2, padding=3),  # stem
    "conv1": lambda: nn.Conv2d(3, 4, 1),
    "conv4_same": lambda: nn.Conv2d(3, 4, 4, padding="same"),
    "pool2_s2": lambda: nn.MaxPool2d(2, 2),
    "pool3_s2_pad1": lambda: nn.MaxPool2d(3, 2, padding=1),  # scratch UNet
    "upsample2x": Upsample2x,
    "deconv4_s2_p1": lambda: nn.ConvTranspose2d(3, 4, 4, 2, 1),  # V2
    "deconv3_s2_p1_op1": lambda: nn.ConvTranspose2d(3, 4, 3, 2, 1, 1),  # V1
    "deconv6_s2_p2": lambda: nn.ConvTranspose2d(3, 4, 6, 2, 2, bias=False),
    "int8_conv3_s2": lambda: _int8(nn.Conv2d(3, 4, 3, stride=2, padding=1)),
    "int8_deconv4_s2_p1": lambda: _int8(nn.ConvTranspose2d(3, 4, 4, 2, 1)),
}


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_band_layer_equals_unsplit(kind, n):
    """Each spatial layer on n bands (every height of HEIGHTS the layer
    takes, so bands of 0 and 1 rows too) equals the unsplit layer on the
    same float64 input, exactly."""
    torch.manual_seed(0)
    layer = _NHWC(LAYERS[kind]()).double().eval()
    program = SpatialProgram(layer)
    ran = 0
    for h in HEIGHTS:
        x = torch.randn(2, h, 9, 3, dtype=torch.float64)
        try:
            want = layer(x)
        except RuntimeError:  # too small for the layer unsplit too
            continue
        got = program(x, ["cpu"] * n)
        assert [p.shape[1] for p in got.parts] == [
            b - a for a, b in band_rows(want.shape[1], n)]
        assert torch.equal(torch.cat(got.parts, 1), want), (kind, n, h)
        ran += 1
    assert ran >= 5


def test_exchange_moves_only_the_halo_rows():
    """A 3x3 conv over 4 bands of 16 rows fetches one row across each of
    the 3 inner boundaries in each direction, and nothing else."""
    layer = _NHWC(nn.Conv2d(3, 4, 3, padding=1)).double().eval()
    x = torch.randn(1, 16, 5, 3, dtype=torch.float64)
    EXCHANGE.reset()
    SpatialProgram(layer)(x, ["cpu"] * 4)
    row = 1 * 3 * 5 * 8  # (B, C, 1, W) float64
    assert EXCHANGE.as_dict() == dict(halo_bytes=6 * row, gather_bytes=0,
                                      transfers=6, max_rows=1,
                                      max_bytes=row)


def test_unknown_and_row_reading_ops_raise():
    """No fallback: an op without a band rule, or one that reads along
    the rows, refuses to run."""
    cases = [lambda x: x.sum(1, keepdim=True),
             lambda x: torch.softmax(x, 1),
             lambda x: torch.flip(x, (1,)),
             lambda x: x[:, 1:]]
    x = torch.randn(1, 8, 4, 3)
    for fn in cases:
        with pytest.raises(NotImplementedError, match="spatial serving"):
            SpatialProgram(fn)(x, ["cpu"] * 2)


# ------------------------------------------------- against single device

class Probs64(nn.Module):
    """(B, H, W, 3) -> float64 softmax of a float64 model over its two
    classes, the logit difference centred and scaled to standard deviation
    4 on `x` (so that few pixels sit near the threshold)."""

    def __init__(self, model, x):
        super().__init__()
        self.model = model
        with torch.no_grad():
            d = self.logits(x)
            d = d[:, 1] - d[:, 0]
        s, m = 4.0 / float(d.std()), float(d.mean())
        self.register_buffer("w", torch.tensor(
            [s, s], dtype=torch.float64).reshape(1, 2, 1, 1))
        self.register_buffer("b", torch.tensor(
            [0.0, -s * m], dtype=torch.float64).reshape(1, 2, 1, 1))

    def logits(self, x):
        return self.model(x.permute(0, 3, 1, 2).to(torch.float64))

    def forward(self, x):
        return torch.softmax(self.logits(x) * self.w + self.b, 1).permute(
            0, 2, 3, 1)


FAMILIES = {
    "resnet34": lambda: UNetResNet(34, num_filters=4),
    "unet11": lambda: UNet11(num_filters=4),
    "vgg16": lambda: UNetVGG16(num_filters=4),
    "scratch_pool3_s2": lambda: UNet(n_filters=4, repeat_blocks=2,
                                     pool_kernel=3, pool_stride=2),
    "unetpp": lambda: UNetPlusPlus(n_filters=4, depth=4),
}
POST = dict(target_size=(40, 40), category_layers=(1, 1),
            active_layers=(1,))


def _image(seed=0, h=128, w=64):
    rng = np.random.RandomState(seed)
    low = torch.from_numpy(rng.rand(1, 3, h // 16, w // 16).astype(
        np.float32))
    return nn.functional.interpolate(low, size=(h, w), mode="bilinear"
                                     ).permute(0, 2, 3, 1) * 2 - 1


def _family_probs(family, x):
    torch.manual_seed(1)  # seed 0 leaves the narrow ResNet34's output flat
    model = fold_batch_stats(FAMILIES[family]().eval()).double()
    return Probs64(model, x).eval()


def _serve_both(probs_fn, x, n, **kwargs):
    args = {**POST, **kwargs}
    single = FusedServe(probs_fn, **args)
    spatial = FusedServe(probs_fn, mesh=make_mesh(["cpu"] * n),
                         spatial=True, **args)
    return single, spatial, single(x), spatial(x)


def _assert_same(got, want, rtol=1e-5):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=rtol, atol=0)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6)
    assert want[0].max() > 0


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_spatial_equals_single_device(family, n):
    """Each family, BN folded, in float64 over n CPU bands: the forward's
    probabilities equal the unsplit forward's (max |dp| <= 1e-10), the
    gathered target-size map is within 1e-10 of resize_bilinear of them,
    and labels, areas and scores are the single-device FusedServe's
    (scores 1e-5 relative)."""
    x = _image()
    probs = _family_probs(family, x)
    _, spatial, want, got = _serve_both(probs, x, n)
    with torch.no_grad():
        full = probs(x)
        bands = spatial.spatial.program()(x, ["cpu"] * n)
        assert float((torch.cat(bands.parts, 1) - full).abs().max()) <= 1e-10
        dp = spatial.spatial(x) - resize_bilinear(full, POST["target_size"])
    assert float(dp.abs().max()) <= 1e-10
    _assert_same(got, want)


@pytest.mark.parametrize("n", (2, 4))
def test_int8_forward_spatial_equals_single_device(n):
    """The int8 forward (QuantizedProbs over a ResNet34 at 4 filters,
    compute dtype float64, calibrated on the image): its float32
    probabilities bit-equal at full size over n bands, within 1e-6 at the
    target size, and labels, areas and scores (1e-5) the single
    device's."""
    x = _image(1)
    torch.manual_seed(1)
    model = fold_batch_stats(UNetResNet(34, num_filters=4).eval())
    with torch.no_grad():  # the logit difference: mean 0, std 4 on x
        d = model(x.permute(0, 3, 1, 2))
        d = d[:, 1] - d[:, 0]
        scale, w, b = 4.0 / d.std(), model.final.weight, model.final.bias
        w[1] = w[0] + scale * (w[1] - w[0])
        b[1] = b[0] + scale * (b[1] - b[0] - d.mean())
    probs = QuantizedProbs(*quantized_probs_fn(
        lambda: model, x, compute_dtype=torch.float64))
    _, spatial, want, got = _serve_both(probs, x, n)
    with torch.no_grad():
        full = probs(x)
        bands = spatial.spatial.program()(x, ["cpu"] * n)
        assert torch.equal(torch.cat(bands.parts, 1), full)
        dp = spatial.spatial(x) - resize_bilinear(full, POST["target_size"])
    assert float(dp.abs().max()) <= 1e-6
    _assert_same(got, want)


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("mode", ["features", "crop", "erode_dilate",
                                  "overflow"])
def test_serving_modes_spatial_equal_single_device(mode, n):
    """The feature tensor (compute_features), the centre crop of
    unet_padded (crop_size: each band keeps its rows inside the window),
    erosion 3 + dilation 2, and an instance pad of half the components
    (the overflow rerun, single-device on the first device, widens it)
    over n bands against
    one device, in float64 (as test_family_spatial_equals_single_device)."""
    x = _image(2, 192, 128)
    probs = _family_probs("unet11", x)  # 11 components at the target
    count = int(FusedServe(probs, **POST)(x)[0].max())
    assert count >= 2
    kwargs = {"features": dict(compute_features=True),
              "crop": dict(crop_size=(100, 96)),
              "erode_dilate": dict(erode_size=3, dilate_size=2),
              "overflow": dict(max_instances=count // 2)}[mode]
    single, spatial, want, got = _serve_both(probs, x, n, **kwargs)
    with torch.no_grad():
        dp = spatial.spatial(x) - resize_bilinear(single._probs(x),
                                                  POST["target_size"])
    assert float(dp.abs().max()) <= 1e-10
    _assert_same(got, want)
    assert len(got) == (4 if mode == "features" else 3)
    if mode == "overflow":
        assert got[1].shape[-1] >= count


def test_spatial_gather_is_target_size_scale():
    """The JAX test of the same name, on the port's counter: over 8 bands
    of a 512^2 image no transfer carries as many rows as the
    full-resolution map, and the gather moves 7 target-size partials."""
    def probs_fn(images):
        logit = images[..., 0] * 4.0
        return torch.softmax(torch.stack([-logit, logit], -1), -1)

    post = dict(target_size=(48, 48), category_layers=(1, 1),
                active_layers=(0,))
    x = torch.rand(1, 512, 512, 3)
    serve = FusedServe(probs_fn, mesh=make_mesh(["cpu"] * 8), spatial=True,
                       **post)
    EXCHANGE.reset()
    serve(x)
    assert EXCHANGE.max_rows < 512
    assert EXCHANGE.gather_bytes == 7 * 48 * 48 * 2 * 4
    assert EXCHANGE.max_bytes == 48 * 48 * 2 * 4


def test_spatial_follows_the_trainers_weights(tmp_path):
    """FusedServe(spatial=True) over the trainer's probability function
    traces its current folded module, and a weight change re-traces: the
    served labels follow the new weights as the single device's do."""
    config = build_config(overrides={"encoder": "ResNet34", "image_h": 64,
                                     "image_w": 64, "device": "cpu",
                                     "model_dtype": "float32"})
    pipe = PIPELINES["unet_weighted"]["inference"](config)
    probs = pipe.trainer.probs_apply_fn()
    x = _image(3, 128, 64)
    serve = FusedServe(probs, mesh=make_mesh(["cpu"] * 2), spatial=True,
                       **POST)
    first = serve.spatial.program()
    assert serve.spatial.program() is first
    state = {k: v.clone() for k, v in pipe.trainer.model.state_dict().items()}
    state["final.bias"] = state["final.bias"] + torch.tensor([-3.0, 3.0])
    pipe.set_weights(state)
    assert serve.spatial.program() is not first
    np.testing.assert_array_equal(serve(x)[0], FusedServe(probs, **POST)(x)[0])


# ---------------------------------------------------------------- JAX

def _band_rule(got, want, p_ref, band, threshold=0.5):
    """Labels equal but at pixels whose reference probability lies within
    `band` of the threshold; images whose foregrounds agree: labels equal,
    scores 1e-4."""
    got_l, want_l = np.asarray(got[0]), np.asarray(want[0])
    assert got_l.shape == want_l.shape
    near = np.abs(p_ref - threshold) <= band
    fg_got, fg_want = got_l > 0, want_l > 0
    assert not ((fg_got != fg_want) & ~near).any()
    for i in range(len(got_l)):
        if (fg_got[i] == fg_want[i]).all():
            np.testing.assert_array_equal(got_l[i], want_l[i])
            np.testing.assert_allclose(np.asarray(got[1])[i],
                                       np.asarray(want[1])[i], rtol=1e-4,
                                       atol=1e-5)
    assert want_l.max() > 0


def test_spatial_infer_matches_jax():
    """make_spatial_infer against mapping_tpu.infer.sharded's, on
    tests/test_sharded_infer.py's geometry: the scratch UNet (4 filters,
    2 blocks, float32, Flax initialisation carried over by
    models/convert.py), one 512 x 256 image, 8 bands, target 128^2: the
    band rule (module docstring), and labels and scores equal to the
    port's single-device serving (scores 1e-4, as the JAX test)."""
    model = FlaxUNet(n_filters=4, repeat_blocks=2, dtype=jnp.float32)
    x = np.random.RandomState(2).rand(1, 512, 256, 3).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 64, 64, 3)), train=False)
    port = UNet(n_filters=4, repeat_blocks=2)
    port.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in
                          convert.named_state_dict_from_flax(
                              variables["params"],
                              variables["batch_stats"]).items()})
    port.eval()

    def apply_fn(v, im):
        return model.apply(v, im, train=False)

    def port_apply(m, im):
        return m(im.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    post = dict(target_size=(128, 128), category_layers=(1, 1),
                active_layers=(1,))
    want = jax_spatial(apply_fn, jax_make_mesh(), **post)(variables, x)
    xt = torch.from_numpy(x)
    got = make_spatial_infer(port_apply, make_mesh(["cpu"] * 8), **post)(
        port, xt)
    one = make_sharded_infer(port_apply, make_mesh(["cpu"]), **post)(port, xt)
    np.testing.assert_array_equal(got[0].numpy(), one[0].numpy())
    np.testing.assert_allclose(got[1].numpy(), one[1].numpy(), rtol=1e-4,
                               atol=1e-4)
    p_jax = np.asarray(jax.image.resize(
        jax.nn.softmax(apply_fn(variables, x), -1), (1, 128, 128, 2),
        "linear"))[..., 1]
    with torch.no_grad():
        p_port = resize_bilinear(torch.softmax(port_apply(port, xt), -1),
                                 (128, 128))[..., 1].numpy()
    band = float(np.abs(p_port - p_jax).max())
    assert band < 1e-4
    _band_rule([o.numpy()[:, 1] for o in got],
               [np.asarray(o)[:, 1] for o in want], p_jax, band)


def test_fused_serve_spatial_matches_jax():
    """FusedServe(spatial=True) with the identity probability function of
    tests/test_serving.py (channel 0 x 4 as the building logit) on its
    geometry (2 images of 128 x 64, target 48^2, 8 bands) against JAX's
    spatial FusedServe: the band rule, areas equal where labels are."""
    rng = np.random.RandomState(5)
    base = rng.rand(2, 16, 8, 3).astype(np.float32)
    images = np.asarray(jax.image.resize(jnp.asarray(base), (2, 128, 64, 3),
                                         "linear")) * 2.0 - 1.0
    post = dict(target_size=(48, 48), category_layers=(1, 1),
                active_layers=(0, 1), erode_size=0, dilate_size=0)

    def jax_probs(params, im):
        logit = im[..., 0] * params["scale"]
        return jax.nn.softmax(jnp.stack([-logit, logit], -1), -1)

    def port_probs(im):
        logit = im[..., 0] * 4.0
        return torch.softmax(torch.stack([-logit, logit], -1), -1)

    params = {"scale": jnp.float32(4.0)}
    want = JaxFusedServe(jax_probs, lambda: params, mesh=jax_make_mesh(),
                         spatial=True, **post)(jnp.asarray(images))
    got = FusedServe(port_probs, mesh=make_mesh(["cpu"] * 8), spatial=True,
                     **post)(torch.from_numpy(images))
    p_jax = np.asarray(jax.image.resize(jax_probs(params, images),
                                        (2, 48, 48, 2), "linear"))
    p_port = resize_bilinear(port_probs(torch.from_numpy(images)),
                             (48, 48)).numpy()
    band = float(np.abs(p_port - p_jax).max())
    assert band < 1e-5
    for layer, channel in ((0, 0), (1, 1)):
        _band_rule([o[:, layer] for o in got], [o[:, layer] for o in want],
                   p_jax[..., channel], band)
        same = (got[0][:, layer] == want[0][:, layer]).all((1, 2))
        np.testing.assert_array_equal(got[2][same, layer],
                                      want[2][same, layer])


# ----------------------------------------------------------- refusals

@pytest.mark.parametrize("case", ["no_mesh", "tta", "one_device"])
def test_refusals_match_jax(case):
    """No mesh and TTA refuse with the JAX FusedServe's messages, in both
    packages; a pipeline with spatial_serving: 1 on one device (the CPU)
    refuses with JAX's message when it builds its serve program, and
    data_parallel: 1 there is the plain path (no mesh, no ranks)."""
    post = dict(target_size=(8, 8), category_layers=(1, 1))
    if case == "no_mesh":
        match = "requires a device mesh"
        with pytest.raises(ValueError, match=match):
            JaxFusedServe(lambda p, x: x, lambda: {}, spatial=True, **post)
        with pytest.raises(ValueError, match=match):
            FusedServe(lambda x: x, spatial=True, **post)
    elif case == "tta":
        match = "does not support TTA"
        with pytest.raises(ValueError, match=match):
            JaxFusedServe(lambda p, x: x, lambda: {}, mesh=jax_make_mesh(),
                          spatial=True, tta_specs=[object()], **post)
        with pytest.raises(ValueError, match=match):
            FusedServe(lambda x: x, mesh=make_mesh(["cpu"] * 2),
                       spatial=True, tta_specs=[object()], **post)
    else:
        overrides = {"encoder": "ResNet34", "image_h": 64, "image_w": 64,
                     "device": "cpu"}
        pipe = PIPELINES["unet_weighted"]["inference"](build_config(
            overrides={**overrides, "spatial_serving": 1}))
        with pytest.raises(ValueError,
                           match="spatial_serving: 1 needs more than one "
                                 "device"):
            pipe.serve_program()
        config = build_config(overrides={**overrides, "data_parallel": 1})
        dp = PIPELINES["unet_weighted"]["inference"](config)
        assert dp.trainer.mesh is None and dp.serve_program().mesh is None
        assert rank_devices("unet_weighted", config.params) is None


# ----------------------------------------------------------- pipeline

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    yield make_workspace(root)
    shutil.rmtree(root)


def _four_cpus(monkeypatch):
    monkeypatch.setattr(pipelines, "visible_devices",
                        lambda device: [device] * 4)


@pytest.mark.parametrize("forward", ["float", "int8"])
def test_evaluate_spatial_equals_single_device(workspace, monkeypatch,
                                               forward):
    """evaluate with spatial_serving: 1 over 4 CPU devices (the CPU
    counted four times, as the JAX tests count 8 virtual devices) writes
    the instances of the single-device evaluate (scores 1e-5 relative)
    and gives its AP/AR, as tests/test_serving.py asserts for JAX, with
    the float and the int8 forward (quantized_serving: 1); its serve
    program is spatial over those devices."""
    ws = workspace
    extra = {"quantized_serving": 1} if forward == "int8" else {}
    single = PipelineManager(write_config(ws, f"single_{forward}", extra))
    ap, ar = single.evaluate("unet_weighted", False, None)
    _four_cpus(monkeypatch)
    spatial = PipelineManager(write_config(
        ws, f"spatial_{forward}", {**extra, "spatial_serving": 1}))
    got = spatial.evaluate("unet_weighted", False, None)
    assert got == (ap, ar)
    want = json.loads((ws["root"] / f"single_{forward}" / "prediction.json"
                       ).read_text())
    preds = json.loads((ws["root"] / f"spatial_{forward}" /
                        "prediction.json").read_text())
    assert len(preds) == len(want) > 0
    for p, w in zip(preds, want):
        assert (p["image_id"], p["segmentation"], p["bbox"]) == (
            w["image_id"], w["segmentation"], w["bbox"])
        assert abs(p["score"] - w["score"]) <= 1e-5 * abs(w["score"])
    pipe = PIPELINES["unet_weighted"]["inference"](build_config(
        write_config(ws, f"spatial_{forward}",
                     {**extra, "spatial_serving": 1})))
    serve = pipe.serve_program()
    assert serve.spatial is not None and len(serve.mesh) == 4
    assert isinstance(serve.program.model_probs, QuantizedProbs) == (
        forward == "int8")


def test_export_with_spatial_serving_writes_the_same_programs(
        workspace, monkeypatch, tmp_path):
    """export stays single-device: with spatial_serving: 1 it writes the
    manifest and programs (their graphs) of the plain export."""
    _four_cpus(monkeypatch)
    out = {}
    for name, extra in (("plain", {}), ("spatial", {"spatial_serving": 1})):
        config = build_config(write_config(workspace, f"export_{name}",
                                           extra))
        pipe = PIPELINES["unet_weighted"]["inference"](config)
        manifest = export_serving_artifact(pipe, config,
                                           str(tmp_path / name))
        program = torch.export.load(str(tmp_path / name /
                                        "serve_b4.pt2"))
        out[name] = (manifest, str(program.graph_module.code))
    assert out["plain"] == out["spatial"]


def test_daemon_keeps_every_bucket_with_spatial_serving(workspace,
                                                        monkeypatch):
    """The daemon over a spatial pipeline keeps the buckets that do not
    divide over its 4 devices (mapping_tpu/infer/daemon.py keeps them
    too), and serves through the spatial program."""
    _four_cpus(monkeypatch)
    config = build_config(write_config(
        workspace, "daemon", {"spatial_serving": 1,
                              "serve_batch_buckets": "1,3"}))
    pipe = PIPELINES["unet_weighted"]["inference"](config)
    daemon = port_daemon.daemon_from_pipeline(pipe, config, port=0)
    try:
        assert daemon.batcher._buckets == [1, 3, 4]
        assert pipe.serve_program().spatial is not None
    finally:
        daemon.server.server_close()
        daemon.batcher.close()
