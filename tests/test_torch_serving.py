"""The serving slice as a whole: uint8 tiles -> instances, port vs JAX.

The same random UNetResNet34 weights (BatchNorm statistics randomised)
serve the same uint8 tiles through the JAX package's FusedServe, with a
BN-folded Flax probabilities function built the way
mapping_tpu/train/trainer.py `probs_apply_fn` builds one, and through the
port's UNetPipeline on the CPU, in float32.

Tolerances: probabilities 1e-4 absolute. Labels agree except at pixels
whose resized probability lies within 1e-4 of the 0.5 threshold, where the
two frameworks' float32 rounding may fall on either side. Images whose
labels agree in full must agree in areas exactly, in scores (means of
those probabilities) to 1e-4 relative, and in the COCO annotations written
from them (mapping_tpu.infer.annotations).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapping_tpu.constants import CATEGORY_IDS
from mapping_tpu.data.augment import resize_bilinear as jax_resize
from mapping_tpu.data.loader import _infer_batch_resize
from mapping_tpu.infer.annotations import labeled_to_annotations
from mapping_tpu.infer.serving import FusedServe as JaxFusedServe
from mapping_tpu.models.fold_bn import fold_batch_stats as jax_fold
from mapping_tpu.models.torch_convert import convert_unet_resnet
from mapping_tpu.models.unet_resnet import UNetResNet as FlaxUNetResNet
from mapping_tpu_torch.models.unet_resnet import UNetResNet
from mapping_tpu_torch.pipelines import UNetPipeline

torch.set_num_threads(2)

PARAMS = {"encoder": "ResNet34", "model_dtype": "float32", "image_h": 64,
          "image_w": 64, "batch_size_inference": 2}
POST = dict(target_size=(300, 300), category_layers=(1, 1),
            active_layers=(1,))


def _tiles(n=4, hw=96, seed=0):
    """Blobby uint8 tiles: upsampled low-resolution noise."""
    low = np.random.RandomState(seed).rand(n, hw // 16, hw // 16, 3)
    up = np.asarray(jax_resize(jnp.asarray(low, jnp.float32), (hw, hw)))
    return (up * 255).astype(np.uint8)


def _state_dict(images, seed=0):
    """Random ResNet34 UNet weights whose logit difference over the batch
    has mean 0 and standard deviation 4, so that about half the pixels are
    foreground and probabilities span (0, 1) without saturating."""
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    model = UNetResNet(34).eval()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            m.weight.data = torch.from_numpy(
                1 + 0.1 * rng.randn(c).astype(np.float32))
            m.bias.data = torch.from_numpy(0.1 * rng.randn(c).astype(np.float32))
            m.running_mean = torch.from_numpy(
                0.1 * rng.randn(c).astype(np.float32))
            m.running_var = torch.from_numpy(
                (0.75 + 0.5 * rng.rand(c)).astype(np.float32))
    with torch.no_grad():
        x = torch.tensor(images).permute(0, 3, 1, 2)
        logits = model(x)
        diff = logits[:, 1] - logits[:, 0]
        centre, scale = diff.mean(), 4.0 / diff.std()
        w, b = model.final.weight, model.final.bias
        w[1] = w[0] + scale * (w[1] - w[0])
        b[1] = b[0] + scale * (b[1] - b[0] - centre)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _jax_serve(state):
    params, stats = convert_unet_resnet(state, 34, True)
    folded = jax_fold(params, stats)
    model = FlaxUNetResNet(encoder_depth=34, dtype=jnp.float32, fold_bn=True)

    def probs_fn(p, images):  # as UNetTrainer.probs_apply_fn builds it
        logits = model.apply({"params": p}, images, train=False)
        return jax.nn.softmax(logits.astype(jnp.float32), axis=-1)

    return JaxFusedServe(probs_fn, lambda: folded, **POST), probs_fn, folded


@pytest.fixture(scope="module")
def slice_outputs():
    tiles = _tiles()
    size = (PARAMS["image_h"], PARAMS["image_w"])
    images = np.asarray(_infer_batch_resize(jnp.asarray(tiles), size)["image"])
    state = _state_dict(images)
    jax_serve, jax_probs_fn, folded = _jax_serve(state)
    pipe = UNetPipeline(PARAMS, state, device="cpu")
    bs = PARAMS["batch_size_inference"]
    batches = [tiles[i:i + bs] for i in range(0, len(tiles), bs)]
    jax_outs = [jax_serve(_infer_batch_resize(jnp.asarray(b), size)["image"])
                for b in batches]
    port_outs = [pipe.serve(pipe.preprocess(b)) for b in batches]
    return dict(
        tiles=tiles, pipe=pipe, state=state,
        jax=[np.concatenate(o) for o in zip(*jax_outs)],
        port=[np.concatenate(o) for o in zip(*port_outs)],
        jax_probs=np.asarray(jax_probs_fn(folded, jnp.asarray(images))),
        port_probs=pipe.probs(pipe.preprocess(tiles)).numpy())


def test_probabilities_match(slice_outputs):
    jp, pp = slice_outputs["jax_probs"], slice_outputs["port_probs"]
    assert pp.shape == jp.shape and pp.dtype == np.float32
    np.testing.assert_allclose(pp, jp, atol=1e-4, rtol=0)
    assert 0.2 < (jp[..., 1] > 0.5).mean() < 0.8


def _same_images(out):
    """Indices of the images whose labels agree in full; asserts that any
    disagreement lies at near-threshold pixels and that most images agree."""
    resized = np.asarray(jax_resize(jnp.asarray(out["jax_probs"]),
                                    POST["target_size"]))
    near = np.abs(resized[..., 1] - 0.5) < 1e-4
    jl, pl = out["jax"][0][:, 1], out["port"][0][:, 1]
    assert not (pl != jl)[~near].any()
    same = [i for i in range(len(jl)) if np.array_equal(pl[i], jl[i])]
    assert len(same) >= len(jl) - 1
    return same


def test_labels_scores_areas_match(slice_outputs):
    (jl, js, ja), (pl, ps, pa) = slice_outputs["jax"], slice_outputs["port"]
    assert pl.dtype == jl.dtype == np.int16
    assert not jl[:, 0].any() and not pl[:, 0].any()  # background inactive
    assert jl[:, 1].max(axis=(1, 2)).min() > 0
    same = _same_images(slice_outputs)
    np.testing.assert_array_equal(pa[same], ja[same])
    np.testing.assert_allclose(ps[same], js[same], rtol=1e-4, atol=0)


def test_annotations_match(slice_outputs):
    (jl, js, _), (pl, ps, _) = slice_outputs["jax"], slice_outputs["port"]
    for i in _same_images(slice_outputs):
        want = labeled_to_annotations(i, jl[i], js[i], CATEGORY_IDS, (1, 1))
        got = labeled_to_annotations(i, pl[i], ps[i], CATEGORY_IDS, (1, 1))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["segmentation"] == w["segmentation"]
            assert g["bbox"] == w["bbox"]
            np.testing.assert_allclose(g["score"], w["score"], rtol=1e-4)


def test_transform_yields_trimmed_rows(slice_outputs):
    """transform(): one batch in flight, per image (labels, one score list
    per layer trimmed to the layer's instance count)."""
    labels, scores = slice_outputs["port"][:2]
    rows = list(slice_outputs["pipe"].transform(slice_outputs["tiles"]))
    assert len(rows) == len(labels)
    for (lab, trimmed), lab_b, sc_b in zip(rows, labels, scores):
        np.testing.assert_array_equal(lab, lab_b)
        assert [len(t) for t in trimmed] == [int(l.max()) for l in lab_b]
        np.testing.assert_array_equal(trimmed[1], sc_b[1][:len(trimmed[1])])


@pytest.mark.parametrize("dtype,tf32_in_forward", [("float32", False),
                                                   ("bfloat16", True)])
def test_tf32_off_only_inside_float32_forward(slice_outputs, dtype,
                                              tf32_in_forward):
    """A float32 pipeline turns TF32 off for its own forward and leaves the
    process's settings as they were."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    seen = []
    try:
        for f in flags:
            f.allow_tf32 = True
        pipe = UNetPipeline({**PARAMS, "model_dtype": dtype},
                            slice_outputs["state"], device="cpu")
        pipe.model.register_forward_hook(
            lambda *_: seen.append([f.allow_tf32 for f in flags]))
        pipe.probs(pipe.preprocess(slice_outputs["tiles"][:1]))
        after = [f.allow_tf32 for f in flags]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    assert seen == [[tf32_in_forward] * 2]
    assert after == [True, True]


def test_unported_settings_raise():
    state = {}
    with pytest.raises(NotImplementedError, match="ROADMAP item 21"):
        UNetPipeline({"quantized_serving": 1}, state, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 16"):
        UNetPipeline({"data_parallel": 1}, state, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
        UNetPipeline({"loader_mode": "crop_and_pad"}, state, device="cpu")


def test_cuda_pipeline_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        UNetPipeline(PARAMS, {}, device="cuda")


def test_port_imports_without_jax():
    """Every module of mapping_tpu_torch imports with jax and flax
    blocked, and none imports the JAX package: the port must run where
    neither is installed."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import mapping_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'mapping_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert {'mapping_tpu_torch.kernels.ccl',\n"
        "        'mapping_tpu_torch.kernels.conv_dw',\n"
        "        'mapping_tpu_torch.ops.conv_dw',\n"
        "        'mapping_tpu_torch.train.losses',\n"
        "        'mapping_tpu_torch.train.state',\n"
        "        'mapping_tpu_torch.train.step',\n"
        "        'mapping_tpu_torch.train.trainer',\n"
        "        'mapping_tpu_torch.tools.dw_probe'} <= set(names)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'mapping_tpu') and sys.modules[k] is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 24


def test_constants_equal_jax_package():
    from mapping_tpu import constants as jax_constants
    from mapping_tpu_torch import constants

    for name in ("CATEGORY_IDS", "CATEGORY_LAYERS", "MEAN", "STD"):
        assert getattr(constants, name) == getattr(jax_constants, name)
