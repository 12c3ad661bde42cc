"""The serving slice as a whole: uint8 tiles -> instances, port vs JAX.

The same random UNetResNet34 weights (BatchNorm statistics randomised)
serve the same uint8 tiles through the JAX package's FusedServe, with a
BN-folded Flax probabilities function built the way
mapping_tpu/train/trainer.py `probs_apply_fn` builds one, and through the
port's `unet_weighted` UNetPipeline on the CPU, in float32.

Tolerances: probabilities 1e-4 absolute. Labels agree except at pixels
whose resized probability lies within 1e-4 of the 0.5 threshold, where the
two frameworks' float32 rounding may fall on either side. Images whose
labels agree in full must agree in areas exactly, in scores (means of
those probabilities) to 1e-4 relative, and in the COCO annotations written
from them (mapping_tpu.infer.annotations).
"""

import subprocess
import sys
from pathlib import Path

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
from mapping_tpu_torch.config import build_config
from mapping_tpu_torch.models.unet_resnet import UNetResNet
from mapping_tpu_torch.pipelines import PIPELINES

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


def _pipeline(params, state, device="cpu"):
    """The port's unet_weighted inference pipeline for the JAX parameter
    dict `params`, serving the weights `state`."""
    config = build_config(overrides={**params, "device": device})
    pipe = PIPELINES["unet_weighted"]["inference"](config)
    return pipe.set_weights(state) if state else pipe


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
    pipe = _pipeline(PARAMS, state)
    bs = PARAMS["batch_size_inference"]
    batches = [tiles[i:i + bs] for i in range(0, len(tiles), bs)]
    jax_outs = [jax_serve(_infer_batch_resize(jnp.asarray(b), size)["image"])
                for b in batches]
    serve, preprocess = pipe.serve_program(), pipe.loader.infer_preprocess
    port_outs = [serve(preprocess(b)) for b in batches]
    return dict(
        tiles=tiles, pipe=pipe, state=state,
        jax=[np.concatenate(o) for o in zip(*jax_outs)],
        port=[np.concatenate(o) for o in zip(*port_outs)],
        jax_probs=np.asarray(jax_probs_fn(folded, jnp.asarray(images))),
        port_probs=pipe.trainer.probs_apply_fn()(preprocess(tiles)).numpy())


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
    """transform_arrays(): one batch in flight, per image (labels, one
    score list per layer trimmed to the layer's instance count)."""
    labels, scores = slice_outputs["port"][:2]
    rows = list(slice_outputs["pipe"].transform_arrays(
        slice_outputs["tiles"]))
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
        pipe = _pipeline({**PARAMS, "model_dtype": dtype},
                         slice_outputs["state"])
        pipe.trainer.serving_model().register_forward_hook(
            lambda *_: seen.append([f.allow_tf32 for f in flags]))
        pipe.trainer.probs_apply_fn()(
            pipe.loader.infer_preprocess(slice_outputs["tiles"][:1]))
        after = [f.allow_tf32 for f in flags]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    assert seen == [[tf32_in_forward] * 2]
    assert after == [True, True]


def test_unported_settings_raise():
    """No setting of the JAX package is left unported: spatial serving
    (item 16b) builds, and its serve program on the one CPU refuses as the
    JAX package's does on one device (tests/test_torch_spatial.py runs it
    over CPU devices); data_parallel (item 16) builds, on the CPU without
    a mesh (tests/test_torch_parallel.py runs it), and int8 serving (item
    21) builds (tests/test_torch_quantize.py runs it)."""
    state = {}
    spatial = _pipeline({"spatial_serving": 1}, state)
    with pytest.raises(ValueError, match="needs more than one device"):
        spatial.serve_program()
    assert _pipeline({"data_parallel": 1}, state).trainer.mesh is None
    assert _pipeline({"quantized_serving": 1}, state).quantized


def test_cuda_pipeline_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _pipeline(PARAMS, {}, device="cuda")


def test_port_imports_without_jax():
    """Every module of mapping_tpu_torch, the CLI included, imports with
    jax, flax, pandas, yaml, click, PIL, msgpack, joblib, imageio and
    sklearn blocked, and none imports the JAX package: the port must run
    where none is installed."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'flax', 'pandas', 'yaml', 'click', 'PIL', "
        "'msgpack', 'joblib', 'imageio', 'sklearn'):\n"
        "    sys.modules[m] = None\n"
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
        "        'mapping_tpu_torch.tools.dw_probe',\n"
        "        'mapping_tpu_torch.main', 'mapping_tpu_torch.manager',\n"
        "        'mapping_tpu_torch.config',\n"
        "        'mapping_tpu_torch.train.checkpoint',\n"
        "        'mapping_tpu_torch.utils.png',\n"
        "        'mapping_tpu_torch.utils.webp',\n"
        "        'mapping_tpu_torch.utils.bmp',\n"
        "        'mapping_tpu_torch.utils.gif',\n"
        "        'mapping_tpu_torch.utils.jp2',\n"
        "        'mapping_tpu_torch.prep.targets',\n"
        "        'mapping_tpu_torch.ops.edt',\n"
        "        'mapping_tpu_torch.utils.ndpickle',\n"
        "        'mapping_tpu_torch.train.callbacks',\n"
        "        'mapping_tpu_torch.pipelines',\n"
        "        'mapping_tpu_torch.scoring',\n"
        "        'mapping_tpu_torch.data.tta',\n"
        "        'mapping_tpu_torch.utils.native_gbm',\n"
        "        'mapping_tpu_torch.infer.daemon',\n"
        "        'mapping_tpu_torch.infer.artifact',\n"
        "        'mapping_tpu_torch.utils.resize',\n"
        "        'mapping_tpu_torch.models.vgg',\n"
        "        'mapping_tpu_torch.models.scratch',\n"
        "        'mapping_tpu_torch.models.unetpp',\n"
        "        'mapping_tpu_torch.utils.visualize',\n"
        "        'mapping_tpu_torch.models.quantize',\n"
        "        'mapping_tpu_torch.ops.crf',\n"
        "        'mapping_tpu_torch.ops.resize',\n"
        "        'mapping_tpu_torch.graph',\n"
        "        'mapping_tpu_torch.sklearn_models',\n"
        "        'mapping_tpu_torch.utils.misc',\n"
        "        'mapping_tpu_torch.parallel',\n"
        "        'mapping_tpu_torch.parallel.mesh',\n"
        "        'mapping_tpu_torch.parallel.distributed',\n"
        "        'mapping_tpu_torch.parallel.dryrun',\n"
        "        'mapping_tpu_torch.parallel.spatial',\n"
        "        'mapping_tpu_torch.infer.sharded',\n"
        "        'mapping_tpu_torch.utils.jpeg',\n"
        "        'mapping_tpu_torch.kernels.jpeg',\n"
        "        'mapping_tpu_torch.utils.tiff',\n"
        "        'mapping_tpu_torch.utils.native_decode',\n"
        "        'mapping_tpu_torch.tools.scale_rehearsal'} <= set(names)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'mapping_tpu', 'pandas', 'yaml', 'click', 'PIL', "
        "'msgpack', 'joblib', 'imageio', 'sklearn') and sys.modules[k] is "
        "not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 24


def test_chip_smoke_imports_without_jax_and_refuses_without_a_card(tmp_path):
    """chip_smoke.py imports nothing of jax, flax, PIL or the JAX package,
    and run without a CUDA card (as here), or from a directory that holds
    it alone, exits non-zero before printing any result."""
    root = Path(__file__).resolve().parents[1]
    block = ("import sys, runpy\n"
             "for m in ('jax', 'flax', 'mapping_tpu', 'PIL'):\n"
             "    sys.modules[m] = None\n"
             "import torch\n"
             "torch.cuda.is_available = lambda: {card}\n"
             "sys.argv = ['chip_smoke.py']\n"
             "runpy.run_path({path!r}, run_name='__main__')\n")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((root / "chip_smoke.py").read_text())
    for card, path, reason in ((False, root / "chip_smoke.py", "is False"),
                               (True, alone, "no mapping_tpu_torch")):
        out = subprocess.run(
            [sys.executable, "-c", block.format(card=card, path=str(path))],
            capture_output=True, text=True, timeout=120, cwd=tmp_path)
        assert out.returncode != 0 and reason in out.stderr, out.stderr
        assert out.stdout == ""
    # the modules phase 12 (the zoo, visualize, parity_drill) drives
    # import with the same packages blocked
    zoo = ("import sys, importlib\n"
           "for m in ('jax', 'flax', 'mapping_tpu', 'PIL'):\n"
           "    sys.modules[m] = None\n"
           f"sys.path.insert(0, {str(root)!r})\n"
           "import runpy\n"
           f"runpy.run_path({str(root / 'chip_smoke.py')!r})\n"
           "for n in ('models.vgg', 'models.scratch', 'models.unetpp',\n"
           "          'models.registry', 'utils.visualize', 'manager',\n"
           "          'main'):\n"
           "    importlib.import_module('mapping_tpu_torch.' + n)\n"
           "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', "
           "'flax', 'mapping_tpu', 'PIL') and sys.modules[k] is not None]\n"
           "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", zoo], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr


def test_constants_equal_jax_package():
    from mapping_tpu import constants as jax_constants
    from mapping_tpu_torch import constants

    for name in ("CATEGORY_IDS", "CATEGORY_LAYERS", "MEAN", "STD",
                 "SIZE_COLUMNS", "X_COLUMNS", "Y_COLUMNS",
                 "Y_COLUMNS_SCORING", "SEED"):
        assert getattr(constants, name) == getattr(jax_constants, name)
