"""The zoo through the port's pipelines and trainer, against the JAX
package.

- `evaluate` of a VGG11 and a `from_scratch` experiment (the config's
  defaults: UNet11 at 32 filters; the scratch UNet at 16 filters, 4
  levels, pool 3/2, BatchNorm, dropout 0.1) from a JAX-written
  `unet.msgpack`, on the synthetic fixture at 64^2, float32, device cpu:
  the same prediction.json instances under the per-pixel near-threshold
  rule of tests/test_torch_evaluate.py, and AP/AR equal (0.05 where an
  image is excused). The VGG11 weights are a reference torch UNet11
  (tests/torch_ref_models.py) converted by the JAX package's
  `convert_full_checkpoint`; the scratch weights are seeded port weights
  carried into Flax by name. Both have their last layer centred so that
  about half the pixels are building, and the JAX trainer saves them.
- The VGG pretrained-encoder graft: exactly the JAX trainer's.
- `import_checkpoint` of reference UNet11 / UNetVGG16 files: the weights
  the JAX package's converter makes of them, exactly (its trainer's
  import of a VGG file fails on the empty batch_stats tree, a reference
  fault); the families JAX refuses, refused.
- UNetMultitask trains in both packages but cannot be validated or served
  in either.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import jax

from mapping_tpu.manager import PipelineManager as JaxManager
from mapping_tpu.pipelines import PIPELINES as JAX_PIPELINES
from mapping_tpu.config import build_config as jax_build_config
from mapping_tpu.models.torch_convert import convert_full_checkpoint
from mapping_tpu_torch.config import build_config
from mapping_tpu_torch.data.loader import infer_batch_resize, load_image
from mapping_tpu_torch.models import convert
from mapping_tpu_torch.models.registry import build_network
from mapping_tpu_torch.pipelines import PIPELINES
from mapping_tpu_torch.train.step import MULTI_HEAD
from mapping_tpu_torch.train.trainer import UNetTrainer
from tests.fixtures.synthetic import generate
from tests.test_torch_evaluate import (PIPELINE, assert_same_instances,
                                       assert_same_scores, run_jax, run_port,
                                       served_probabilities, write_config)
from tests.test_torch_zoo import _named_to_flax
from tests.torch_ref_models import TorchUNet11, TorchUNetVGG16
from tests.torch_guards import drop_tmp_path  # noqa: F401 (autouse)

torch.set_num_threads(2)

LOSS_PARAMS = {"w0": 50, "sigma": 10, "imsize": (64, 64), "dice_weight": 0.2,
               "bce_weight": 1.0, "smooth": 1, "dice_activation": "softmax"}


def _centre(model, head, images):
    """Rescale the 1x1 `head` so that the logit difference over `images`
    (NCHW) has mean 0 and standard deviation 4."""
    with torch.no_grad():
        logits = model(images)
        diff = logits[:, 1] - logits[:, 0]
        centre, scale = diff.mean(), 4.0 / diff.std()
        w, b = head.weight, head.bias
        w[1] = w[0] + scale * (w[1] - w[0])
        b[1] = b[0] + scale * (b[1] - b[0] - centre)


def _randomize_bn(model, seed):
    rng = np.random.RandomState(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            m.weight.data = torch.from_numpy(
                1 + 0.1 * rng.randn(c).astype(np.float32))
            m.bias.data = torch.from_numpy(0.1 * rng.randn(c)
                                           .astype(np.float32))
            m.running_mean = torch.from_numpy(0.1 * rng.randn(c)
                                              .astype(np.float32))
            m.running_var = torch.from_numpy((0.75 + 0.5 * rng.rand(c))
                                             .astype(np.float32))


def _workspace(root, encoder):
    """The fixture, JAX metadata and a JAX `unet.msgpack` of `encoder`
    under root/jax_cache (what write_config links experiments to)."""
    data_dir = root / "data"
    generate(str(data_dir), n_train=1, n_val=6, seed=7)
    paths = sorted(str(p) for p in (data_dir / "val" / "images").iterdir())
    tiles = np.stack([load_image(p) for p in paths])
    images = infer_batch_resize(torch.from_numpy(tiles), (64, 64)).permute(
        0, 3, 1, 2)
    ws = {"root": root, "data_dir": data_dir, "tiles": tiles,
          "extra": {"encoder": encoder}}
    config = write_config(ws, "jax_cache", ws["extra"])
    jax_manager = JaxManager(config)
    jax_manager.prepare_metadata(True, True)
    torch.manual_seed(0)
    jpipe = JAX_PIPELINES[PIPELINE]["inference"](jax_build_config(config))
    jpipe.trainer._ensure_state()
    state = jpipe.trainer.state
    if encoder == "VGG11":
        model = TorchUNet11().eval()
        _centre(model, model.final, images)
        state = state.replace(params=convert_full_checkpoint(
            {k: v.numpy() for k, v in model.state_dict().items()},
            encoder)[0])
    else:
        model = build_network(build_config(config).unet["model_params"])
        model.eval()
        _randomize_bn(model, 0)
        _centre(model, model.output, images)
        params, stats = _named_to_flax(
            {k: v.numpy() for k, v in model.state_dict().items()},
            jax.device_get(state.params), jax.device_get(state.batch_stats))
        state = state.replace(params=params, batch_stats=stats)
    jpipe.trainer.state = state
    jpipe.trainer.save(jpipe.trainer_cache_path)
    return ws


@pytest.fixture(scope="module")
def native_libs():
    from mapping_tpu.utils import native as jax_native

    for _ in range(3):  # a worker that lost the JAX package's build race
        if jax_native._lib.build():
            break
    assert jax_native._lib.available()


@pytest.mark.parametrize("encoder", ["VGG11", "from_scratch"])
def test_evaluate_matches_jax(native_libs, tmp_path, encoder):
    ws = _workspace(tmp_path, encoder)
    extra = ws["extra"]
    ap, ar, want = run_jax(ws, "jax_eval", extra)
    got_ap, got_ar, got = run_port(ws, "port_eval", extra)
    ids = sorted({p["image_id"] for p in want})
    assert ids == list(range(1, 7))
    excused = assert_same_instances(
        got, want, served_probabilities(ws, PIPELINE, extra), ids)
    assert_same_scores([got_ap, got_ar], [ap, ar], excused)
    shutil.rmtree(tmp_path / "jax_cache")


# ------------------------------------------------- pretrained encoders

def _torchvision_vgg(path, cfg, seed=0, bad=None):
    """A torchvision vgg state_dict of random values: `features.N` convs
    and a classifier head."""
    from mapping_tpu_torch.models.vgg import vgg_features

    gen = torch.Generator().manual_seed(seed)
    state = {f"features.{k}": 0.1 * torch.randn(v.shape, generator=gen)
             for k, v in vgg_features(cfg).state_dict().items()}
    state["classifier.0.weight"] = torch.randn((16, 8), generator=gen)
    state["classifier.0.bias"] = torch.randn((16,), generator=gen)
    if bad:
        state[bad] = torch.zeros(7, 7, 3, 3)
    torch.save(state, path)
    return state


def _jax_trainer(encoder, **kw):
    from mapping_tpu.train.trainer import UNetTrainer as JaxTrainer

    return JaxTrainer(model_params={"encoder": encoder, "dtype": "float32",
                                    **kw.pop("model_params", {})},
                      optimizer_params={"lr": 5e-4}, loss_params=LOSS_PARAMS,
                      training_config={"epochs": 1}, input_size=(64, 64),
                      **kw)


def _port_trainer(encoder, **kw):
    return UNetTrainer(model_params={"encoder": encoder, "dtype": "float32",
                                     **kw.pop("model_params", {})},
                       optimizer_params={"lr": 5e-4}, loss_params=LOSS_PARAMS,
                       training_config={"epochs": 1}, input_size=(64, 64),
                       device="cpu", **kw)


@pytest.mark.parametrize("encoder", ["VGG11", "VGG16"])
def test_vgg_pretrained_graft_matches_jax(tmp_path, encoder):
    """`features.N` of a torchvision file become `encoder.N` (the
    classifier dropped), exactly as the JAX trainer grafts `conv_N`; the
    decoder keeps its seeded weights."""
    from mapping_tpu_torch.models.vgg import VGG11_CFG, VGG16_CFG

    path = tmp_path / f"{encoder.lower()}.pth"
    source = _torchvision_vgg(path, VGG11_CFG if encoder == "VGG11"
                              else VGG16_CFG)
    jax_trainer = _jax_trainer(encoder, pretrained_weights=str(path))
    jax_trainer._ensure_state()
    params = jax.device_get(jax_trainer.state.params)
    want = convert.state_dict_for_encoder({"encoder": encoder}, params, {})
    trainer = _port_trainer(encoder, pretrained_weights=str(path))
    decoder = {k: v.clone() for k, v in trainer.model.state_dict().items()
               if not k.startswith("encoder.")}
    got = trainer.state_dict()
    grafted = [k for k in got if k.startswith("encoder.")]
    assert grafted
    for k in grafted:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(),
                                      source["features." + k[8:]].numpy())
    for k, v in decoder.items():
        assert torch.equal(got[k], v), k


def test_pretrained_graft_refusals_match_jax(tmp_path):
    """A VGG file with a wrong shape raises in both packages; the families
    the JAX trainer cannot graft raise the same ValueError in the port."""
    from mapping_tpu_torch.models.vgg import VGG11_CFG

    path = tmp_path / "bad.pth"
    _torchvision_vgg(path, VGG11_CFG, bad="features.3.weight")
    with pytest.raises(ValueError, match="shape mismatch"):
        _jax_trainer("VGG11", pretrained_weights=str(path))._ensure_state()
    with pytest.raises(ValueError, match="shape mismatch"):
        _port_trainer("VGG11", pretrained_weights=str(path)).state_dict()
    for encoder in ("from_scratch", "UNetPlusPlus"):
        message = f"pretrained weights unsupported for encoder {encoder!r}"
        with pytest.raises(ValueError) as jax_err:
            _jax_trainer(encoder, pretrained_weights=str(path))._ensure_state()
        assert str(jax_err.value) == message
        with pytest.raises(ValueError) as port_err:
            _port_trainer(encoder, pretrained_weights=str(path)).state_dict()
        assert str(port_err.value) == message


# ---------------------------------------------------- reference imports

@pytest.mark.parametrize("encoder,is_deconv", [("VGG11", True),
                                               ("VGG16", True),
                                               ("VGG16", False)])
def test_import_reference_vgg_checkpoint(tmp_path, encoder, is_deconv):
    """A reference UNet11 / UNetVGG16 file ("module."-prefixed, as
    DataParallel saves it) loads unchanged into the port and holds the
    weights the JAX package's `convert_full_checkpoint` makes of it,
    exactly. The JAX trainer's own import of the file raises: it maps the
    converter's empty batch_stats dict onto its state's empty FrozenDict
    (a reference fault; the port imports what the converter means)."""
    from mapping_tpu.models.torch_convert import load_torch_file

    torch.manual_seed(1)
    ref = (TorchUNet11() if encoder == "VGG11"
           else TorchUNetVGG16(is_deconv=is_deconv))
    path = tmp_path / "reference.pth"
    torch.save({"module." + k: v for k, v in ref.state_dict().items()}, path)
    jax_trainer = _jax_trainer(encoder,
                               model_params={"is_deconv": is_deconv})
    with pytest.raises(ValueError, match="FrozenDict"):
        jax_trainer.import_torch_checkpoint(str(path))
    params, stats = convert_full_checkpoint(load_torch_file(str(path)),
                                            encoder)
    assert stats == {}
    want = convert.state_dict_for_encoder(
        {"encoder": encoder, "is_deconv": is_deconv}, params, stats)
    trainer = _port_trainer(encoder,
                            model_params={"is_deconv": is_deconv})
    trainer.import_torch_checkpoint(path)
    got = trainer.state_dict()
    assert sorted(got) == sorted(want) == sorted(ref.state_dict())
    for k, v in ref.state_dict().items():
        assert torch.equal(got[k], v), k
        np.testing.assert_array_equal(want[k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("encoder", ["from_scratch", "UNetPlusPlus"])
def test_import_checkpoint_refusals_match_jax(tmp_path, encoder):
    path = tmp_path / "any.pth"
    torch.save(build_network({"encoder": encoder}).state_dict(), path)
    with pytest.raises(ValueError) as jax_err:
        _jax_trainer(encoder).import_torch_checkpoint(str(path))
    with pytest.raises(ValueError) as port_err:
        _port_trainer(encoder).import_torch_checkpoint(path)
    assert str(port_err.value) == str(jax_err.value)
    assert "checkpoint import unsupported" in str(port_err.value)


# ------------------------------------------------------------ multi-head

MULTI = {"n_filters": 4, "repeat_blocks": 2, "nr_outputs": 2, "dropout": 0.0}


def _batch(seed=0, n=2, hw=64):
    rng = np.random.RandomState(seed)
    image = rng.randn(n, hw, hw, 3).astype(np.float32)
    mask = (image.mean(-1) > 0).astype(np.float32)
    target = np.stack([mask, np.zeros_like(mask), 4 * mask], -1)
    return image, target


def test_multi_head_trains_but_is_refused_for_validation_and_serving(
        tmp_path):
    """UNetMultitask takes a train step with a finite loss in both
    packages; the JAX eval and predict steps then fail on its list of
    logits, and the port refuses at the same points with MULTI_HEAD: the
    validation loss, the serving function (FusedServe, the per-epoch mAP)
    and the export."""
    from mapping_tpu.train.trainer import UNetTrainer as JaxTrainer
    from mapping_tpu_torch.infer.artifact import export_serving_artifact

    image, target = _batch()
    common = dict(model_params={"encoder": "from_scratch",
                                "dtype": "float32", **MULTI},
                  optimizer_params={"lr": 5e-4}, loss_params=LOSS_PARAMS,
                  training_config={"epochs": 1}, input_size=(64, 64))
    jax_trainer = JaxTrainer(**common)
    jax_trainer.fit(([{"image": image, "target": target}], 1))
    assert np.isfinite(jax_trainer.state.step)
    val = ([{"image": image, "target": target}], 1)
    with pytest.raises(Exception):
        jax_trainer.score_validation(val)
    with pytest.raises(Exception):
        jax_trainer.predict_probs_fn()(image)

    trainer = UNetTrainer(device="cpu", **common)
    batch = {"image": torch.from_numpy(image),
             "target": torch.from_numpy(target)}
    trainer.fit(([batch], 1))
    assert len(trainer.train_losses) == 1
    assert np.isfinite(trainer.train_losses[0])
    with pytest.raises(TypeError, match="multi-head"):
        trainer.score_validation(([batch], 1))
    with pytest.raises(TypeError, match="multi-head"):
        trainer.probs_apply_fn()
    with pytest.raises(TypeError) as err:
        trainer.probs_module()
    assert str(err.value) == MULTI_HEAD

    config = build_config(None, {
        "encoder": "from_scratch", "nr_unet_outputs": 2, "n_filters": 4,
        "repeat_blocks": 2, "model_dtype": "float32", "image_h": 64,
        "image_w": 64, "batch_size_inference": 2, "device": "cpu",
        "experiment_dir": str(tmp_path / "exp")})
    pipe = PIPELINES[PIPELINE]["inference"](config)
    pipe.set_weights(trainer.state_dict())
    tiles = np.zeros((2, 300, 300, 3), np.uint8)
    with pytest.raises(TypeError, match="multi-head"):
        list(pipe.transform_arrays(tiles))
    with pytest.raises(TypeError, match="multi-head"):
        export_serving_artifact(pipe, config, str(tmp_path / "artifact"))


@pytest.mark.parametrize("encoder,extra", [
    ("VGG16", {}), ("UNetPlusPlus", {"n_filters": 4, "depth": 3}),
    ("from_scratch", {**MULTI, "dropout": 0.1})])
def test_trainer_loads_a_jax_cache_of_each_family(tmp_path, encoder, extra):
    """A JAX UNetTrainer's `save` (unet.msgpack) of VGG16, UNet++ and
    UNetMultitask read by the port's `load`: the state_dict of
    `state_dict_for_encoder`, and eval-mode float32 logits within 1e-4
    of the largest |logit| of the JAX model's (each head)."""
    from mapping_tpu_torch.train.checkpoint import load_flax_weights

    jax_trainer = _jax_trainer(encoder, model_params=extra)
    jax_trainer._ensure_state()
    path = str(tmp_path / "unet.msgpack")
    jax_trainer.save(path)
    trainer = _port_trainer(encoder, model_params=extra).load(path)
    want = convert.state_dict_for_encoder({"encoder": encoder},
                                          *load_flax_weights(path))
    got = trainer.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    state = jax_trainer.state
    variables = {"params": state.params}
    if jax.tree_util.tree_leaves(state.batch_stats):
        variables["batch_stats"] = state.batch_stats
    logits = jax_trainer.model.apply(variables, x, train=False)
    with torch.no_grad():
        out = trainer.model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    logits = logits if isinstance(logits, list) else [logits]
    out = out if isinstance(out, list) else [out]
    assert len(out) == len(logits)
    for o, l in zip(out, logits):
        l = np.asarray(l)
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), l,
                                   atol=1e-4 * np.abs(l).max(), rtol=0)
