"""The scoring pipelines end to end, the port against the JAX package.

On the synthetic fixture (4 train and 4 val tiles of 100^2, so that 19
threshold layers stay cheap on the CPU; predictions at 100^2), an
experiment holds a `unet.msgpack` that the JAX package wrote (seeded
ResNet34 weights, 64^2 in, float32) and the `scoring_model.joblib` that
the JAX package's `train -p scoring_model` fitted on it with 19 threshold
layers (`category_layers: [1, 19]`, a small GBM). The port, on the CPU,
reads both and evaluates `unet_scoring_model` and `unet_tta_scoring_model`
beside the JAX package, trains its own scoring model through its CLI, and
runs every named pipeline from `mapping_tpu_torch.main`.

Tolerances:
- JAX's labels and feature tensor of every image, fed through the port's
  feature tables, regressor and NMS, give JAX's prediction.json exactly.
- The port's own run: AP/AR within 1e-3. Images whose 19 label layers
  both frameworks agree on hold the same feature tensor (integers exact,
  floats 2e-5 relative), the same instances and the same NMS outcome; an
  image may differ only where a resized probability lies within the two
  frameworks' largest difference of one of the 19 thresholds. A score may
  differ where a feature lies within the bf16 hi/lo error of a GBM split
  (JAX sums probabilities in bf16 halves, the port in float64); the test
  counts such scores and prints the count.
"""

import json
import os
import shutil
import subprocess
import sys
from collections import defaultdict

import numpy as np
import pytest
import torch

from mapping_tpu.config import build_config as jax_build_config
from mapping_tpu.data.augment import resize_bilinear as jax_resize
from mapping_tpu.infer.postprocess import layer_thresholds
from mapping_tpu.manager import PipelineManager as JaxManager
from mapping_tpu.pipelines import PIPELINES as JAX_PIPELINES
from mapping_tpu.utils import native as jax_native
from mapping_tpu.utils import native_gbm as jax_native_gbm
from mapping_tpu_torch import main
from mapping_tpu_torch.config import build_config
from mapping_tpu_torch.constants import CATEGORY_IDS
from mapping_tpu_torch.data.augment import resize_bilinear
from mapping_tpu_torch.data.loader import infer_batch_resize, load_image
from mapping_tpu_torch.infer.annotations import labeled_to_annotations
from mapping_tpu_torch.manager import PipelineManager, generate_prediction
from mapping_tpu_torch.pipelines import PIPELINES
from mapping_tpu_torch.scoring import FILE_FORMAT
from tests.fixtures.synthetic import generate
from tests.test_torch_evaluate import _centred_state_dict

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 100
PARAMS = {"encoder": "ResNet34", "model_dtype": "float32", "image_h": 64,
          "image_w": 64, "batch_size_inference": 4, "device": "cpu",
          "crop_image_h": TILE, "crop_image_w": TILE,
          "h_pad": 14, "w_pad": 14}  # padded: 128^2 in
SCORING = {"category_layers": [1, 19], "lgbm__min_data": 5,
           "lgbm__num_leaves": 15, "lgbm__learning_rate": 0.1,
           "lgbm__number_of_trees": 60, "lgbm__early_stopping": 5}
THRESHOLDS = [t for t, _ in layer_thresholds((1, 19))[1:]]


def write_config(ws, name, extra):
    """A parameter file for the experiment `name` (JSON scalars and flow
    lists, which both packages' readers take), whose transformers link to
    the JAX
    package's unet.msgpack and, when it exists, scoring_model.joblib."""
    exp = ws["root"] / name
    (exp / "transformers").mkdir(parents=True, exist_ok=True)
    for file in ("unet.msgpack", "scoring_model.joblib"):
        cache = ws["root"] / "jax_cache" / "transformers" / file
        link = exp / "transformers" / file
        if cache.exists() and not link.exists() and name != "jax_cache":
            link.symlink_to(cache)
    params = {**PARAMS, "data_dir": str(ws["data_dir"]),
              "meta_dir": str(ws["root"] / "meta"),
              "experiment_dir": str(exp), **extra}
    path = ws["root"] / f"{name}.yaml"
    path.write_text("parameters:\n" + "".join(
        f"  {k}: {json.dumps(v)}\n" for k, v in params.items()))
    return str(path)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The fixture's data and metadata, the JAX unet cache, and the JAX
    package's scoring model trained on it."""
    for lib in (jax_native._lib, jax_native_gbm._lib):
        for _ in range(3):  # a worker that lost the JAX build race
            if lib.build():
                break
        assert lib.available()
    root = tmp_path_factory.mktemp("evaluate_scoring")
    data_dir = root / "data"
    generate(str(data_dir), n_train=4, n_val=4, seed=7, tile=(TILE, TILE))
    paths = sorted(str(p) for p in (data_dir / "val" / "images").iterdir())
    tiles = np.stack([load_image(p) for p in paths])
    state = _centred_state_dict(infer_batch_resize(torch.from_numpy(tiles),
                                                   (64, 64)))
    ckpt = root / "reference.pth"
    torch.save(state, ckpt)
    ws = {"root": root, "data_dir": data_dir, "tiles": tiles, "state": state,
          "checkpoint": ckpt}
    jax = JaxManager(write_config(ws, "jax_cache", {}))
    jax.prepare_metadata(True, True)
    jax.import_checkpoint(str(ckpt), "unet_weighted")
    JaxManager(write_config(ws, "jax_cache", SCORING)).train(
        "scoring_model", False)
    assert (root / "jax_cache" / "transformers" /
            "scoring_model.joblib").exists()
    yield ws
    shutil.rmtree(root)


def _prediction(ws, name):
    return json.loads((ws["root"] / name / "prediction.json").read_text())


def _data(rows):
    return {"input": {"meta": rows, "target_sizes": [(300, 300)] * len(rows)},
            "specs": {"train_mode": False},
            "callback_input": {"meta_valid": None}}


def _val_rows(ws):
    import pandas as pd

    meta = pd.read_csv(ws["root"] / "meta" / "metadata.csv")
    return meta[meta["is_valid"] == 1]


def _recording(pipe):
    """Wrap the scoring pipeline's base stream so that it also keeps each
    image's labels and feature tensor; returns that list."""
    seen = []
    inner = pipe.base._postprocessed_images

    def wrapped(data, return_features=False):
        for pred, feats in inner(data, return_features):
            seen.append((np.asarray(pred[0]), np.asarray(feats)))
            yield pred, feats

    pipe.base._postprocessed_images = wrapped
    return seen


def _gbm_scores(pipe, seen, jax):
    """The regressor's scores before NMS, per image and layer."""
    if jax:
        from mapping_tpu.scoring import features_from_tensor
    else:
        from mapping_tpu_torch.scoring import features_from_tensor
    return [pipe.model.transform([features_from_tensor(
        feats, labels, category_layers=pipe.category_layers)])["scores"][0]
        for labels, feats in seen]


def _max_probability_difference(ws, pipeline):
    """(largest |port - JAX| of the base serve programs' resized building
    probability, JAX's maps (N, TILE, TILE))."""
    import jax

    base = {"unet_scoring_model": "unet_weighted",
            "unet_tta_scoring_model": "unet_tta"}[pipeline]
    config = write_config(ws, f"probe_{pipeline}", SCORING)
    pipe = PIPELINES[base]["inference"](build_config(config)).set_weights(
        ws["state"])
    with torch.no_grad():
        port = resize_bilinear(pipe.serve_program()._probs(
            pipe.loader.infer_preprocess(ws["tiles"])), (TILE, TILE))
    jpipe = JAX_PIPELINES[base]["inference"](jax_build_config(config))
    jpipe.trainer.load(jpipe.trainer_cache_path)
    serve = jpipe.serve_program()
    probs = jax.jit(serve._probs)(serve._get_params(),
                                  jpipe.loader.infer_preprocess(ws["tiles"]))
    want = np.asarray(jax_resize(probs, (TILE, TILE)))[..., 1]
    return float(np.abs(port[..., 1].numpy() - want).max()), want


@pytest.fixture(scope="module")
def runs(workspace):
    """Both frameworks' evaluate of the two scoring pipelines through the
    JAX scoring model, each pipeline recording its images' labels, feature
    tensors and GBM scores on the way."""
    out = {}
    for pipeline in ("unet_scoring_model", "unet_tta_scoring_model"):
        run = {}
        for side, manager_cls, build, registry in (
                ("jax", JaxManager, jax_build_config, JAX_PIPELINES),
                ("port", PipelineManager, build_config, PIPELINES)):
            config = write_config(workspace, f"{side}_{pipeline}", SCORING)
            pipe = registry[pipeline]["inference"](build(config))
            seen = _recording(pipe)
            with pytest.MonkeyPatch.context() as mp:
                mp.setitem(registry, pipeline, {"inference": lambda _: pipe})
                manager = manager_cls(config)
                ap_ar = manager.evaluate(pipeline, False, None)
            run[side] = dict(ap_ar=ap_ar, seen=seen,
                             scores=_gbm_scores(pipe, seen, side == "jax"),
                             prediction=_prediction(workspace,
                                                    f"{side}_{pipeline}"),
                             timings=getattr(manager, "timings", None))
        out[pipeline] = run
    return out


@pytest.mark.parametrize("pipeline", ["unet_scoring_model",
                                      "unet_tta_scoring_model"])
def test_jax_features_through_the_port_equal_jax(workspace, runs, pipeline):
    """JAX's labels and feature tensors, scored by the port's tables, GBM
    (read from the JAX joblib) and NMS and written by the port's
    annotation writer, are JAX's prediction.json exactly."""
    port = PIPELINES[pipeline]["inference"](build_config(
        write_config(workspace, f"port_{pipeline}", SCORING)))
    port._load_model()
    want = runs[pipeline]["jax"]["prediction"]
    got = []
    ids = _val_rows(workspace)["ImageId"].tolist()
    for image_id, (labels, feats) in zip(ids,
                                         runs[pipeline]["jax"]["seen"]):
        labels, scores = port._score_one(labels, feats)
        got.extend(labeled_to_annotations(image_id, labels, scores,
                                          CATEGORY_IDS, (1, 19),
                                          emit_suppressed=False))
    assert len(want) > 0 and port.nms.suppressed > 0
    assert json.dumps(got) == json.dumps(want)


@pytest.mark.parametrize("pipeline", ["unet_scoring_model",
                                      "unet_tta_scoring_model"])
def test_scoring_evaluate_matches_jax(workspace, runs, pipeline):
    ws = workspace
    jax, port = runs[pipeline]["jax"], runs[pipeline]["port"]
    (j_ap, j_ar), (p_ap, p_ar) = jax["ap_ar"], port["ap_ar"]
    assert abs(p_ap - j_ap) <= 1e-3 and abs(p_ar - j_ar) <= 1e-3
    diff, jax_p = _max_probability_difference(ws, pipeline)
    assert diff < 1e-4
    near = [sum(int((np.abs(p - t) <= diff).sum()) for t in THRESHOLDS)
            for p in jax_p]
    by_image = [defaultdict(list), defaultdict(list)]
    for side, preds in zip(by_image, (port["prediction"],
                                      jax["prediction"])):
        for p in preds:
            side[p["image_id"]].append(p)
    ids = _val_rows(ws)["ImageId"].tolist()
    assert len(port["seen"]) == len(jax["seen"]) == len(ids)
    agreeing, score_flips = 0, 0
    for i, image_id in enumerate(ids):
        (pl, pf), (jl, jf) = port["seen"][i], jax["seen"][i]
        if not np.array_equal(pl, jl):
            assert near[i] > 0, f"image {image_id}: labels differ away " \
                f"from the thresholds"
            continue
        agreeing += 1
        np.testing.assert_array_equal(pf[..., [0, 4, 6, 7, 8]],
                                      jf[..., [0, 4, 6, 7, 8]])
        np.testing.assert_allclose(pf, jf, rtol=2e-5, atol=0)
        flips = sum(a != b for pa, ja in zip(port["scores"][i],
                                             jax["scores"][i])
                    for a, b in zip(pa, ja))
        score_flips += flips
        if flips == 0:
            g, w = by_image[0][image_id], by_image[1][image_id]
            assert [(a["segmentation"], a["bbox"], a["score"]) for a in g] \
                == [(b["segmentation"], b["bbox"], b["score"]) for b in w]
    print(f"{pipeline}: {agreeing} of {len(ids)} images with equal labels "
          f"(probabilities differ by {diff:.2e}); {score_flips} GBM scores "
          f"differ, from a feature within the bf16 hi/lo error of a split")
    assert agreeing >= 1
    t = port["timings"]
    assert t["images"] == len(ids) and t["nms_s"] > 0 and t["suppressed"] > 0


def test_port_trains_the_scoring_model_through_its_cli(workspace):
    """`train -p scoring_model` in a subprocess writes the port's file
    (never a joblib), whose GBM then scores `evaluate -p
    unet_padded_scoring_model`."""
    ws = workspace
    config = write_config(ws, "port_train", SCORING)
    transformers = ws["root"] / "port_train" / "transformers"
    (transformers / "scoring_model.joblib").unlink()
    out = subprocess.run(
        [sys.executable, "-m", "mapping_tpu_torch.main", "--config", config,
         "train", "-p", "scoring_model"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "feature rows from 4 images" in out.stdout
    assert not (transformers / "scoring_model.joblib").exists()
    with open(transformers / "scoring_model.pkl", "rb") as f:
        import pickle

        assert pickle.load(f)["format"] == FILE_FORMAT
    manager = main.main(["--config", config, "evaluate", "-p",
                         "unet_padded_scoring_model"])
    prediction = _prediction(ws, "port_train")
    assert {p["image_id"] for p in prediction} <= set(range(1, 5))
    assert all(p["score"] != 0 for p in prediction)
    assert manager.timings["images"] == 4


@pytest.mark.parametrize("command,pipeline,layers", [
    ("evaluate", "unet_tta", [1, 1]),
    ("evaluate", "unet_padded", [1, 1]),
    ("evaluate", "unet_scoring_model", [1, 19]),
    ("predict_on_dir", "unet_tta_scoring_model", [1, 19]),
    ("predict_on_dir", "unet_padded", [1, 1]),
])
def test_cli_runs_every_named_pipeline(workspace, tmp_path, command,
                                       pipeline, layers):
    ws = workspace
    name = f"cli_{command}_{pipeline}"
    config = write_config(ws, name, {**SCORING, "category_layers": layers})
    args = ["--config", config, command, "-p", pipeline]
    if command == "predict_on_dir":
        args += ["--dir_path", str(ws["data_dir"] / "val" / "images"),
                 "--prediction_path", str(tmp_path / "out.json")]
    manager = main.main(args)
    path = (tmp_path / "out.json" if command == "predict_on_dir"
            else ws["root"] / name / "prediction.json")
    prediction = json.loads(path.read_text())
    assert prediction and manager.timings["images"] == 4
    assert ("nms_s" in manager.timings) == ("scoring" in pipeline)


def test_scoring_inference_streams_and_drops_suppressed(workspace):
    """As in the JAX package (tests/test_scoring_e2e.py): a default
    evaluate streams (the batch transform is never called) and writes
    what the chunked path writes; `emit_suppressed: 1` adds exactly the
    zero-scored instances and leaves AP/AR equal."""
    ws = workspace
    config = build_config(write_config(ws, "port_stream", SCORING))
    rows = _val_rows(ws).to_dict("records")
    batch = PIPELINES["unet_scoring_model"]["inference"](config)
    assert batch.force_stream
    want = generate_prediction(rows, batch, config, chunk_size=4)
    stream = PIPELINES["unet_scoring_model"]["inference"](config)

    def boom(data):
        raise AssertionError("the batch transform ran on the default path")

    stream.transform = boom
    assert json.dumps(generate_prediction(rows, stream, config)) == \
        json.dumps(want)

    dropped = PipelineManager(write_config(ws, "port_drop", SCORING))
    ap_d = dropped.evaluate("unet_scoring_model", False, None)
    pred_d = _prediction(ws, "port_drop")
    emitted = PipelineManager(write_config(ws, "port_emit", {
        **SCORING, "emit_suppressed": 1}))
    ap_e = emitted.evaluate("unet_scoring_model", False, None)
    pred_e = _prediction(ws, "port_emit")
    assert ap_d == ap_e
    assert all(a["score"] != 0 for a in pred_d)
    n_zero = sum(a["score"] == 0 for a in pred_e)
    assert n_zero > 0 and len(pred_e) == len(pred_d) + n_zero
    assert [a for a in pred_e if a["score"] != 0] == pred_d


def test_scoring_stream_is_lazy(workspace):
    """Pulling one image serves one batch."""
    ws = workspace
    config = build_config(write_config(ws, "port_lazy", {
        **SCORING, "batch_size_inference": 1}))
    pipe = PIPELINES["unet_scoring_model"]["inference"](config)
    serve = pipe.base.serve_program(return_features=True)
    calls = []
    collect = serve.collect
    serve.collect = lambda handle: calls.append(1) or collect(handle)
    stream = pipe.transform_stream(_data(
        _val_rows(ws).to_dict("records")))["y_pred"]
    assert calls == []
    next(stream)
    assert len(calls) == 1


def test_import_checkpoint_under_a_scoring_pipeline_fills_the_base(
        workspace):
    ws = workspace
    manager = PipelineManager(write_config(ws, "port_import", SCORING))
    (ws["root"] / "port_import" / "transformers" / "unet.msgpack").unlink()
    manager.import_checkpoint(str(ws["checkpoint"]), "unet_scoring_model")
    assert (ws["root"] / "port_import" / "transformers" / "unet.pt").exists()
    with pytest.raises(AssertionError):
        PipelineManager(write_config(ws, "port_import_11", {})) \
            .import_checkpoint(str(ws["checkpoint"]), "unet_scoring_model")


def test_random_forest_is_refused(workspace):
    config = build_config(write_config(workspace, "port_rf", {
        **SCORING, "scoring_model": "random_forest"}))
    with pytest.raises(NotImplementedError, match="sklearn"):
        PIPELINES["unet_scoring_model"]["inference"](config)
