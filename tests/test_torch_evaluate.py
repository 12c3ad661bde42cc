"""evaluate and predict_on_dir end to end, the port against the JAX package.

On the synthetic fixture (tests/fixtures/synthetic.py, 6 val tiles of
300^2 JPEG), an experiment holds a `unet.msgpack` that the JAX package
wrote (`import_checkpoint` of seeded random UNetResNet34 weights). The
JAX PipelineManager and the port's read it and run the `unet_weighted`
pipeline at 64^2, batch 4 (a ragged tail of 2 padded with duplicates),
model_dtype float32, the port on the CPU.

Tolerances: prediction.json holds the same instances, image by image
(image id, category, counts string and bbox equal, scores 1e-4
relative), and AP/AR are equal. An image may differ only where the two
frameworks' float32 rounding may put a pixel on either side of the 0.5
threshold: the band is the largest |port - JAX| of the resized building
probability over the batches as they were served (`served_probabilities`,
at most 1e-4), and every pixel where the two decoded label maps disagree
must have a JAX probability within that band of the threshold (within the
erosion + dilation reach of such a pixel when the postprocess erodes or
dilates), and every instance of one side that the other lacks must touch
such a pixel. AP/AR then agree to 0.05.
"""

import json
import os
import shutil
import subprocess
import sys
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

from mapping_tpu.manager import PipelineManager as JaxManager
from mapping_tpu.manager import _sample as jax_sample
from mapping_tpu_torch.config import build_config
from mapping_tpu_torch.constants import SEED
from mapping_tpu_torch.data.augment import resize_bilinear
from mapping_tpu_torch.data.coco import COCOIndex
from mapping_tpu_torch.data.loader import infer_batch_resize, load_image
from mapping_tpu_torch.manager import PipelineManager
from mapping_tpu_torch.models.unet_resnet import UNetResNet
from mapping_tpu_torch.pipelines import PIPELINES
from tests.fixtures.synthetic import generate

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PARAMS = {"encoder": "ResNet34", "model_dtype": "float32", "image_h": 64,
          "image_w": 64, "batch_size_inference": 4, "device": "cpu"}
PIPELINE = "unet_weighted"


def _centred_state_dict(images, seed=0):
    """Random UNetResNet34 weights (BatchNorm statistics randomised) whose
    logit difference over `images` has mean 0 and standard deviation 4."""
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
        logits = model(images.permute(0, 3, 1, 2))
        diff = logits[:, 1] - logits[:, 0]
        centre, scale = diff.mean(), 4.0 / diff.std()
        w, b = model.final.weight, model.final.bias
        w[1] = w[0] + scale * (w[1] - w[0])
        b[1] = b[0] + scale * (b[1] - b[0] - centre)
    return model.state_dict()


def make_workspace(root: Path):
    """The fixture's data, metadata written by the JAX package, and a JAX
    transformer cache (unet.msgpack) of a reference torch checkpoint."""
    data_dir = root / "data"
    generate(str(data_dir), n_train=1, n_val=6, seed=7)
    paths = sorted(str(p) for p in (data_dir / "val" / "images").iterdir())
    tiles = np.stack([load_image(p) for p in paths])
    state = _centred_state_dict(infer_batch_resize(torch.from_numpy(tiles),
                                                   (64, 64)))
    ckpt = root / "reference.pth"
    torch.save(state, ckpt)
    ws = {"root": root, "data_dir": data_dir, "tiles": tiles, "state": state,
          "paths": paths}
    jax = JaxManager(write_config(ws, "jax_cache", {}))
    jax.prepare_metadata(True, True)
    jax.import_checkpoint(str(ckpt), PIPELINE)
    return ws


def write_config(ws, name, extra):
    """A parameter file for the experiment `name`, whose transformer cache
    links to the JAX package's unet.msgpack."""
    exp = ws["root"] / name
    cache = ws["root"] / "jax_cache" / "transformers" / "unet.msgpack"
    if cache.exists() and not (exp / "transformers").exists():
        (exp / "transformers").mkdir(parents=True)
        (exp / "transformers" / "unet.msgpack").symlink_to(cache)
    params = {**PARAMS, "data_dir": str(ws["data_dir"]),
              "meta_dir": str(ws["root"] / "meta"),
              "experiment_dir": str(exp), **extra}
    path = ws["root"] / f"{name}.yaml"
    # JSON scalars and flow lists ([1, 19]), which both packages' readers
    # take (the port's refuses block lists)
    path.write_text("parameters:\n" + "".join(
        f"  {k}: {json.dumps(v)}\n" for k, v in params.items()))
    return str(path)


def run_jax(ws, name, extra):
    manager = JaxManager(write_config(ws, name, extra))
    ap, ar = manager.evaluate(PIPELINE, False, None)
    return float(ap), float(ar), _prediction(ws, name)


def run_port(ws, name, extra):
    manager = PipelineManager(write_config(ws, name, extra))
    ap, ar = manager.evaluate(PIPELINE, False, None)
    assert not (ws["root"] / name / "transformers" / "unet.pt").exists()
    return float(ap), float(ar), _prediction(ws, name)


def _prediction(ws, name):
    return json.loads((ws["root"] / name / "prediction.json").read_text())


def served_probabilities(ws, pipeline, extra):
    """(port, JAX) resized building probability (N, 300, 300) of the
    fixture's tiles, computed by each framework's serve program on the
    batches of `batch_size_inference` that evaluate serves (the ragged
    tail padded with the last tile), from the experiment's unet.msgpack."""
    import jax

    from mapping_tpu.config import build_config as jax_build_config
    from mapping_tpu.data.augment import resize_bilinear as jax_resize
    from mapping_tpu.pipelines import PIPELINES as JAX_PIPELINES

    config = write_config(ws, f"probe_{pipeline}_{len(extra)}", extra)
    pipe = PIPELINES[pipeline]["inference"](build_config(config))
    pipe._ensure_weights()
    port_serve = pipe.serve_program()
    jpipe = JAX_PIPELINES[pipeline]["inference"](jax_build_config(config))
    jpipe.trainer.load(jpipe.trainer_cache_path)
    jax_serve = jpipe.serve_program()
    jax_probs = jax.jit(jax_serve._probs)
    tiles = ws["tiles"]
    bs = int(build_config(config).params.batch_size_inference)
    port, want = [], []
    for start in range(0, len(tiles), bs):
        idx = np.minimum(np.arange(start, start + bs), len(tiles) - 1)
        n = min(bs, len(tiles) - start)
        with torch.no_grad():
            p = resize_bilinear(port_serve._probs(
                pipe.loader.infer_preprocess(tiles[idx])), (300, 300))
        j = jax_resize(jax_probs(jax_serve._get_params(),
                                 jpipe.loader.infer_preprocess(tiles[idx])),
                       (300, 300))
        port.append(p[:n, ..., 1].numpy())
        want.append(np.asarray(j)[:n, ..., 1])
    return np.concatenate(port), np.concatenate(want)


def _label_map(preds, shape):
    """The decoded instances of one image: foreground (H, W) bool and the
    instance masks, keyed by counts string."""
    from mapping_tpu_torch.ops.rle import decode

    fg = np.zeros(shape, bool)
    masks = {}
    for p in preds:
        mask = decode(p["segmentation"]).astype(bool)
        fg |= mask
        masks[p["segmentation"]["counts"]] = mask
    return fg, masks


def assert_same_instances(got, want, probs, image_ids, reach=0,
                          threshold=0.5):
    """Instances equal image by image (scores 1e-4 relative). An image
    that differs is decoded on both sides: every pixel where the two label
    maps disagree must lie within `reach` pixels of one whose JAX
    probability is within the band (max |port - JAX| of `probs`, the
    (port, JAX) maps of `served_probabilities`) of the threshold, and every
    instance of one side that the other lacks must touch such a pixel.
    Returns the excused images."""
    from scipy import ndimage

    port, jax_maps = probs
    band = float(np.abs(port - jax_maps).max())
    assert band < 1e-4, band
    by_image = [defaultdict(list), defaultdict(list)]
    for side, preds in zip(by_image, (got, want)):
        for p in preds:
            side[p["image_id"]].append(p)
    excused = []
    for i, image_id in enumerate(image_ids):
        g, w = by_image[0][image_id], by_image[1][image_id]
        same = len(g) == len(w) and all(
            a["category_id"] == b["category_id"]
            and a["segmentation"] == b["segmentation"]
            and a["bbox"] == b["bbox"]
            and abs(a["score"] - b["score"]) <= 1e-4 * abs(b["score"])
            for a, b in zip(g, w))
        if same:
            continue
        near = np.abs(jax_maps[i] - threshold) <= band
        if reach:
            near = ndimage.binary_dilation(
                near, np.ones((2 * reach + 1,) * 2, bool))
        fg_g, masks_g = _label_map(g, near.shape)
        fg_w, masks_w = _label_map(w, near.shape)
        away = (fg_g != fg_w) & ~near
        assert not away.any(), (
            f"image {image_id}: {int(away.sum())} pixels differ away from "
            f"the threshold (band {band:.3g})")
        touching = ndimage.binary_dilation(near)
        for key in set(masks_g) ^ set(masks_w):
            mask = masks_g.get(key, masks_w.get(key))
            assert (mask & touching).any(), (
                f"image {image_id}: an instance differs away from the "
                f"threshold (band {band:.3g})")
        for key in set(masks_g) & set(masks_w):
            a = next(p for p in g if p["segmentation"]["counts"] == key)
            b = next(p for p in w if p["segmentation"]["counts"] == key)
            assert abs(a["score"] - b["score"]) <= 1e-4 * abs(b["score"])
        excused.append(image_id)
    assert len(excused) < len(image_ids) and len(got) > 0
    return excused


def assert_same_scores(got, want, excused):
    if excused:
        np.testing.assert_allclose(got, want, atol=0.05)
    else:
        assert got == want


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate")
    yield make_workspace(root)
    shutil.rmtree(root)  # ~0.5 GB of checkpoints


def test_cli_evaluate_matches_jax(workspace):
    """The port's CLI in a subprocess, at the resize defaults: the same
    prediction.json instances as the JAX package and equal AP/AR; the
    duplicated tail images are not written."""
    ws = workspace
    ap, ar, want = run_jax(ws, "jax_resize", {})
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run(
        [sys.executable, "-m", "mapping_tpu_torch.main", "--config",
         write_config(ws, "port_resize", {}), "evaluate", "-p", PIPELINE],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    got = _prediction(ws, "port_resize")
    ids = sorted({p["image_id"] for p in want})
    assert ids == list(range(1, 7))
    excused = assert_same_instances(
        got, want, served_probabilities(ws, PIPELINE, {}), ids)
    metrics = [json.loads(l) for l in (ws["root"] / "port_resize"
                                       / "metrics.jsonl").open()]
    assert [m["channel"] for m in metrics] == ["Precision", "Recall"]
    assert_same_scores([m["y"] for m in metrics], [ap, ar], excused)


def test_predict_on_dir_matches_jax(workspace, tmp_path):
    ws = workspace
    images = str(ws["data_dir"] / "val" / "images")
    JaxManager(write_config(ws, "jax_predict", {})).predict_on_dir(
        PIPELINE, images, str(tmp_path / "jax.json"), None)
    manager = PipelineManager(write_config(ws, "port_predict", {}))
    manager.predict_on_dir(PIPELINE, images, str(tmp_path / "port.json"),
                           None)
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert sorted({p["image_id"] for p in want}) == list(range(6))
    assert_same_instances(got, want,
                          served_probabilities(ws, PIPELINE, {}), range(6))
    t = manager.timings
    assert t["images"] == 6 and t["decode_s"] > 0 and t["device_s"] > 0


def test_chunked_and_streamed_predictions_equal_the_whole(workspace):
    """evaluate -c 4 and stream_mode write the same prediction.json as one
    chunk (the port against itself)."""
    ws = workspace
    whole = run_port(ws, "port_whole", {})
    chunked = PipelineManager(write_config(ws, "port_chunked", {}))
    assert chunked.evaluate(PIPELINE, False, 4) == whole[:2]
    stream = PipelineManager(write_config(ws, "port_stream",
                                          {"stream_mode": 1}))
    assert stream.evaluate(PIPELINE, False, None) == whole[:2]
    assert _prediction(ws, "port_chunked") == whole[2] == \
        _prediction(ws, "port_stream")


def test_port_prefers_its_own_cache(workspace):
    """With unet.pt beside unet.msgpack the port reads unet.pt, folds it
    once and frees the float32 model."""
    ws = workspace
    config = write_config(ws, "port_own_cache", {})
    pipe = PIPELINES[PIPELINE]["inference"](build_config(config))
    state = {k: v.clone() for k, v in ws["state"].items()}
    state["final.bias"] += 1.0
    pipe.set_weights(state).trainer.save(pipe.trainer_cache_path)
    fresh = PIPELINES[PIPELINE]["inference"](build_config(config))
    list(fresh.transform_arrays(ws["tiles"][:1]))
    assert fresh.trainer.model is None
    assert torch.equal(fresh.trainer.serving_model().final.bias,
                       state["final.bias"])


def test_serve_only_serves_the_same_and_refuses_the_rest(workspace):
    """UNetTrainer.serve_only keeps the folded copy (the same float32
    probabilities, exactly) and frees the float32 model: saving, loading
    and training then raise."""
    ws = workspace
    pipe = PIPELINES[PIPELINE]["inference"](build_config(
        write_config(ws, "port_serve_only", {}))).set_weights(ws["state"])
    images = pipe.loader.infer_preprocess(ws["tiles"][:2])
    want = pipe.trainer.probs_apply_fn()(images)
    trainer = pipe.trainer.serve_only()
    assert torch.equal(trainer.probs_apply_fn()(images), want)
    for call in (lambda: trainer.save(pipe.trainer_cache_path),
                 lambda: trainer.load_state_dict(ws["state"]),
                 lambda: trainer.fit(([], 0))):
        with pytest.raises(RuntimeError, match="serve_only"):
            call()


def test_evaluate_with_pretrained_weights_serves_the_cache(workspace):
    """A config naming a pretrained encoder file (a training config of the
    reference) evaluates the experiment's cached weights, as the JAX
    package does: the same prediction.json as without it."""
    from mapping_tpu_torch.models.resnet import ResNetEncoder

    ws = workspace
    encoder = {k: v + 0.5 if v.is_floating_point() else v
               for k, v in ResNetEncoder(34).state_dict().items()}
    path = ws["root"] / "resnet34.pth"
    torch.save(encoder, path)
    base = run_port(ws, "port_no_pretrained", {})
    got = run_port(ws, "port_pretrained", {"pretrained_weights": str(path)})
    assert got == base


class GroundTruthPipeline:
    """Stands in for a unet pipeline whose labels are the split's ground
    truth: each image's annotations filled as instances 1..n of the
    building layer, with score 1; records the images it was given."""

    def __init__(self, gt_path):
        self.coco = COCOIndex(gt_path)
        self.loader = SimpleNamespace(decode_seconds=0.0)
        self.device_seconds = 0.0
        self.seen = []

    def clean_cache(self):
        pass

    def transform(self, data):
        y_pred = []
        for row in data["input"]["meta"]:
            self.seen.append(row["ImageId"])
            anns = self.coco.load_anns(self.coco.get_ann_ids(
                img_ids=[row["ImageId"]]))
            labels = np.zeros((2, 300, 300), np.int16)
            for i, ann in enumerate(anns, start=1):
                labels[1][self.coco.ann_to_mask(ann) > 0] = i
            y_pred.append((labels, [[], [1.0] * len(anns)]))
        return {"y_pred": y_pred}


def test_manager_evaluate_scores_ground_truth_as_one(workspace, monkeypatch):
    """PipelineManager.evaluate from the pipeline's labels to AP/AR: the
    ground truth of a sample of 4 of the 6 images, given as the labels,
    goes through the annotation writer, prediction.json and the manager's
    own coco_evaluation call (the sampled image ids, the building
    category) and scores AP = AR = 1. Scoring all 6 images would miss
    the 2 unsampled ones; another category would score 0."""
    ws = workspace
    oracle = GroundTruthPipeline(str(ws["data_dir"] / "val"
                                     / "annotation.json"))
    monkeypatch.setitem(PIPELINES, "ground_truth",
                        {"inference": lambda config: oracle})
    manager = PipelineManager(write_config(ws, "port_ground_truth",
                                           {"evaluation_data_sample": 4}))
    assert manager.evaluate("ground_truth", False, None) == (1.0, 1.0)
    meta = pd.read_csv(ws["root"] / "meta" / "metadata.csv")
    want = jax_sample(meta[meta["is_valid"] == 1], 4, SEED)["ImageId"]
    assert oracle.seen == [int(i) for i in want]
    assert len({p["image_id"] for p in _prediction(ws, "port_ground_truth")
                }) == 4
