"""evaluate -p unet_tta and -p unet_padded end to end, the port against the
JAX package.

The workspace is that of tests/test_torch_evaluate.py (a JAX-written
`unet.msgpack` of seeded ResNet34 weights, 64^2, float32, the port on the
CPU). Tolerances: prediction.json holds the same instances image by image
(counts string, bbox and category equal, scores 1e-4 relative) and AP/AR
are equal. An image may differ only where one framework's resized
probability, as its serve program computes it (the 12 deduplicated TTA
forwards aggregated, or the padded forward cut back to the tile), lies
within the largest difference between the two frameworks' maps of the
0.5 threshold, where float32 rounding may fall on either side; AP/AR then
agree to 0.05.
"""

import shutil
from collections import defaultdict

import numpy as np
import pytest
import torch

from mapping_tpu.config import build_config as jax_build_config
from mapping_tpu.data.augment import resize_bilinear as jax_resize
from mapping_tpu.manager import PipelineManager as JaxManager
from mapping_tpu.pipelines import PIPELINES as JAX_PIPELINES
from mapping_tpu_torch.config import build_config
from mapping_tpu_torch.data.augment import resize_bilinear
from mapping_tpu_torch.manager import PipelineManager
from mapping_tpu_torch.pipelines import PIPELINES
from tests.test_torch_evaluate import (PARAMS, _prediction,
                                       assert_same_scores,
                                       make_workspace, write_config)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate_tta")
    yield make_workspace(root)
    shutil.rmtree(root)  # ~0.5 GB of checkpoints


def evaluate(ws, manager_cls, name, pipeline, extra):
    manager = manager_cls(write_config(ws, name, extra))
    ap, ar = manager.evaluate(pipeline, False, None)
    return float(ap), float(ar), _prediction(ws, name), manager


def near_threshold(ws, pipeline, extra, threshold=0.5):
    """Per image, the pixels where the two frameworks' serve programs may
    fall on either side of `threshold`: the JAX probability at 300^2 lies
    within the largest |port - JAX| difference of it."""
    name = f"probe_{pipeline}_{len(extra)}"
    config = build_config(write_config(ws, name, extra))
    pipe = PIPELINES[pipeline]["inference"](config).set_weights(ws["state"])
    with torch.no_grad():
        port = resize_bilinear(pipe.serve_program()._probs(
            pipe.loader.infer_preprocess(ws["tiles"])), (300, 300))
    jpipe = JAX_PIPELINES[pipeline]["inference"](jax_build_config(
        write_config(ws, name, extra)))
    jpipe.trainer.load(jpipe.trainer_cache_path)
    serve = jpipe.serve_program()
    jax = np.asarray(jax_resize(serve._probs(
        serve._get_params(), jpipe.loader.infer_preprocess(ws["tiles"])),
        (300, 300)))[..., 1]
    diff = float(np.abs(port[..., 1].numpy() - jax).max())
    assert diff < 1e-4
    return (np.abs(jax - threshold) <= diff).sum(axis=(1, 2))


def assert_same_instances(got, want, near, image_ids):
    """Instances equal image by image (scores 1e-4 relative); an image
    that differs must hold a near-threshold pixel. Returns the excused
    images."""
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
        if not same:
            assert near[i] > 0, f"image {image_id} differs away from the " \
                f"threshold"
            excused.append(image_id)
    assert len(excused) < len(image_ids) and len(got) > 0
    return excused


@pytest.mark.parametrize("pipeline,extra", [
    ("unet_tta", {}),
    ("unet_tta", {"tta_aggregation_method": "mean"}),
    ("unet_padded", {"pad_method": "reflect"}),
])
def test_evaluate_matches_jax(workspace, pipeline, extra):
    name = f"{pipeline}_{len(extra)}"
    ap, ar, want, _ = evaluate(workspace, JaxManager, f"jax_{name}",
                               pipeline, extra)
    p_ap, p_ar, got, manager = evaluate(workspace, PipelineManager,
                                        f"port_{name}", pipeline, extra)
    excused = assert_same_instances(got, want,
                                    near_threshold(workspace, pipeline, extra),
                                    list(range(1, 7)))
    assert_same_scores([p_ap, p_ar], [ap, ar], excused)
    assert manager.timings["images"] == 6


def test_padded_and_tta_pipelines_are_built_as_in_jax(workspace):
    """unet_padded pads in the loader and crops the predictions back;
    unet_tta crops only when the loader pads."""
    for extra, crops in (({}, False), ({"loader_mode": "crop_and_pad"},
                                       True)):
        config = build_config(overrides={**PARAMS, **extra})
        tta = PIPELINES["unet_tta"]["inference"](config)
        padded = PIPELINES["unet_padded"]["inference"](config)
        assert tta.crop_predictions == crops and tta.tta
        assert padded.crop_predictions and padded.loader.mode == \
            "crop_and_pad"
        serve = tta.serve_program()
        assert serve._crop_size == ((300, 300) if crops else None)
