"""evaluate -p unet_tta and -p unet_padded end to end, the port against the
JAX package.

The workspace is that of tests/test_torch_evaluate.py (a JAX-written
`unet.msgpack` of seeded ResNet34 weights, 64^2, float32, the port on the
CPU). Tolerances: prediction.json holds the same instances image by image
(counts string, bbox and category equal, scores 1e-4 relative) and AP/AR
are equal. An image may differ only where a pixel's JAX probability, as
its serve program computes it on the batches as they were served (the 12
deduplicated TTA forwards aggregated, or the padded forward cut back to
the tile), lies within the largest difference between the two
frameworks' maps of the 0.5 threshold, where float32 rounding may fall on
either side (tests/test_torch_evaluate.assert_same_instances); AP/AR then
agree to 0.05.
"""

import shutil

import pytest
import torch

from mapping_tpu.manager import PipelineManager as JaxManager
from mapping_tpu_torch.config import build_config
from mapping_tpu_torch.manager import PipelineManager
from mapping_tpu_torch.pipelines import PIPELINES
from tests.test_torch_evaluate import (PARAMS, _prediction,
                                       assert_same_instances,
                                       assert_same_scores, make_workspace,
                                       served_probabilities, write_config)

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
    excused = assert_same_instances(
        got, want, served_probabilities(workspace, pipeline, extra),
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
