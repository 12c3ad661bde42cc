"""evaluate end to end in the other postprocess and loader modes, the port
against the JAX package: erosion 3 with dilation 2, and the crop_and_pad
loader with reflect padding (300^2 tiles padded to 320^2, predictions
resized back to 300^2). The workspace and the tolerances are those of
tests/test_torch_evaluate.py (same instances image by image, scores 1e-4
relative, equal AP/AR; an image that differs only where a pixel may fall
on either side of the threshold, measured on the served batches, is
excused). Erosion and dilation move a threshold flip by up to
erode // 2 + dilate // 2 pixels, which is the reach allowed."""

import shutil

import pytest

from tests.test_torch_evaluate import (PIPELINE, assert_same_instances,
                                       assert_same_scores, make_workspace,
                                       run_jax, run_port,
                                       served_probabilities)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate_modes")
    yield make_workspace(root)
    shutil.rmtree(root)  # ~0.5 GB of checkpoints


@pytest.mark.parametrize("name,extra", [
    ("erode3_dilate2", {"erode_selem_size": 3, "dilate_selem_size": 2}),
    ("crop_and_pad_reflect", {"loader_mode": "crop_and_pad",
                              "pad_method": "reflect"}),
])
def test_evaluate_matches_jax(workspace, name, extra):
    ap, ar, want = run_jax(workspace, f"jax_{name}", extra)
    p_ap, p_ar, got = run_port(workspace, f"port_{name}", extra)
    reach = (extra.get("erode_selem_size", 0) // 2
             + extra.get("dilate_selem_size", 0) // 2)
    excused = assert_same_instances(
        got, want, served_probabilities(workspace, PIPELINE, extra),
        list(range(1, 7)), reach=reach)
    assert_same_scores([p_ap, p_ar], [ap, ar], excused)
