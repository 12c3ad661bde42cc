"""The port's scale rehearsal (mapping_tpu_torch/tools/scale_rehearsal.py)
against tools/scale_rehearsal.py's dataset: the same annotations as
tests/fixtures/synthetic.generate, its JPEG tiles read equal by libjpeg
(the JAX decoder) and the port's decoder, and a leg run end to end on the
CPU in a child process."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from mapping_tpu.utils import native_decode as jax_decode
from mapping_tpu_torch.config import load_params
from mapping_tpu_torch.tools import scale_rehearsal
from mapping_tpu_torch.utils import native_decode
from tests.fixtures import synthetic

ROOT = Path(__file__).resolve().parents[1]


def test_dataset_matches_the_synthetic_fixture(tmp_path):
    """At a small n and the rehearsal's density the annotation files equal
    the fixture generator's, byte for byte, and each tile is a baseline
    JPEG that libjpeg and the port decode to the same pixels, near the
    fixture's picture."""
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    scale_rehearsal.generate(str(ours), n_train=5, n_val=3, seed=7,
                             max_buildings=20)
    synthetic.generate(str(theirs), n_train=5, n_val=3, seed=7,
                       max_buildings=20)
    for split in ("train", "val"):
        for name in ("annotation.json", "annotation-small.json"):
            assert (ours / split / name).read_bytes() == \
                (theirs / split / name).read_bytes()
        images = json.loads((ours / split / "annotation.json").read_text())
        for entry in images["images"]:
            path = ours / split / "images" / entry["file_name"]
            got = native_decode.decode_rgb(path)
            np.testing.assert_array_equal(got, jax_decode.decode_rgb(
                str(path)))
            fixture = jax_decode.decode_rgb(
                str(theirs / split / "images" / entry["file_name"]))
            assert np.abs(got.astype(int) - fixture).mean() < 6


def test_a_leg_runs_on_the_cpu(tmp_path):
    """`--legs prepare_masks --device cpu` at a few tiles: the child exits
    0, reports its peak RSS, and the masks of every tile are written."""
    out = subprocess.run(
        [sys.executable, "-m", "mapping_tpu_torch.tools.scale_rehearsal",
         "--root", str(tmp_path), "--n-train", "3", "--n-val", "2",
         "--legs", "prepare_masks", "--device", "cpu"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    results = json.loads((tmp_path / "rehearsal_results.json").read_text())
    assert [r["leg"] for r in results] == ["prepare_masks"]
    assert results[0]["returncode"] == 0
    assert results[0]["peak_rss_mb"] > 0
    masks = list((tmp_path / "meta").rglob("masks/*.png"))
    assert len(masks) == 5
    params = load_params(str(tmp_path / "config19.yaml"))
    assert params["device"] == "cpu"
    assert params["category_layers"] == [1, 19]
    assert params["data_dir"] == str(tmp_path / "data")
