"""The `visualize` and `parity_drill` commands, the port against the JAX
package.

Workspace: the synthetic fixture and the reference UNetResNet34
checkpoint of tests/test_torch_evaluate.py (64^2, float32, device cpu).
- parity_drill: the JAX drill and the port's CLI drill (checkpoint and
  data dir from $CHECKPOINT / $DATA_DIR), each in a fresh experiment whose
  meta_dir has no metadata.csv, so both scan the val split first. The
  reports have the same keys, and the same values: AP/AR equal unless an
  image is excused by the per-pixel near-threshold rule of
  test_torch_evaluate.py (then 0.05), the rest exactly.
- visualize: on the JAX drill's prediction.json, with scores rewritten so
  that the filters bite (score 0, low scores, more instances than
  max_dets), the overlays the port writes decode to the arrays of the
  JAX package's Pillow-written PNGs, exactly (the files' bytes differ).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from mapping_tpu.manager import PipelineManager as JaxManager
from mapping_tpu.manager import parity_drill as jax_parity_drill
from mapping_tpu.utils.visualize import \
    visualize_predictions as jax_visualize
from mapping_tpu_torch import main
from mapping_tpu_torch.manager import (PARITY_TOLERANCE, REFERENCE_AP,
                                       REFERENCE_AR)
from mapping_tpu_torch.utils.png import read_png_rgb
from mapping_tpu_torch.utils.visualize import visualize_predictions
from tests.test_torch_evaluate import (PARAMS, PIPELINE, _prediction,
                                       assert_same_instances,
                                       assert_same_scores, make_workspace,
                                       served_probabilities)

torch.set_num_threads(2)


def _config(ws, name):
    """A parameter file of a fresh experiment and meta_dir (no metadata,
    no cache)."""
    params = {**PARAMS, "data_dir": str(ws["data_dir"]),
              "meta_dir": str(ws["root"] / f"meta_{name}"),
              "experiment_dir": str(ws["root"] / name)}
    path = ws["root"] / f"{name}.yaml"
    path.write_text("parameters:\n" + "".join(
        f"  {k}: {json.dumps(v)}\n" for k, v in params.items()))
    return str(path)


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """(workspace, JAX report, the port's report as its CLI printed it)."""
    from mapping_tpu.utils import native as jax_native

    for _ in range(3):  # a worker that lost the JAX package's build race
        if jax_native._lib.build():
            break
    root = tmp_path_factory.mktemp("drill")
    ws = make_workspace(root)
    ckpt = str(root / "reference.pth")
    jax_report = jax_parity_drill(JaxManager(_config(ws, "jax_drill")),
                                  PIPELINE, ckpt)
    mp = pytest.MonkeyPatch()
    mp.setenv("CHECKPOINT", ckpt)
    mp.setenv("DATA_DIR", str(ws["data_dir"]))
    try:
        import contextlib
        import io

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main.main(["--config", _config(ws, "port_drill"), "parity_drill",
                       "-p", PIPELINE])
    finally:
        mp.undo()
    text = out.getvalue()
    port_report = json.loads(text[text.index("{\n"):])
    yield ws, jax_report, port_report
    shutil.rmtree(root)


def test_parity_drill_reports_what_jax_reports(drills):
    ws, want, got = drills
    assert list(got) == list(want)
    assert (REFERENCE_AP, REFERENCE_AR, PARITY_TOLERANCE) == (0.943, 0.954,
                                                              0.002)
    assert (ws["root"] / "meta_port_drill" / "metadata.csv").exists()
    excused = assert_same_instances(
        _prediction(ws, "port_drill"), _prediction(ws, "jax_drill"),
        served_probabilities(ws, PIPELINE, {}), list(range(1, 7)))
    assert_same_scores([got["ap"], got["ar"]], [want["ap"], want["ar"]],
                       excused)
    for key in want:
        if key not in ("ap", "ar", "delta_ap", "delta_ar"):
            assert got[key] == want[key], key
    if not excused:
        assert got == want


def test_parity_drill_without_a_checkpoint_is_a_usage_error(drills,
                                                            monkeypatch,
                                                            capsys):
    ws = drills[0]
    monkeypatch.delenv("CHECKPOINT", raising=False)
    with pytest.raises(SystemExit) as exc:
        main.main(["--config", _config(ws, "no_ckpt"), "parity_drill"])
    assert exc.value.code == 2
    assert "no checkpoint: pass --checkpoint or set $CHECKPOINT" in \
        capsys.readouterr().err
    with pytest.raises(FileNotFoundError, match="no checkpoint at"):
        main.main(["--config", _config(ws, "no_ckpt"), "parity_drill",
                   "--checkpoint", str(ws["root"] / "absent.pth")])


def _rescored(ws, tmp_path):
    """The JAX drill's prediction.json with scores that exercise the
    filters: every third instance 0 (suppressed), the rest spread over
    (0, 1)."""
    preds = _prediction(ws, "jax_drill")
    assert len(preds) > 6
    for i, p in enumerate(preds):
        p["score"] = 0.0 if i % 3 == 0 else round(0.05 + (i * 0.37) % 0.9,
                                                  4)
    path = tmp_path / "rescored.json"
    path.write_text(json.dumps(preds))
    return str(path)


@pytest.mark.parametrize("kw", [
    {}, {"n_images": 3, "seed": 5},
    {"score_threshold": 0.5, "max_dets": 1},
    {"hide_suppressed": False, "max_dets": 0},
    {"image_ids": [2, 4, 99], "dataset": "val"}])
def test_overlays_equal_jax_pixel_for_pixel(drills, tmp_path, kw):
    ws = drills[0]
    preds = _rescored(ws, tmp_path)
    want = jax_visualize(preds, str(ws["data_dir"]), str(tmp_path / "jax"),
                         **kw)
    got = visualize_predictions(preds, str(ws["data_dir"]),
                                str(tmp_path / "port"), **kw)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert got
    from PIL import Image

    for g, w in zip(got, want):
        np.testing.assert_array_equal(read_png_rgb(g),
                                      np.asarray(Image.open(w)), err_msg=g)


def test_cli_visualize_prints_the_written_files(drills, tmp_path, capsys):
    ws = drills[0]
    preds = _rescored(ws, tmp_path)
    capsys.readouterr()
    main.main(["--config", _config(ws, "cli_visualize"), "visualize",
               "--prediction_path", preds, "--out_dir",
               str(tmp_path / "port"), "-n", "4", "--show_suppressed",
               "--max_dets", "2"])
    written = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jax_visualize(preds, str(ws["data_dir"]), str(tmp_path / "jax"),
                         n_images=4, hide_suppressed=False, max_dets=2)
    assert [os.path.basename(p) for p in written["written"]] == \
        [os.path.basename(p) for p in want]
    for g, w in zip(written["written"], want):
        from PIL import Image

        np.testing.assert_array_equal(read_png_rgb(g),
                                      np.asarray(Image.open(w)))


def test_every_jax_command_is_a_port_command():
    """No command of the JAX CLI is left unported."""
    from mapping_tpu.main import main as jax_cli

    port = main._parser()._subparsers._group_actions[0].choices
    assert set(jax_cli.commands) <= set(port)
