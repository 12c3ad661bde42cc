"""The port's serving artifact (mapping_tpu_torch/infer/artifact.py) and
the `export`, `evaluate --artifact`, `predict_on_dir --artifact` and
`serve` commands, against the live port and the JAX package.

The workspace is that of tests/test_torch_evaluate.py: the synthetic
fixture's 6 val tiles of 300^2 JPEG and a JAX-written `unet.msgpack` of
seeded ResNet34 weights, served at 64^2, batch 4, float32, on the CPU.
The port exports `unet_weighted` with `serve_batch_buckets: "1,2"`
(programs for batches 1, 2 and 4).

Tolerances: the replay of an exported program runs the live FusedServe's
ATen ops on the same device, so labels and areas must be exact and scores
within 1e-6 relative (the replay is expected to be bit-equal, and is
asserted so where it is). Against the JAX package's artifact the
instances follow tests/test_torch_evaluate.assert_same_instances (a pixel
may differ only within the measured |port - JAX| of the threshold).
"""

import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from mapping_tpu_torch import main
from mapping_tpu_torch.config import build_config
from mapping_tpu_torch.infer import artifact
from mapping_tpu_torch.infer.artifact import (export_serving_artifact,
                                              load_artifact,
                                              predict_dir_with_artifact,
                                              predict_paths_with_artifact)
from mapping_tpu_torch.manager import PipelineManager
from mapping_tpu_torch.pipelines import PIPELINES
from tests.test_torch_evaluate import (PIPELINE, _prediction,
                                       assert_same_instances, make_workspace,
                                       served_probabilities, write_config)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BUCKETS = {"serve_batch_buckets": "1,2"}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from mapping_tpu.utils import native as jax_native

    for _ in range(3):  # a worker that lost the JAX package's build race
        if jax_native._lib.build():
            break
    assert jax_native._lib.available()
    root = tmp_path_factory.mktemp("artifact")
    yield make_workspace(root)
    shutil.rmtree(root)  # ~1 GB of checkpoints and programs


@pytest.fixture(scope="module")
def exported(workspace):
    """The CLI's `export -p unet_weighted` (device cpu): (config, dir,
    manifest as printed)."""
    ws = workspace
    config = write_config(ws, "port_export", BUCKETS)
    out = ws["root"] / "artifact"
    main.main(["--config", config, "export", "-p", PIPELINE, "--dir_path",
               str(out)])
    manifest = json.loads((out / "manifest.json").read_text())
    return config, out, manifest


def _live(config, tiles, pipeline=PIPELINE, features=False):
    """The live port's FusedServe outputs for uint8 tiles."""
    pipe = PIPELINES[pipeline]["inference"](build_config(config))
    base = getattr(pipe, "base", pipe)
    base._ensure_weights()
    return base.serve_program(features)(base.loader.infer_preprocess(tiles))


def _assert_replay_equals_live(got, want):
    """Labels and areas exact, scores and features 1e-6 relative. Where
    the live serve escalated an image past the instance pad, the replay
    keeps the exported pad: its instances are the live ones up to it."""
    assert len(got) == len(want)
    pad = got[1].shape[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2][:, :, :pad])
    np.testing.assert_allclose(got[1], want[1][:, :, :pad], rtol=1e-6,
                               atol=0)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g, w[:, :, :pad], rtol=1e-6, atol=0)


def test_export_writes_one_program_per_bucket(exported):
    _, out, manifest = exported
    assert manifest["batch_buckets"] == [1, 2, 4]
    assert manifest["outputs"] == ["labels_i16", "scores", "areas"]
    assert manifest["exported_on_device"] == "cpu"
    assert manifest["torch_version"] == torch.__version__
    assert manifest["quantized"] is False and not manifest["scoring_model"]
    assert manifest["image_hw"] == [300, 300]
    assert manifest["pipeline"] == "UNetPipeline"
    assert "jax_version" not in manifest and "platforms" not in manifest
    assert sorted(p.name for p in out.iterdir()) == [
        "manifest.json", "serve_b1.pt2", "serve_b2.pt2", "serve_b4.pt2"]


def test_exported_program_holds_the_ccl_op(exported):
    """The labelling is the registered op, not the plain version's traced
    ops (whose data-dependent nonzero could not be exported)."""
    _, out, _ = exported
    program = torch.export.load(str(out / "serve_b4.pt2"))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("mapping_tpu_torch.ccl_label.default") == 1
    assert not [t for t in targets if "nonzero" in t]


@pytest.mark.parametrize("shape,dtype", [((2, 17, 19), torch.bool),
                                         ((3, 32, 64), torch.uint8),
                                         ((1, 1, 1), torch.bool)])
def test_ccl_op_passes_opcheck(shape, dtype):
    from mapping_tpu_torch.ops.ccl import ccl_label

    mask = (torch.rand(shape, generator=torch.Generator().manual_seed(1))
            > 0.5).to(dtype)
    torch.library.opcheck(ccl_label, (mask,))


def test_replay_and_evaluate_in_a_process_without_jax_or_pil(workspace,
                                                            exported,
                                                            tmp_path):
    """A fresh process with jax, flax, PIL and the JAX package blocked
    loads the artifact, replays the 6 tiles (bucket padding and chunking:
    4 + 2 padded to 2) and runs the CLI's `evaluate --artifact` and
    `predict_on_dir --artifact`; the replay equals the live FusedServe
    bit for bit, and evaluate gives the live `evaluate`'s AP/AR and
    prediction.json."""
    ws = workspace
    config, out, _ = exported
    art_config = write_config(ws, "port_evaluate_artifact", BUCKETS)
    code = (
        "import json, sys\n"
        "for m in ('jax', 'flax', 'PIL', 'mapping_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from mapping_tpu_torch import main\n"
        "from mapping_tpu_torch.infer.artifact import load_artifact\n"
        "art = load_artifact(sys.argv[1])\n"
        "outs = art(np.load(sys.argv[2]))\n"
        "np.savez(sys.argv[3], *outs)\n"
        "manager = main.main(['--config', sys.argv[4], 'evaluate', "
        "'--artifact', sys.argv[1]])\n"
        "main.main(['--config', sys.argv[4], 'predict_on_dir', "
        "'--artifact', sys.argv[1], '--dir_path', sys.argv[5], "
        "'--prediction_path', sys.argv[6]])\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'PIL', 'mapping_tpu') and sys.modules[k] is not "
        "None]\n"
        "assert not bad, bad\n"
        "print('TIMINGS ' + json.dumps(manager.timings))\n")
    np.save(tmp_path / "tiles.npy", ws["tiles"])
    images = ws["data_dir"] / "val" / "images"
    proc = subprocess.run(
        [sys.executable, "-c", code, str(out), str(tmp_path / "tiles.npy"),
         str(tmp_path / "outs.npz"), art_config, str(images),
         str(tmp_path / "dir.json")],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(tmp_path / "outs.npz") as npz:
        got = [npz[f"arr_{i}"] for i in range(3)]
    want = _live(config, ws["tiles"])
    _assert_replay_equals_live(got, want)
    for g, w in zip(got, want):  # found bit-equal on the CPU
        np.testing.assert_array_equal(g, w)

    live = PipelineManager(write_config(ws, "port_live", BUCKETS))
    ap, ar = live.evaluate(PIPELINE, False, None)
    metrics = [json.loads(line) for line in (
        ws["root"] / "port_evaluate_artifact" / "metrics.jsonl").open()]
    assert [m["y"] for m in metrics] == [ap, ar]
    assert _prediction(ws, "port_evaluate_artifact") == \
        _prediction(ws, "port_live")
    timings = json.loads(proc.stdout.split("TIMINGS ")[-1])
    assert timings["images"] == 6
    for key in ("load_s", "decode_s", "device_s", "annotation_s",
                "cocoeval_s", "total_s"):
        assert timings[key] > 0
    # predict_on_dir --artifact: the same instances under the file ids
    by_dir = json.loads((tmp_path / "dir.json").read_text())
    assert sorted({p["image_id"] for p in by_dir}) == list(range(6))
    gt = json.loads((ws["data_dir"] / "val" / "annotation.json").read_text())
    by_name = {im["file_name"]: im["id"] for im in gt["images"]}
    ids = {i: by_name[Path(path).name] for i, path in enumerate(ws["paths"])}
    assert _sorted([{**p, "image_id": ids[p["image_id"]]}
                    for p in by_dir]) == _sorted(_prediction(ws, "port_live"))


def _sorted(prediction):
    return sorted(prediction, key=lambda p: json.dumps(p, sort_keys=True))


def test_bucket_padding_and_chunking(workspace, exported):
    """3 tiles pad to the 4-bucket; 9 run as 4 + 4 + 1 (the 1-bucket for
    the tail); outputs per image equal the live program's on the same
    batches (a float32 forward on the CPU may round differently at
    another batch size)."""
    ws = workspace
    config, out, _ = exported
    art = load_artifact(str(out))
    tiles = np.concatenate([ws["tiles"], ws["tiles"][:3]])
    got = art(tiles)
    assert got[0].shape[0] == 9 and got[0].dtype == np.int16
    chunks = [_live(config, tiles[i:i + 4]) for i in (0, 4, 8)]
    _assert_replay_equals_live(got, [np.concatenate(parts)
                                     for parts in zip(*chunks)])
    got3 = art(tiles[:3])
    for g, w in zip(got3, got):
        np.testing.assert_array_equal(g, w[:3])
    with pytest.raises(ValueError, match="no exported program"):
        art.dispatch(tiles[:3])
    outs = art.collect(art.dispatch(tiles[:2]))
    for g, w in zip(outs, got):
        np.testing.assert_array_equal(g, w[:2])


def test_replicate_over_two_cpus_equals_one(workspace, exported):
    ws = workspace
    _, out, _ = exported
    tiles = np.concatenate([ws["tiles"], ws["tiles"][:3]])
    art = load_artifact(str(out))
    want = art(tiles)
    assert art.replicate(["cpu"])._replicas is None  # one: a warning
    dp = load_artifact(str(out)).replicate(["cpu", "cpu"])
    assert len(dp._replicas) == 2
    for g, w in zip(dp(tiles), want):
        np.testing.assert_array_equal(g, w)


def test_input_validation_device_class_and_version_gate(workspace, exported,
                                                       tmp_path):
    ws = workspace
    config, out, manifest = exported
    art = load_artifact(str(out))
    with pytest.raises(ValueError, match="tiles"):
        art(np.zeros((1, 32, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        art(np.zeros((300, 300, 3), np.uint8))
    with pytest.raises(ValueError, match="non-empty"):
        art(np.zeros((0, 300, 300, 3), np.uint8))
    with pytest.raises(FileNotFoundError):
        load_artifact(str(tmp_path / "nope"))
    # a program is bound to the device class it was exported on
    with pytest.raises(ValueError, match="exported on cpu"):
        load_artifact(str(out), device="cuda")
    pipe = PIPELINES[PIPELINE]["inference"](build_config(config))
    for platforms in (["cuda"], ["tpu"], ["cpu", "cuda"]):
        with pytest.raises(ValueError, match="platforms"):
            export_serving_artifact(pipe, build_config(config),
                                    str(tmp_path / "x"), platforms=platforms)
    gated = tmp_path / "gated"
    gated.mkdir()
    (gated / "manifest.json").write_text(json.dumps(
        {**manifest, "artifact_version": 999}))
    with pytest.raises(ValueError, match="version"):
        load_artifact(str(gated))


@pytest.fixture(scope="module")
def jax_artifact(workspace):
    """The JAX package's artifact of the same pipeline and weights
    (bucket 4 only)."""
    from mapping_tpu.infer.artifact import \
        export_serving_artifact as jax_export
    from mapping_tpu.manager import PipelineManager as JaxManager
    from mapping_tpu.pipelines import PIPELINES as JAX_PIPELINES

    ws = workspace
    manager = JaxManager(write_config(ws, "jax_export",
                                      {"serve_batch_buckets": ""}))
    pipeline = JAX_PIPELINES[PIPELINE]["inference"](manager.config)
    out = ws["root"] / "jax_artifact"
    manifest = jax_export(pipeline, manager.config, str(out))
    return out, manifest


def test_jax_artifact_is_refused_naming_what_it_holds(jax_artifact,
                                                      exported):
    out, manifest = jax_artifact
    with pytest.raises(ValueError, match="JAX serving artifact") as info:
        load_artifact(str(out))
    assert "serve_b4.bin" in str(info.value)
    assert manifest["jax_version"] in str(info.value)
    # the port's manifest keeps the JAX fields but for the JAX-only ones
    _, _, port_manifest = exported
    jax_only = {"jax_version", "platforms", "exported_on_backend",
                "disabled_safety_checks", "leaf_dtypes"}
    assert set(port_manifest) == (set(manifest) - jax_only) | {
        "torch_version", "exported_on_device"}


def test_predict_on_dir_artifact_matches_jax(workspace, exported,
                                             jax_artifact, tmp_path):
    """predict_on_dir --artifact of both packages on the val images: the
    same instances image by image, but where a pixel's JAX probability
    lies within the measured |port - JAX| of the threshold."""
    from mapping_tpu.infer.artifact import \
        predict_dir_with_artifact as jax_predict

    ws = workspace
    _, out, _ = exported
    images = str(ws["data_dir"] / "val" / "images")
    want = jax_predict(str(jax_artifact[0]), images,
                       str(tmp_path / "jax.json"))
    timings = {}
    got = predict_dir_with_artifact(str(out), images,
                                    str(tmp_path / "port.json"),
                                    timings=timings)
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert sorted({p["image_id"] for p in want}) == list(range(6))
    assert_same_instances(got, want,
                          served_probabilities(ws, PIPELINE, {}), range(6))
    assert timings["images"] == 6 and timings["device_s"] > 0
    with pytest.raises(ValueError, match="no images"):
        empty = tmp_path / "empty"
        empty.mkdir()
        predict_dir_with_artifact(str(out), str(empty),
                                  str(tmp_path / "e.json"))


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_tta_export_equals_live(workspace):
    """unet_tta's program holds the 12 deduplicated forwards, their
    inverses and the weighted gmean. On these random weights an image has
    more components than the 256-instance pad: the live serve escalates
    it, the replay keeps the pad and warns once."""
    ws = workspace
    config = write_config(ws, "port_tta", {"serve_batch_buckets": ""})
    pipe = PIPELINES["unet_tta"]["inference"](build_config(config))
    out = ws["root"] / "artifact_tta"  # removed with the workspace
    manifest = export_serving_artifact(pipe, build_config(config), str(out))
    assert manifest["tta_variants"] == 16 and manifest["batch_buckets"] == [4]
    art = load_artifact(str(out))
    records = _Records()
    artifact.logger.addHandler(records)
    try:
        got = art(ws["tiles"][:4])
        again = art(ws["tiles"][:4])
    finally:
        artifact.logger.removeHandler(records)
    want = _live(config, ws["tiles"][:4], "unet_tta")
    _assert_replay_equals_live(got, want)
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)
    overflow = [m for m in records.messages if "instance pad" in m]
    assert len(overflow) == (1 if want[1].shape[2] > 256 else 0)


def _scoring_model(path):
    """A small GBM fitted on random feature rows, in the port's file."""
    from mapping_tpu_torch.scoring import MODEL_COLUMNS, ScoringGBM

    rng = np.random.RandomState(0)
    x = rng.rand(200, len(MODEL_COLUMNS))
    y = x[:, 2] * 0.8
    model = ScoringGBM(model_params={"min_data": 5, "num_leaves": 8},
                       training_params={"number_boosting_rounds": 20})
    model._fit_estimator(x, y, x, y)
    path.parent.mkdir(parents=True, exist_ok=True)
    model.save(str(path))


def test_scoring_export_equals_live(workspace):
    """unet_scoring_model at category_layers [1, 19]: the program emits
    the feature tensor, the bundled GBM comes back through `converter()`,
    and both equal the live pipeline's."""
    from mapping_tpu_torch.constants import CATEGORY_IDS
    from mapping_tpu_torch.infer.daemon import scoring_convert_fn

    ws = workspace
    extra = {"serve_batch_buckets": "", "category_layers": [1, 19]}
    config = write_config(ws, "port_scoring", extra)
    _scoring_model(ws["root"] / "port_scoring" / "transformers"
                   / "scoring_model.pkl")
    pipe = PIPELINES["unet_scoring_model"]["inference"](build_config(config))
    out = ws["root"] / "artifact_scoring"  # removed with the workspace
    manifest = export_serving_artifact(pipe, build_config(config), str(out))
    assert manifest["outputs"][-1] == "features"
    assert manifest["scoring_model"] and manifest["emit_suppressed"] == 0
    art = load_artifact(str(out))
    tiles = ws["tiles"][:4]
    got = art(tiles)
    want = _live(config, tiles, "unet_scoring_model", features=True)
    _assert_replay_equals_live(got, want)
    convert = art.converter()
    live = scoring_convert_fn(pipe.model, pipe.category_layers,
                              pipe.nms.iou_threshold, emit_suppressed=False)
    # at the exported pad (the live serve escalated past it)
    want = [want[0]] + [w[:, :, :got[1].shape[2]] for w in want[1:]]
    for i in range(4):
        assert convert(i, got, i) == live(i, want, i)
    assert CATEGORY_IDS[1] is not None


def _post(port, body, image_id, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict", data=body,
        headers={"Content-Type": "image/jpeg", "X-Image-Id": str(image_id)})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())["annotations"]


def test_serve_artifact_and_pipeline_answer_predict(workspace, exported):
    """`serve --artifact` and `serve -p` over HTTP: lone requests of JPEG
    bytes run the 1-bucket programs, and each answer equals that image's
    annotations from the artifact's (or the pipeline's) batch-1 serve."""
    from mapping_tpu_torch.infer.daemon import (daemon_from_artifact,
                                                daemon_from_pipeline)

    ws = workspace
    config, out, _ = exported
    pipe = PIPELINES[PIPELINE]["inference"](build_config(config))
    art = load_artifact(str(out))
    daemons = {
        "artifact": daemon_from_artifact(str(out), port=0, max_wait_ms=1.0,
                                         device="cpu"),
        "pipeline": daemon_from_pipeline(pipe, build_config(config), port=0,
                                         max_wait_ms=1.0)}
    for d in daemons.values():
        d.start_background()
    try:
        for name, d in daemons.items():
            assert d.batcher._buckets == [1, 2, 4]
            for i in (0, 3):
                body = Path(ws["paths"][i]).read_bytes()
                got = _post(d.port, body, 10 + i)
                tile = ws["tiles"][i][None]
                outs = (art(tile) if name == "artifact" else
                        pipe.serve_program()(pipe.loader.infer_preprocess(
                            tile)))
                assert got == art.annotations(10 + i, outs[0][0],
                                              outs[1][0])
            assert d.batcher.stats["bucket_batches"]["1"] == 2
    finally:
        for d in daemons.values():
            d.shutdown()


def test_cli_serve_artifact_in_a_subprocess(workspace, exported):
    """`python3 -m mapping_tpu_torch.main serve --artifact D` answers
    /v1/health and /v1/predict (a JPEG tile: the batch-1 program's
    annotations of it) and stops on SIGTERM."""
    import signal
    import socket
    import urllib.error

    ws = workspace
    config, out, _ = exported
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "mapping_tpu_torch.main", "--config", config,
         "serve", "--artifact", str(out), "--port", str(port)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT),
                       # the thread count of this process (set above): a
                       # float sum split over other threads rounds apart
                       "OMP_NUM_THREADS": str(torch.get_num_threads())},
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, f"serve exited {proc.returncode}"
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/v1/health", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except (urllib.error.URLError, OSError):
                assert time.monotonic() < deadline, "no /v1/health"
                time.sleep(0.2)
        assert health["batch_buckets"] == [1, 2, 4]
        assert health["artifact_device"] == "cpu"
        got = _post(port, Path(ws["paths"][2]).read_bytes(), 3)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    art = load_artifact(str(out))
    outs = art(ws["tiles"][2][None])
    assert got == art.annotations(3, outs[0][0], outs[1][0])


def test_predict_paths_decodes_the_next_chunk_during_compute(monkeypatch):
    """Chunk k + 1 decodes on the look-ahead thread while chunk k runs: at
    least two decodes fall inside a replay window."""
    from mapping_tpu_torch.utils import native_decode

    events = []
    lock = threading.Lock()

    def fake_load(path):
        time.sleep(0.05)
        with lock:
            events.append(("decode", time.monotonic()))
        return np.zeros((8, 8, 3), np.uint8)

    monkeypatch.setattr(native_decode, "read_image", fake_load)

    class StubArt:
        device = torch.device("cpu")
        image_hw = (8, 8)
        manifest = {"batch_buckets": [2], "category_layers": [1, 1],
                    "max_instances": 4}

        def converter(self):
            return None

        def __call__(self, images):
            with lock:
                events.append(("call_start", time.monotonic()))
            time.sleep(0.2)
            with lock:
                events.append(("call_end", time.monotonic()))
            b = images.shape[0]
            return (np.zeros((b, 2, 8, 8), np.int16),
                    np.zeros((b, 2, 4), np.float32),
                    np.zeros((b, 2, 4), np.int32))

    timings = {}
    predict_paths_with_artifact(StubArt(), list(range(8)),
                                [f"img_{i}.png" for i in range(8)],
                                chunk_images=2, timings=timings)
    windows, start = [], None
    for kind, t in events:
        if kind == "call_start":
            start = t
        elif kind == "call_end":
            windows.append((start, t))
    decodes = [t for kind, t in events if kind == "decode"]
    assert sum(1 for t in decodes if any(a < t < b for a, b in windows)) >= 2
    assert timings["images"] == 8 and timings["decode_s"] > 0


def test_export_guards_as_jax(workspace):
    """export takes the segmentation pipelines and their scoring variants
    only, the latter with multiple thresholds, as the JAX package does."""
    from mapping_tpu_torch.infer.daemon import unwrap_scoring_pipeline

    ws = workspace
    config = build_config(write_config(ws, "port_guards", {}))
    with pytest.raises(ValueError, match="train-only"):
        unwrap_scoring_pipeline(PIPELINES["scoring_model"]["train"](config),
                                entry="export")
    with pytest.raises(ValueError, match=r"\[1, 19\]"):
        export_serving_artifact(
            PIPELINES["unet_scoring_model"]["inference"](config), config,
            "unused")
