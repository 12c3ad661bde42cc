"""Training from the port's CLI against the JAX package's, on the CPU.

The trainer with its callbacks (ResNet34 at 64^2, float32, batch 2 or 4):
a run stopped after 3 epochs and resumed with a schedule of 5 trains
exactly 5 steps, ends at epoch 4, and holds weights, Adam's moments and
the schedule of an uninterrupted 5-epoch run (1e-6; they come out equal);
validation changes no loss, BatchNorm statistic, train/eval mode or
random draw; the best weights are a copy; the folded serving copy follows
every step; warm start loads weights only. `_begin_stage` in the four
cases of tests/test_warm_start.py gives the JAX package's outcome on the
JAX directory layout, with the port's file names. Then `train` /
`train_evaluate` through `mapping_tpu_torch.main` on the synthetic
fixture beside the JAX `manager.train`: the same files under the two
naming schemes, the same epochs and steps in the sidecar and the resume
file, the same metric channels.
"""

import json
import shutil
from pathlib import Path

import flax
import numpy as np
import pytest
import torch

import mapping_tpu.manager as jax_manager
import mapping_tpu_torch.manager as port_manager
from mapping_tpu.config import build_config as jax_build_config
from mapping_tpu.pipelines import UNetPipeline as JaxPipeline
from mapping_tpu_torch import main as cli
from mapping_tpu_torch.config import build_config
from mapping_tpu_torch.pipelines import UNetPipeline
from mapping_tpu_torch.train import trainer as trainer_module
from mapping_tpu_torch.train.callbacks import Callback
from mapping_tpu_torch.train.checkpoint import load_train_state
from mapping_tpu_torch.train.trainer import UNetTrainer
from tests.torch_train_workspace import PARAMS, config, make_experiment

torch.set_num_threads(2)

LOSS_PARAMS = {"imsize": (64, 64)}


def _trainer(epochs, cc=None, lr=1e-3, gamma=0.5):
    return UNetTrainer(
        model_params={"encoder": "ResNet34", "dtype": "float32"},
        optimizer_params={"lr": lr, "gamma": gamma, "weight_decay": 1e-4},
        loss_params=LOSS_PARAMS, training_config={"epochs": epochs},
        callbacks_config=cc, loss_name="ce", input_size=(64, 64),
        device="cpu")


def _datagen(n_batches=2, seed=0):
    """A fixed flow of n_batches batches of 2 tiles of 64^2 (every pass
    the same batches, as the JAX package's resume tests use)."""
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(n_batches):
        img = rng.rand(2, 64, 64, 3).astype(np.float32)
        mask = (img.mean(-1) > 0.5).astype(np.float32)
        batches.append({"image": torch.from_numpy(img),
                        "target": torch.from_numpy(np.stack(
                            [mask, np.zeros_like(mask),
                             np.ones_like(mask)], -1))})
    return batches, n_batches


def _cc(ck_dir, **extra):
    return {"checkpoint_dir": str(ck_dir), "resume": True, "resume_every": 1,
            "patience": 100, "minimize": True, "validate_with_map": False,
            "best_write_every": 1, **extra}


@pytest.fixture
def workdir(tmp_path):
    """tmp_path, emptied after the test: resume files of ResNet34 weights
    and Adam's moments are ~450 MB each."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _adam_moments(payload):
    return [(k, state[k]) for state in payload["optimizer"]["state"].values()
            for k in ("exp_avg", "exp_avg_sq")]


def test_resumed_run_equals_an_uninterrupted_one(workdir):
    """3 epochs, then the same command with 5: exactly 5 epochs of
    optimizer steps (2 batches an epoch: 10), epoch_id 4 in the sidecar,
    and weights,
    BatchNorm statistics, Adam's moments and step counts, and the
    StepLR schedule equal to those of a 5-epoch run (1e-6)."""
    datagen = _datagen()
    cc = _cc(workdir / "killed")
    _trainer(3, cc).fit(datagen, validation_datagen=datagen)
    first = load_train_state(workdir / "killed" / "last.pt")
    assert first["step"] == 6 and first["aux"]["epoch_id"] == 2
    resumed = _trainer(5, cc).fit(datagen, validation_datagen=datagen)
    assert resumed.step == 10 and len(resumed.train_losses) == 4
    straight = _trainer(5, _cc(workdir / "straight"))
    straight.fit(datagen, validation_datagen=datagen)
    a, b = (load_train_state(workdir / d / "last.pt")
            for d in ("killed", "straight"))
    assert a["aux"]["epoch_id"] == b["aux"]["epoch_id"] == 4
    assert a["step"] == b["step"] == 10
    assert a["scheduler"] == b["scheduler"]
    assert a["scheduler"]["last_epoch"] == 10
    for k, v in b["model"].items():
        torch.testing.assert_close(a["model"][k], v, rtol=0, atol=1e-6)
    for (name, got), (_, want) in zip(_adam_moments(a), _adam_moments(b)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert [s["step"] for s in a["optimizer"]["state"].values()] == \
        [s["step"] for s in b["optimizer"]["state"].values()]
    assert json.loads((workdir / "killed" / "last.pt.aux.json").read_text()
                      ) == a["aux"]


def test_completed_run_does_not_retrain(workdir):
    datagen = _datagen(n_batches=1)
    cc = _cc(workdir / "ck")
    _trainer(3, cc).fit(datagen, validation_datagen=datagen)
    again = _trainer(3, cc).fit(datagen, validation_datagen=datagen)
    assert again.step == 3 and again.train_losses == []


def test_resume_restores_adam_on_the_models_device(workdir):
    """last.pt reads back with torch.load(weights_only=True): Adam's
    moments go onto the model's parameters' device and dtype, the StepLR
    position and the rate follow, the step count is restored."""
    datagen = _datagen(n_batches=1)
    t = _trainer(2, _cc(workdir / "ck")).fit(datagen,
                                             validation_datagen=datagen)
    fresh = _trainer(2)
    fresh._ensure_state(steps_per_epoch=1)
    aux = fresh.load_train_state(workdir / "ck" / "last.pt")
    assert aux["epoch_id"] == 1 and fresh.step == 2
    assert fresh.scheduler.last_epoch == t.scheduler.last_epoch == 2
    assert fresh.optimizer.param_groups[0]["lr"] == pytest.approx(
        1e-3 * 0.25)
    for p in fresh.model.parameters():
        state = fresh.optimizer.state[p]
        assert state["exp_avg"].device == p.device
        assert state["exp_avg"].dtype == p.dtype


def test_a_jax_resume_file_is_refused(workdir):
    """The port resumes only from its own last.pt: a JAX last.msgpack in
    the checkpoint dir raises, naming it, before any step."""
    (workdir / "ck").mkdir()
    (workdir / "ck" / "last.msgpack").write_bytes(b"jax state")
    t = _trainer(1, _cc(workdir / "ck"))
    with pytest.raises(RuntimeError, match="last.msgpack is a resume file "
                                           "of the JAX package"):
        t.fit(_datagen(n_batches=1))
    assert t.step == 0


class _Probe(Callback):
    """Records, at every epoch end, the model's mode, the BatchNorm
    running statistics and the global random state."""

    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def on_epoch_end(self, *a, **kw):
        model = self.trainer.model
        self.seen.append((model.training, torch.random.get_rng_state(),
                          {k: v.clone() for k, v in model.state_dict().items()
                           if "running" in k}))
        super().on_epoch_end(*a, **kw)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    root = make_experiment(tmp_path_factory.mktemp("train_cli"))
    yield root
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("validate_with_map", [False, True])
def test_validation_leaves_training_untouched(workdir, experiment,
                                              monkeypatch, validate_with_map):
    """A fit with per-epoch validation (the loss, or COCO mAP through
    FusedServe on the synthetic val split) gives the same losses as a fit
    without it, and the validation changes neither the BatchNorm running
    statistics, the model's train/eval mode nor the global random state:
    probes before and after the other callbacks see the same."""
    from mapping_tpu_torch.data.loader import SegmentationLoader
    from mapping_tpu_torch.data.metadata import read_metadata

    rows = [r for r in read_metadata(experiment / "meta" / "metadata.csv")
            if r["is_valid"] == 1]
    loader = SegmentationLoader(size=(64, 64), batch_size_inference=4,
                                device="cpu")
    x = [r["file_path_image"] for r in rows]
    y = [r["file_path_mask_eroded_0_dilated_0"] for r in rows]
    valid = loader.transform(x, y, x, y)["validation_datagen"]
    datagen = _datagen()
    plain = _trainer(2).fit(datagen)

    before, after = [], []
    build = trainer_module.default_unet_callbacks

    def with_probes(cc):
        cbs = build(cc)
        cbs.callbacks = ([_Probe(before)] + cbs.callbacks[:-1]
                         + [_Probe(after), cbs.callbacks[-1]])
        return cbs

    monkeypatch.setattr(trainer_module, "default_unet_callbacks", with_probes)
    cc = _cc(workdir / "ck", validate_with_map=validate_with_map,
             minimize=not validate_with_map,
             data_dir=str(experiment / "data"))
    validated = _trainer(2, cc).fit(datagen, validation_datagen=valid,
                                    meta_valid=rows)
    assert validated.train_losses == plain.train_losses
    assert len(validated.validation_loss) == 2
    for (mode_b, rng_b, stats_b), (mode_a, rng_a, stats_a) in zip(before,
                                                                  after):
        assert mode_b == mode_a and torch.equal(rng_b, rng_a)
        assert all(torch.equal(stats_b[k], stats_a[k]) for k in stats_b)


def test_best_weights_are_a_copy_loaded_at_the_end(workdir, monkeypatch):
    """Validation improves only at epoch 0: best.pt holds epoch 0's
    weights (not the live ones, which .cpu() would alias on the CPU), and
    fit ends on them."""
    seen = []

    class Capture(Callback):
        def on_epoch_end(self, *a, **kw):
            seen.append({k: v.clone() for k, v in
                         self.trainer.model.state_dict().items()})
            super().on_epoch_end(*a, **kw)

    build = trainer_module.default_unet_callbacks

    def with_capture(cc):
        cbs = build(cc)
        cbs.callbacks.append(Capture())
        return cbs

    monkeypatch.setattr(trainer_module, "default_unet_callbacks",
                        with_capture)
    t = _trainer(3, _cc(workdir / "ck"))
    values = iter([1.0, 2.0, 3.0])
    monkeypatch.setattr(t, "score_validation",
                        lambda datagen: {"sum": np.float32(next(values))})
    datagen = _datagen(n_batches=1)
    t.fit(datagen, validation_datagen=datagen)
    best = torch.load(workdir / "ck" / "best.pt", weights_only=True)
    final = t.model.state_dict()
    for k in seen[0]:
        assert torch.equal(best[k], seen[0][k])
        assert torch.equal(final[k], seen[0][k])
    assert any(not torch.equal(seen[0][k], seen[2][k]) for k in seen[0])


def test_folded_serving_copy_follows_every_step():
    """The BN-folded copy that validation serves is folded again after
    the weights change: at each epoch end it gives the float32 master's
    probabilities (1e-4), though it was first folded before training."""
    t = _trainer(2)
    images = _datagen()[0][0]["image"]
    t.probs_apply_fn()(images)  # folds the initial weights
    gaps = []

    class Compare(Callback):
        def on_epoch_end(self, *a, **kw):
            served = t.probs_apply_fn()(images)
            gaps.append(float((served - t._predict_step(images)).abs().max()))
            super().on_epoch_end(*a, **kw)

    t._build_callbacks = lambda: trainer_module.CallbackList([Compare()])
    t.fit(_datagen())
    assert len(gaps) == 2 and max(gaps) <= 1e-4, gaps


@pytest.mark.parametrize("source", ["cache", "resume file"])
def test_warm_start_loads_weights_only(workdir, source):
    """warm_start(path) of a cache or a resume file: the weights, a fresh
    optimizer, step 0 and a fresh schedule, as the JAX trainer's; the
    next fit trains from those weights."""
    datagen = _datagen(n_batches=1)
    stage1 = _trainer(2, _cc(workdir / "ck")).fit(datagen)
    path = workdir / "unet.pt"
    stage1.save(path)
    if source == "resume file":
        path = workdir / "ck" / "last.pt"
        weights = load_train_state(path)["model"]
    else:
        weights = stage1.state_dict()
    stage2 = _trainer(1, lr=1e-4).warm_start(str(path))
    assert stage2.optimizer is None  # applied on first use, like JAX's
    stage2._ensure_state()
    assert stage2.warm_started_from == str(path) and stage2.step == 0
    assert stage2.optimizer.param_groups[0]["lr"] == 1e-4
    assert not stage2.optimizer.state
    for k, v in stage2.state_dict().items():
        assert torch.equal(v, weights[k])
    stage2.fit(datagen)
    assert stage2.step == 1
    assert any(not torch.equal(v, weights[k])
               for k, v in stage2.state_dict().items())


# -------------------------------------------------------- multistage

def _write(path: Path, data: bytes):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)


CASES = {
    # (files under the checkpoint dir, archives present, outcome)
    "archive": ({"last": b"stage1-resume", "STAGE_COMPLETE": b"done"},
                False),
    "killed": ({"last": b"stage2-partial"}, True),
    "legacy": ({"best": b"legacy-best"}, False),
    "ambiguous": ({"last": b"ambiguous-resume"}, False),
}


def _stage_layout(root, ext, case):
    """tests/test_warm_start.py's disk state of `case` with the file
    names of a package whose checkpoints end in `ext`; returns the file
    tree as (relative path with `ext` named EXT, bytes)."""
    files, archives = CASES[case]
    ck = root / "checkpoints" / "unet"
    ck.mkdir(parents=True)
    for name, data in files.items():
        _write(ck / (name if name == "STAGE_COMPLETE" else name + ext), data)
    if archives:
        (root / "checkpoints" / "unet.stage1").mkdir()
    _write(root / "transformers" / f"unet{ext}", b"stage1-weights")


def _tree(root, ext):
    return sorted((str(p.relative_to(root)).replace(ext, ".EXT"),
                   p.read_bytes()) for p in root.rglob("*") if p.is_file()
                  ) + sorted(str(p.relative_to(root)) for p in
                             root.rglob("*") if p.is_dir())


@pytest.mark.parametrize("case", list(CASES))
def test_begin_stage_matches_jax(tmp_path, case):
    """_begin_stage on each case's disk state, JAX names (.msgpack) for
    the JAX pipeline and the port's (.pt) for the port's: the same tree
    afterwards (archives moved or copied, or nothing touched), the same
    warm-start source, or both refuse the ambiguous case."""
    outcomes = []
    for name, ext in (("jax", ".msgpack"), ("port", ".pt")):
        root = tmp_path / name
        _stage_layout(root, ext, case)
        params = {**PARAMS, "experiment_dir": str(root), "warm_start": 1}
        if name == "jax":
            pipe = JaxPipeline(jax_build_config(None, overrides=params),
                               train_mode=True)
            begin = pipe._begin_stage
        else:
            pipe = UNetPipeline(build_config(None, overrides=params),
                                train_mode=True)
            begin = lambda: pipe._begin_stage(pipe.trainer_cache_path)
        try:
            begin()
            source = pipe.trainer._warm_start_path
            outcome = ("warm start", Path(source).name.replace(ext, ".EXT"))
        except RuntimeError as e:
            assert "resume sidecar" in str(e)
            outcome = ("refused",)
        outcomes.append((outcome, _tree(root, ext)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][0][0] == ("refused" if case == "ambiguous"
                                 else "warm start")


def test_warm_start_and_overwrite_exclude_each_other(tmp_path):
    for mod in (jax_manager, port_manager):
        manager = mod.PipelineManager(None, overrides={
            "experiment_dir": str(tmp_path / "experiment"),
            "meta_dir": str(tmp_path / "meta"), "overwrite": 1})
        with pytest.raises(ValueError, match="mutually exclusive"):
            manager.train("unet", dev_mode=True, warm_start=True)


def test_warm_start_flag_holds_for_one_call(tmp_path, monkeypatch):
    """train(warm_start=True) sets the flag for that call only, in both
    packages: a later train on the same manager does not warm-start."""
    for mod in (jax_manager, port_manager):
        seen = []
        monkeypatch.setattr(mod, "train", lambda name, dev, config:
                            seen.append(config.params.get("warm_start", 0)))
        manager = mod.PipelineManager(None, overrides={
            "experiment_dir": str(tmp_path / "experiment"),
            "meta_dir": str(tmp_path / "meta")})
        manager.train("unet", dev_mode=True, warm_start=True)
        manager.train("unet", dev_mode=True)
        assert seen == [1, 0]
        assert manager.config.params.get("warm_start", 0) == 0


# ------------------------------------------------------------- the CLI

TRAIN = {"epochs_nr": 2, "resume_every": 1, "best_write_every": 1,
         "evaluation_data_sample": 5}


@pytest.fixture(scope="module")
def trained(experiment):
    """`train_evaluate -p unet_weighted` through the port's CLI and the
    JAX manager's train and evaluate, one experiment each."""
    root = experiment
    jax = jax_manager.PipelineManager(config(root, "jax", **TRAIN))
    jax.train("unet_weighted", dev_mode=False)
    jax_scores = jax.evaluate("unet_weighted", False, None)
    port = cli.main(["--config", config(root, "port", **TRAIN),
                     "train_evaluate", "-p", "unet_weighted"])
    return {"root": root, "jax_scores": jax_scores, "port": port}


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def test_cli_train_writes_the_jax_files_under_the_port_names(trained):
    root = trained["root"]
    names = {"unet.msgpack": "unet.pt", "best.msgpack": "best.pt",
             "last.msgpack": "last.pt"}
    jax_files = []
    for path in _files(root / "jax"):
        for a, b in names.items():
            path = path.replace(a, b)
        jax_files.append(path)
    assert _files(root / "port") == sorted(jax_files) == sorted([
        "checkpoints/unet/STAGE_COMPLETE", "checkpoints/unet/best.pt",
        "checkpoints/unet/last.pt", "checkpoints/unet/last.pt.aux.json",
        "metrics.jsonl", "prediction.json", "transformers/unet.pt"])


def test_cli_train_epochs_and_steps_match_jax(trained):
    """The sidecars hold epoch 1 and the same callback keys; the resume
    files hold 2 epochs of 2 steps (4 train tiles, batch 2)."""
    root = trained["root"]
    ck = {name: root / name / "checkpoints" / "unet"
          for name in ("jax", "port")}
    jax_aux = json.loads((ck["jax"] / "last.msgpack.aux.json").read_text())
    port_aux = json.loads((ck["port"] / "last.pt.aux.json").read_text())
    assert jax_aux["epoch_id"] == port_aux["epoch_id"] == 1
    assert {k: set(v) for k, v in jax_aux["callbacks"].items()} == \
        {k: set(v) for k, v in port_aux["callbacks"].items()}
    jax_state = flax.serialization.msgpack_restore(
        (ck["jax"] / "last.msgpack").read_bytes())
    assert int(np.asarray(jax_state["step"])) == \
        load_train_state(ck["port"] / "last.pt")["step"] == 4


def test_cli_metric_channels_match_jax(trained):
    """metrics.jsonl: the same channels, as often, in the same order;
    finite losses; the validation mAP and AP/AR within [0, 1]."""
    root = trained["root"]
    lines = {name: [json.loads(l) for l in (root / name / "metrics.jsonl")
                    .read_text().splitlines()] for name in ("jax", "port")}
    assert [m["channel"] for m in lines["jax"]] == \
        [m["channel"] for m in lines["port"]]
    assert [m["x"] for m in lines["jax"]] == [m["x"] for m in lines["port"]]
    values = {m["channel"]: m["y"] for m in lines["port"]}
    assert set(values) == {"unet batch loss", "unet epoch_val sum",
                           "Precision", "Recall"}
    assert all(np.isfinite(m["y"]) for m in lines["port"])
    assert all(0 <= m["y"] <= 1 for m in lines["port"]
               if m["channel"] != "unet batch loss")
    assert all(0 <= s <= 1 for s in trained["jax_scores"])


def test_cli_train_again_reads_the_cache(trained):
    """A second `train` of a finished experiment loads the cache and
    trains nothing, in the port as in the JAX package."""
    root = trained["root"]
    last = root / "port" / "checkpoints" / "unet" / "last.pt"
    stamp = last.stat().st_mtime_ns
    manager = cli.main(["--config", config(root, "port", **TRAIN), "train"])
    assert last.stat().st_mtime_ns == stamp
    assert manager.params.experiment_dir == str(root / "port")


def test_cli_warm_start_trains_the_next_stage(trained):
    """`train -w` with another rate: stage 1 archived
    (checkpoints/unet.stage1, transformers/unet.stage1.pt, bit-equal), and
    a fresh schedule of 1 epoch from its weights."""
    root = trained["root"]
    exp = root / "port"
    stage1 = (exp / "transformers" / "unet.pt").read_bytes()
    cli.main(["--config", config(root, "port", **{**TRAIN, "epochs_nr": 1,
                                                  "lr": 1e-4}),
              "train", "-w"])
    assert (exp / "transformers" / "unet.stage1.pt").read_bytes() == stage1
    assert (exp / "checkpoints" / "unet.stage1" / "STAGE_COMPLETE").exists()
    payload = load_train_state(exp / "checkpoints" / "unet" / "last.pt")
    assert payload["step"] == 2 and payload["aux"]["epoch_id"] == 0
    assert payload["optimizer"]["param_groups"][0]["lr"] == 1e-4
    assert (exp / "transformers" / "unet.pt").read_bytes() != stage1


def test_cli_train_continues_a_jax_experiment(trained):
    """A JAX experiment's unet.msgpack counts as the cache: `train` loads
    it and trains nothing; `train -w` archives it as unet.stage1.msgpack
    (and the JAX checkpoint dir, whose last.msgpack the port would refuse)
    and trains the port's stage from its weights."""
    root = trained["root"]
    exp = root / "from_jax"
    shutil.copytree(root / "jax" / "transformers", exp / "transformers")
    shutil.copytree(root / "jax" / "checkpoints", exp / "checkpoints")
    cfg = config(root, "from_jax", **{**TRAIN, "epochs_nr": 1})
    cli.main(["--config", cfg, "train"])
    assert not (exp / "transformers" / "unet.pt").exists()
    cli.main(["--config", cfg, "train", "-w"])
    assert (exp / "transformers" / "unet.stage1.msgpack").exists()
    assert (exp / "checkpoints" / "unet.stage1" / "last.msgpack").exists()
    assert (exp / "transformers" / "unet.pt").exists()
    assert load_train_state(exp / "checkpoints" / "unet" / "last.pt"
                            )["step"] == 2
