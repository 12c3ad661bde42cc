"""The port's training callbacks against the JAX package's, class by class.

The same hook sequence (the trainer's fit loop: train begin, per epoch the
batch hooks and the epoch end, the break check, train end) drives a JAX
callback over a stand-in of the JAX trainer and the port's over a stand-in
of the port's, both given the same scripted validation values. What they
decide must be equal: the epoch early stopping breaks at, the best value
and when it is written, the sidecar JSON of the resume checkpoint, the
metrics.jsonl lines, the order of the default list. Then
`ValidationMonitorSegmentation._map_validation` runs in both packages on
the synthetic val split with the same weights: AP within 1e-6.
"""

import json
import shutil
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import mapping_tpu.train.callbacks as jax_cb
import mapping_tpu_torch.train.callbacks as port_cb
from mapping_tpu.pipelines import UNetPipeline as JaxPipeline
from mapping_tpu_torch.config import build_config
from mapping_tpu_torch.data.loader import load_image
from mapping_tpu_torch.data.metadata import read_metadata
from mapping_tpu_torch.pipelines import UNetPipeline
from mapping_tpu_torch.train.checkpoint import (load_train_state,
                                                save_train_state)
from tests.test_torch_evaluate import _centred_state_dict
from tests.torch_train_workspace import config, make_experiment
from tests.torch_guards import drop_tmp_path  # noqa: F401 (autouse)

torch.set_num_threads(2)


class _JaxState(SimpleNamespace):
    def replace(self, **kw):
        return _JaxState(**{**vars(self), **kw})


class _Fake:
    """What the callbacks read of a trainer: the memo of validation
    values, `score_validation` giving the scripted value of the k-th call,
    and weights that `set_weights` (an optimizer step) sets to a value."""

    def __init__(self, values):
        self.values = list(values)
        self.calls = 0
        self.validation_loss = {}
        self.resume_info = {}

    def score_validation(self, datagen):
        self.calls += 1
        return {"sum": np.float32(self.values[self.calls - 1])}


class JaxFake(_Fake):
    def __init__(self, values):
        super().__init__(values)
        self.state = _JaxState(params={"w": np.zeros(3, np.float32)},
                               batch_stats={}, opt_state={},
                               step=np.int32(0))

    def set_weights(self, value):
        self.state = self.state.replace(
            params={"w": np.full(3, value, np.float32)},
            step=np.int32(self.state.step + 1))


class PortFake(_Fake):
    def __init__(self, values):
        super().__init__(values)
        self.model = torch.nn.Linear(3, 1, bias=False)
        self.step = 0

    def set_weights(self, value):
        with torch.no_grad():
            self.model.weight.fill_(value)
        self.step += 1

    def save_train_state(self, path, aux):
        save_train_state(path, self.model.state_dict(), {}, None, self.step,
                         aux)

    def load_train_state(self, path):
        payload = load_train_state(path)
        self.model.load_state_dict(payload["model"])
        self.step = payload["step"]
        return payload["aux"]


def drive(cbs, trainer, epochs, batches=2, datagen=("valid flow", 1)):
    """The fit loop's hook sequence, one optimizer step an epoch that sets
    the weights to the epoch number; returns the epochs run."""
    trainer.resume_info = {}
    trainer._callbacks = cbs
    cbs.set_params(trainer, validation_datagen=datagen, meta_valid=None)
    cbs.on_train_begin()
    ran = []
    for epoch in range(trainer.resume_info.get("next_epoch", 0), epochs):
        cbs.on_epoch_begin()
        for b in range(batches):
            cbs.on_batch_begin()
            cbs.on_batch_end(metrics={"loss": 1.0 / (1 + epoch + b)})
        if hasattr(trainer, "set_weights"):
            trainer.set_weights(float(epoch))
        cbs.on_epoch_end()
        ran.append(epoch)
        if cbs.training_break():
            break
    cbs.on_train_end()
    return ran


PACKAGES = ((jax_cb, JaxFake), (port_cb, PortFake))


@pytest.mark.parametrize("minimize,values", [
    (True, [5.0, 4.0, 4.5, 4.2, 4.1, 3.0, 2.0]),
    (False, [0.1, 0.3, 0.2, 0.25, 0.3, 0.5, 0.6])])
def test_early_stopping_epoch_matches_jax(minimize, values):
    got = []
    for mod, fake in PACKAGES:
        t = fake(values)
        es = mod.EarlyStopping(patience=2, minimize=minimize)
        ran = drive(mod.CallbackList([es]), t, epochs=len(values))
        got.append((ran, es.best, es.since_best, t.calls))
    assert got[0] == got[1]
    assert got[1][0] == [0, 1, 2, 3, 4]  # broke after epoch 4


def test_validation_is_computed_once_per_epoch(tmp_path):
    """Four callbacks read the validation value each epoch; the trainer
    scores it once, and both packages memoise the same values."""
    got = []
    for mod, fake in PACKAGES:
        t = fake([3.0, 2.0, 2.5])
        cbs = mod.CallbackList([
            mod.ValidationMonitor(),
            mod.ModelCheckpoint(str(tmp_path / mod.__name__), write_every=1),
            mod.EarlyStopping(patience=5),
            mod.MetricsMonitor(mod.MetricSink())])
        drive(cbs, t, epochs=3)
        got.append((t.calls, {k: float(v["sum"])
                              for k, v in t.validation_loss.items()}))
    assert got[0] == got[1] == (3, {0: 3.0, 1: 2.0, 2: 2.5})


@pytest.mark.parametrize("write_every", [1, 2, 3])
def test_best_checkpoint_value_and_write_cadence_match_jax(tmp_path,
                                                           write_every):
    """ModelCheckpoint's best value, its dirty flag and the epoch of its
    last write after every epoch are the JAX package's; the port's
    best.pt holds the weights of the best epoch, not the live ones (the
    host copy is a copy on the CPU too)."""
    values = [5.0, 4.0, 6.0, 3.0, 3.5, 3.2]
    traces = []
    for mod, fake in PACKAGES:
        t = fake(values)
        ck = mod.ModelCheckpoint(str(tmp_path / mod.__name__),
                                 write_every=write_every)

        class Record(mod.Callback):
            def on_epoch_end(self, *a, **kw):
                trace.append((ck.best, ck._dirty, ck._last_write_epoch))
                super().on_epoch_end(*a, **kw)

        trace = []
        drive(mod.CallbackList([ck, Record()]), t, epochs=len(values))
        traces.append((trace, ck._last_write_epoch))
    assert traces[0] == traces[1]
    best = torch.load(tmp_path / "mapping_tpu_torch.train.callbacks"
                      / "best.pt", weights_only=True)
    assert torch.equal(best["weight"], torch.full((1, 3), 3.0))  # epoch 3
    assert (tmp_path / "mapping_tpu.train.callbacks" / "best.msgpack").exists()


def _default_list(mod, root, **extra):
    cc = {"checkpoint_dir": str(root / "checkpoints" / "unet"),
          "resume": True, "resume_every": 1, "validate_with_map": False,
          "minimize": True, "patience": 10, "best_write_every": 2, **extra}
    return mod.default_unet_callbacks(cc)


def test_sidecar_json_and_metrics_match_jax(tmp_path):
    """The default list over 3 epochs: the sidecar JSON of the last epoch
    (last.msgpack.aux.json / last.pt.aux.json) is equal, holds that epoch's
    early-stopping and best-checkpoint states (the save runs after them),
    and metrics.jsonl has the same channels, steps and values."""
    sidecars, metrics = [], []
    for (mod, fake), name in zip(PACKAGES, ("last.msgpack", "last.pt")):
        root = tmp_path / mod.__name__
        cbs = _default_list(mod, root)
        names = [type(c).__name__ for c in cbs.callbacks]
        assert names[0] == "ResumeCheckpoint" and names[-1] == "_ResumeSaver"
        drive(cbs, fake([3.0, 2.0, 2.5]), epochs=3)
        sidecars.append(json.loads((root / "checkpoints" / "unet"
                                    / f"{name}.aux.json").read_text()))
        metrics.append([(m["channel"], m["x"], m["y"]) for m in map(
            json.loads, (root / "metrics.jsonl").read_text().splitlines())])
    assert sidecars[0] == sidecars[1]
    assert sidecars[1] == {"epoch_id": 2, "callbacks": {
        "ModelCheckpoint": {"best": 2.0, "last_write_epoch": 2},
        "EarlyStopping": {"best": 2.0, "since_best": 1}}}
    assert metrics[0] == metrics[1]
    assert {c for c, _, _ in metrics[1]} == {"unet batch loss",
                                             "unet epoch_val sum"}


def test_resume_continues_the_schedule_like_jax(tmp_path):
    """A run of 3 epochs resumed with a schedule of 5: both packages run
    epochs 3 and 4 only, restore the callbacks' states from the sidecar
    and the trainer's weights and step from the resume file, and end on
    the same sidecar. The port reads the sidecar's dict from last.pt."""
    got = []
    for mod, fake in PACKAGES:
        root = tmp_path / mod.__name__
        first = fake([3.0, 2.0, 2.5, 1.0, 4.0])
        drive(_default_list(mod, root), first, epochs=3)
        second = fake([1.0, 4.0])
        ran = drive(_default_list(mod, root), second, epochs=5)
        name = "last.pt" if mod is port_cb else "last.msgpack"
        got.append((ran, second.calls, json.loads(
            (root / "checkpoints" / "unet" / f"{name}.aux.json").read_text())))
        step = (second.step if mod is port_cb
                else int(second.state.step))
        assert step == 5  # 3 restored, 2 more
    assert got[0] == got[1]
    assert got[1][0] == [3, 4] and got[1][2]["epoch_id"] == 4
    assert got[1][2]["callbacks"]["EarlyStopping"] == {"best": 1.0,
                                                       "since_best": 1}
    payload = load_train_state(tmp_path / "mapping_tpu_torch.train.callbacks"
                               / "checkpoints" / "unet" / "last.pt")
    assert payload["aux"] == got[1][2]


@pytest.mark.parametrize("extra", [
    {},
    {"resume": False, "validate_with_map": True},
    {"profile_trace_dir": "trace", "image_monitor_dir": "images"},
    {"resume": False, "profile_trace_dir": "trace",
     "image_monitor_dir": "images", "validate_with_map": True}])
def test_default_callback_order_matches_jax(tmp_path, extra):
    names = [[type(c).__name__ for c in
              _default_list(mod, tmp_path, **extra).callbacks]
             for mod in (jax_cb, port_cb)]
    assert names[0] == names[1]


def test_prediction_images_match_jax(tmp_path):
    """PredictionImageMonitor writes the same ground truth | prediction
    PNGs as the JAX package's (imageio there, the port's PNG writer
    here) for the same probabilities and targets."""
    rng = np.random.RandomState(0)
    probs = rng.rand(3, 16, 16, 2).astype(np.float32)
    target = (rng.rand(3, 16, 16, 3) > 0.5).astype(np.float32)
    out = {}
    for mod in (jax_cb, port_cb):
        as_array = (np.asarray if mod is jax_cb else torch.from_numpy)
        batch = {"image": as_array(np.zeros((3, 16, 16, 3), np.float32)),
                 "target": as_array(target)}
        trainer = SimpleNamespace(state=None, validation_loss={},
                                  _predict_step=lambda *args: as_array(
                                      probs))
        monitor = mod.PredictionImageMonitor(str(tmp_path / mod.__name__),
                                             image_nr=2)
        drive(mod.CallbackList([monitor]), trainer, epochs=1, batches=0,
              datagen=([batch], 1))
        files = sorted((tmp_path / mod.__name__ / "epoch_0").iterdir())
        out[mod] = [np.asarray(Image.open(f)) for f in files]
    assert len(out[port_cb]) == 2
    for a, b in zip(out[jax_cb], out[port_cb]):
        np.testing.assert_array_equal(a, b)


def test_profiler_trace_spans_the_jax_batches(tmp_path, monkeypatch):
    """ProfilerTrace starts and stops at the batches the JAX callback
    starts and stops jax.profiler at (recorded here in its place), and
    writes a Chrome trace of torch.profiler."""
    import jax

    events = {jax_cb: [], port_cb: []}
    jt = jax_cb.ProfilerTrace(str(tmp_path / "jax"), start_batch=2,
                              n_batches=3)
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: events[
        jax_cb].append(("start", jt.batch_id)))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: events[
        jax_cb].append(("stop", jt.batch_id)))
    pt = port_cb.ProfilerTrace(str(tmp_path / "trace"), start_batch=2,
                               n_batches=3)
    begin, stop = pt.on_batch_begin, pt._stop

    def on_batch_begin(*a, **kw):
        was = pt._profiler
        begin(*a, **kw)
        if was is None and pt._profiler is not None:
            events[port_cb].append(("start", pt.batch_id))

    def recorded_stop():
        events[port_cb].append(("stop", pt.batch_id))
        stop()

    pt.on_batch_begin, pt._stop = on_batch_begin, recorded_stop
    for mod, callback in ((jax_cb, jt), (port_cb, pt)):
        drive(mod.CallbackList([callback]), PortFake([]), epochs=1,
              batches=8)
    assert events[jax_cb] == events[port_cb] == [("start", 2), ("stop", 5)]
    doc = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert pt._done and doc["traceEvents"]


# ----------------------------------------------------------- mAP monitor

@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    root = make_experiment(tmp_path_factory.mktemp("callbacks"), n_train=1)
    yield root
    shutil.rmtree(root)


def _brightness_probs(images, xp):
    """Probabilities of a building where the first channel is brighter
    than the fixture's background (at most 114 of 255; buildings are
    130 or more), in numpy-like `xp` (jax.numpy or torch)."""
    from mapping_tpu_torch.constants import MEAN, STD

    cut = (122 / 255 - MEAN[0]) / STD[0]
    p = 1 / (1 + xp.exp(-20 * (images[..., 0] - cut)))
    return xp.stack([1 - p, p], -1)


@pytest.mark.parametrize("probs", ["weights", "brightness"])
def test_map_validation_matches_jax(experiment, tmp_path, monkeypatch,
                                    probs):
    """ValidationMonitorSegmentation._map_validation on the synthetic val
    split (5 tiles, a full batch of 4 and a ragged one) in both packages:
    AP within 1e-6. `weights`: the same random UNetResNet34 weights
    (AP 0 on this split: random weights find no building); `brightness`:
    the same probability function of the images in place of the network,
    which finds the buildings (AP above 0.5)."""
    import jax.numpy as jnp

    root = experiment
    rows = [r for r in read_metadata(root / "meta" / "metadata.csv")
            if r["is_valid"] == 1]
    x = [r["file_path_image"] for r in rows]
    y = [r["file_path_mask_eroded_0_dilated_0"] for r in rows]
    cfg = config(root, "map")
    port = UNetPipeline(build_config(cfg), train_mode=False)
    images = port.loader.infer_preprocess(np.stack([load_image(p)
                                                    for p in x]))
    state = _centred_state_dict(images)
    checkpoint = tmp_path / "weights.pth"
    torch.save(state, checkpoint)
    port.trainer.load_state_dict(state)
    from mapping_tpu.config import build_config as jax_build_config

    jax = JaxPipeline(jax_build_config(cfg), train_mode=False)
    jax.trainer.import_torch_checkpoint(str(checkpoint))
    if probs == "brightness":
        monkeypatch.setattr(port.trainer, "probs_apply_fn", lambda: (
            lambda images: _brightness_probs(images, torch)))
        monkeypatch.setattr(jax.trainer, "probs_apply_fn", lambda: (
            lambda p, images: _brightness_probs(images, jnp), lambda: {}))
    meta = pd.read_csv(root / "meta" / "metadata.csv")
    meta_valid = meta[meta["is_valid"] == 1]
    assert list(meta_valid["ImageId"]) == [r["ImageId"] for r in rows]
    aps = []
    for mod, pipe, meta_rows in ((jax_cb, jax, meta_valid),
                                 (port_cb, port, rows)):
        monitor = mod.ValidationMonitorSegmentation(
            data_dir=str(root / "data"), target_size=(300, 300),
            category_layers=(1, 1))
        valid = pipe.loader.transform(x, y, x, y,
                                      train_mode=True)["validation_datagen"]
        monitor.set_params(pipe.trainer, validation_datagen=valid,
                           meta_valid=meta_rows)
        aps.append(float(monitor._map_validation()))
    assert abs(aps[0] - aps[1]) <= 1e-6, aps
    assert aps[1] > 0.5 if probs == "brightness" else aps[1] == 0.0
