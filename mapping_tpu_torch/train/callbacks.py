"""Training callbacks: monitors, early stopping, checkpoints, timing,
metric sinks, per-epoch COCO AP validation, resume.

Counterpart of mapping_tpu/train/callbacks.py, class by class, with the
same hooks, resume protocol and JSON sidecar schema ({"epoch_id",
"callbacks": {class name: state}}). What differs:
- `ValidationMonitorSegmentation` serves the validation split through the
  port's `FusedServe` (BN-folded forward, softmax, resize, threshold and
  the CUDA CCL `label` on a card) and scores it with the port's COCOeval;
  the validation metadata are row dicts;
- `ModelCheckpoint` keeps the best weights as a host copy of the model's
  state_dict (cloned: on the CPU `.cpu()` would alias the live weights)
  and writes them to `best.pt`;
- `ResumeCheckpoint` writes the trainer's whole state to `last.pt` with
  the sidecar's dict inside it, and the sidecar `last.pt.aux.json` beside
  it; a resume reads the dict from `last.pt`, so the schedule and the
  state it belongs to always come from one atomic write. The loader's
  shuffle state is not restored, as in the JAX package: a resumed epoch
  draws a new permutation;
- `ProfilerTrace` runs `torch.profiler` and writes a Chrome trace;
- `PredictionImageMonitor` writes its PNGs with `utils/png`.

On the ranks of a data-parallel trainer (train/trainer.py) the JAX
package validates through `FusedServe(mesh=trainer.mesh)`; here rank 0
validates on its own card while the other ranks wait for the value it
broadcasts (`_rank0_value`): data-parallel serving gives the outputs of
single-device serving, so the mAP is the same, and every rank then takes
the same best-checkpoint and early-stopping decisions. Only rank 0 writes
files (best.pt, last.pt and its sidecar, metrics.jsonl, traces, images);
every rank reads a resume file.
"""

import json
import logging
import os
import tempfile
import time
from collections import defaultdict, deque
from typing import List, Optional

import numpy as np
import torch

from mapping_tpu_torch.parallel import distributed
from mapping_tpu_torch.train.checkpoint import (refuse_jax_resume_file,
                                                save_state_dict)

logger = logging.getLogger(__name__)


def _rank0_value(trainer, compute):
    """compute() on rank 0 of a data-parallel trainer, its value handed to
    every rank; compute() anywhere else."""
    if getattr(trainer, "data_parallel", None) is None:
        return compute()
    return distributed.primary_value(compute)


def _writes(trainer) -> bool:
    """Whether this process writes the run's files: all but the ranks
    other than 0 of a data-parallel trainer."""
    return getattr(trainer, "is_primary", True)


class MetricSink:
    """stdout + optional JSONL channel sink (neptune send_metric analog)."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self.jsonl_path = jsonl_path

    def send(self, channel: str, x: float, y: float):
        if self.jsonl_path:
            # lazy dir creation: constructing a manager (e.g. `--help`)
            # should not scaffold experiment directories
            os.makedirs(os.path.dirname(self.jsonl_path) or ".", exist_ok=True)
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps({"channel": channel, "x": float(x),
                                    "y": float(y), "ts": time.time()}) + "\n")

    def send_metric(self, name: str, value: float):
        logger.info("metric %s = %s", name, value)
        self.send(name, 0, value)


class Callback:
    def __init__(self):
        self.trainer = None
        self.validation_datagen = None
        self.meta_valid = None
        self.epoch_id = 0
        self.batch_id = 0

    def set_params(self, trainer, validation_datagen=None, meta_valid=None):
        self.trainer = trainer
        self.validation_datagen = validation_datagen
        self.meta_valid = meta_valid

    def on_train_begin(self, *a, **kw):
        # a ResumeCheckpoint (first in the CallbackList) may have published
        # resume_info: the epoch schedule continues, it does not restart
        self.epoch_id = self._resume_info().get("next_epoch", 0)
        self.batch_id = 0

    def on_train_end(self, *a, **kw):
        pass

    # -- resume protocol -----------------------------------------------------
    def _resume_info(self) -> dict:
        return getattr(self.trainer, "resume_info", None) or {}

    def _resume_state(self) -> Optional[dict]:
        """This callback's own state from the resume checkpoint (keyed by
        class name; one instance per class in the default list)."""
        return self._resume_info().get("callbacks", {}).get(
            type(self).__name__)

    def state_dict(self) -> dict:
        """JSON-serialisable state persisted into the resume checkpoint."""
        return {}

    def on_epoch_begin(self, *a, **kw):
        pass

    def on_epoch_end(self, *a, **kw):
        self.epoch_id += 1

    def on_batch_begin(self, *a, **kw):
        pass

    def on_batch_end(self, *a, **kw):
        self.batch_id += 1

    def training_break(self, *a, **kw):
        return False

    def get_validation_loss(self):
        """Validation metrics, computed once per epoch and shared through
        `trainer.validation_loss`."""
        if self.epoch_id not in self.trainer.validation_loss:
            self.trainer.validation_loss[self.epoch_id] = _rank0_value(
                self.trainer, lambda: self.trainer.score_validation(
                    self.validation_datagen))
        return self.trainer.validation_loss[self.epoch_id]


class CallbackList(Callback):
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        super().__init__()
        self.callbacks = list(callbacks or [])

    def __len__(self):
        return len(self.callbacks)

    def set_params(self, *a, **kw):
        for c in self.callbacks:
            c.set_params(*a, **kw)

    def on_train_begin(self, *a, **kw):
        for c in self.callbacks:
            c.on_train_begin(*a, **kw)

    def on_train_end(self, *a, **kw):
        for c in self.callbacks:
            c.on_train_end(*a, **kw)

    def on_epoch_begin(self, *a, **kw):
        for c in self.callbacks:
            c.on_epoch_begin(*a, **kw)

    def on_epoch_end(self, *a, **kw):
        for c in self.callbacks:
            c.on_epoch_end(*a, **kw)

    def on_batch_begin(self, *a, **kw):
        for c in self.callbacks:
            c.on_batch_begin(*a, **kw)

    def on_batch_end(self, *a, **kw):
        for c in self.callbacks:
            c.on_batch_end(*a, **kw)

    def training_break(self, *a, **kw):
        return any(c.training_break(*a, **kw) for c in self.callbacks)

    def state_dicts(self) -> dict:
        """Per-callback resume states, keyed by class name (empty states
        dropped)."""
        out = {}
        for c in self.callbacks:
            state = c.state_dict()
            if state:
                out[type(c).__name__] = state
        return out


class TrainingMonitor(Callback):
    """Running batch and epoch loss averages."""

    def __init__(self, batch_every=1, epoch_every=1):
        super().__init__()
        self.batch_every = batch_every
        self.epoch_every = epoch_every
        self.epoch_losses = defaultdict(list)

    def on_epoch_begin(self, *a, **kw):
        self.epoch_losses = defaultdict(list)

    def on_batch_end(self, metrics=None, **kw):
        metrics = metrics or {}
        for name, value in metrics.items():
            self.epoch_losses[name].append(float(value))
        if self.batch_every and self.batch_id % self.batch_every == 0:
            msg = " ".join(f"{k}={float(v):.5f}" for k, v in metrics.items())
            logger.info("epoch %d batch %d %s", self.epoch_id, self.batch_id,
                        msg)
        super().on_batch_end(**kw)

    def on_epoch_end(self, *a, **kw):
        if self.epoch_every and self.epoch_id % self.epoch_every == 0:
            for name, values in self.epoch_losses.items():
                logger.info("epoch %d avg %s = %.5f", self.epoch_id, name,
                            float(np.mean(values)))
        super().on_epoch_end(*a, **kw)


class ValidationMonitor(Callback):
    """Per-epoch validation loss."""

    def __init__(self, epoch_every=1, **_):
        super().__init__()
        self.epoch_every = epoch_every

    def on_epoch_end(self, *a, **kw):
        if self.validation_datagen is not None and (
                self.epoch_every and self.epoch_id % self.epoch_every == 0):
            loss = self.get_validation_loss()
            for name, value in loss.items():
                logger.info("epoch %d validation %s = %.5f", self.epoch_id,
                            name, float(value))
        super().on_epoch_end(*a, **kw)


class ValidationMonitorSegmentation(ValidationMonitor):
    """Per-epoch COCO AP on the validation split, the 'sum' metric of the
    best checkpoint and early stopping. The geometry comes from the run's
    config (crop_image_h/w and category_layers), as `evaluate` uses it."""

    def __init__(self, data_dir=None, validate_with_map=True,
                 small_annotations_size=14, epoch_every=1,
                 target_size=(300, 300), category_layers=(1, 1), **_):
        super().__init__(epoch_every=epoch_every)
        self.data_dir = data_dir
        self.validate_with_map = validate_with_map
        self.small_annotations_size = small_annotations_size
        self.target_size = tuple(target_size)
        self.category_layers = tuple(category_layers)
        self._serve = None

    def _serve_program(self):
        """The FusedServe the pipelines serve with, over the trainer's
        BN-folded copy, which is folded again after every optimizer step:
        each epoch scores that epoch's weights."""
        if self._serve is None:
            from mapping_tpu_torch.constants import CATEGORY_IDS
            from mapping_tpu_torch.infer.postprocess import active_layers_for
            from mapping_tpu_torch.infer.serving import FusedServe

            self._serve = FusedServe(
                self.trainer.probs_apply_fn(), target_size=self.target_size,
                category_layers=self.category_layers,
                active_layers=active_layers_for(CATEGORY_IDS,
                                                self.category_layers))
        return self._serve

    def get_validation_loss(self):
        if not self.validate_with_map or self.meta_valid is None:
            return super().get_validation_loss()
        if self.epoch_id not in self.trainer.validation_loss:
            ap = _rank0_value(self.trainer, self._map_validation)
            self.trainer.validation_loss[self.epoch_id] = {
                "sum": np.asarray(ap)}
        return self.trainer.validation_loss[self.epoch_id]

    def _map_validation(self):
        from mapping_tpu_torch.constants import CATEGORY_IDS
        from mapping_tpu_torch.eval.cocoeval import coco_evaluation
        from mapping_tpu_torch.infer.annotations import create_annotations

        start = time.perf_counter()
        gt_path = os.path.join(self.data_dir, "val", "annotation.json")
        image_ids = [r["ImageId"] for r in self.meta_valid]
        serve = self._serve_program()
        annotations = []
        idx = 0
        flow, steps = self.validation_datagen
        for batch_id, batch in enumerate(flow):
            images = batch["image"] if isinstance(batch, dict) else batch
            labels, scores, _ = serve(images)
            batch_ids = image_ids[idx: idx + labels.shape[0]]
            idx += labels.shape[0]
            annotations.extend(create_annotations(
                batch_ids, labels, scores, CATEGORY_IDS,
                self.category_layers))
            if batch_id + 1 >= steps:
                break
        with tempfile.NamedTemporaryFile("w", suffix=".json",
                                         delete=False) as f:
            json.dump(annotations, f)
            pred_path = f.name
        try:
            ap, _ = coco_evaluation(
                gt_path, pred_path, image_ids,
                [cid for cid in CATEGORY_IDS if cid is not None],
                self.small_annotations_size, verbose=False)
        finally:
            os.unlink(pred_path)
        logger.info("epoch %d validation mAP = %.5f in %.2f s", self.epoch_id,
                    ap, time.perf_counter() - start)
        return ap


class EarlyStopping(Callback):
    """Patience on the validation 'sum'."""

    def __init__(self, patience=30, minimize=True, **_):
        super().__init__()
        self.patience = patience
        self.minimize = minimize
        self.best = None
        self.since_best = 0
        self._break = False

    def on_train_begin(self, *a, **kw):
        super().on_train_begin(*a, **kw)
        self.best = None
        self.since_best = 0
        self._break = False
        resumed = self._resume_state()
        if resumed:
            self.best = resumed.get("best")
            self.since_best = int(resumed.get("since_best", 0))

    def state_dict(self):
        return {"best": self.best, "since_best": self.since_best}

    def on_epoch_end(self, *a, **kw):
        if self.validation_datagen is not None or self.meta_valid is not None:
            value = float(np.asarray(self.get_validation_loss()["sum"]))
            improved = (self.best is None or
                        (value < self.best if self.minimize
                         else value > self.best))
            if improved:
                self.best = value
                self.since_best = 0
            else:
                self.since_best += 1
            if self.since_best > self.patience:
                self._break = True
        super().on_epoch_end(*a, **kw)

    def training_break(self, *a, **kw):
        return self._break


class ModelCheckpoint(Callback):
    """Keep the best weights by the validation 'sum': a host copy per
    improvement, written to best.pt at most every `write_every` epochs
    (and once at train end)."""

    def __init__(self, checkpoint_dir, minimize=True, epoch_every=1,
                 write_every=5, **_):
        super().__init__()
        self.checkpoint_dir = checkpoint_dir
        self.minimize = minimize
        self.epoch_every = epoch_every
        self.write_every = write_every
        self.best = None
        self._best_state = None
        self._dirty = False
        self._last_write_epoch = None

    @property
    def best_path(self):
        return os.path.join(self.checkpoint_dir, "best.pt")

    def on_train_begin(self, *a, **kw):
        super().on_train_begin(*a, **kw)
        self.best = None
        self._best_state = None
        self._dirty = False
        self._last_write_epoch = None
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        resumed = self._resume_state()
        if resumed:
            # the best score survives the kill; the best weights are in
            # best.pt (fit reloads it at the end), overwritten only by an
            # epoch that improves on that score
            self.best = resumed.get("best")
            lw = resumed.get("last_write_epoch")
            self._last_write_epoch = None if lw is None else int(lw)

    def state_dict(self):
        return {"best": self.best,
                "last_write_epoch": self._last_write_epoch}

    def on_epoch_end(self, *a, **kw):
        if self.epoch_every and self.epoch_id % self.epoch_every == 0:
            if self.validation_datagen is not None or \
                    self.meta_valid is not None:
                value = float(np.asarray(self.get_validation_loss()["sum"]))
            else:
                value = None
            improved = (value is None or self.best is None or
                        (value < self.best if self.minimize
                         else value > self.best))
            if improved:
                if value is not None:
                    self.best = value
                if _writes(self.trainer):
                    # a copy, also on the CPU, where .cpu() would alias
                    # the weights that training goes on changing
                    self._best_state = {
                        k: v.detach().to("cpu", copy=True)
                        for k, v in self.trainer.model.state_dict().items()}
                    self._dirty = True
                logger.info("epoch %d new best checkpoint (score=%s)",
                            self.epoch_id, value)
        if self._dirty and self.write_every and (
                self._last_write_epoch is None
                or self.epoch_id - self._last_write_epoch >= self.write_every):
            self._write_best()
        super().on_epoch_end(*a, **kw)

    def _write_best(self):
        start = time.perf_counter()
        save_state_dict(self._best_state, self.best_path)
        self._dirty = False
        self._last_write_epoch = self.epoch_id
        logger.info("best checkpoint written to %s in %.2f s (score=%s)",
                    self.best_path, time.perf_counter() - start, self.best)

    def on_train_end(self, *a, **kw):
        if self._best_state is not None and self._dirty:
            self._write_best()
        super().on_train_end(*a, **kw)


class ExperimentTiming(Callback):
    """Epoch wall time and the rolling mean batch time."""

    def __init__(self, batch_every=10, epoch_every=1, **_):
        super().__init__()
        self.batch_every = batch_every
        self.epoch_every = epoch_every
        self.batch_times = deque(maxlen=100)
        self._epoch_start = None
        self._batch_start = None

    def on_epoch_begin(self, *a, **kw):
        self._epoch_start = time.time()

    def on_epoch_end(self, *a, **kw):
        if self.epoch_every and self.epoch_id % self.epoch_every == 0:
            logger.info("epoch %d took %.2fs", self.epoch_id,
                        time.time() - self._epoch_start)
        super().on_epoch_end(*a, **kw)

    def on_batch_begin(self, *a, **kw):
        self._batch_start = time.time()

    def on_batch_end(self, *a, **kw):
        self.batch_times.append(time.time() - self._batch_start)
        if self.batch_every and self.batch_id % self.batch_every == 0:
            logger.info("batch %d rolling mean time %.4fs", self.batch_id,
                        float(np.mean(self.batch_times)))
        super().on_batch_end(*a, **kw)


class MetricsMonitor(Callback):
    """Batch losses and epoch validation metrics to a MetricSink."""

    def __init__(self, sink: Optional[MetricSink] = None, model_name="unet",
                 **_):
        super().__init__()
        self.sink = sink or MetricSink()
        self.model_name = model_name

    def on_batch_end(self, metrics=None, **kw):
        if _writes(self.trainer):
            for name, value in (metrics or {}).items():
                self.sink.send(f"{self.model_name} batch {name}",
                               self.batch_id, float(value))
        super().on_batch_end(**kw)

    def on_epoch_end(self, *a, **kw):
        if self.validation_datagen is not None or self.meta_valid is not None:
            for name, value in self.get_validation_loss().items():
                if _writes(self.trainer):
                    self.sink.send(f"{self.model_name} epoch_val {name}",
                                   self.epoch_id, float(np.asarray(value)))
        super().on_epoch_end(*a, **kw)


class ResumeCheckpoint(Callback):
    """Periodic 'last' checkpoint of the whole training state, and the
    resume from it: a run killed after epoch k continues its schedule at
    k + 1 with the weights, optimizer, schedule and step of epoch k, and
    the best-checkpoint and early-stopping states of that epoch."""

    def __init__(self, checkpoint_dir, epoch_every=5, defer_save=False, **_):
        super().__init__()
        self.checkpoint_dir = checkpoint_dir
        self.epoch_every = epoch_every
        # first in the default list (its on_train_begin publishes
        # resume_info before its siblings read it), but its save runs last
        # through a _ResumeSaver, after the siblings processed the epoch
        self.defer_save = defer_save

    @property
    def last_path(self):
        return os.path.join(self.checkpoint_dir, "last.pt")

    @property
    def aux_path(self):
        """The epoch schedule and callback states, as JSON beside
        last.pt."""
        return self.last_path + ".aux.json"

    def on_train_begin(self, *a, **kw):
        # publish resume_info before super() so this callback's own epoch
        # counter picks it up too
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        refuse_jax_resume_file(self.checkpoint_dir)
        if os.path.exists(self.last_path):
            aux = self.trainer.load_train_state(self.last_path)
            self.trainer.resume_info = {
                "next_epoch": int(aux.get("epoch_id", -1)) + 1,
                "callbacks": aux.get("callbacks", {})}
            logger.info("resumed from %s at step %d (next epoch %d)",
                        self.last_path, self.trainer.step,
                        self.trainer.resume_info["next_epoch"])
        super().on_train_begin(*a, **kw)

    def on_epoch_end(self, *a, **kw):
        if not self.defer_save:
            self.maybe_save(self.epoch_id)
        super().on_epoch_end(*a, **kw)

    def maybe_save(self, epoch_id):
        if not (self.epoch_every and epoch_id % self.epoch_every == 0
                and _writes(self.trainer)):
            return
        start = time.perf_counter()
        aux = {"epoch_id": epoch_id}
        callbacks = getattr(self.trainer, "_callbacks", None)
        if callbacks is not None:
            aux["callbacks"] = callbacks.state_dicts()
        self.trainer.save_train_state(self.last_path, aux)
        tmp = self.aux_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(aux, f)
        os.replace(tmp, self.aux_path)
        logger.info("resume checkpoint of epoch %d written to %s in %.2f s",
                    epoch_id, self.last_path, time.perf_counter() - start)


class _ResumeSaver(Callback):
    """Tail of the default callback list: the ResumeCheckpoint save, after
    every sibling processed the epoch, so the persisted states reflect this
    epoch's validation."""

    def __init__(self, owner: "ResumeCheckpoint"):
        super().__init__()
        self.owner = owner

    def on_epoch_end(self, *a, **kw):
        self.owner.maybe_save(self.epoch_id)
        super().on_epoch_end(*a, **kw)


class ProfilerTrace(Callback):
    """torch.profiler trace (host and, on a card, device activity) of
    `n_batches` training steps from batch `start_batch`, written as a
    Chrome trace under `trace_dir`."""

    def __init__(self, trace_dir, start_batch=10, n_batches=5, **_):
        super().__init__()
        self.trace_dir = trace_dir
        self.start_batch = start_batch
        self.n_batches = n_batches
        self._profiler = None
        self._done = False

    def on_batch_begin(self, *a, **kw):
        if (not self._done and self._profiler is None
                and self.batch_id == self.start_batch
                and _writes(self.trainer)):
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()

    def _stop(self):
        self._profiler.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, "trace.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        logger.info("profiler trace written to %s", path)

    def on_batch_end(self, *a, **kw):
        if self._profiler is not None and \
                self.batch_id >= self.start_batch + self.n_batches:
            self._stop()
            self._done = True
        super().on_batch_end(**kw)

    def on_train_end(self, *a, **kw):
        if self._profiler is not None:
            self._stop()


class PredictionImageMonitor(Callback):
    """Up to `image_nr` ground-truth | prediction mask pairs of the first
    validation batch per epoch, as PNGs under output_dir/epoch_{k}."""

    def __init__(self, output_dir, image_nr=4, epoch_every=1, **_):
        super().__init__()
        self.output_dir = output_dir
        self.image_nr = image_nr
        self.epoch_every = epoch_every

    def on_epoch_end(self, *a, **kw):
        if (self.validation_datagen is not None and self.epoch_every
                and self.epoch_id % self.epoch_every == 0
                and _writes(self.trainer)):
            self._save_images()
        super().on_epoch_end(*a, **kw)

    def _save_images(self):
        from mapping_tpu_torch.utils.png import write_png_gray

        flow, steps = self.validation_datagen
        saved = 0
        out_dir = os.path.join(self.output_dir, f"epoch_{self.epoch_id}")
        os.makedirs(out_dir, exist_ok=True)
        for batch in flow:
            if "target" not in batch:
                break
            probs = self.trainer._predict_step(batch["image"])
            pred = probs[..., -1].cpu().numpy() > 0.5
            gt = batch["target"][..., 0].cpu().numpy() > 0.5
            for i in range(pred.shape[0]):
                if saved >= self.image_nr:
                    return
                pair = np.concatenate([gt[i], pred[i]], axis=1)
                write_png_gray(os.path.join(out_dir, f"val_{saved}.png"),
                               (pair * 255).astype(np.uint8))
                saved += 1
            break


def default_unet_callbacks(callbacks_config) -> CallbackList:
    """The JAX package's default list, in its order: the resume first (it
    publishes resume_info), its save last."""
    cc = callbacks_config
    validate_with_map = cc.get("validate_with_map", False)
    validation_cls = (ValidationMonitorSegmentation if validate_with_map
                      else ValidationMonitor)
    callbacks = []
    resume_cb = None
    if cc.get("resume", True) and cc.get("checkpoint_dir"):
        resume_cb = ResumeCheckpoint(
            cc["checkpoint_dir"], epoch_every=cc.get("resume_every", 5),
            defer_save=True)
        callbacks.append(resume_cb)
    callbacks += [
        ExperimentTiming(),
        TrainingMonitor(),
        validation_cls(**cc),
        ModelCheckpoint(cc["checkpoint_dir"],
                        minimize=cc.get("minimize", True),
                        write_every=cc.get("best_write_every", 5)),
        EarlyStopping(patience=cc.get("patience", 30),
                      minimize=cc.get("minimize", True)),
        MetricsMonitor(sink=MetricSink(os.path.join(
            os.path.dirname(os.path.dirname(cc["checkpoint_dir"])),
            "metrics.jsonl")) if cc.get("checkpoint_dir") else None),
    ]
    if cc.get("profile_trace_dir"):
        callbacks.append(ProfilerTrace(cc["profile_trace_dir"]))
    if cc.get("image_monitor_dir"):
        callbacks.append(PredictionImageMonitor(
            cc["image_monitor_dir"], image_nr=cc.get("image_nr", 4)))
    if resume_cb is not None:
        callbacks.append(_ResumeSaver(resume_cb))
    return CallbackList(callbacks)
