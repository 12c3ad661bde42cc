"""The named pipelines: unet / unet_weighted (train and inference),
unet_tta, unet_padded, scoring_model (train) and the three scoring
inference pipelines.

Counterpart of mapping_tpu/pipelines.py: a UNetPipeline composes the
loader's device preprocess, the trainer's BN-folded forward with a float32
softmax (`UNetTrainer.probs_apply_fn`) and the fused postprocess
(`FusedServe`, with test-time augmentation for `tta` and the centre crop
for `padded`), with one batch in flight. Its weights live in the
experiment's transformer cache: the port writes `unet.pt` (torch.save of
the reference-named state_dict) beside where the JAX package writes
`unet.msgpack`, and reads either, its own first; weights read from a cache
are folded once and the float32 model is freed (`UNetTrainer.serve_only`).

`fit_transform(data)` (train mode) trains on the metadata rows' image and
mask files with the callbacks of the config's `unet.callbacks`, writes the
cache and marks the stage complete; a cache (the port's or the JAX
package's) short-circuits it unless `overwrite` or `warm_start` is set.
`warm_start` runs the next stage of the multistage recipe: the completed
stage's checkpoint dir moves to `checkpoints/unet.stage{N}` and its cache
is copied to `transformers/unet.stage{N}.pt` (`.msgpack` for a JAX
cache), and the fit starts from those weights. `transform(data,
return_features)` takes the manager's data dict, whose metadata rows name
the image files, and can also return each image's scoring feature tensor;
`transform_arrays(images_u8)` serves uint8 tiles already in host memory
through the same program.

The scoring pipelines (scoring.py) wrap a UNetPipeline as `base`:
`ScoringModelPipeline` streams the training images through it with 19
threshold layers, builds the feature tables with the ground-truth IoU and
fits the GBM, written to `transformers/scoring_model.pkl` (the JAX
package's `scoring_model.joblib` beside it is read, never written);
`ScoringInferencePipeline` scores every instance with the GBM and
suppresses overlaps across layers (NMS), one image at a time
(`force_stream`). With `quantized_serving: 1` every pipeline serves the
int8 forward of models/quantize.py, calibrated on the first
`quant_calib_images` metadata images.

`data_parallel: 1` gives the trainer the mesh "auto" (train/trainer.py):
with one visible card that is no mesh and the plain path runs, as in the
JAX package. With more, serving runs a replica per card (infer/serving.py
`FusedServe(mesh=...)`, int8 serving included), and training runs on the
ranks of a process group, one per card, which the train command starts
(manager.py): there the loader hands each rank its shard of the global
batch, rank 0 alone archives a warm-started stage and writes the cache
and the stage marker, and the others wait for it.

`spatial_serving: 1` serves each image's rows split over a mesh (infer/
serving.py `FusedServe(spatial=True)`): the trainer's mesh with
`data_parallel: 1`, otherwise one built for serving only, of every
visible card; with one device it raises, as the JAX package does. A rank
of a data-parallel trainer validates on its own card.
"""

import logging
import os
import shutil
import time
from functools import partial

import torch

from mapping_tpu_torch.constants import (CATEGORY_IDS, CATEGORY_LAYERS, SEED,
                                         X_COLUMNS, Y_COLUMNS)
from mapping_tpu_torch.data.loader import SegmentationLoader
from mapping_tpu_torch.data.tta import tta_specs
from mapping_tpu_torch.infer.postprocess import active_layers_for
from mapping_tpu_torch.data.metadata import read_metadata
from mapping_tpu_torch.infer.serving import FusedServe, ServeProgram
from mapping_tpu_torch.models.quantize import (QuantizedProbs,
                                               quantized_probs_fn)
from mapping_tpu_torch.parallel import distributed, make_mesh
from mapping_tpu_torch.scoring import (NonMaximumSupression, ScoringGBM,
                                       features_from_tensor)
from mapping_tpu_torch.train.trainer import UNetTrainer

logger = logging.getLogger(__name__)


def visible_devices(device: torch.device):
    """Every visible device of `device`'s kind: the CUDA cards, or the one
    CPU."""
    if device.type == "cuda":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [device]


def spatial_mesh(device: torch.device):
    """The mesh of spatial serving without a trainer's mesh: every visible
    device of `device`'s kind, which must be more than one."""
    devices = visible_devices(device)
    if len(devices) < 2:
        raise ValueError("spatial_serving: 1 needs more than one device")
    return make_mesh(devices)


def _xy(rows):
    """The image paths of metadata rows, and their mask paths where the
    rows have them."""
    x = [row[X_COLUMNS[0]] for row in rows]
    y_col = Y_COLUMNS[0]
    y = [row[y_col] for row in rows] if rows and y_col in rows[0] else None
    return x, y


def _category_layers(config):
    return tuple(config.params.get("category_layers", CATEGORY_LAYERS))


class UNetPipeline:
    """unet / unet_weighted / unet_tta / unet_padded training and inference
    on `config.params.device`. `padded` switches the loader to
    `crop_and_pad`; the predictions of padded inputs are cropped back to
    the target size (always for `padded`, and for `tta` when the loader
    pads)."""

    def __init__(self, config, train_mode: bool, loss_name: str = "ce",
                 tta: bool = False, padded: bool = False):
        self.config = config
        self.cache_dir = config.env.cache_dirpath
        self.tta = tta
        self.padded = padded
        device = config.params.get("device", "cuda")
        loader = config.loader
        mode = "crop_and_pad" if padded else loader.mode
        self.crop_predictions = padded or (tta and mode == "crop_and_pad")
        self.trainer = UNetTrainer(
            model_params=config.unet.model_params,
            optimizer_params=config.unet.optimizer_params,
            loss_params=config.unet.loss,
            training_config=config.unet.training,
            callbacks_config=config.unet.callbacks if train_mode else None,
            loss_name=loss_name,
            input_size=config.loader.size,
            seed=SEED,
            mesh="auto" if config.params.get("data_parallel", 0) else None,
            remat=bool(config.params.get("remat", 0)),
            pretrained_weights=config.unet.get("pretrained_weights", ""),
            device=device)
        dp = self.trainer.data_parallel
        self.loader = SegmentationLoader(
            mode=mode, size=loader.size, pad=loader.pad,
            pad_method=loader.pad_method,
            batch_size_train=loader.batch_size_train,
            batch_size_inference=loader.batch_size_inference,
            seed=loader.seed,
            load_in_memory=loader.load_in_memory,
            device=self.trainer.device,
            shard=None if dp is None else (dp.rank, dp.world))
        self.category_layers = _category_layers(config)
        self.quantized = bool(config.params.get("quantized_serving", 0))
        self._quantized = None
        self._serve = {}
        self._weights_loaded = False
        #: host seconds spent in FusedServe.dispatch and .collect
        self.device_seconds = 0.0

    # ------------------------------------------------------------ cache
    @property
    def trainer_cache_path(self):
        return os.path.join(self.cache_dir, "transformers", "unet.pt")

    @property
    def jax_cache_path(self):
        """Where the JAX package keeps the same experiment's weights."""
        return os.path.join(self.cache_dir, "transformers", "unet.msgpack")

    def clean_cache(self):
        pass  # no in-RAM step outputs to drop; kept for the JAX surface

    def import_checkpoint(self, path):
        """A reference torch checkpoint (plain / {'state_dict': ...} /
        'module.'-prefixed) into the trainer and the transformer cache."""
        self.trainer.import_torch_checkpoint(path)
        self.trainer.save(self.trainer_cache_path)
        self._mark_stage_complete()
        self._weights_loaded = True
        return self

    def set_weights(self, state_dict):
        """Serve the reference-named `state_dict` (no cache is read); the
        trainer keeps its float32 model, to be saved or set again."""
        self.trainer.load_state_dict(state_dict)
        self._weights_loaded = True
        return self

    def _cache(self):
        """The experiment's transformer cache, the port's before the JAX
        package's, or None."""
        for path in (self.trainer_cache_path, self.jax_cache_path):
            if os.path.exists(path):
                return path
        return None

    def _ensure_weights(self):
        if self._weights_loaded:
            return
        cache = self._cache()
        if cache is not None:
            self.trainer.load(cache)
            if not self.quantized:  # int8 serving quantises the float32 fold
                self.trainer.serve_only()
            self._weights_loaded = True
            return
        raise RuntimeError(
            f"no trained unet found at {self.trainer_cache_path} or "
            f"{self.jax_cache_path}; import a checkpoint first")

    # ------------------------------------------------------------- fit
    def fit_transform(self, data):
        """Train on data["input"]["meta"] (rows with image and mask
        paths), validating on data["callback_input"]["meta_valid"]; then
        write the cache and the stage marker. Returns no predictions: the
        JAX package's fit_transform does not predict the training set
        either."""
        meta = data["input"]["meta"]
        meta_valid = data.get("callback_input", {}).get("meta_valid")
        x, y = _xy(meta)
        x_valid = y_valid = None
        if meta_valid is not None and len(meta_valid):
            x_valid, y_valid = _xy(meta_valid)

        cache = self._cache()
        params = self.config.params
        warm = bool(params.get("warm_start", 0))
        if cache and not params.get("overwrite", 0) and not warm:
            logger.info("unet: loading cached transformer from %s", cache)
            self.trainer.load(cache)
        else:
            if cache and warm:
                self._begin_stage(cache)
            gens = self.loader.transform(x, y, x_valid, y_valid,
                                         train_mode=True)
            self.trainer.fit(gens["datagen"], gens["validation_datagen"],
                             meta_valid=meta_valid)
            if self.trainer.is_primary:
                self.trainer.save(self.trainer_cache_path)
                self._mark_stage_complete()
            distributed.barrier()
        self._weights_loaded = True
        return {"y_pred": []}

    # --------------------------------------------------- multistage train
    @property
    def _checkpoint_dir(self):
        return self.config.unet.get("callbacks", {}).get("checkpoint_dir")

    @property
    def _stage_marker(self):
        ck = self._checkpoint_dir
        return os.path.join(ck, "STAGE_COMPLETE") if ck else None

    def _mark_stage_complete(self):
        """The completed-fit marker in the checkpoint dir: a finished stage
        (archived by the next warm start) against a killed one (left in
        place, so that its resume file continues the schedule)."""
        marker = self._stage_marker
        if marker:
            os.makedirs(os.path.dirname(marker), exist_ok=True)
            with open(marker, "w") as f:
                f.write("stage complete\n")

    def _begin_stage(self, cache):
        """`warm_start` with an existing cache: the next stage of the
        multistage recipe, from the weights in `cache` (on a mesh rank 0
        archives, and every rank warm-starts once it has; see
        `_archive_stage`)."""
        if self.trainer.is_primary:
            self._archive_stage(cache)
        distributed.barrier()
        self.trainer.warm_start(cache)

    def _archive_stage(self, cache):
        """The archiving of `_begin_stage`. A completed stage
        (marker present) is archived, never destroyed: its checkpoint dir
        moves to `<checkpoint_dir>.stage{N}` and its cache is copied to
        `unet.stage{N}` beside it, so the new stage starts a fresh
        schedule, optimizer and best/early-stop tracking. A stage killed
        mid-run (no marker, archives present) stays in place: its resume
        file continues it. A checkpoint dir with no marker and no archives
        is a stage completed before markers existed: archived, unless it
        holds a resume file, which could as well be a killed stage whose
        archives were removed; that case is refused."""
        ck = self._checkpoint_dir
        marker = self._stage_marker
        stem, ext = os.path.splitext(self.trainer_cache_path)
        archive_ext = os.path.splitext(cache)[1]
        completed = bool(ck and marker and os.path.exists(marker))
        if ck and not completed:
            # a killed warm-started stage always has archived predecessors
            # (archiving precedes fitting), and a killed first stage never
            # gets here (only a completed fit writes the cache)
            has_archives = os.path.isdir(f"{ck}.stage1") or any(
                os.path.exists(f"{stem}.stage1{e}")
                for e in (ext, ".msgpack"))
            if os.path.isdir(ck) and not has_archives:
                resume_files = [n for n in ("last.pt", "last.msgpack")
                                if os.path.exists(os.path.join(ck, n))]
                if resume_files:
                    raise RuntimeError(
                        "warm start: checkpoint dir {} has no STAGE_COMPLETE "
                        "marker and no stage archives, but a resume sidecar "
                        "({}) is present: this is either a stage completed "
                        "before stage markers existed, or a killed "
                        "warm-start stage whose archives were removed. If "
                        "the previous stage finished, delete {}* from the "
                        "checkpoint dir and re-run; if it was killed "
                        "mid-run, re-run the SAME train command without "
                        "--warm_start to resume it first.".format(
                            ck, resume_files[0], resume_files[0]))
                completed = True
                logger.warning(
                    "warm start: checkpoint dir has no STAGE_COMPLETE marker "
                    "and no stage archives (pre-marker experiment); treating "
                    "the previous stage as completed and archiving it")
        if completed:
            n = 1
            while os.path.isdir(f"{ck}.stage{n}") or any(
                    os.path.exists(f"{stem}.stage{n}{e}")
                    for e in (ext, ".msgpack")):
                n += 1
            shutil.move(ck, f"{ck}.stage{n}")
            shutil.copy2(cache, f"{stem}.stage{n}{archive_ext}")
            logger.info("warm start: archived completed stage (checkpoints "
                        "-> %s.stage%d, weights -> %s.stage%d%s)", ck, n,
                        stem, n, archive_ext)

    # -------------------------------------------------------- inference
    def serve_program(self, return_features=False):
        """The FusedServe this pipeline runs: forward (+TTA) + softmax +
        fused postprocess per batch; only labels, scores and areas (and
        with `return_features` the feature tensor) leave the device."""
        key = bool(return_features)
        if key not in self._serve:
            # a rank of a data-parallel trainer serves on its own card
            rank = self.trainer.data_parallel is not None
            mesh = None if rank else self.trainer.mesh
            spatial = bool(self.config.params.get("spatial_serving", 0)) \
                and not rank
            if spatial and mesh is None:
                # an inference-only mesh, never the trainer's
                mesh = spatial_mesh(self.trainer.device)
            self._serve[key] = FusedServe(self._probs_fn(), mesh=mesh,
                                          spatial=spatial,
                                          **self._serve_args(key))
        return self._serve[key]

    def _probs_fn(self):
        """The forward this pipeline serves: the trainer's float one, or
        with `quantized_serving: 1` the int8 one (models/quantize.py),
        recalibrated when the trainer's weights change. Float, with a
        warning, when there is no metadata to calibrate on."""
        if not self.quantized:
            return self.trainer.probs_apply_fn()
        if self._quantized is None:
            calib = self._calibration_images()
            if calib is None:
                logger.warning("quantized_serving: no metadata to calibrate "
                               "on; serving float")
                return self.trainer.probs_apply_fn()
            self._quantized = QuantizedProbs(*quantized_probs_fn(
                self.trainer.folded_float32, calib,
                compute_dtype=self.trainer.dtype,
                calib_batch_size=int(
                    self.config.params.batch_size_inference),
                version_fn=lambda: self.trainer._state_version))
        return self._quantized

    def _calibration_images(self):
        """The first `quant_calib_images` metadata images, preprocessed as
        the serve program sees them, on the loader's device; None when
        the metadata file does not exist yet."""
        path = os.path.join(self.config.params.meta_dir, "metadata.csv")
        if not os.path.exists(path):
            return None
        n = max(int(self.config.params.get("quant_calib_images", 32)), 1)
        x, _ = _xy(read_metadata(path)[:n])
        flow, steps = self.loader.transform(x, None,
                                            train_mode=False)["datagen"]
        chunks, total = [], 0
        for batch_id, batch in enumerate(flow):
            chunks.append(batch["image"])
            total += batch["image"].shape[0]
            if total >= n or batch_id + 1 >= steps:
                break
        if hasattr(flow, "close"):
            flow.close()
        return torch.cat(chunks)[:n]

    def serve_module(self, return_features=False):
        """The ServeProgram of `serve_program` with the loader's device
        preprocess in front (uint8 tiles in) over the current weights, for
        export (infer/artifact.py)."""
        self._ensure_weights()
        probs = self._probs_fn()
        module = (probs.module() if isinstance(probs, QuantizedProbs)
                  else self.trainer.probs_module())
        return ServeProgram(module, preprocess=self.loader.device_preprocess,
                            **self._serve_args(return_features))

    def _serve_args(self, return_features):
        post = self.config.postprocessor
        return dict(
            target_size=tuple(post.target_size),
            category_layers=self.category_layers,
            active_layers=active_layers_for(CATEGORY_IDS,
                                            self.category_layers),
            erode_size=int(post.erode_selem_size),
            dilate_size=int(post.dilate_selem_size),
            crop_size=(tuple(post.target_size) if self.crop_predictions
                       else None),
            tta_specs=(tta_specs(**dict(self.config.tta_generator))
                       if self.tta else None),
            tta_method=self.config.tta_aggregator.method,
            compute_features=bool(return_features))

    def _serve_flow(self, flow, steps, return_features=False):
        """(((labels, trimmed scores), feature tensor or None) per image)
        over the flow's batches, one batch in flight: batch k+1 is
        dispatched before batch k is collected. The padded tail's
        duplicates are not emitted."""
        n_images = getattr(flow, "n_images", None)
        serve = self.serve_program(return_features)
        emitted = 0

        def rows(outs):
            nonlocal emitted
            for i, (lab, sc) in enumerate(zip(outs[0], outs[1])):
                if n_images is not None and emitted >= n_images:
                    return
                emitted += 1
                yield ((lab, [list(sc[l][:int(lab[l].max())])
                              for l in range(lab.shape[0])]),
                       outs[3][i] if return_features else None)

        def collect(handle):
            start = time.perf_counter()
            outs = serve.collect(handle)
            self.device_seconds += time.perf_counter() - start
            return outs

        pending = None
        for batch_id, batch in enumerate(flow):
            start = time.perf_counter()
            handle = serve.dispatch(batch["image"])
            self.device_seconds += time.perf_counter() - start
            if pending is not None:
                yield from rows(collect(pending))
            pending = handle
            if batch_id + 1 >= steps:
                break
        if pending is not None:
            yield from rows(collect(pending))

    def _postprocessed_images(self, data, return_features=False):
        self._ensure_weights()
        x = [row[X_COLUMNS[0]] for row in data["input"]["meta"]]
        flow, steps = self.loader.transform(x, None,
                                            train_mode=False)["datagen"]
        yield from self._serve_flow(flow, steps, return_features)

    def transform(self, data, return_features=False):
        """{"y_pred": [(labels (L, th, tw) int16, one trimmed score list
        per layer) per image]} for the metadata rows of `data`, and with
        `return_features` "features_tensor": each image's (L,
        max_instances, 9) feature tensor."""
        y_pred, feats = [], []
        for pred, f in self._postprocessed_images(data, return_features):
            y_pred.append(pred)
            feats.append(f)
        out = {"y_pred": y_pred}
        if return_features:
            out["features_tensor"] = feats
        return out

    def transform_stream(self, data):
        """{"y_pred": a generator of the same per-image results}: at most
        one postprocessed batch is held at a time."""
        return {"y_pred": (pred for pred, _ in
                           self._postprocessed_images(data))}

    def transform_arrays(self, images_u8):
        """The same per-image results for (N, H, W, 3) uint8 tiles in host
        memory."""
        self._ensure_weights()
        for pred, _ in self._serve_flow(*self.loader.array_flow(images_u8)):
            yield pred


class ScoringModelPipeline:
    """scoring_model training: the base unet's inference over the sampled
    training images with the feature tensor, the feature tables with the
    ground-truth IoU, and the regressor's fit, one image at a time."""

    def __init__(self, config):
        self.config = config
        self.cache_dir = config.env.cache_dirpath
        self.base = UNetPipeline(config, train_mode=False)
        self.model = _make_scoring_model(config)
        self.category_layers = _category_layers(config)

    @property
    def cache_path(self):
        return _scoring_paths(self.cache_dir)[0]

    def clean_cache(self):
        pass

    def fit_transform(self, data):
        """data["input"]: "meta" rows and "annotations", one
        {category_id: [annotation]} per row (none: no IoU targets)."""
        meta = data["input"]["meta"]
        annotations = data["input"].get("annotations")
        if annotations is None:
            annotations = [{}] * len(meta)
        self.model.fit_stream(
            features_from_tensor(feats, labels, anns,
                                 category_layers=self.category_layers)
            for ((labels, _), feats), anns in zip(
                self.base._postprocessed_images(data, return_features=True),
                annotations))
        os.makedirs(os.path.dirname(self.cache_path), exist_ok=True)
        self.model.save(self.cache_path)
        logger.info("scoring model written to %s", self.cache_path)
        return {"scoring_model": self.model}

    def transform(self, data):
        raise RuntimeError("scoring_model pipeline only supports training")


class ScoringInferencePipeline:
    """unet[_padded|_tta]_scoring_model: the base pipeline's inference with
    the feature tensor, the regressor's predicted IoU as each instance's
    score, then NMS across the threshold layers, per image. `force_stream`
    makes the manager stream it: 19 layers of label maps per image are
    never all held."""

    force_stream = True

    def __init__(self, config, base_factory):
        self.config = config
        self.cache_dir = config.env.cache_dirpath
        self.base = base_factory(config)
        self.model = _make_scoring_model(config)
        self.category_layers = _category_layers(config)
        self.nms = NonMaximumSupression(
            iou_threshold=config.postprocessor.nms.iou_threshold)
        #: host seconds of the feature tables and the regressor
        self.scoring_seconds = 0.0
        self._loaded = False

    def clean_cache(self):
        pass

    def _load_model(self):
        """The port's scoring model file, else the JAX package's."""
        if self._loaded:
            return
        for path in _scoring_paths(self.cache_dir):
            if os.path.exists(path):
                self.model.load(path)
                self._loaded = True
                return
        raise RuntimeError("no trained scoring model at {} or {}".format(
            *_scoring_paths(self.cache_dir)))

    def _score_one(self, labels, feats):
        """features -> predicted-IoU scores -> NMS across layers, for one
        image (NMS never looks across images)."""
        start = time.perf_counter()
        features = features_from_tensor(feats, labels,
                                         category_layers=self.category_layers)
        image_scores = self.model.transform([features])["scores"][0]
        self.scoring_seconds += time.perf_counter() - start
        (labels, image_scores), = self.nms.transform(
            [(labels, image_scores)])["images_with_scores"]
        return labels, image_scores

    def transform(self, data):
        return {"y_pred": list(self.transform_stream(data)["y_pred"])}

    def transform_stream(self, data):
        """{"y_pred": a generator of (labels, scores after NMS) per
        image}: at most one postprocessed batch is held at a time."""
        self._load_model()
        return {"y_pred": (
            self._score_one(pred[0], feats)
            for pred, feats in self.base._postprocessed_images(
                data, return_features=True))}

    def fit_transform(self, data):
        return self.transform(data)


def _scoring_paths(cache_dir):
    """(the port's scoring model file, the JAX package's)."""
    stem = os.path.join(cache_dir, "transformers", "scoring_model")
    return f"{stem}.pkl", f"{stem}.joblib"


def _make_scoring_model(config):
    post = config.postprocessor
    if post.scoring_model != "lgbm":
        raise NotImplementedError(
            f"scoring_model: {post.scoring_model!r} is not ported: the JAX "
            f"package's random forest is sklearn's, which the port does not "
            f"import; use scoring_model: lgbm (the native GBM)")
    cfg = post.lightGBM
    return ScoringGBM(model_params=dict(cfg.model_params),
                      training_params=dict(cfg.training_params),
                      train_size=cfg.train_size, target=cfg.target)


PIPELINES = {
    "unet": {
        "train": partial(UNetPipeline, train_mode=True, loss_name="ce"),
        "inference": partial(UNetPipeline, train_mode=False, loss_name="ce"),
    },
    "unet_weighted": {
        "train": partial(UNetPipeline, train_mode=True, loss_name="weighted"),
        "inference": partial(UNetPipeline, train_mode=False,
                             loss_name="weighted"),
    },
    "unet_tta": {
        "inference": partial(UNetPipeline, train_mode=False, tta=True),
    },
    "unet_padded": {
        "inference": partial(UNetPipeline, train_mode=False, padded=True),
    },
    "scoring_model": {"train": ScoringModelPipeline},
    "unet_scoring_model": {
        "inference": partial(
            ScoringInferencePipeline,
            base_factory=partial(UNetPipeline, train_mode=False)),
    },
    "unet_padded_scoring_model": {
        "inference": partial(
            ScoringInferencePipeline,
            base_factory=partial(UNetPipeline, train_mode=False, padded=True)),
    },
    "unet_tta_scoring_model": {
        "inference": partial(
            ScoringInferencePipeline,
            base_factory=partial(UNetPipeline, train_mode=False, tta=True)),
    },
}
