"""The named pipelines: the `unet`/`unet_weighted` train and inference
paths.

Counterpart of mapping_tpu/pipelines.py `UNetPipeline` and `PIPELINES`: a
pipeline composes the loader's device preprocess, the trainer's BN-folded
forward with a float32 softmax (`UNetTrainer.probs_apply_fn`) and the
fused postprocess (`FusedServe`), with one batch in flight. Its weights
live in the experiment's transformer cache: the port writes `unet.pt`
(torch.save of the reference-named state_dict) beside where the JAX
package writes `unet.msgpack`, and reads either, its own first; weights
read from a cache are folded once and the float32 model is freed
(`UNetTrainer.serve_only`).

`fit_transform(data)` (train mode) trains on the metadata rows' image and
mask files with the callbacks of the config's `unet.callbacks`, writes the
cache and marks the stage complete; a cache (the port's or the JAX
package's) short-circuits it unless `overwrite` or `warm_start` is set.
`warm_start` runs the next stage of the multistage recipe: the completed
stage's checkpoint dir moves to `checkpoints/unet.stage{N}` and its cache
is copied to `transformers/unet.stage{N}.pt` (`.msgpack` for a JAX
cache), and the fit starts from those weights. `transform(data)` takes
the manager's data dict, whose metadata rows name the image files;
`transform_arrays(images_u8)` serves uint8 tiles already in host memory
through the same program. Not ported yet, and raising with their ROADMAP
item: TTA and the padded centre crop (item 14), the scoring pipelines
(item 15), int8 serving (item 21) and a device mesh (item 16).
"""

import logging
import os
import shutil
import time
from functools import partial

from mapping_tpu_torch.constants import (CATEGORY_IDS, CATEGORY_LAYERS, SEED,
                                         X_COLUMNS, Y_COLUMNS)
from mapping_tpu_torch.data.loader import SegmentationLoader
from mapping_tpu_torch.infer.postprocess import active_layers_for
from mapping_tpu_torch.infer.serving import FusedServe
from mapping_tpu_torch.train.trainer import UNetTrainer

logger = logging.getLogger(__name__)

# settings of the JAX package this port does not run yet -> ROADMAP item
_NOT_PORTED = {"quantized_serving": 21, "data_parallel": 16,
               "spatial_serving": 16}


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP item {item})")


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
    """unet / unet_weighted training and inference on
    `config.params.device`."""

    def __init__(self, config, train_mode: bool, loss_name: str = "ce"):
        for key, item in _NOT_PORTED.items():
            if config.params.get(key, 0):
                raise _not_ported(f"{key}: {config.params[key]!r}", item)
        self.config = config
        self.cache_dir = config.env.cache_dirpath
        device = config.params.get("device", "cuda")
        loader = config.loader
        self.loader = SegmentationLoader(
            mode=loader.mode, size=loader.size, pad=loader.pad,
            pad_method=loader.pad_method,
            batch_size_train=loader.batch_size_train,
            batch_size_inference=loader.batch_size_inference,
            seed=loader.seed,
            load_in_memory=loader.load_in_memory, device=device)
        self.trainer = UNetTrainer(
            model_params=config.unet.model_params,
            optimizer_params=config.unet.optimizer_params,
            loss_params=config.unet.loss,
            training_config=config.unet.training,
            callbacks_config=config.unet.callbacks if train_mode else None,
            loss_name=loss_name,
            input_size=config.loader.size,
            seed=SEED,
            remat=bool(config.params.get("remat", 0)),
            pretrained_weights=config.unet.get("pretrained_weights", ""),
            device=device)
        self.category_layers = _category_layers(config)
        self._serve = None
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
            self.trainer.load(cache).serve_only()
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
            self.trainer.save(self.trainer_cache_path)
            self._mark_stage_complete()
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
        multistage recipe, from the weights in `cache`. A completed stage
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
        self.trainer.warm_start(cache)

    # -------------------------------------------------------- inference
    def serve_program(self):
        """The FusedServe this pipeline runs: forward + softmax + fused
        postprocess per batch; only labels, scores and areas leave the
        device."""
        if self._serve is None:
            post = self.config.postprocessor
            self._serve = FusedServe(
                self.trainer.probs_apply_fn(),
                target_size=tuple(post.target_size),
                category_layers=self.category_layers,
                active_layers=active_layers_for(CATEGORY_IDS,
                                                self.category_layers),
                erode_size=int(post.erode_selem_size),
                dilate_size=int(post.dilate_selem_size))
        return self._serve

    def _serve_flow(self, flow, steps):
        """((labels, trimmed scores) per image) over the flow's batches,
        one batch in flight: batch k+1 is dispatched before batch k is
        collected. The padded tail's duplicates are not emitted."""
        n_images = getattr(flow, "n_images", None)
        serve = self.serve_program()
        emitted = 0

        def rows(outs):
            nonlocal emitted
            for lab, sc in zip(outs[0], outs[1]):
                if n_images is not None and emitted >= n_images:
                    return
                emitted += 1
                yield lab, [list(sc[l][:int(lab[l].max())])
                            for l in range(lab.shape[0])]

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

    def _postprocessed_images(self, data):
        self._ensure_weights()
        x = [row[X_COLUMNS[0]] for row in data["input"]["meta"]]
        flow, steps = self.loader.transform(x, None,
                                            train_mode=False)["datagen"]
        yield from self._serve_flow(flow, steps)

    def transform(self, data):
        """{"y_pred": [(labels (L, th, tw) int16, one trimmed score list
        per layer) per image]} for the metadata rows of `data`."""
        return {"y_pred": list(self._postprocessed_images(data))}

    def transform_stream(self, data):
        """{"y_pred": a generator of the same per-image results}: at most
        one postprocessed batch is held at a time."""
        return {"y_pred": self._postprocessed_images(data)}

    def transform_arrays(self, images_u8):
        """The same per-image results for (N, H, W, 3) uint8 tiles in host
        memory."""
        self._ensure_weights()
        yield from self._serve_flow(*self.loader.array_flow(images_u8))


def _unported_factory(what, item):
    def factory(config):
        raise _not_ported(what, item)
    return factory


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
    "unet_tta": {"inference": _unported_factory("unet_tta", "14")},
    "unet_padded": {"inference": _unported_factory("unet_padded", "14")},
    "scoring_model": {"train": _unported_factory("scoring_model", "15")},
    **{name: {"inference": _unported_factory(name, "15")}
       for name in ("unet_scoring_model", "unet_padded_scoring_model",
                    "unet_tta_scoring_model")},
}
