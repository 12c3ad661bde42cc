"""The named pipelines: the `unet`/`unet_weighted` inference path.

Counterpart of mapping_tpu/pipelines.py `UNetPipeline` and `PIPELINES`: a
pipeline composes the loader's device preprocess, the trainer's BN-folded
forward with a float32 softmax (`UNetTrainer.probs_apply_fn`) and the
fused postprocess (`FusedServe`), with one batch in flight. Its weights
live in the experiment's transformer cache: the port writes `unet.pt`
(torch.save of the reference-named state_dict) beside where the JAX
package writes `unet.msgpack`, and reads either, its own first; weights
read from a cache are folded once and the float32 model is freed
(`UNetTrainer.serve_only`).

`transform(data)` takes the manager's data dict, whose metadata rows name
the image files; `transform_arrays(images_u8)` serves uint8 tiles already
in host memory through the same program. Not ported yet, and raising with
their ROADMAP item: training (item 11), TTA and the padded
centre crop (item 14), the scoring pipelines (item 15), int8 serving (item
21) and a device mesh (item 16).
"""

import os
import time
from functools import partial

from mapping_tpu_torch.constants import (CATEGORY_IDS, CATEGORY_LAYERS, SEED,
                                         X_COLUMNS)
from mapping_tpu_torch.data.loader import SegmentationLoader
from mapping_tpu_torch.infer.postprocess import active_layers_for
from mapping_tpu_torch.infer.serving import FusedServe
from mapping_tpu_torch.train.trainer import UNetTrainer

# settings of the JAX package this port does not run yet -> ROADMAP item
_NOT_PORTED = {"quantized_serving": 21, "data_parallel": 16,
               "spatial_serving": 16}


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP item {item})")


def _category_layers(config):
    return tuple(config.params.get("category_layers", CATEGORY_LAYERS))


class UNetPipeline:
    """unet / unet_weighted inference on `config.params.device`."""

    def __init__(self, config, train_mode: bool, loss_name: str = "ce"):
        if train_mode:
            raise _not_ported("training a pipeline", "11")
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
            batch_size_inference=loader.batch_size_inference,
            load_in_memory=loader.load_in_memory, device=device)
        self.trainer = UNetTrainer(
            model_params=config.unet.model_params,
            optimizer_params=config.unet.optimizer_params,
            loss_params=config.unet.loss,
            training_config=config.unet.training,
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
        self._weights_loaded = True
        return self

    def set_weights(self, state_dict):
        """Serve the reference-named `state_dict` (no cache is read); the
        trainer keeps its float32 model, to be saved or set again."""
        self.trainer.load_state_dict(state_dict)
        self._weights_loaded = True
        return self

    def _ensure_weights(self):
        if self._weights_loaded:
            return
        for path in (self.trainer_cache_path, self.jax_cache_path):
            if os.path.exists(path):
                self.trainer.load(path).serve_only()
                self._weights_loaded = True
                return
        raise RuntimeError(
            f"no trained unet found at {self.trainer_cache_path} or "
            f"{self.jax_cache_path}; import a checkpoint first")

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
        "train": _unported_factory("the unet train pipeline", "11"),
        "inference": partial(UNetPipeline, train_mode=False, loss_name="ce"),
    },
    "unet_weighted": {
        "train": _unported_factory("the unet_weighted train pipeline",
                                   "11"),
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
