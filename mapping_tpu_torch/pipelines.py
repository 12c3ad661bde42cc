"""The serving pipeline: uint8 tiles -> labelled instances and scores.

Counterpart of the inference half of mapping_tpu/pipelines.py
`UNetPipeline` (`serve_program`, `_postprocessed_images`) together with
mapping_tpu/train/trainer.py `probs_apply_fn`: the BN-folded UNetResNet
forward, a float32 softmax, and `FusedServe`, one batch in flight.

Configuration is a plain dict whose keys are those of the JAX package's
parameter file (mapping_tpu/config.py DEFAULT_PARAMS); only the keys below
are read. Values this port does not run yet raise.
"""

import contextlib
from typing import Any, Dict, Iterator, Mapping

import numpy as np
import torch

from mapping_tpu_torch.constants import CATEGORY_IDS, CATEGORY_LAYERS
from mapping_tpu_torch.data.loader import infer_batch_resize
from mapping_tpu_torch.infer.postprocess import active_layers_for
from mapping_tpu_torch.infer.serving import FusedServe
from mapping_tpu_torch.models.fold_bn import fold_batch_stats
from mapping_tpu_torch.models.registry import build_network

#: the JAX config's defaults for the keys this pipeline reads
SERVE_DEFAULTS: Dict[str, Any] = {
    "encoder": "ResNet101",
    "model_dtype": "bfloat16",
    "loader_mode": "resize",
    "image_h": 256,
    "image_w": 256,
    "batch_size_inference": 20,
    "crop_image_h": 300,
    "crop_image_w": 300,
    "erode_selem_size": 0,
    "dilate_selem_size": 0,
    "category_layers": CATEGORY_LAYERS,
    "quantized_serving": 0,
    "data_parallel": 0,
    "spatial_serving": 0,
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# settings of the JAX package this port does not run yet -> ROADMAP item
_NOT_PORTED = {"quantized_serving": 21, "data_parallel": 16,
               "spatial_serving": 16}


class UNetPipeline:
    """Serving UNetPipeline (`unet`/`unet_weighted` evaluate path, no TTA).

    params: the JAX parameter dict (keys of SERVE_DEFAULTS).
    state_dict: reference-named UNetResNet weights with BatchNorm
        statistics (e.g. from models.convert.state_dict_from_flax).
    device: where the model runs; a CUDA device needs a card and never
        falls back to the CPU.
    """

    def __init__(self, params: Mapping[str, Any],
                 state_dict: Mapping[str, Any], device="cuda"):
        p = {**SERVE_DEFAULTS, **params}
        for key, item in _NOT_PORTED.items():
            if p[key]:
                raise NotImplementedError(
                    f"{key}: {p[key]!r} is not ported yet (ROADMAP item "
                    f"{item})")
        if p["loader_mode"] != "resize":
            raise NotImplementedError(
                f"loader_mode {p['loader_mode']!r} is not ported yet "
                "(ROADMAP item 3)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("UNetPipeline: CUDA device requested but "
                               "torch.cuda.is_available() is False")
        self.dtype = _DTYPES[p["model_dtype"]]
        model = build_network({"encoder": p["encoder"]})
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in state_dict.items()})
        self.model = fold_batch_stats(model.eval()).to(
            device=self.device, dtype=self.dtype,
            memory_format=torch.channels_last)
        self.size = (int(p["image_h"]), int(p["image_w"]))
        self.batch_size = int(p["batch_size_inference"])
        category_layers = tuple(p["category_layers"])
        self.serve = FusedServe(
            self.probs, target_size=(int(p["crop_image_h"]),
                                     int(p["crop_image_w"])),
            category_layers=category_layers,
            active_layers=active_layers_for(CATEGORY_IDS, category_layers),
            erode_size=int(p["erode_selem_size"]),
            dilate_size=int(p["dilate_selem_size"]))

    @torch.inference_mode()
    def probs(self, images):
        """(B, H, W, 3) normalised images -> (B, H, W, C) float32 softmax
        probabilities; the convs run in the pipeline's dtype, and float32
        means full float32 (no TF32) for this call only."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        with _no_tf32(self.dtype == torch.float32):
            logits = self.model(x)
        return torch.softmax(logits.to(torch.float32), dim=1).permute(
            0, 2, 3, 1)

    def preprocess(self, images_u8):
        """(B, H, W, 3) uint8 (numpy or tensor) -> normalised float32
        (B, image_h, image_w, 3) on the pipeline's device."""
        return infer_batch_resize(torch.as_tensor(images_u8).to(self.device),
                                  self.size)

    def transform(self, images_u8) -> Iterator:
        """Yield (labels (L, th, tw) int16, trimmed scores: one list per
        layer) for each image of the (N, H, W, 3) uint8 tiles, in batches
        of `batch_size_inference` with one batch in flight: batch k+1 is
        dispatched before batch k is collected."""
        pending = None
        for start in range(0, len(images_u8), self.batch_size):
            batch = images_u8[start:start + self.batch_size]
            handle = self.serve.dispatch(self.preprocess(batch))
            if pending is not None:
                yield from _rows(self.serve.collect(pending))
            pending = handle
        if pending is not None:
            yield from _rows(self.serve.collect(pending))


@contextlib.contextmanager
def _no_tf32(active):
    """Turn TF32 off for matmuls and cuDNN convs while the block enqueues
    its kernels, and restore the process's settings after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if active:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _rows(outs):
    labels_b, scores_b = outs[0], outs[1]
    for lab, sc in zip(labels_b, scores_b):
        yield lab, [list(sc[l][:int(lab[l].max())])
                    for l in range(lab.shape[0])]
