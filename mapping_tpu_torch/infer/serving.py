"""Serving: forward (+TTA) + postprocess for one batch, enqueued on the
device.

Counterpart of mapping_tpu/infer/serving.py `FusedServe` on one device:
images -> [TTA expand -> forward -> inverse -> aggregate | forward] ->
softmax -> [centre crop] -> resize -> threshold -> erode/restore -> CCL ->
dilate -> scores [-> the per-instance feature tensor]. `ServeProgram` is
that chain as one module, the counterpart of the JAX `FusedServe._body`;
with a `preprocess` it also takes the loader mode's device preprocess
(uint8 tiles in, as the JAX `loader.infer_preprocess` inside an exported
program), and its `forward` at the base instance pad is what
infer/artifact.py exports with torch.export. `FusedServe` runs the same
module: `dispatch` enqueues all of it on the current CUDA stream and
returns without waiting; `collect` copies the compact outputs to the host,
which waits for them, and runs the overflow escalation (the rerun repeats
the TTA on the images it reruns). A serving loop that dispatches batch k+1
before it collects batch k keeps the device busy while the host handles
batch k. An int8 forward (models/quantize.py `QuantizedProbs`) serves as
any other; `enable_async_recalibration` and `recalibration_stats` reach
its recalibration.

Data-parallel serving (`mesh`, parallel/mesh.py; the JAX package's
shard_map over 'data'): one process, a replica per data-axis device.
`dispatch` cuts the batch into contiguous equal shards (a batch that does
not divide raises, as JAX's NamedSharding does), moves each to its device
and enqueues the whole fused body there without waiting: forward (+TTA),
softmax, resize, threshold, erode/restore, the CCL `label` on that
device's card, scores [, features]. `probs_fn` must run on its input's
device (the trainer's and the int8 forward do, with one copy of the
weights per device, parallel/mesh.py `Replicas`); a module is copied to
each device here the same way.
`collect` gathers the shards in order, and the overflow escalation re-runs
the dense images on the first device, as the JAX package re-runs them
single-device.

Spatial serving (`spatial=True` over a `mesh`; the JAX package's
`_spatial_program`): each image's rows are split over the mesh's devices
and the forward runs band by band with a row exchange at every layer that
reads another band's rows (parallel/spatial.py `SpatialProgram`, a trace
of the forward's module: `probs_fn` itself, or its `module()`, as the
trainer's and the int8 forward's give, re-traced when that object
changes). Each band's probabilities are cropped (`crop_size`) and resized
toward `target_size`, W first, then H as the band's partial; the partials
are summed on the first device, and `fused_postprocess` runs there, the
CCL `label` included, on the (B, th, tw, C) map. It refuses without a
mesh and with TTA, as the JAX package does; the overflow rerun runs
single-device on the first device.
"""

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from mapping_tpu_torch.data.augment import center_crop
from mapping_tpu_torch.data.tta import tta_wrap_predict
from mapping_tpu_torch.infer.postprocess import (MAX_INSTANCES,
                                                 escalate_overflow,
                                                 fused_postprocess)
from mapping_tpu_torch.parallel.mesh import Replicas, shard_batch
from mapping_tpu_torch.parallel.spatial import (SpatialProgram, crop_bands,
                                                gather_resized)


class ServeProgram(torch.nn.Module):
    """One batch through the serving chain, on the inputs' device.

    `forward(images_u8)`: (B, H, W, 3) uint8 -> labels (B, L, th, tw)
    int16, scores (B, L, N) float32, areas (B, L, N) int32 [, features
    (B, L, N, 9) float32 with `compute_features`], N = `max_instances`;
    it needs `preprocess` (uint8 -> normalised float32). `run(images,
    max_instances)` takes images already normalised and any pad.

    probs_fn(images) -> (B, H, W, C) softmax probabilities, float32; a
    module (trainer.SoftmaxProbs) is registered as a submodule, so that an
    export holds its weights. `tta_specs` (data/tta.py) serve every batch
    through test-time augmentation aggregated by `tta_method`; `crop_size`
    cuts the centre of the probabilities (the padded loader's undo) before
    the resize.
    """

    def __init__(self, probs_fn: Callable, *, target_size: Tuple[int, int],
                 category_layers: Tuple[int, ...],
                 active_layers: Optional[Tuple[int, ...]] = None,
                 erode_size: int = 0, dilate_size: int = 0,
                 crop_size: Optional[Tuple[int, int]] = None,
                 tta_specs: Optional[Sequence] = None,
                 tta_method: str = "gmean",
                 compute_features: bool = False,
                 max_instances: int = MAX_INSTANCES,
                 preprocess: Optional[Callable] = None):
        super().__init__()
        self.model_probs = probs_fn
        self._probs_fn = (tta_wrap_predict(probs_fn, list(tta_specs),
                                           tta_method)
                          if tta_specs else probs_fn)
        self.tta_variants = len(tta_specs) if tta_specs else 0
        self.post = dict(target_size=tuple(target_size),
                         category_layers=tuple(category_layers),
                         active_layers=active_layers,
                         erode_size=int(erode_size),
                         dilate_size=int(dilate_size),
                         compute_features=bool(compute_features))
        self.crop_size = tuple(crop_size) if crop_size else None
        self.max_instances = int(max_instances)
        self.preprocess = preprocess

    def probs(self, images):
        probs = self._probs_fn(images)
        if self.crop_size is not None:
            probs = center_crop(probs, self.crop_size)
        return probs

    def run(self, images, max_instances: int):
        outs = fused_postprocess(self.probs(images),
                                 max_instances=max_instances, **self.post)
        return (labels_i16(outs[0]),) + tuple(outs[1:])

    def forward(self, images_u8):
        return self.run(self.preprocess(images_u8), self.max_instances)


def _device_scope(device: torch.device):
    """The block runs with `device` as the current card (nothing on the
    CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class SpatialServe:
    """images -> (B, th, tw, C) probabilities on the first device of
    `devices`: `probs_fn` band by band over the devices, each band cropped
    to `crop_size` (centred) and resized toward `target_size`, the
    partials summed there (parallel/spatial.py). What is traced is
    `probs_fn` if it is a module, else the module its `module()` returns
    (the trainer's probability function, models/quantize.QuantizedProbs),
    else the plain function; a new object is traced anew."""

    def __init__(self, probs_fn: Callable, devices, target_size,
                 crop_size=None):
        self.probs_fn = probs_fn
        self.devices = tuple(devices)
        self.target_size = tuple(target_size)
        self.crop_size = crop_size
        self._program = None

    def program(self) -> SpatialProgram:
        fn = self.probs_fn
        module = getattr(fn, "module", None)
        if not isinstance(fn, torch.nn.Module) and callable(module):
            fn = module()
        if self._program is None or self._program.source is not fn:
            self._program = SpatialProgram(fn)
        return self._program

    def __call__(self, images):
        bands = self.program()(images, self.devices)
        h, pieces = crop_bands(bands, self.crop_size)
        return gather_resized(h, pieces, self.target_size, self.devices[0])


def _on_each_device(module: torch.nn.Module) -> Callable:
    """images -> module(images) through a copy of `module` on the images'
    device (`Replicas`: one copy per device)."""
    replicas = Replicas()
    return lambda images: replicas.get(module, images.device)(images)


class FusedServe:
    """images (B, H, W, 3) normalised float -> numpy labels (B, L, th, tw)
    int16, scores (B, L, N) float32, areas (B, L, N) int32 [, features
    (B, L, N, 9) float32 with `compute_features`], through a ServeProgram
    (same arguments) in inference mode; over a `mesh`, a shard of the
    batch on each of its data-axis devices, or with `spatial` a band of
    each image's rows (module docstring)."""

    def __init__(self, probs_fn: Callable, mesh=None, spatial: bool = False,
                 **kwargs):
        if spatial and mesh is None:
            raise ValueError("spatial serving requires a device mesh")
        if spatial and kwargs.get("tta_specs"):
            raise ValueError("spatial serving does not support TTA "
                             "(rotations need square shard-local tiles)")
        self.mesh = mesh
        self.spatial = None
        if spatial:
            self.spatial = SpatialServe(
                probs_fn, mesh.devices, kwargs["target_size"],
                kwargs.get("crop_size"))
        if mesh is not None and isinstance(probs_fn, torch.nn.Module):
            probs_fn = _on_each_device(probs_fn)
        self.program = ServeProgram(probs_fn, **kwargs)
        self._post = self.program.post
        self._crop_size = self.program.crop_size
        self._base_max_instances = self.program.max_instances

    def _probs(self, images):
        return self.program.probs(images)

    @torch.inference_mode()
    def _run(self, images, max_instances):
        with _device_scope(images.device):
            return self.program.run(images, max_instances)

    @torch.inference_mode()
    def _run_spatial(self, images, max_instances):
        first = self.mesh.devices[0]
        probs = self.spatial(images)
        with _device_scope(first):
            outs = fused_postprocess(probs, max_instances=max_instances,
                                     **self._post)
        return (labels_i16(outs[0]),) + tuple(outs[1:])

    def enable_async_recalibration(self) -> bool:
        """Online mode for an int8 forward (models/quantize.py): on a
        weight change, serve the previous int8 snapshot while the qtable
        rebuilds on a background thread. False (nothing done) for a float
        forward."""
        hook = getattr(self.program.model_probs, "set_async", None)
        if hook is None:
            return False
        hook(True)
        return True

    def recalibration_stats(self):
        """{"recalibrations", "serving_stale_batches"} of an int8 forward;
        {} for a float one."""
        return dict(getattr(self.program.model_probs, "stats", {}) or {})

    def dispatch(self, images):
        """Enqueue one batch (on a mesh, one shard on each device); returns
        a handle for `collect`. Does not synchronise."""
        if self.mesh is None:
            return [self._run(images, self._base_max_instances)], images
        if self.spatial is not None:
            return [self._run_spatial(images, self._base_max_instances)], \
                images
        return [self._run(shard, self._base_max_instances)
                for shard in shard_batch(images, self.mesh)], images

    def collect(self, handle):
        """Copy a dispatched batch's outputs to the host (this waits for
        them), the shards in order, and re-run images that overflow the
        instance pad with a doubled pad, up to MAX_INSTANCES_CEILING, on
        the first device of the mesh."""
        shards, images = handle
        first = (images.device if self.mesh is None
                 else self.mesh.devices[0])

        def rerun(idx, pad):
            sel = torch.as_tensor(idx, device=images.device)
            return [o.cpu().numpy()
                    for o in self._run(images[sel].to(first), pad)]

        outs = [np.concatenate(parts) if len(parts) > 1 else parts[0]
                for parts in zip(*[[o.cpu().numpy() for o in shard]
                                   for shard in shards])]
        return escalate_overflow(outs, rerun, self._base_max_instances)

    def __call__(self, images):
        return self.collect(self.dispatch(images))


def labels_i16(labels):
    """int32 labels -> int16 for the copy to the host, clamped at 32767 so
    a map with more components stays above every escalation pad instead of
    wrapping negative."""
    return torch.clamp(labels, max=32767).to(torch.int16)
