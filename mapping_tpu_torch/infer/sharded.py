"""Data-parallel fused inference: forward + postprocess per shard of a mesh.

Counterpart of mapping_tpu/infer/sharded.py, built on the replicas of
infer/serving.py: the batch is cut into contiguous equal shards over the
mesh's data axis (parallel/mesh.py `shard_batch`, which refuses a batch
that does not divide), the model is copied to each device once for as
long as the caller passes the same module object (`Replicas`; pass a new
object when the weights change), and each device runs the whole fused body
(forward -> softmax -> resize -> threshold -> CCL -> scores) on its shard,
the CCL through the CUDA `label` on that shard's card. The shards are
enqueued one after the other without waiting, and the outputs are
concatenated in order on the first device. No traffic crosses devices
after the weights are copied, as under JAX's shard_map.

`make_spatial_infer` splits each image's rows over the mesh's devices
instead (parallel/spatial.py): the forward runs band by band with a row
exchange at every layer that reads another band's rows, each band's
probabilities are resized toward the target size (W, then H as partials
summed on the first device), and the postprocess runs there on the small
map.
"""

from typing import Callable, Tuple

import torch

from mapping_tpu_torch.data.tta import tta_wrap_predict
from mapping_tpu_torch.infer.postprocess import fused_postprocess
from mapping_tpu_torch.infer.serving import SpatialServe, _device_scope
from mapping_tpu_torch.parallel.mesh import Mesh, Replicas, shard_batch


def _softmax(logits):
    return torch.softmax(logits.to(torch.float32), dim=-1)


def make_sharded_infer(apply_fn: Callable, mesh: Mesh,
                       target_size: Tuple[int, int] = (300, 300),
                       category_layers: Tuple[int, ...] = (1, 1),
                       active_layers: Tuple[int, ...] = None,
                       erode_size: int = 0,
                       dilate_size: int = 0):
    """(model, images) -> (labels, scores) with images (N, H, W, 3) cut
    over the mesh's data axis and `model` (a module, in eval mode) copied
    to each of its devices. apply_fn(model, images) -> logits (N, H, W,
    C). N must divide over the data axis."""
    post = dict(target_size=target_size, category_layers=category_layers,
                active_layers=active_layers, erode_size=erode_size,
                dilate_size=dilate_size)

    def per_device(model, images):
        labels, scores, _ = fused_postprocess(
            _softmax(apply_fn(model, images)), **post)
        return labels, scores

    return _sharded(per_device, mesh)


def make_sharded_tta_infer(apply_fn: Callable, mesh: Mesh, specs,
                           method: str = "gmean",
                           target_size: Tuple[int, int] = (300, 300),
                           category_layers: Tuple[int, ...] = (1, 1),
                           active_layers: Tuple[int, ...] = None,
                           erode_size: int = 0,
                           dilate_size: int = 0):
    """The same with test-time augmentation: each device expands its
    shard into the TTA variants of `specs`, runs the forward on them,
    inverts and aggregates them by `method` (data/tta.py), and
    postprocesses its shard."""
    post = dict(target_size=target_size, category_layers=category_layers,
                active_layers=active_layers, erode_size=erode_size,
                dilate_size=dilate_size)

    def per_device(model, images):
        probs = tta_wrap_predict(lambda flat: _softmax(apply_fn(model, flat)),
                                 list(specs), method)(images)
        labels, scores, _ = fused_postprocess(probs, **post)
        return labels, scores

    return _sharded(per_device, mesh)


def _sharded(per_device: Callable, mesh: Mesh):
    replicas = Replicas()

    @torch.inference_mode()
    def run(model, images):
        outs = []
        for shard in shard_batch(images, mesh):
            with _device_scope(shard.device):
                outs.append(per_device(replicas.get(model, shard.device),
                                       shard))
        first = mesh.devices[0]
        return tuple(torch.cat([o[i].to(first) for o in outs])
                     for i in range(len(outs[0])))

    return run


class _Probs(torch.nn.Module):
    """images -> float32 softmax of apply_fn(model, images), over the last
    axis; `model` a submodule, so that a trace reaches its layers."""

    def __init__(self, apply_fn, model):
        super().__init__()
        self.apply_fn, self.model = apply_fn, model

    def forward(self, images):
        return _softmax(self.apply_fn(self.model, images))


def make_spatial_infer(apply_fn: Callable, mesh: Mesh,
                       target_size: Tuple[int, int] = (300, 300),
                       category_layers: Tuple[int, ...] = (1, 1),
                       active_layers: Tuple[int, ...] = None,
                       erode_size: int = 0,
                       dilate_size: int = 0):
    """(model, images) -> (labels, scores) for images (N, H, W, 3) too
    large for one device: each image's rows split over the mesh's devices,
    `model` (a module, in eval mode) copied to each once for as long as
    the caller passes the same object. apply_fn(model, images) -> logits
    (N, H, W, C), traced with torch.fx (parallel/spatial.py names the
    layers it splits); the labels and scores are on the first device."""
    post = dict(target_size=target_size, category_layers=category_layers,
                active_layers=active_layers, erode_size=erode_size,
                dilate_size=dilate_size)
    serve = SpatialServe(None, mesh.devices, target_size)

    @torch.inference_mode()
    def run(model, images):
        if getattr(serve.probs_fn, "model", None) is not model:
            serve.probs_fn = _Probs(apply_fn, model)
        probs = serve(images)
        with _device_scope(mesh.devices[0]):
            labels, scores, _ = fused_postprocess(probs, **post)
        return labels, scores

    return run
