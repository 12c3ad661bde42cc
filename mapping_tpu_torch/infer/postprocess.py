"""Mask postprocessing on the device: probabilities -> labelled instances.

Counterpart of mapping_tpu/infer/postprocess.py: resize the (B, H, W, C)
probabilities to the target size, threshold each category channel per
layer, label the connected components (the CUDA CCL kernels for a CUDA
tensor), and score every instance as mean probability x sqrt(area).
Erosion/dilation (ROADMAP item 4) and the scoring feature tensor (item 15)
are not ported yet and raise.
"""

import logging
from typing import Sequence, Tuple

import numpy as np
import torch

from mapping_tpu_torch.data.augment import resize_bilinear
from mapping_tpu_torch.ops.ccl import connected_components
from mapping_tpu_torch.ops.instance import instance_areas_and_prob_sums

MAX_INSTANCES = 256
#: escalation ceiling for images denser than the default instance pad
MAX_INSTANCES_CEILING = 4096

logger = logging.getLogger(__name__)


def layer_thresholds(category_layers: Sequence[int]):
    """Per-layer (threshold, category_channel): n layers per category with
    thresholds arange(step, 1, step), step = 1 / (n + 1)."""
    out = []
    for cat_ch, n_layers in enumerate(category_layers):
        step = 1.0 / (n_layers + 1)
        for t in np.arange(step, 1.0 - 1e-9, step):
            out.append((float(t), cat_ch))
    return out


def active_layers_for(category_ids, category_layers) -> Tuple[int, ...]:
    """Layer indices whose category is emitted (CATEGORY_IDS entry not
    None)."""
    out = []
    layer = 0
    for cat_ch, n_layers in enumerate(category_layers):
        for _ in range(n_layers):
            if category_ids[cat_ch] is not None:
                out.append(layer)
            layer += 1
    return tuple(out)


def fused_postprocess(probs, target_size: Tuple[int, int] = (300, 300),
                      category_layers: Tuple[int, ...] = (1, 1),
                      erode_size: int = 0, dilate_size: int = 0,
                      max_instances: int = MAX_INSTANCES,
                      active_layers: Tuple[int, ...] = None,
                      compute_features: bool = False):
    """probs (B, H, W, C) float -> labels (B, L, th, tw) int32,
    scores (B, L, max_instances) float32, areas (B, L, max_instances) int32,
    on the device of `probs`.

    L = sum(category_layers); inactive layers (not in `active_layers`,
    default all) come back as zeros."""
    if compute_features:
        raise NotImplementedError(
            "compute_features: the scoring feature tensor is not ported yet "
            "(ROADMAP item 15)")
    if erode_size > 0 or dilate_size > 0:
        raise NotImplementedError(
            "erode/dilate postprocessing is not ported yet (ROADMAP item 4)")
    b = probs.shape[0]
    th, tw = target_size
    probs = probs.to(torch.float32)
    if tuple(probs.shape[1:3]) != (th, tw):
        probs = resize_bilinear(probs, (th, tw))

    specs = layer_thresholds(category_layers)
    n_layers = len(specs)
    active = list(range(n_layers) if active_layers is None else active_layers)
    layer_probs = torch.stack([probs[..., specs[l][1]] for l in active], 1)
    thresholds = torch.tensor([specs[l][0] for l in active],
                              dtype=torch.float32, device=probs.device)
    binary = layer_probs > thresholds.reshape(1, -1, 1, 1)
    labels_a = connected_components(binary)  # (B, LA, th, tw)

    areas, sums = instance_areas_and_prob_sums(
        labels_a.reshape(-1, th, tw), layer_probs.reshape(-1, th, tw),
        max_instances)
    areas_i, sums_i = areas[:, 1:], sums[:, 1:]
    safe = torch.clamp(areas_i, min=1).to(torch.float32)
    scores_a = (sums_i / safe) * torch.sqrt(areas_i.to(torch.float32))
    scores_a = torch.where(areas_i > 0, scores_a, 0.0)

    la = len(active)
    idx = torch.tensor(active, device=probs.device)
    labels = torch.zeros((b, n_layers, th, tw), dtype=torch.int32,
                         device=probs.device)
    scores = torch.zeros((b, n_layers, max_instances), dtype=torch.float32,
                         device=probs.device)
    areas_out = torch.zeros((b, n_layers, max_instances), dtype=torch.int32,
                            device=probs.device)
    labels[:, idx] = labels_a
    scores[:, idx] = scores_a.reshape(b, la, max_instances)
    areas_out[:, idx] = areas_i.reshape(b, la, max_instances)
    return labels, scores, areas_out


def _merge_overflow(outs, retried, overflow):
    """Overwrite the overflow rows of numpy outputs; outputs beyond labels
    pad along the instances axis (2) to the retry width."""
    merged = [outs[0].copy()]
    merged[0][overflow] = retried[0]
    for out, out_r in zip(outs[1:], retried[1:]):
        widths = [(0, 0)] * out.ndim
        widths[2] = (0, out_r.shape[2] - out.shape[2])
        out = np.pad(out, widths)
        out[overflow] = out_r
        merged.append(out)
    return merged


def escalate_overflow(outs, rerun, max_instances):
    """Overflow escalation over numpy outputs (labels first).

    The per-instance outputs are padded to `max_instances` but CCL is
    uncapped: images with more components than the pad are re-run with
    `rerun(indices, doubled_pad)` -> numpy outputs and merged, up to
    MAX_INSTANCES_CEILING, past which the tail is dropped with a warning."""
    while True:
        counts = outs[0].max(axis=(1, 2, 3))
        overflow = np.where(counts > max_instances)[0]
        if overflow.size == 0:
            return tuple(outs)
        if max_instances >= MAX_INSTANCES_CEILING:
            logger.warning(
                "%d image(s) exceed the instance-pad ceiling %d (max "
                "components %d); tail instances dropped", overflow.size,
                MAX_INSTANCES_CEILING, int(counts.max()))
            return tuple(outs)
        max_instances *= 2
        logger.info("%d image(s) overflow; re-running them padded to %d",
                    overflow.size, max_instances)
        outs = _merge_overflow(outs, rerun(overflow, max_instances), overflow)


def postprocess_probabilities(probs, **kwargs):
    """`fused_postprocess` with numpy outputs and the overflow escalation."""
    max_instances = kwargs.pop("max_instances", MAX_INSTANCES)

    def run(p, pad):
        return [o.cpu().numpy() for o in
                fused_postprocess(p, max_instances=pad, **kwargs)]

    return escalate_overflow(
        run(probs, max_instances),
        lambda idx, pad: run(probs[torch.as_tensor(idx, device=probs.device)],
                             pad),
        max_instances)
