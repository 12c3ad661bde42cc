"""Labelled instance maps -> COCO result annotations.

A copy of mapping_tpu/infer/annotations.py: each threshold layer is split
into its instances, each Fortran-order RLE encoded (UTF-8 counts) with its
bbox taken from the RLE and its score attached; the layer maps to its
category by searchsorted(cumsum(category_layers)), and layers whose
category id is None (the background) are skipped. The C++ library
(utils/native.py `rle_instances`) extracts every instance of a layer in
one pass where it builds; the numpy RLE code does otherwise, and writes
the same strings (`_instance_rle`).
"""

import logging
from typing import List, Optional, Sequence

import numpy as np

from mapping_tpu_torch.ops import rle as rle_ops
from mapping_tpu_torch.utils import native as _native

logger = logging.getLogger(__name__)


def labeled_to_annotations(
    image_id: int,
    labels: np.ndarray,
    scores,
    category_ids: Sequence[Optional[int]],
    category_layers: Sequence[int],
    emit_suppressed: bool = True,
) -> List[dict]:
    """labels (L, H, W) int, scores (L, max_instances) array or one list
    per layer -> result dicts.

    emit_suppressed=False drops instances whose score is exactly 0.0, the
    scoring pipelines' mark of an NMS-suppressed instance. A layer with
    more instances than score slots (past the escalation ceiling) keeps
    the first ones and logs a warning."""
    annotations = []
    layer_to_cat = np.searchsorted(
        np.cumsum(category_layers), np.arange(labels.shape[0]), side="right")
    for layer_nr in range(labels.shape[0]):
        category_id = category_ids[layer_to_cat[layer_nr]]
        if category_id is None:
            continue
        layer = labels[layer_nr]
        layer_scores = scores[layer_nr]
        n_instances = min(int(layer.max()), len(layer_scores))
        if int(layer.max()) > len(layer_scores):
            logger.warning(
                "annotations: image %d layer %d has %d instances but only "
                "%d score slots; dropping the tail",
                int(image_id), layer_nr, int(layer.max()), len(layer_scores))
        if n_instances == 0:
            continue
        h, w = layer.shape
        if _native.available():
            instances = [(counts.decode("utf-8"), bbox) for counts, bbox in
                         _native.rle_instances(layer, n_instances)]
        else:
            instances = [_instance_rle(layer == label_nr)
                         for label_nr in range(1, n_instances + 1)]
        for label_nr, (counts, bbox) in enumerate(instances, start=1):
            score = float(layer_scores[label_nr - 1])
            if not emit_suppressed and score == 0.0:
                continue
            annotations.append({
                "image_id": int(image_id),
                "category_id": int(category_id),
                "score": score,
                "segmentation": {"size": [h, w], "counts": counts},
                "bbox": bbox,
            })
    return annotations


def _instance_rle(mask):
    """(counts string, bbox) of one instance mask in the C++ library's
    form: its run list ends with an empty 0-run when the last pixel in
    column-major order is set, where `ops/rle.encode` (pycocotools) ends
    with the 1-run. Both decode to the same mask; this keeps the string
    the same whether or not the library builds."""
    mask = np.asarray(mask, np.uint8)
    runs = rle_ops._runs_from_flat(mask.flatten(order="F") != 0)
    if mask.size and mask[-1, -1]:
        runs.append(0)
    rle = {"size": list(mask.shape),
           "counts": rle_ops.counts_to_string(runs)}
    return rle["counts"].decode("utf-8"), rle_ops.to_bbox(rle)


def create_annotations(
    image_ids: Sequence[int],
    labels_batch: np.ndarray,
    scores_batch: np.ndarray,
    category_ids: Sequence[Optional[int]],
    category_layers: Sequence[int],
) -> List[dict]:
    """Batch driver: (B, L, H, W) labels + (B, L, N) scores -> annotations."""
    annotations = []
    for image_id, labels, scores in zip(image_ids, labels_batch, scores_batch):
        annotations.extend(labeled_to_annotations(
            image_id, np.asarray(labels), np.asarray(scores),
            category_ids, category_layers))
    return annotations
