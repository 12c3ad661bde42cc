"""Ground-truth-vs-prediction overlays of a prediction.json.

Counterpart of mapping_tpu/utils/visualize.py, behind the CLI's
`visualize`:

    python3 -m mapping_tpu_torch.main --config cfg.yaml visualize \
        --prediction_path experiment/prediction.json --out_dir overlays/

Each written PNG shows a tile with its ground-truth instances tinted green
and the predicted ones red, with 1-px instance boundaries. Pixel-equal to
the JAX package's overlays; the PNG is written by `utils/png.py` (no
Pillow), so the files' bytes differ from Pillow's but decode to the same
array. Needs no card.
"""

import json
import logging
import os
from typing import List, Optional, Sequence

import numpy as np

from mapping_tpu_torch.data.coco import COCOIndex
from mapping_tpu_torch.data.loader import load_image
from mapping_tpu_torch.utils.png import write_png_rgb

logger = logging.getLogger(__name__)

_GT_COLOR = np.array([40, 220, 70], np.float32)      # green
_PRED_COLOR = np.array([235, 60, 50], np.float32)    # red
_FILL_ALPHA = 0.35
_EDGE_ALPHA = 0.95


def _union_and_edges(masks: Sequence[np.ndarray], shape):
    """(filled union, 1-px boundary union) over instance masks; pixels
    outside the image count as background, so a mask on the tile's edge
    gets its boundary drawn along it."""
    union = np.zeros(shape, bool)
    edges = np.zeros(shape, bool)
    for m in masks:
        m = m.astype(bool)
        interior = m.copy()
        interior[1:, :] &= m[:-1, :]
        interior[:-1, :] &= m[1:, :]
        interior[:, 1:] &= m[:, :-1]
        interior[:, :-1] &= m[:, 1:]
        interior[0, :] = interior[-1, :] = False
        interior[:, 0] = interior[:, -1] = False
        edges |= m & ~interior
        union |= m
    return union, edges


def overlay_instances(image_u8: np.ndarray,
                      gt_masks: Sequence[np.ndarray],
                      pred_masks: Sequence[np.ndarray]) -> np.ndarray:
    """(H, W, 3) uint8 tile with the ground truth tinted green and the
    predictions red."""
    out = image_u8.astype(np.float32)
    for masks, color in ((gt_masks, _GT_COLOR), (pred_masks, _PRED_COLOR)):
        if not masks:
            continue
        fill, edges = _union_and_edges(masks, image_u8.shape[:2])
        out[fill] = out[fill] * (1 - _FILL_ALPHA) + color * _FILL_ALPHA
        out[edges] = out[edges] * (1 - _EDGE_ALPHA) + color * _EDGE_ALPHA
    return np.clip(out, 0, 255).astype(np.uint8)


def visualize_predictions(prediction_path: str, data_dir: str, out_dir: str,
                          dataset: str = "val", n_images: int = 8,
                          image_ids: Optional[Sequence[int]] = None,
                          score_threshold: float = 0.0,
                          max_dets: int = 100,
                          hide_suppressed: bool = True,
                          seed: int = 1234) -> List[str]:
    """Write out_dir/overlay_{image_id}.png for sampled images; returns
    the written paths.

    prediction_path: a COCO results json (what evaluate / predict_on_dir
    write); data_dir/dataset holds annotation.json and images/.
    image_ids overrides the sample: otherwise `n_images` ids drawn with
    RandomState(seed) from the predicted ids the split has (all its ids
    when none). Per image, instances with a score below score_threshold
    are dropped, and with hide_suppressed those with score 0 (the
    NMS-suppressed instances of a scoring pipeline's emit_suppressed
    output); at most max_dets (0: all) are drawn, by score."""
    gt = COCOIndex(os.path.join(data_dir, dataset, "annotation.json"))
    with open(prediction_path) as f:
        results = json.load(f)
    dt = gt.load_res(results) if results else None

    if image_ids is None:
        predicted = {int(r["image_id"]) for r in results}
        valid = predicted & set(gt.imgs)
        candidates = sorted(valid) or sorted(gt.get_img_ids())
        dropped = len(predicted) - len(valid)
        if dropped:
            logger.warning("%d predicted image id(s) absent from %s GT; "
                           "sampling the rest", dropped, dataset)
        rng = np.random.RandomState(seed)
        take = min(int(n_images), len(candidates))
        image_ids = sorted(rng.choice(candidates, size=take, replace=False))

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for image_id in image_ids:
        image_id = int(image_id)
        if image_id not in gt.imgs:
            logger.warning("image id %d not in %s GT; skipped", image_id,
                           dataset)
            continue
        info = gt.imgs[image_id]
        tile = load_image(os.path.join(data_dir, dataset, "images",
                                       info["file_name"]))
        gt_masks = [gt.ann_to_mask(a) for a in
                    gt.load_anns(gt.get_ann_ids(img_ids=[image_id]))]
        pred_anns = (dt.load_anns(dt.get_ann_ids(img_ids=[image_id]))
                     if dt is not None else [])
        kept = [a for a in pred_anns
                if (not hide_suppressed or float(a.get("score", 1.0)) > 0.0)
                and float(a.get("score", 1.0)) >= score_threshold]
        kept.sort(key=lambda a: -float(a.get("score", 1.0)))  # stable
        if max_dets > 0 and len(kept) > max_dets:
            logger.info(
                "image %d: drawing top %d of %d detections by score (the "
                "eval maxDets protocol); raise --score_threshold to cut "
                "low-score instances", image_id, max_dets, len(kept))
            kept = kept[:max_dets]
        pred_masks = [dt.ann_to_mask(a) for a in kept]
        path = os.path.join(out_dir, f"overlay_{image_id}.png")
        write_png_rgb(path, overlay_instances(tile, gt_masks, pred_masks))
        written.append(path)
        logger.info("wrote %s (gt=%d pred=%d)", path, len(gt_masks),
                    len(pred_masks))
    return written
