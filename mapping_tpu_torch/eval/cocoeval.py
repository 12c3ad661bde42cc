"""COCO segmentation evaluation with the crowdAI fork's summary.

A copy of mapping_tpu/eval/cocoeval.py without its JAX-package imports:
pycocotools COCOeval matching and accumulation (greedy best-IoU match in
score order per IoU threshold, crowd GTs matchable many times, ignored
regions, area-range filtering, 101-point interpolated precision), the
fork's area ranges all / small (< 14^2) / large, its 6-stat summary all at
IoU 0.5, and the truncation of detections to the top maxDets by score
before IoU. `coco_evaluation` returns (AP@0.5, AR@0.5). Mask IoU goes
through the port's RLE codec (ops/rle.py) and its C++ fast path.
"""

from typing import List

import numpy as np

from mapping_tpu_torch.data.coco import COCOIndex
from mapping_tpu_torch.ops import rle as rle_ops


class EvalParams:
    """Default parameters mirroring the fork's Params(iouType='segm')."""

    def __init__(self, iou_type: str = "segm"):
        self.iou_type = iou_type
        self.img_ids: List[int] = []
        self.cat_ids: List[int] = []
        self.iou_thrs = np.linspace(0.5, 0.95, 10, endpoint=True)
        self.rec_thrs = np.linspace(0.0, 1.00, 101, endpoint=True)
        self.max_dets = [1, 10, 100]
        self.area_rng = [[0, 1e10], [0, 14**2], [14**2, 1e10]]
        self.area_rng_lbl = ["all", "small", "large"]
        self.use_cats = 1


class COCOEvaluator:
    """Evaluate detections in `coco_dt` against ground truth `coco_gt`."""

    def __init__(self, coco_gt: COCOIndex, coco_dt: COCOIndex,
                 iou_type: str = "segm"):
        self.coco_gt = coco_gt
        self.coco_dt = coco_dt
        self.params = EvalParams(iou_type)
        self.params.img_ids = sorted(coco_gt.get_img_ids())
        self.params.cat_ids = sorted(coco_gt.get_cat_ids())
        self.eval = {}
        self.stats = np.zeros((6,))
        self._img_cat_results = {}

    # ------------------------------------------------------------------ iou
    def _segmentation_of(self, ann, coco):
        seg = ann.get("segmentation")
        img = coco.imgs[ann["image_id"]]
        return rle_ops.annotation_to_rle(ann, img["height"], img["width"])

    def _compute_iou(self, img_id, cat_id, gts, dts):
        if not gts or not dts:
            return np.zeros((len(dts), len(gts)))
        if self.params.iou_type == "segm":
            g = [self._segmentation_of(ann, self.coco_gt) for ann in gts]
            d = [self._segmentation_of(ann, self.coco_dt) for ann in dts]
            iscrowd = [int(ann.get("iscrowd", 0)) for ann in gts]
            return rle_ops.iou(d, g, iscrowd)
        g = [ann["bbox"] for ann in gts]
        d = [ann["bbox"] for ann in dts]
        iscrowd = [int(ann.get("iscrowd", 0)) for ann in gts]
        return rle_ops.iou_boxes(d, g, iscrowd)

    # ------------------------------------------------------------- matching
    def _ann_area(self, ann):
        if "area" in ann:
            return ann["area"]
        seg = ann.get("segmentation")
        if isinstance(seg, dict):
            return rle_ops.area(seg)
        return ann["bbox"][2] * ann["bbox"][3]

    def _evaluate_img(self, gts, dts, ious, area_rng, max_det):
        """One (image, category, areaRng, maxDet) cell of the evaluation."""
        T = len(self.params.iou_thrs)
        for g in gts:
            area = self._ann_area(g)
            g["_ignore"] = bool(g.get("iscrowd", 0)) or not (
                area_rng[0] <= area < area_rng[1])
        # non-ignored GTs first (stable), detections by descending score
        gt_order = sorted(range(len(gts)), key=lambda i: gts[i]["_ignore"])
        gts_s = [gts[i] for i in gt_order]
        dt_order = sorted(range(len(dts)),
                          key=lambda i: -dts[i].get("score", 0.0))[:max_det]
        dts_s = [dts[i] for i in dt_order]
        ious_s = (ious[dt_order][:, gt_order]
                  if len(gt_order) and len(dt_order) else
                  np.zeros((len(dt_order), len(gt_order))))

        G, D = len(gts_s), len(dts_s)
        gt_matched = np.zeros((T, G), dtype=np.int64)
        dt_matched = np.zeros((T, D), dtype=np.int64)
        gt_ignore = np.array([g["_ignore"] for g in gts_s], dtype=bool)
        dt_ignore = np.zeros((T, D), dtype=bool)
        for t_ind, t in enumerate(self.params.iou_thrs):
            for d_ind in range(D):
                best_iou = min(t, 1 - 1e-10)
                best_g = -1
                for g_ind in range(G):
                    # taken GTs can't rematch, except crowd GTs
                    if gt_matched[t_ind, g_ind] and not gts_s[g_ind].get("iscrowd", 0):
                        continue
                    # once we reach ignored GTs, stop if a real match exists
                    if best_g > -1 and not gt_ignore[best_g] and gt_ignore[g_ind]:
                        break
                    if ious_s[d_ind, g_ind] < best_iou:
                        continue
                    best_iou = ious_s[d_ind, g_ind]
                    best_g = g_ind
                if best_g == -1:
                    continue
                dt_ignore[t_ind, d_ind] = gt_ignore[best_g]
                dt_matched[t_ind, d_ind] = gts_s[best_g]["id"]
                gt_matched[t_ind, best_g] = dts_s[d_ind]["id"]
        # unmatched detections outside the area range are ignored
        dt_areas = np.array([self._ann_area(d) for d in dts_s]) if D else np.zeros((0,))
        out_of_rng = (dt_areas < area_rng[0]) | (dt_areas >= area_rng[1])
        dt_ignore = dt_ignore | ((dt_matched == 0) & out_of_rng[None, :])
        return {
            "dt_scores": np.array([d.get("score", 0.0) for d in dts_s]),
            "dt_matched": dt_matched,
            "dt_ignore": dt_ignore,
            "gt_ignore": gt_ignore,
            "num_gt": int((~gt_ignore).sum()),
        }

    # ------------------------------------------------------------ pipeline
    def evaluate(self):
        p = self.params
        cat_ids = p.cat_ids if p.use_cats else [-1]
        self._per_img = {}
        for cat_id in cat_ids:
            for img_id in p.img_ids:
                # shallow copies: _evaluate_img only writes the top-level
                # _ignore key; deep-copying every segmentation payload per
                # (category, image) dominated per-epoch validation on
                # large annotations
                gts = [{**a} for a in
                       self.coco_gt.img_to_anns.get(img_id, [])
                       if not p.use_cats or a["category_id"] == cat_id]
                dts = [a for a in self.coco_dt.img_to_anns.get(img_id, [])
                       if not p.use_cats or a["category_id"] == cat_id]
                # pycocotools truncates dt to the top maxDets[-1] by score
                # BEFORE computing IoU (cocoeval.py computeIoU); every
                # _evaluate_img cell slices to max_det <= max(max_dets)
                # after its own stable sort, so results are identical and
                # the IoU matrix stops scaling with raw detection count
                # (the 19-threshold-layer scoring path emits thousands of
                # suppressed zero-score detections per image)
                top = max(p.max_dets)
                if len(dts) > top:
                    dts = sorted(dts,
                                 key=lambda d: -d.get("score", 0.0))[:top]
                ious = self._compute_iou(img_id, cat_id, gts, dts)
                cells = []
                for a_ind, a_rng in enumerate(p.area_rng):
                    cells.append(self._evaluate_img(
                        gts, dts, ious, a_rng, max(p.max_dets)))
                self._per_img[(cat_id, img_id)] = cells

    def accumulate(self):
        p = self.params
        T = len(p.iou_thrs)
        R = len(p.rec_thrs)
        K = len(p.cat_ids) if p.use_cats else 1
        A = len(p.area_rng)
        M = len(p.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        cat_ids = p.cat_ids if p.use_cats else [-1]
        for k, cat_id in enumerate(cat_ids):
            for a in range(A):
                cells = [self._per_img[(cat_id, img_id)][a]
                         for img_id in p.img_ids
                         if (cat_id, img_id) in self._per_img]
                if not cells:
                    continue
                num_gt = sum(c["num_gt"] for c in cells)
                for m, max_det in enumerate(p.max_dets):
                    scores = np.concatenate(
                        [c["dt_scores"][:max_det] for c in cells])
                    matched = np.concatenate(
                        [c["dt_matched"][:, :max_det] for c in cells], axis=1)
                    ignored = np.concatenate(
                        [c["dt_ignore"][:, :max_det] for c in cells], axis=1)
                    order = np.argsort(-scores, kind="mergesort")
                    matched = matched[:, order]
                    ignored = ignored[:, order]
                    tps = (matched > 0) & ~ignored
                    fps = (matched == 0) & ~ignored
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    if num_gt == 0:
                        continue
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        rc = tp / num_gt
                        pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                        recall[t, k, a, m] = rc[-1] if len(rc) else 0.0
                        # interpolated precision: monotone non-increasing
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, p.rec_thrs, side="left")
                        q = np.zeros((R,))
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[t, :, k, a, m] = q
        self.eval = {"precision": precision, "recall": recall,
                     "params": p}

    def _summary_value(self, ap, iou_thr, area_lbl, max_det):
        p = self.params
        a = p.area_rng_lbl.index(area_lbl)
        m = p.max_dets.index(max_det)
        t = int(np.argmin(np.abs(p.iou_thrs - iou_thr)))
        s = (self.eval["precision"][t, :, :, a, m] if ap
             else self.eval["recall"][t, :, a, m])
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self, verbose=True):
        """Fork layout (src/cocoeval.py:465-473): 6 stats, all at IoU=0.5:
        [AP, AP-small, AP-large, AR, AR-small, AR-large] @ maxDets=100."""
        md = self.params.max_dets[-1]
        self.stats = np.array([
            self._summary_value(1, 0.5, "all", md),
            self._summary_value(1, 0.5, "small", md),
            self._summary_value(1, 0.5, "large", md),
            self._summary_value(0, 0.5, "all", md),
            self._summary_value(0, 0.5, "small", md),
            self._summary_value(0, 0.5, "large", md),
        ])
        if verbose:
            labels = ["AP@0.5 all", "AP@0.5 small", "AP@0.5 large",
                      "AR@0.5 all", "AR@0.5 small", "AR@0.5 large"]
            for name, value in zip(labels, self.stats):
                print(f" {name:<14s} (maxDets={md}) = {value:0.3f}")
        return self.stats


_GT_CACHE = {}


def _load_gt(gt_filepath):
    """Per-process GT index cache: per-epoch validation re-evaluates against
    the same annotation file (src/callbacks.py:133-151) and parsing a large
    COCO json every epoch would dominate."""
    import os

    key = (gt_filepath, os.path.getmtime(gt_filepath))
    if key not in _GT_CACHE:
        _GT_CACHE.clear()
        _GT_CACHE[key] = COCOIndex(gt_filepath)
    return _GT_CACHE[key]


def coco_evaluation(gt_filepath, prediction_filepath, image_ids, category_ids,
                    small_annotations_size=14, verbose=True):
    """(AP@.5, AR@.5) driver (reference src/utils.py:308-321)."""
    coco_gt = _load_gt(gt_filepath)
    coco_dt = coco_gt.load_res(prediction_filepath)
    evaluator = COCOEvaluator(coco_gt, coco_dt)
    evaluator.params.img_ids = list(image_ids)
    evaluator.params.cat_ids = list(category_ids)
    s = small_annotations_size
    evaluator.params.area_rng = [[0, 1e10], [0, s**2], [s**2, 1e10]]
    evaluator.evaluate()
    evaluator.accumulate()
    stats = evaluator.summarize(verbose=verbose)
    return stats[0], stats[3]
