"""Minimal COCO annotation index (pycocotools-free).

A copy of mapping_tpu/data/coco.py: image/annotation/category lookup with
the pycocotools COCO surface, annotation -> RLE/mask through the port's
RLE codec (ops/rle.py), and `load_res` for a results file.
"""

import json
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from mapping_tpu_torch.ops import rle as rle_ops


class COCOIndex:
    """Annotation database with the pycocotools COCO lookup surface."""

    def __init__(self, annotation_file: Optional[str] = None,
                 dataset: Optional[Dict[str, Any]] = None):
        if dataset is None:
            dataset = {}
            if annotation_file is not None:
                with open(annotation_file) as f:
                    dataset = json.load(f)
        self.dataset = dataset
        self.imgs: Dict[int, dict] = {}
        self.anns: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self._index()

    def _index(self):
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    # -- pycocotools-compatible lookup --------------------------------------
    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs)

    def get_ann_ids(self, img_ids: Optional[Sequence[int]] = None,
                    cat_ids: Optional[Sequence[int]] = None) -> List[int]:
        if img_ids is None:
            anns = list(self.anns.values())
        else:
            anns = [a for i in img_ids for a in self.img_to_anns.get(i, [])]
        if cat_ids is not None:
            cat_ids = set(cat_ids)
            anns = [a for a in anns if a["category_id"] in cat_ids]
        return [a["id"] for a in anns]

    def get_cat_ids(self) -> List[int]:
        return sorted(self.cats)

    def load_imgs(self, ids: Sequence[int]) -> List[dict]:
        return [self.imgs[i] for i in ids]

    def load_anns(self, ids: Sequence[int]) -> List[dict]:
        return [self.anns[i] for i in ids]

    # camelCase aliases so call sites written against pycocotools just work
    getImgIds = get_img_ids
    getAnnIds = get_ann_ids
    getCatIds = get_cat_ids
    loadImgs = load_imgs
    loadAnns = load_anns

    # -- mask materialization ------------------------------------------------
    def ann_to_rle(self, ann: dict) -> dict:
        img = self.imgs[ann["image_id"]]
        return rle_ops.annotation_to_rle(ann, img["height"], img["width"])

    def ann_to_mask(self, ann: dict) -> np.ndarray:
        return rle_ops.decode(self.ann_to_rle(ann))

    annToRLE = ann_to_rle
    annToMask = ann_to_mask

    def load_res(self, results) -> "COCOIndex":
        """Build a results COCOIndex from a predictions list/json
        (pycocotools COCO.loadRes for segmentation results)."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        res_dataset = {
            "images": list(self.imgs.values()),
            "categories": list(self.cats.values()),
            "annotations": [],
        }
        for i, det in enumerate(results):
            ann = dict(det)
            ann["id"] = i + 1
            seg = ann.get("segmentation")
            if isinstance(seg, dict):
                if "area" not in ann:
                    ann["area"] = rle_ops.area(seg)
                if "bbox" not in ann:
                    ann["bbox"] = rle_ops.to_bbox(seg)
            ann.setdefault("iscrowd", 0)
            res_dataset["annotations"].append(ann)
        return COCOIndex(dataset=res_dataset)

    loadRes = load_res
