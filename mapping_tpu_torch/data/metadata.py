"""Metadata tables: the image list of an experiment, as rows of dicts.

Counterpart of mapping_tpu/data/metadata.py without pandas: the same
columns (ImageId, file_path_image, is_train, is_valid, n_buildings and one
`file_path_mask{suffix}` column per prepared mask directory under
`meta_dir`, or is_test for an inference directory) in the same order, and
`write_metadata` writes the same metadata.csv as pandas' to_csv(index=None)
(None as an empty field, '\\n' line ends, minimal quoting).
"""

import csv
import glob
import json
import os
from typing import Dict, List

Rows = List[Dict[str, object]]

#: columns read back as integers (the rest stay strings, empty -> None)
_INT_COLUMNS = ("ImageId", "is_train", "is_valid", "is_test")


def _mask_dirs(meta_dir, masks_overlayed_prefix):
    dirs, suffixes = [], []
    for file_path in sorted(glob.glob(os.path.join(meta_dir, "*"))):
        base = os.path.basename(file_path)
        if base.startswith(masks_overlayed_prefix):
            dirs.append(file_path)
            suffixes.append(base.replace(masks_overlayed_prefix, ""))
    return dirs, suffixes


def generate_metadata(data_dir, meta_dir, masks_overlayed_prefix,
                      process_train_data=True,
                      process_validation_data=True) -> Rows:
    if not (process_train_data or process_validation_data):
        raise ValueError("at least one of process_train_data/"
                         "process_validation_data must be set")
    mask_dirs, suffixes = _mask_dirs(meta_dir, masks_overlayed_prefix)
    splits = (["train"] if process_train_data else []) \
        + (["val"] if process_validation_data else [])
    rows = []
    for split in splits:
        images_path = os.path.join(data_dir, split, "images")
        with open(os.path.join(data_dir, split, "annotation.json")) as f:
            annotation = json.load(f)
        name_to_id = {img["file_name"]: img["id"]
                      for img in annotation["images"]}
        for image_file_path in sorted(glob.glob(os.path.join(images_path,
                                                             "*"))):
            name = os.path.basename(image_file_path)
            row = {"ImageId": name_to_id[name],
                   "file_path_image": image_file_path,
                   "is_train": 1 if split == "train" else 0,
                   "is_valid": 1 if split == "val" else 0,
                   "n_buildings": None}
            stem = name.rsplit(".", 1)[0]
            for mask_dir, suffix in zip(mask_dirs, suffixes):
                row["file_path_mask" + suffix] = os.path.join(
                    mask_dir, split, "masks", f"{stem}.png")
            rows.append(row)
    return rows


def generate_inference_metadata(images_dir) -> Rows:
    return [{"ImageId": image_id, "file_path_image": path, "is_train": 0,
             "is_valid": 0, "is_test": 1, "n_buildings": None}
            for image_id, path in enumerate(
                sorted(glob.glob(os.path.join(images_dir, "*"))))]


def write_metadata(rows: Rows, path):
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        if rows:
            writer.writerow(list(rows[0]))
        for row in rows:
            writer.writerow(list(row.values()))


def read_metadata(path) -> Rows:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        for key, value in row.items():
            if value == "":
                row[key] = None
            elif key in _INT_COLUMNS:
                row[key] = int(value)
    return rows
