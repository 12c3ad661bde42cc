"""PipelineManager: the experiment lifecycle behind the CLI.

Counterpart of mapping_tpu/manager.py for prepare_masks (the target files
of the train and val splits, computed on the config's `device`),
prepare_metadata, train (the validation sample, dev mode's 20 train and
10 validation rows, `overwrite`, and `warm_start` for one call), evaluate
(validation sample, chunked or streamed
prediction, prediction.json, COCO AP/AR at IoU 0.5), predict_on_dir and
import_checkpoint, with the CATEGORY_LAYERS guards and the MetricSink
(stdout + metrics.jsonl under the experiment dir). Metadata are lists of
row dicts (data/metadata.py) instead of DataFrames.

Training the scoring model (`train -p scoring_model`) samples
`scoring_model__num_training_examples` train rows and groups their
annotations per category (`_get_scoring_model_data`). The scoring
inference pipelines are streamed (their `force_stream`), and the
instances their NMS suppressed (score 0) are written only with
`emit_suppressed`.

Each evaluate and predict_on_dir leaves the host seconds of its stages in
`manager.timings`: decode (on the loader's threads), device (in
FusedServe.dispatch and .collect), annotation + RLE, COCOeval, and the
whole call; a scoring pipeline adds its feature tables and regressor
(`scoring_s`), its NMS (`nms_s`) and the instances NMS suppressed.

`parity_drill` imports a reference checkpoint, scans the val split's
metadata when there is none, evaluates, and reports AP/AR beside the
reference's published 0.943 / 0.954 (the CLI's `parity_drill`).

`evaluate_artifact` (`evaluate --artifact DIR`) scores an exported serving
artifact (infer/artifact.py) on the same validation sample with the same
COCOeval, and leaves the same stage seconds in `manager.timings`.

`data_parallel: 1` (ROADMAP item 16): `train` of a unet pipeline with
more than one visible card runs `train_on_ranks` over them, one spawned
process per card (parallel/distributed.py), and returns when they have
finished; `evaluate` (and `train_evaluate`'s evaluate, in this process)
then serves on a replica per card. With one card every command runs the
plain path.
"""

import copy
import json
import logging
import math
import os
import random
import shutil
import time
from typing import Optional

import numpy as np

from mapping_tpu_torch.config import build_config
from mapping_tpu_torch.constants import (CATEGORY_IDS, CATEGORY_LAYERS, SEED,
                                         X_COLUMNS, Y_COLUMNS_SCORING)
from mapping_tpu_torch.data.coco import COCOIndex
from mapping_tpu_torch.data.metadata import (generate_inference_metadata,
                                             generate_metadata, read_metadata,
                                             write_metadata)
from mapping_tpu_torch.eval.cocoeval import coco_evaluation
from mapping_tpu_torch.infer.annotations import labeled_to_annotations
from mapping_tpu_torch.parallel import distributed
from mapping_tpu_torch.pipelines import PIPELINES
from mapping_tpu_torch.prep.targets import overlay_masks
from mapping_tpu_torch.train.callbacks import MetricSink

logger = logging.getLogger(__name__)


def _seed_everything(seed):
    random.seed(seed)
    np.random.seed(seed)


class PipelineManager:
    def __init__(self, config_path: Optional[str] = None, overrides=None):
        self.config = build_config(config_path, overrides)
        self.params = self.config.params
        _seed_everything(SEED)
        self.sink = MetricSink(os.path.join(self.params.experiment_dir,
                                            "metrics.jsonl"))
        self.timings = {}

    def _category_layers(self):
        return list(self.params.get("category_layers", CATEGORY_LAYERS))

    def prepare_masks(self, dev_mode):
        prepare_masks(dev_mode, self.params)

    def prepare_metadata(self, train_data, valid_data):
        prepare_metadata(train_data, valid_data, self.params)

    def start_experiment(self):
        os.makedirs(self.params.experiment_dir, exist_ok=True)

    def finish_experiment(self):
        pass

    def train(self, pipeline_name, dev_mode, warm_start=False):
        cl = self._category_layers()
        if pipeline_name == "scoring_model":
            assert cl[1] > 1, (
                "Train the scoring model with multiple thresholds: set "
                "category_layers to [1, 19]")
        else:
            assert cl[1] == 1, (
                "Training the base unet requires category_layers [1, 1]")
        if (warm_start or self.config.params.get("warm_start", 0)) \
                and self.config.params.get("overwrite", 0):
            raise ValueError(
                "warm_start and overwrite are mutually exclusive: overwrite "
                "deletes the experiment dir (including the previous stage's "
                "weights warm_start would continue from)")
        # the flag holds for this call only: config.params is shared, and a
        # later train() on this manager must not warm-start because an
        # earlier call asked for it
        prev = self.config.params.get("warm_start", 0)
        if warm_start:
            self.config.params["warm_start"] = 1
        try:
            devices = rank_devices(pipeline_name, self.config.params)
            if devices:
                train_on_ranks(pipeline_name, dev_mode, self.config, devices)
            else:
                train(pipeline_name, dev_mode, self.config)
        finally:
            self.config.params["warm_start"] = prev

    def evaluate(self, pipeline_name, dev_mode, chunk_size):
        cl = self._category_layers()
        if "scoring_model" in pipeline_name:
            assert cl[1] > 1, (
                "Evaluating a scoring-model pipeline requires multiple "
                "thresholds: set category_layers to [1, 19]")
        else:
            assert cl[1] == 1, (
                "Evaluating without a second-layer model requires "
                "category_layers [1, 1]")
        self.timings = {}
        ap, ar = evaluate(pipeline_name, dev_mode, chunk_size, self.config,
                          self.timings)
        self.sink.send_metric("Precision", ap)
        self.sink.send_metric("Recall", ar)
        return ap, ar

    def evaluate_artifact(self, artifact_dir, dev_mode=False,
                          chunk_size=None):
        self.timings = {}
        ap, ar = evaluate_with_artifact(artifact_dir, dev_mode, chunk_size,
                                        self.config, self.timings)
        self.sink.send_metric("Precision", ap)
        self.sink.send_metric("Recall", ar)
        return ap, ar

    def import_checkpoint(self, path, pipeline_name="unet"):
        """A complete reference torch checkpoint into the experiment's
        transformer cache; evaluate then scores those weights."""
        cl = self._category_layers()
        if "scoring_model" in pipeline_name:
            assert cl[1] > 1, (
                "Importing under a scoring-model pipeline requires multiple "
                "thresholds: set category_layers to [1, 19]")
        else:
            assert cl[1] == 1, (
                "Importing a base unet checkpoint requires category_layers "
                "[1, 1] (this yaml sets {})".format(cl))
        pipeline = PIPELINES[pipeline_name]["inference"](self.config)
        getattr(pipeline, "base", pipeline).import_checkpoint(path)

    def predict_on_dir(self, pipeline_name, dir_path, prediction_path,
                       chunk_size):
        cl = self._category_layers()
        if "scoring_model" in pipeline_name:
            assert cl[1] > 1, "set category_layers to [1, 19]"
        else:
            assert cl[1] == 1, "set category_layers to [1, 1]"
        self.timings = {}
        predict_on_dir(pipeline_name, dir_path, prediction_path, chunk_size,
                       self.config, self.timings)


#: the reference's published stage-1 validation result and the agreed
#: tolerance (the JAX package's mapping_tpu/manager.py keeps the same)
REFERENCE_AP = 0.943
REFERENCE_AR = 0.954
PARITY_TOLERANCE = 0.002


def parity_drill(manager, pipeline_name, checkpoint_path, data_dir=None,
                 chunk_size=None, dev_mode=False):
    """import_checkpoint -> prepare_metadata of the val split when
    meta_dir has no metadata.csv -> evaluate -> the report (a dict with
    the JAX drill's keys): AP/AR, the reference's, their deltas, the
    tolerance and whether both deltas are within it. `data_dir` replaces
    the config's for this manager."""
    if data_dir:
        manager.params["data_dir"] = str(data_dir)
    if not os.path.exists(checkpoint_path):
        raise FileNotFoundError(f"no checkpoint at {checkpoint_path}")
    manager.start_experiment()
    meta_path = os.path.join(manager.params.meta_dir, "metadata.csv")
    if not os.path.exists(meta_path):
        logger.info("parity drill: no metadata.csv; scanning the val split")
        manager.prepare_metadata(train_data=False, valid_data=True)
    manager.import_checkpoint(checkpoint_path, pipeline_name)
    ap, ar = manager.evaluate(pipeline_name, dev_mode=dev_mode,
                              chunk_size=chunk_size)
    report = {
        "pipeline": pipeline_name,
        "checkpoint": str(checkpoint_path),
        "ap": float(ap),
        "ar": float(ar),
        "reference_ap": REFERENCE_AP,
        "reference_ar": REFERENCE_AR,
        "delta_ap": round(float(ap) - REFERENCE_AP, 6),
        "delta_ar": round(float(ar) - REFERENCE_AR, 6),
        "tolerance": PARITY_TOLERANCE,
        "parity": bool(abs(float(ap) - REFERENCE_AP) <= PARITY_TOLERANCE
                       and abs(float(ar) - REFERENCE_AR) <= PARITY_TOLERANCE),
    }
    logger.info("parity drill: AP %.4f (ref %.3f, delta %+.4f)  AR %.4f "
                "(ref %.3f, delta %+.4f)  parity=%s",
                report["ap"], REFERENCE_AP, report["delta_ap"],
                report["ar"], REFERENCE_AR, report["delta_ar"],
                report["parity"])
    return report


# ---------------------------------------------------------------------------
# module-level drivers
# ---------------------------------------------------------------------------

def prepare_masks(dev_mode, params):
    """The target files of the train and val splits (annotation-small.json
    in dev mode) under meta_dir/masks_overlayed_eroded_{e}_dilated_{d}."""
    for dataset in ["train", "val"]:
        mask_dirname = "masks_overlayed_eroded_{}_dilated_{}".format(
            params.erode_selem_size, params.dilate_selem_size)
        target_dir = os.path.join(params.meta_dir, mask_dirname)
        logger.info("overlaying masks for %s -> %s", dataset, target_dir)
        overlay_masks(
            data_dir=params.data_dir,
            dataset=dataset,
            target_dir=target_dir,
            category_ids=CATEGORY_IDS,
            erode=params.erode_selem_size,
            dilate=params.dilate_selem_size,
            is_small=bool(dev_mode),
            num_threads=params.num_threads,
            border_width=params.border_width,
            small_annotations_size=params.small_annotations_size,
            device=params.get("device", "cuda"),
        )


def prepare_metadata(train_data, valid_data, params):
    logger.info("creating metadata")
    rows = generate_metadata(
        data_dir=params.data_dir,
        meta_dir=params.meta_dir,
        masks_overlayed_prefix=params.masks_overlayed_prefix,
        process_train_data=train_data,
        process_validation_data=valid_data,
    )
    path = os.path.join(params.meta_dir, "metadata.csv")
    os.makedirs(params.meta_dir, exist_ok=True)
    write_metadata(rows, path)
    logger.info("metadata saved to %s", path)


def _sample(rows, n, seed):
    """pandas' rows.sample(n, random_state=seed): the rows at
    RandomState(seed).choice(len, n, replace=False), in that order; all
    rows when n covers them."""
    n = min(int(n), len(rows))
    if n >= len(rows):
        return rows
    idx = np.random.RandomState(seed).choice(len(rows), size=n, replace=False)
    return [rows[i] for i in idx]


def rank_devices(pipeline_name, params):
    """The cards to train `pipeline_name` on, one rank each, or None for
    one process: with `data_parallel: 1`, every visible card where there
    is more than one, for the pipelines that train the unet."""
    if not params.get("data_parallel", 0) or pipeline_name not in (
            "unet", "unet_weighted"):
        return None
    if str(params.get("device", "cuda")) != "cuda":
        return None
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [f"cuda:{i}" for i in range(n)] if n > 1 else None


def train_on_ranks(pipeline_name, dev_mode, config, devices):
    """`train` on one spawned process per device (a rank each, NCCL for
    distinct cards, gloo otherwise) with `data_parallel: 1`: the ranks
    train data-parallel, rank 0 writes the files. Raises if a rank
    fails."""
    logger.info("training %s on %d ranks: %s", pipeline_name, len(devices),
                devices)
    config = copy.deepcopy(config)
    config.params["data_parallel"] = 1
    distributed.spawn(_train_rank, devices, pipeline_name, dev_mode, config)


def _train_rank(pipeline_name, dev_mode, config):
    logger = logging.getLogger("mapping_tpu_torch")
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            f"%(asctime)s rank {distributed.rank()} %(name)s >>> "
            f"%(message)s", datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    _seed_everything(SEED)
    train(pipeline_name, dev_mode, config)


def train(pipeline_name, dev_mode, config):
    params = config.params
    logger.info("training %s", pipeline_name)
    if bool(params.overwrite) and os.path.isdir(params.experiment_dir) \
            and distributed.is_primary():
        shutil.rmtree(params.experiment_dir)
    distributed.barrier()

    meta = read_metadata(os.path.join(params.meta_dir, "metadata.csv"))
    meta_train = [r for r in meta if r["is_train"] == 1]
    meta_valid = _sample([r for r in meta if r["is_valid"] == 1],
                         params.evaluation_data_sample, SEED)
    if dev_mode:
        meta_train = _sample(meta_train, 20, SEED)
        meta_valid = _sample(meta_valid, 10, SEED)
    train_mode, annotations = True, None
    if pipeline_name == "scoring_model":
        train_mode = False
        meta_train, annotations = _get_scoring_model_data(
            params.data_dir, meta_train,
            params.scoring_model__num_training_examples, SEED)
    data = {
        "input": {"meta": meta_train,
                  "target_sizes": [(300, 300)] * len(meta_train),
                  "annotations": annotations},
        "specs": {"train_mode": train_mode},
        "callback_input": {"meta_valid": meta_valid},
    }
    pipeline = PIPELINES[pipeline_name]["train"](config)
    pipeline.clean_cache()
    pipeline.fit_transform(data)
    pipeline.clean_cache()


def _validation_rows(params, dev_mode):
    meta = read_metadata(os.path.join(params.meta_dir, "metadata.csv"))
    rows = _sample([r for r in meta if r["is_valid"] == 1],
                   params.evaluation_data_sample, SEED)
    return _sample(rows, 30, SEED) if dev_mode else rows


def evaluate(pipeline_name, dev_mode, chunk_size, config, timings=None):
    params = config.params
    timings = {} if timings is None else timings
    start = time.perf_counter()
    logger.info("evaluating %s", pipeline_name)
    meta_valid = _validation_rows(params, dev_mode)
    pipeline = PIPELINES[pipeline_name]["inference"](config)
    prediction = generate_prediction(meta_valid, pipeline, config, chunk_size,
                                     timings)

    prediction_filepath = os.path.join(params.experiment_dir,
                                       "prediction.json")
    os.makedirs(params.experiment_dir, exist_ok=True)
    with open(prediction_filepath, "w") as f:
        json.dump(prediction, f)

    eval_start = time.perf_counter()
    ap, ar = coco_evaluation(
        gt_filepath=os.path.join(params.data_dir, "val", "annotation.json"),
        prediction_filepath=prediction_filepath,
        image_ids=[row[Y_COLUMNS_SCORING[0]] for row in meta_valid],
        category_ids=[c for c in CATEGORY_IDS if c is not None],
        small_annotations_size=params.small_annotations_size,
    )
    timings["cocoeval_s"] = time.perf_counter() - eval_start
    timings["total_s"] = time.perf_counter() - start
    logger.info("validation precision (AP@0.5) = %.4f", ap)
    logger.info("validation recall    (AR@0.5) = %.4f", ar)
    logger.info("host seconds: %s", json.dumps(timings))
    return ap, ar


def evaluate_with_artifact(artifact_dir, dev_mode, chunk_size, config,
                           timings=None):
    """`evaluate --artifact DIR`: the exported programs over the same
    validation sample as `evaluate`, scored by the same COCOeval, so an
    artifact's AP/AR can be held against the live pipeline's before it is
    deployed. Needs the config's data and metadata dirs and its `device`,
    but no checkpoint or model code. Fills `timings` as `evaluate` does,
    and with the seconds of the artifact's load (`load_s`)."""
    from mapping_tpu_torch.infer.artifact import (load_artifact,
                                                  predict_paths_with_artifact)

    params = config.params
    timings = {} if timings is None else timings
    start = time.perf_counter()
    logger.info("evaluating artifact %s", artifact_dir)
    meta_valid = _validation_rows(params, dev_mode)
    load_start = time.perf_counter()
    art = load_artifact(artifact_dir, device=params.get("device", "cuda"))
    timings["load_s"] = time.perf_counter() - load_start
    if params.get("data_parallel", 0):
        art.replicate()  # one replica, with a warning, on a single card
    prediction = predict_paths_with_artifact(
        art, [row[Y_COLUMNS_SCORING[0]] for row in meta_valid],
        [row[X_COLUMNS[0]] for row in meta_valid],
        chunk_images=int(chunk_size or 0), timings=timings)

    prediction_filepath = os.path.join(params.experiment_dir,
                                       "prediction.json")
    os.makedirs(params.experiment_dir, exist_ok=True)
    with open(prediction_filepath, "w") as f:
        json.dump(prediction, f)

    eval_start = time.perf_counter()
    ap, ar = coco_evaluation(
        gt_filepath=os.path.join(params.data_dir, "val", "annotation.json"),
        prediction_filepath=prediction_filepath,
        image_ids=[row[Y_COLUMNS_SCORING[0]] for row in meta_valid],
        category_ids=[c for c in CATEGORY_IDS if c is not None],
        small_annotations_size=params.small_annotations_size,
    )
    timings["cocoeval_s"] = time.perf_counter() - eval_start
    timings["total_s"] = time.perf_counter() - start
    logger.info("artifact validation precision (AP@0.5) = %.4f", ap)
    logger.info("artifact validation recall    (AR@0.5) = %.4f", ar)
    logger.info("host seconds: %s", json.dumps(timings))
    return ap, ar


def predict_on_dir(pipeline_name, dir_path, prediction_path, chunk_size,
                   config, timings=None):
    timings = {} if timings is None else timings
    start = time.perf_counter()
    meta = generate_inference_metadata(images_dir=dir_path)
    pipeline = PIPELINES[pipeline_name]["inference"](config)
    prediction = generate_prediction(meta, pipeline, config, chunk_size,
                                     timings)
    with open(prediction_path, "w") as f:
        json.dump(prediction, f)
    timings["total_s"] = time.perf_counter() - start
    logger.info("submission saved to %s", prediction_path)
    logger.info("host seconds: %s", json.dumps(timings))


def generate_prediction(meta_data, pipeline, config, chunk_size=None,
                        timings=None):
    """COCO result dicts for the metadata rows: per chunk of rows (all of
    them when chunk_size is None), or per image through the pipeline's
    stream when `stream_mode` is set, or the pipeline forces it, and no
    chunk size is. A pipeline with an NMS marks suppressed instances with
    score 0; they are written only with `emit_suppressed`. Fills `timings`
    with the host seconds of decode, device and annotation + RLE (and a
    scoring pipeline's scoring and NMS seconds and suppressed count), and
    the image count."""
    timings = {} if timings is None else timings
    category_layers = tuple(config.params.get("category_layers",
                                              CATEGORY_LAYERS))
    emit_suppressed = (not hasattr(pipeline, "nms")
                       or bool(config.params.get("emit_suppressed", 0)))
    stream = bool(config.params.get("stream_mode", 0)
                  or getattr(pipeline, "force_stream", False))
    annotation_s = 0.0
    prediction = []

    def annotate(image_id, labels, scores):
        nonlocal annotation_s
        start = time.perf_counter()
        prediction.extend(labeled_to_annotations(
            image_id, np.asarray(labels), scores, CATEGORY_IDS,
            category_layers, emit_suppressed=emit_suppressed))
        annotation_s += time.perf_counter() - start

    def data_of(rows):
        return {"input": {"meta": rows,
                          "target_sizes": [(300, 300)] * len(rows)},
                "specs": {"train_mode": False},
                "callback_input": {"meta_valid": None}}

    if chunk_size is None and stream:
        results = pipeline.transform_stream(data_of(meta_data))["y_pred"]
        for row, (labels, scores) in zip(meta_data, results, strict=True):
            annotate(row["ImageId"], labels, scores)
    else:
        if chunk_size is None:
            chunks = [meta_data]
        else:
            n = math.ceil(len(meta_data) / chunk_size)
            chunks = [meta_data[i * chunk_size:(i + 1) * chunk_size]
                      for i in range(n)]
        for chunk in chunks:
            pipeline.clean_cache()
            y_pred = pipeline.transform(data_of(chunk))["y_pred"]
            pipeline.clean_cache()
            for row, (labels, scores) in zip(chunk, y_pred, strict=True):
                annotate(row["ImageId"], labels, scores)
    base = getattr(pipeline, "base", pipeline)
    timings.update(images=len(meta_data),
                   decode_s=base.loader.decode_seconds,
                   device_s=base.device_seconds,
                   annotation_s=annotation_s)
    if hasattr(pipeline, "nms"):
        timings.update(scoring_s=pipeline.scoring_seconds,
                       nms_s=pipeline.nms.seconds,
                       suppressed=pipeline.nms.suppressed)
    return prediction


def _get_scoring_model_data(data_dir, meta, num_training_examples, seed):
    """The sampled train rows and, per row, its annotations grouped by
    category id ({category_id: [annotation]}; none for the background)."""
    coco = COCOIndex(os.path.join(data_dir, "train", "annotation.json"))
    meta = _sample(meta, num_training_examples, seed)
    annotations = []
    for row in meta:
        image_annotations = {}
        for category_id in CATEGORY_IDS:
            if category_id is None:
                image_annotations[category_id] = []
                continue
            ann_ids = coco.get_ann_ids(img_ids=[row["ImageId"]],
                                       cat_ids=[category_id])
            image_annotations[category_id] = coco.load_anns(ann_ids)
        annotations.append(image_annotations)
    return meta, annotations
