"""Second-level scoring models: per-instance feature tables, the IoU
regressor, and NMS across threshold layers.

Counterpart of mapping_tpu/scoring.py without pandas or sklearn:
- `features_from_tensor` turns one image's device feature tensor (L,
  max_instances, 9) and labels into one `FeatureTable` per threshold
  layer: numpy columns in the JAX DataFrame's order (`TABLE_COLUMNS`: the
  ground-truth IoU, NaN without ground truth, the layer's threshold, then
  ops/instance.FEATURE_COLUMNS). The IoU targets of the train path come
  from the C++ RLE library (one pass per layer for the detections; the
  ground truth's RLEs are made once per image and category, where the JAX
  package makes them again for every layer).
  `features_for_mask` is the per-instance host oracle of the tests.
- `ScoringGBM` fits the native histogram GBM (cpp/gbm.cpp through
  utils/native_gbm) on the rows with a target, split 70/30 as
  sklearn.model_selection.train_test_split(train_size=0.7,
  random_state=1234) splits them (`train_valid_split`, the same index
  sets). The JAX package's sklearn fallback of the GBM and its
  ScoringRandomForest need sklearn, which the port does not import: a
  GBM library that does not build raises, and `scoring_model:
  random_forest` raises (pipelines._make_scoring_model).
- Persistence: `save` writes the port's own file, a plain pickle of
  builtins ({"format", "class", "params", "blob"}; pickle needs no class
  to read it), which the pipelines keep at transformers/scoring_model.pkl
  beside the JAX package's scoring_model.joblib. `load_estimator` reads
  that file, or a JAX-written joblib file of
  mapping_tpu.utils.native_gbm.NativeGBMRegressor (an uncompressed
  pickle whose one class maps to the port's regressor, with the same
  state); any other class raises, naming itself.
- `remove_overlapping_masks` is the greedy per-image NMS by score across
  every (layer, instance), zeroing the scores of instances whose IoU with
  a kept one exceeds the threshold: run-space IoUs from the C++ library,
  gated by a bound from the boxes and areas. `_remove_overlapping_masks_
  dense` (a boolean mask per pair) is its oracle in the tests only.
"""

import io
import logging
import math
import os
import pickle
import time
from typing import Dict, List

import numpy as np

from mapping_tpu_torch.constants import CATEGORY_IDS, CATEGORY_LAYERS
from mapping_tpu_torch.ops import rle as rle_ops
from mapping_tpu_torch.ops.instance import FEATURE_COLUMNS
from mapping_tpu_torch.utils import native, native_gbm

logger = logging.getLogger(__name__)

#: the columns of a FeatureTable, in the JAX DataFrame's order
TABLE_COLUMNS = ("iou", "threshold") + FEATURE_COLUMNS
#: the columns the regressor reads (the JAX package's _FEATURE_COLUMNS)
MODEL_COLUMNS = ("threshold",) + FEATURE_COLUMNS
#: feature columns the JAX package casts to int
INT_COLUMNS = ("area", "bbox_area", "contour_length")
#: the port's scoring-model file format (a plain pickle of builtins)
FILE_FORMAT = "mapping_tpu_torch scoring model 1"


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

def _bbox(mask):
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return rmin, rmax + 1, cmin, cmax + 1


def _contour_length(mask):
    """Mask pixels minus those left by a 4-neighbour erosion that leaves
    the image border alone."""
    m = mask.astype(bool)
    interior = m.copy()
    interior[1:] &= m[:-1]
    interior[:-1] &= m[1:]
    interior[:, 1:] &= m[:, :-1]
    interior[:, :-1] &= m[:, 1:]
    return int(m.sum() - interior.sum())


def features_for_mask(mask, probabilities, threshold, iou=None) -> Dict:
    """One instance's feature row, on the host (the oracle of the device
    feature tensor)."""
    mask = mask.astype(bool)
    area = int(mask.sum())
    masked = np.where(mask, probabilities, 0.0)
    rmin, rmax, cmin, cmax = _bbox(mask)
    bh, bw = rmax - rmin, cmax - cmin
    h, w = mask.shape
    dists = [rmin, h - rmax, cmin, w - cmax]
    return {
        "iou": iou,
        "threshold": round(float(threshold), 2),
        "area": area,
        "mean_prob": float(masked.sum() / max(area, 1)),
        "max_prob": float(masked.max()) if area else 0.0,
        "bbox_ar": bh / bw,
        "bbox_area": bh * bw,
        "bbox_fill": area / (bh * bw),
        "min_dist_to_border": min(dists),
        "max_dist_to_border": max(dists),
        "contour_length": _contour_length(mask),
    }


def _layer_thresholds(category_layers):
    thresholds = []
    for n in category_layers:
        step = 1.0 / (n + 1)
        thresholds.extend(np.arange(step, 1.0 - 1e-9, step))
    return thresholds


class FeatureTable:
    """One threshold layer's instances: a numpy column per name of
    TABLE_COLUMNS (iou and threshold float64, INT_COLUMNS int64, the other
    features float32, as in the JAX package's DataFrame)."""

    __slots__ = ("columns",)

    def __init__(self, columns):
        self.columns = dict(columns)

    def __len__(self):
        return len(self.columns["iou"])

    def __getitem__(self, name):
        return self.columns[name]

    def matrix(self, names=MODEL_COLUMNS):
        """(rows, len(names)) float64."""
        return np.stack([np.asarray(self.columns[n], np.float64)
                         for n in names], axis=1).reshape(len(self), -1)


def _detection_rles(layer, n, h, w):
    """The RLEs of instances 1..n of a labelled map, in one C++ pass."""
    return [{"size": [h, w], "counts": counts}
            for counts, _ in native.rle_instances(layer, n)]


def _gt_rles(annotations, h, w):
    """One RLE per ground-truth annotation (a multi-polygon annotation
    merged into one)."""
    return [rle_ops.annotation_to_rle(ann, h, w) for ann in annotations]


def _gt_iou_matrix(layer, annotations, gt_rles=None):
    """(instances, annotations) IoU of a labelled layer against ground
    truth annotations, or None without annotations or instances. `gt_rles`
    are the annotations' RLEs when the caller has them already."""
    if not annotations:
        return None
    h, w = layer.shape
    n = int(layer.max())
    if n == 0:
        return None
    if gt_rles is None:
        gt_rles = _gt_rles(annotations, h, w)
    return native.rle_iou(_detection_rles(layer, n, h, w), gt_rles,
                          [0] * len(gt_rles))


def features_from_tensor(feature_tensor, labels, annotations=None,
                         category_layers=None,
                         category_ids=None) -> List[FeatureTable]:
    """One image's device feature tensor (L, max_instances, 9) and labels
    (L, H, W) -> a FeatureTable per layer. The labels give each layer's
    instance count (clamped to the tensor's slots, with a warning) and,
    with `annotations` ({category_id: [annotation]}), the IoU targets."""
    if category_layers is None:
        category_layers = CATEGORY_LAYERS
    if category_ids is None:
        category_ids = CATEGORY_IDS
    annotations = annotations or {}
    thresholds = _layer_thresholds(category_layers)
    layer_to_cat = np.searchsorted(np.cumsum(category_layers),
                                   np.arange(labels.shape[0]), side="right")
    feature_tensor = np.asarray(feature_tensor)
    gt_rles = {}  # category id -> RLEs, shared by the category's layers
    tables = []
    for layer_nr in range(labels.shape[0]):
        category_id = category_ids[layer_to_cat[layer_nr]]
        cat_anns = annotations.get(category_id, [])
        if cat_anns and category_id not in gt_rles:
            gt_rles[category_id] = _gt_rles(cat_anns, *labels.shape[1:])
        layer = labels[layer_nr]
        n = int(layer.max())
        if n > feature_tensor.shape[1]:
            logger.warning("layer %d: %d instances exceed the %d feature "
                           "slots; tail dropped from scoring", layer_nr, n,
                           feature_tensor.shape[1])
            n = feature_tensor.shape[1]
        iou_matrix = _gt_iou_matrix(layer, cat_anns,
                                    gt_rles.get(category_id))
        iou = (np.asarray(iou_matrix.max(axis=1)[:n], dtype=np.float64)
               if iou_matrix is not None and iou_matrix.size else
               np.full(n, np.nan))
        block = feature_tensor[layer_nr, :n]
        columns = {"iou": iou,
                   "threshold": np.full(n, round(float(thresholds[layer_nr]),
                                                 2))}
        for j, name in enumerate(FEATURE_COLUMNS):
            col = block[:, j]
            columns[name] = col.astype(np.int64) if name in INT_COLUMNS \
                else col
        tables.append(FeatureTable(columns))
    return tables


# ---------------------------------------------------------------------------
# the regressor
# ---------------------------------------------------------------------------

def train_valid_split(n, train_size=0.7, seed=1234):
    """(train indices, valid indices) of n rows, the index sets of
    sklearn.model_selection.train_test_split(train_size=train_size,
    random_state=seed): floor(train_size * n) rows to train, the rest to
    validate, from one RandomState(seed) permutation (valid first)."""
    n_train = math.floor(train_size * n)
    n_valid = n - n_train
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_valid:n_valid + n_train], perm[:n_valid]


class _EstimatorUnpickler(pickle.Unpickler):
    """Resolves only the native GBM regressor of either package."""

    ALLOWED = {("mapping_tpu.utils.native_gbm", "NativeGBMRegressor"),
               ("mapping_tpu_torch.utils.native_gbm", "NativeGBMRegressor")}

    def find_class(self, module, name):
        if (module, name) in self.ALLOWED:
            return native_gbm.NativeGBMRegressor
        raise pickle.UnpicklingError(
            f"the scoring model file holds a {module}.{name}: the port reads "
            f"only the native GBM (NativeGBMRegressor); the JAX package's "
            f"sklearn models (its GBM fallback, ScoringRandomForest) need "
            f"sklearn, which the port does not import")


def load_estimator(filepath):
    """The regressor in a file the port wrote (`save`) or a joblib file
    the JAX package wrote of its NativeGBMRegressor."""
    with open(filepath, "rb") as f:
        raw = f.read()
    if raw[:1] != b"\x80":  # pickle protocol 2 or later
        raise ValueError(f"{filepath}: not an uncompressed pickle (a "
                         f"compressed joblib file?)")
    obj = _EstimatorUnpickler(io.BytesIO(raw)).load()
    if isinstance(obj, native_gbm.NativeGBMRegressor):
        return obj
    if isinstance(obj, dict) and obj.get("format") == FILE_FORMAT \
            and obj.get("class") == "NativeGBMRegressor":
        est = native_gbm.NativeGBMRegressor.from_bytes(obj["blob"])
        est.params = dict(obj["params"])
        return est
    raise ValueError(f"{filepath}: not a scoring model file "
                     f"({type(obj).__name__})")


class _ScoringModelBase:
    """Fit on the feature tables, predict per image and layer."""

    target = "iou"
    train_size = 0.7

    def __init__(self):
        self.estimator = None
        self.fit_stats = {}

    def fit(self, features):
        return self.fit_stream(iter(features))

    def fit_stream(self, features_iter):
        """Fit from an iterator of per-image table lists (the background
        layer 0 skipped), keeping each image's rows with a target as numpy
        rows only."""
        Xs, ys = [], []
        n_images = 0
        for image_features in features_iter:
            n_images += 1
            for table in image_features[1:]:
                if not len(table):
                    continue
                target = np.asarray(table[self.target], np.float64)
                keep = ~np.isnan(target)
                if not keep.any():
                    continue
                Xs.append(table.matrix()[keep])
                ys.append(target[keep])
        X = (np.concatenate(Xs) if Xs
             else np.empty((0, len(MODEL_COLUMNS))))
        y = np.concatenate(ys) if ys else np.empty((0,))
        if len(y) < 4:
            X_train, y_train = X, y
            X_valid, y_valid = X, y
        else:
            train, valid = train_valid_split(len(y), self.train_size, 1234)
            X_train, y_train = X[train], y[train]
            X_valid, y_valid = X[valid], y[valid]
        start = time.perf_counter()
        self._fit_estimator(X_train, y_train, X_valid, y_valid)
        self.fit_stats = {"images": n_images, "rows": len(y),
                          "train_rows": len(y_train),
                          "valid_rows": len(y_valid),
                          "fit_s": time.perf_counter() - start}
        logger.info("scoring model: %d feature rows from %d images (train "
                    "%d, valid %d); fit in %.4f s, best_iteration %s of %s "
                    "trees", len(y), n_images, len(y_train), len(y_valid),
                    self.fit_stats["fit_s"],
                    getattr(self, "best_iteration_", None),
                    getattr(self.estimator, "n_trees_", None))
        return self

    def transform(self, features):
        scores = []
        for image_features in features:
            image_scores = []
            for layer_nr, table in enumerate(image_features):
                if layer_nr == 0 or not len(table):
                    image_scores.append([0.0] * len(table))
                    continue
                image_scores.append(list(self.estimator.predict(
                    table.matrix())))
            scores.append(image_scores)
        return {"scores": scores}

    def save(self, filepath):
        """The port's file: a plain pickle of builtins, written through a
        temporary file."""
        state = {"format": FILE_FORMAT,
                 "class": type(self.estimator).__name__,
                 **self.estimator.__getstate__()}
        tmp = f"{filepath}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f, protocol=4)
        os.replace(tmp, filepath)

    def load(self, filepath):
        self.estimator = load_estimator(filepath)
        return self


class ScoringGBM(_ScoringModelBase):
    """The gradient-boosted IoU regressor (the reference's 'lgbm' slot)
    over the native GBM, with the reference's model and training
    parameters."""

    def __init__(self, model_params=None, training_params=None,
                 train_size=0.7, target="iou"):
        super().__init__()
        self.model_params = dict(model_params or {})
        self.training_params = dict(training_params or {})
        self.train_size = train_size
        self.target = target

    def _fit_estimator(self, X_train, y_train, X_valid, y_valid):
        mp, tp = self.model_params, self.training_params
        est = native_gbm.NativeGBMRegressor(
            learning_rate=mp.get("learning_rate", 0.01),
            num_leaves=int(mp.get("num_leaves", 500)),
            min_data=int(mp.get("min_data", 100)),
            max_depth=int(mp.get("max_depth", 20)),
            sub_feature=float(mp.get("sub_feature", 1.0)),
            number_boosting_rounds=int(tp.get("number_boosting_rounds", 500)),
            early_stopping_rounds=int(tp.get("early_stopping_rounds", 10)))
        est.fit(X_train, y_train, X_valid, y_valid)
        self.best_iteration_ = est.best_iteration_
        self.estimator = est


# ---------------------------------------------------------------------------
# NMS across threshold layers
# ---------------------------------------------------------------------------

def remove_overlapping_masks(labels, scores, iou_threshold=0.5):
    """Greedy per-image NMS by score across every (layer, instance),
    zeroing suppressed scores in place; returns (labels, scores).

    One C++ RLE pass per layer, then in score order (ties in (layer,
    label) order) each instance pays an exact run-space IoU only against
    kept instances whose IoU upper bound, min(areas, box intersection)
    over the union it implies, clears the threshold; an IoU above the
    threshold (strictly) suppresses it."""
    entries, entry_scores, handles, boxes = [], [], [], []
    for layer_nr, layer_scores in enumerate(scores):
        n = len(layer_scores)
        if n == 0:
            continue
        packed = native.rle_instances(np.ascontiguousarray(labels[layer_nr]),
                                      n)
        for idx, (counts, bbox) in enumerate(packed):
            entries.append((layer_nr, idx + 1))
            entry_scores.append(float(layer_scores[idx]))
            handles.append(native.RleHandle(counts))
            boxes.append(bbox)
    m = len(entries)
    if m == 0:
        return labels, scores
    order = sorted(range(m), key=lambda i: entry_scores[i], reverse=True)
    b = np.asarray(boxes, dtype=np.float64).reshape(m, 4)
    x1, y1 = b[:, 0], b[:, 1]
    x2, y2 = x1 + b[:, 2], y1 + b[:, 3]
    areas = np.array([h.area for h in handles], dtype=np.float64)
    sx1, sy1, sx2, sy2, sarea = (np.empty(m) for _ in range(5))
    kept = []
    for i in order:
        k = len(kept)
        suppressed = False
        if k:
            iw = np.minimum(x2[i], sx2[:k]) - np.maximum(x1[i], sx1[:k])
            ih = np.minimum(y2[i], sy2[:k]) - np.maximum(y1[i], sy1[:k])
            inter_ub = np.minimum(np.minimum(areas[i], sarea[:k]),
                                  np.maximum(iw, 0.0) * np.maximum(ih, 0.0))
            union_lb = np.maximum(areas[i] + sarea[:k] - inter_ub, 1.0)
            for j in np.nonzero(inter_ub / union_lb > iou_threshold)[0]:
                if native.rle_iou_pair(handles[i],
                                       handles[kept[j]]) > iou_threshold:
                    suppressed = True
                    break
        if suppressed:
            li, ni = entries[i]
            scores[li][ni - 1] = 0
        else:
            sx1[k], sy1[k], sx2[k], sy2[k] = x1[i], y1[i], x2[i], y2[i]
            sarea[k] = areas[i]
            kept.append(i)
    return labels, scores


def _remove_overlapping_masks_dense(labels, scores, iou_threshold=0.5):
    """The reference-shaped NMS over a boolean mask per pair: the test
    oracle of remove_overlapping_masks."""
    entries = []
    for layer_nr, layer_scores in enumerate(scores):
        for label_idx, score in enumerate(layer_scores):
            entries.append((float(score), layer_nr, label_idx + 1))
    entries.sort(key=lambda e: e[0], reverse=True)
    alive = list(entries)
    i = 0
    while i < len(alive):
        _, li, ni = alive[i]
        base = labels[li] == ni
        base_area = base.sum()
        j = i + 1
        while j < len(alive):
            _, lj, nj = alive[j]
            other = labels[lj] == nj
            inter = np.count_nonzero(base & other)
            union = base_area + other.sum() - inter
            if union > 0 and inter / union > iou_threshold:
                scores[lj][nj - 1] = 0
                alive.pop(j)
            else:
                j += 1
        i += 1
    return labels, scores


class NonMaximumSupression:
    """remove_overlapping_masks per image; counts the instances it zeroed
    and its host seconds."""

    def __init__(self, iou_threshold=0.5):
        self.iou_threshold = iou_threshold
        self.suppressed = 0
        self.seconds = 0.0

    def transform(self, images_with_scores):
        start = time.perf_counter()
        out = []
        for labels, scores in images_with_scores:
            before = sum(int(s == 0) for layer in scores for s in layer)
            out.append(remove_overlapping_masks(labels, scores,
                                                self.iou_threshold))
            self.suppressed += sum(int(s == 0) for layer in scores
                                   for s in layer) - before
        self.seconds += time.perf_counter() - start
        return {"images_with_scores": out}
