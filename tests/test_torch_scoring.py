"""The scoring models' parts, port vs JAX: the device feature tensor, the
feature tables, the train/valid split, the native GBM and its files, and
the NMS across threshold layers.

The same seeded numpy inputs go through mapping_tpu (ops/instance,
scoring, utils/native_gbm) and the port (ops/instance, scoring,
utils/native_gbm), the port on the CPU.

Tolerances: feature tensor integer-valued columns (area, bbox area,
distances to the border, contour length) exact, float columns (mean and
max probability, bbox aspect and fill) 2e-5 relative, the port's sums
being float64 where JAX splits bf16 into hi/lo; the host oracle
`features_for_mask` holds the same; feature tables column by column equal
to JAX's DataFrames (names, order, dtypes, values) on the same feature
tensor; the split's index sets equal sklearn's; GBM predictions exact;
NMS outcomes equal.
"""

import copy
import pickle

import joblib
import numpy as np
import pytest
import torch
from scipy import ndimage

from mapping_tpu import scoring as jax_scoring
from mapping_tpu.ops.instance import \
    instance_feature_tensor as jax_feature_tensor
from mapping_tpu.utils import native as jax_native
from mapping_tpu.utils import native_gbm as jax_native_gbm
from mapping_tpu_torch import scoring
from mapping_tpu_torch.infer import postprocess
from mapping_tpu_torch.ops.instance import (FEATURE_COLUMNS,
                                            instance_feature_tensor)
from mapping_tpu_torch.utils import native_gbm
from mapping_tpu_torch.utils.native_lib import (NativeLib,
                                                NativeLibraryUnavailable)

INT_COLS = [0, 4, 6, 7, 8]  # area, bbox_area, distances, contour_length
FLOAT_COLS = [1, 2, 3, 5]
GBM = dict(learning_rate=0.1, num_leaves=15, min_data=5, max_depth=8,
           number_boosting_rounds=60, early_stopping_rounds=5)


@pytest.fixture(scope="module", autouse=True)
def jax_libraries():
    """The JAX package builds its C++ libraries into one temporary file
    shared by every process; a test worker that lost that race at import
    builds them again here, so that both packages run the C++ paths."""
    for lib in (jax_native._lib, jax_native_gbm._lib):
        for _ in range(3):
            if lib.build():
                break
        assert lib.available()


def _label_maps(seed, m=4, hw=(40, 48), dilate=False):
    """(labels (m, H, W) int32, probabilities (m, H, W) float32): blobs
    labelled by scipy, some touching the border; with `dilate` the label
    maps are grey-dilated so that instances touch."""
    rng = np.random.RandomState(seed)
    noise = ndimage.gaussian_filter(rng.rand(m, *hw), (0, 2, 2))
    labels = np.stack([ndimage.label(n > np.quantile(n, 0.6))[0]
                       for n in noise]).astype(np.int32)
    if dilate:
        labels = np.stack([ndimage.grey_dilation(l, size=(3, 3))
                           for l in labels])
    labels[-1] = 0  # an empty map: every slot empty
    probs = rng.rand(m, *hw).astype(np.float32)
    return labels, probs


@pytest.mark.parametrize("seed,dilate,max_instances", [
    (0, False, 64), (1, True, 64), (2, True, 8), (3, False, 4)])
def test_feature_tensor_matches_jax(seed, dilate, max_instances):
    labels, probs = _label_maps(seed, dilate=dilate)
    assert labels.max() > 4  # labels past a small pad are dropped
    want = np.asarray(jax_feature_tensor(labels, probs, max_instances))
    got = instance_feature_tensor(torch.from_numpy(labels),
                                  torch.from_numpy(probs), max_instances)
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    np.testing.assert_array_equal(got[..., INT_COLS], want[..., INT_COLS])
    np.testing.assert_allclose(got[..., FLOAT_COLS], want[..., FLOAT_COLS],
                               rtol=2e-5, atol=0)
    assert not got[-1].any()
    n = labels.max(axis=(1, 2))
    for i in range(len(labels)):
        assert (got[i, :n[i], 0] > 0).all() and not got[i, n[i]:].any()


@pytest.mark.parametrize("dilate", [False, True])
def test_feature_tensor_matches_host_oracle(dilate):
    labels, probs = _label_maps(4, m=2, dilate=dilate)
    got = instance_feature_tensor(torch.from_numpy(labels),
                                  torch.from_numpy(probs), 128).numpy()
    for i in range(len(labels)):
        for label in range(1, labels[i].max() + 1):
            mask = labels[i] == label
            row = scoring.features_for_mask(mask, probs[i], 0.5)
            assert row == jax_scoring.features_for_mask(mask, probs[i], 0.5)
            want = [row[c] for c in FEATURE_COLUMNS]
            np.testing.assert_array_equal(got[i, label - 1, INT_COLS],
                                          np.take(want, INT_COLS))
            np.testing.assert_allclose(got[i, label - 1, FLOAT_COLS],
                                       np.take(want, FLOAT_COLS), rtol=2e-5)


def _scoring_image(seed, layers=(1, 4), hw=(48, 48)):
    """One image of a [1, n] threshold ladder: labels (L, H, W) int16 from
    the port's fused_postprocess, the JAX feature tensor, and ground-truth
    annotations of the building category (polygons of some instances)."""
    rng = np.random.RandomState(seed)
    p = ndimage.gaussian_filter(rng.rand(*hw), 3)
    p = (p - p.min()) / (p.max() - p.min())
    probs = np.stack([1 - p, p], -1)[None].astype(np.float32)
    labels, _, _, feats = postprocess.fused_postprocess(
        torch.from_numpy(probs), target_size=hw, category_layers=layers,
        active_layers=tuple(range(1, sum(layers))), compute_features=True,
        max_instances=32)
    labels = labels[0].numpy().astype(np.int16)
    flat = labels.reshape(-1, *hw).astype(np.int32)
    layer_probs = np.repeat(probs[0][None, ..., 1], len(flat), 0)
    jax_feats = np.array(jax_feature_tensor(flat, layer_probs, 32))
    jax_feats[0] = 0  # the inactive background layer
    anns = []
    for k, obj in enumerate(ndimage.find_objects(ndimage.label(p > 0.55)[0])):
        y, x = obj
        poly = [x.start, y.start, x.stop, y.start, x.stop, y.stop,
                x.start, y.stop]
        anns.append({"id": k + 1, "category_id": 100, "iscrowd": 0,
                     "segmentation": [[float(v) for v in poly]]})
    return labels, feats[0].numpy(), jax_feats, {None: [], 100: anns}


@pytest.mark.parametrize("with_annotations", [False, True])
def test_feature_tables_match_jax_dataframes(with_annotations):
    labels, port_feats, feats, anns = _scoring_image(5)
    np.testing.assert_array_equal(port_feats[..., INT_COLS],
                                  feats[..., INT_COLS])
    anns = anns if with_annotations else None
    want = jax_scoring.features_from_tensor(feats, labels, anns,
                                           category_layers=(1, 4))
    got = scoring.features_from_tensor(feats, labels, anns,
                                       category_layers=(1, 4))
    assert len(got) == len(want) == 5
    assert sum(len(t) for t in got) > 10
    for table, df in zip(got, want):
        assert list(table.columns) == list(df.columns) == list(
            scoring.TABLE_COLUMNS)
        assert len(table) == len(df)
        for name in df.columns:
            col = df[name].to_numpy()
            assert table[name].dtype == col.dtype, name
            np.testing.assert_array_equal(table[name], col, err_msg=name)
    ious = np.concatenate([t["iou"] for t in got[1:]])
    assert np.isnan(ious).all() != with_annotations
    if with_annotations:
        assert (ious > 0.5).any()


@pytest.mark.parametrize("n", [4, 5, 10, 37, 1000])
def test_split_matches_sklearn(n):
    from sklearn.model_selection import train_test_split

    idx = np.arange(n)
    want_train, want_valid = train_test_split(idx, train_size=0.7,
                                              random_state=1234)
    train, valid = scoring.train_valid_split(n)
    np.testing.assert_array_equal(train, want_train)
    np.testing.assert_array_equal(valid, want_valid)


def _tables(seeds):
    """Per-image (port tables, JAX DataFrames) with IoU targets."""
    images = []
    for seed in seeds:
        labels, _, feats, anns = _scoring_image(seed)
        images.append((
            scoring.features_from_tensor(feats, labels, anns,
                                         category_layers=(1, 4)),
            jax_scoring.features_from_tensor(feats, labels, anns,
                                             category_layers=(1, 4))))
    return images


@pytest.fixture(scope="module")
def fitted():
    images = _tables(range(10, 22))
    port = scoring.ScoringGBM(model_params=GBM, training_params=GBM)
    port.fit_stream(p for p, _ in images)
    jax = jax_scoring.ScoringGBM(model_params=GBM, training_params=GBM)
    jax.fit_stream(j for _, j in images)
    assert isinstance(jax.estimator, jax_native_gbm.NativeGBMRegressor)
    return port, jax, images


def test_gbm_matches_jax_exactly(fitted):
    port, jax, images = fitted
    assert port.fit_stats["rows"] > 50
    assert port.best_iteration_ == jax.best_iteration_ > 0
    assert port.estimator.to_bytes() == jax.estimator.to_bytes()
    got = port.transform([p for p, _ in images])["scores"]
    want = jax.transform([j for _, j in images])["scores"]
    assert got == want
    X = images[0][0][2].matrix()
    np.testing.assert_array_equal(port.estimator.predict(X),
                                  jax.estimator.predict(X))


def test_jax_scoring_file_serves_in_the_port(fitted, tmp_path):
    """A JAX-written scoring_model.joblib gives the same predictions in
    the port; the port's own file round-trips; sklearn models and
    compressed files raise, naming what they hold."""
    port, jax, images = fitted
    X = np.concatenate([t.matrix() for p, _ in images for t in p[1:]])
    jax.save(tmp_path / "scoring_model.joblib")
    loaded = scoring.load_estimator(tmp_path / "scoring_model.joblib")
    assert isinstance(loaded, native_gbm.NativeGBMRegressor)
    np.testing.assert_array_equal(loaded.predict(X), jax.estimator.predict(X))
    port.save(tmp_path / "scoring_model.pkl")
    again = scoring.ScoringGBM().load(tmp_path / "scoring_model.pkl")
    np.testing.assert_array_equal(again.estimator.predict(X),
                                  port.estimator.predict(X))
    assert again.estimator.params == port.estimator.params
    with open(tmp_path / "scoring_model.pkl", "rb") as f:
        assert pickle.load(f)["format"] == scoring.FILE_FORMAT

    from sklearn.ensemble import RandomForestRegressor

    forest = RandomForestRegressor(n_estimators=2).fit(X[:20], X[:20, 1])
    joblib.dump(forest, tmp_path / "forest.joblib")
    with pytest.raises(pickle.UnpicklingError, match="RandomForestRegressor"):
        scoring.load_estimator(tmp_path / "forest.joblib")
    joblib.dump(jax.estimator, tmp_path / "packed.joblib", compress=3)
    with pytest.raises(ValueError, match="compressed"):
        scoring.load_estimator(tmp_path / "packed.joblib")


def test_gbm_library_that_fails_to_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "gbm.cpp"
    broken.write_text("this is not C++\n")
    lib = NativeLib("gbm.cpp", "gbm_broken", native_gbm._register)
    lib.src = broken
    monkeypatch.setattr(native_gbm, "load", lib.load)
    model = scoring.ScoringGBM(model_params=GBM, training_params=GBM)
    with pytest.raises(NativeLibraryUnavailable, match="gbm.cpp"):
        model.fit([[]])


def _random_layers(rng, n_layers, h, w, max_instances):
    """Labelled layers of random rectangles, nested copies across layers
    as a threshold ladder makes them; sometimes a spare score slot."""
    labels = np.zeros((n_layers, h, w), dtype=np.int32)
    scores = []
    rects = [(rng.integers(0, h - 4), rng.integers(0, w - 4),
              rng.integers(2, h // 2), rng.integers(2, w // 2))
             for _ in range(max_instances)]
    for layer in range(n_layers):
        n = int(rng.integers(0, max_instances + 1))
        for i in range(n):
            r, c, hh, ww = rects[i]
            shrink = layer + int(rng.integers(0, 2))
            r2, c2 = min(r + hh - shrink, h), min(c + ww - shrink, w)
            if r2 > r and c2 > c:
                labels[layer, r:r2, c:c2] = i + 1
        scores.append(list(np.round(rng.random(n + int(rng.integers(0, 2))),
                                    1)))  # rounded: many ties
    return labels, scores


def _nms_all(labels, scores, threshold=0.5):
    outs = []
    for fn in (scoring.remove_overlapping_masks,
               scoring._remove_overlapping_masks_dense,
               jax_scoring.remove_overlapping_masks):
        s = copy.deepcopy(scores)
        fn(labels.copy(), s, threshold)
        outs.append(s)
    return outs


@pytest.mark.parametrize("seed", range(8))
def test_nms_fast_path_matches_oracle_and_jax(seed):
    labels, scores = _random_layers(np.random.default_rng(seed), 4, 24, 20, 6)
    fast, dense, jax = _nms_all(labels, scores)
    assert fast == dense == jax


def test_nms_random_layers_suppress():
    """The random ladders of the test above do overlap past 0.5."""
    zeroed = 0
    for seed in range(8):
        labels, scores = _random_layers(np.random.default_rng(seed), 4, 24,
                                        20, 6)
        nms = scoring.NonMaximumSupression(0.5)
        nms.transform([(labels, copy.deepcopy(scores))])
        zeroed += nms.suppressed
    assert zeroed > 8


def test_nms_at_the_threshold_and_on_ties():
    """IoU exactly 0.5 keeps both (strictly greater suppresses); tied
    scores keep the earlier (layer, label)."""
    labels = np.zeros((3, 8, 8), dtype=np.int32)
    labels[0, 0:4, 0:4] = 1   # 16 pixels
    labels[1, 0:4, 0:2] = 1   # 8 inside it: IoU 0.5
    labels[2, 0:4, 0:4] = 1   # identical to layer 0
    scores = [[0.9], [0.8], [0.9]]
    fast, dense, jax = _nms_all(labels, scores)
    assert fast == dense == jax == [[0.9], [0.8], [0]]
    nms = scoring.NonMaximumSupression(0.5)
    nms.transform([(labels, scores)])
    assert nms.suppressed == 1 and nms.seconds > 0
