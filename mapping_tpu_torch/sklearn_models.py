"""Generic estimator transformer wrappers for `graph.Step`.

Counterpart of mapping_tpu/sklearn_models.py (the reference's generic
`LightGBM` and `SklearnRegressor` step transformers,
src/steps/sklearn/models.py:30-99): fit / transform / save / load over
an estimator. `SklearnRegressor` and `SklearnClassifier` wrap whatever
estimator the caller passes; the port itself imports no sklearn.
`GBMRegressor` runs the native C++ GBM (utils/native_gbm) only: where g++
cannot build it, fit raises naming the library, as the scoring model does
(the JAX package falls back to sklearn there).

Files are plain pickles (`utils/ndpickle.dump_object`); a joblib file the
JAX package wrote is read without joblib (`ndpickle.load_object`), its
native GBM mapped onto the port's.
"""

from typing import Any, Dict, Optional

import numpy as np

from mapping_tpu_torch.graph import BaseTransformer
from mapping_tpu_torch.utils import native_gbm, ndpickle


class SklearnRegressor(BaseTransformer):
    """Wrap any sklearn regressor estimator (reference :30-40)."""

    def __init__(self, estimator=None):
        self.estimator = estimator

    def fit(self, X, y, **kwargs):
        self.estimator.fit(np.asarray(X), np.asarray(y).ravel())
        return self

    def transform(self, X, **kwargs):
        return {"prediction": self.estimator.predict(np.asarray(X))}

    def save(self, filepath):
        ndpickle.dump_object(self.estimator, filepath)

    def load(self, filepath):
        self.estimator = ndpickle.load_object(filepath)
        return self


class SklearnClassifier(BaseTransformer):
    """Wrap any sklearn classifier; returns class probabilities
    (reference src/steps/sklearn/models.py:13-27)."""

    def __init__(self, estimator=None):
        self.estimator = estimator

    def fit(self, X, y, **kwargs):
        self.estimator.fit(np.asarray(X), np.asarray(y).ravel())
        return self

    def transform(self, X, **kwargs):
        return {"prediction_probability":
                self.estimator.predict_proba(np.asarray(X))}

    def save(self, filepath):
        ndpickle.dump_object(self.estimator, filepath)

    def load(self, filepath):
        self.estimator = ndpickle.load_object(filepath)
        return self


class GBMRegressor(BaseTransformer):
    """Gradient-boosted trees with early stopping, the generic `LightGBM`
    slot (reference src/steps/sklearn/models.py:69-99), over the native
    C++ histogram GBM (cpp/gbm.cpp) with lgb.train's semantics."""

    def __init__(self, model_params: Optional[Dict[str, Any]] = None,
                 training_params: Optional[Dict[str, Any]] = None):
        self.model_params = dict(model_params or {})
        self.training_params = dict(training_params or {})
        self.estimator = None

    def fit(self, X, y, X_valid=None, y_valid=None, **kwargs):
        native_gbm.load()  # raises NativeLibraryUnavailable, naming it
        X = np.asarray(X)
        y = np.asarray(y).ravel()
        if y_valid is None:
            X_valid = None  # a features-only valid set can't drive early stop
        self.estimator = native_gbm.NativeGBMRegressor(
            learning_rate=self.model_params.get("learning_rate", 0.01),
            num_leaves=int(self.model_params.get("num_leaves", 255)),
            min_data=int(self.model_params.get("min_data", 20)),
            max_depth=int(self.model_params.get("max_depth", 0) or 0),
            sub_feature=float(self.model_params.get("sub_feature", 1.0)),
            number_boosting_rounds=int(self.training_params.get(
                "number_boosting_rounds", 500)),
            early_stopping_rounds=int(self.training_params.get(
                "early_stopping_rounds", 10)))
        yv = np.asarray(y_valid).ravel() if y_valid is not None else None
        self.estimator.fit(X, y, X_valid, yv)
        return self

    def transform(self, X, **kwargs):
        return {"prediction": self.estimator.predict(np.asarray(X))}

    def save(self, filepath):
        ndpickle.dump_object(self.estimator, filepath)

    def load(self, filepath):
        self.estimator = ndpickle.load_object(filepath)
        return self


LightGBM = GBMRegressor  # reference-name alias
