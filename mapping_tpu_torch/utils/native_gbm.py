"""ctypes bindings to the C++ histogram GBM (cpp/gbm.cpp).

Counterpart of mapping_tpu/utils/native_gbm.py over the port's NativeLib:
g++ builds the same source into build/ at first use, so the same data give
the same trees and predictions, exactly. `NativeGBMRegressor` trains with
LightGBM's semantics (leaf-wise growth to num_leaves, min_data per leaf,
early stopping on an explicit validation set, prediction at
best_iteration). A library that does not build raises
NativeLibraryUnavailable, naming it; there is no fallback.
"""

import ctypes

import numpy as np

from mapping_tpu_torch.utils.native_lib import NativeLib


def _register(lib):
    D = ctypes.POINTER(ctypes.c_double)
    lib.gbm_train.restype = ctypes.c_void_p
    lib.gbm_train.argtypes = [
        D, D, ctypes.c_long, ctypes.c_int,          # X, y, n, d
        D, D, ctypes.c_long,                        # Xv, yv, nv
        ctypes.c_int, ctypes.c_int, ctypes.c_long,  # num_leaves, max_depth, min_data
        ctypes.c_double, ctypes.c_double,           # learning_rate, lambda_l2
        ctypes.c_double, ctypes.c_int,              # min_sum_hessian, max_bin
        ctypes.c_int, ctypes.c_int,                 # num_rounds, early_stopping
        ctypes.c_double, ctypes.c_uint]             # feature_fraction, seed
    lib.gbm_best_iteration.restype = ctypes.c_int
    lib.gbm_best_iteration.argtypes = [ctypes.c_void_p]
    lib.gbm_num_trees.restype = ctypes.c_int
    lib.gbm_num_trees.argtypes = [ctypes.c_void_p]
    lib.gbm_num_features.restype = ctypes.c_int
    lib.gbm_num_features.argtypes = [ctypes.c_void_p]
    lib.gbm_predict.restype = None
    lib.gbm_predict.argtypes = [ctypes.c_void_p, D, ctypes.c_long,
                                ctypes.c_int, ctypes.c_int, D]
    lib.gbm_serialize.restype = ctypes.c_long
    lib.gbm_serialize.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_long]
    lib.gbm_deserialize.restype = ctypes.c_void_p
    lib.gbm_deserialize.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.gbm_free.restype = None
    lib.gbm_free.argtypes = [ctypes.c_void_p]


_lib = NativeLib("gbm.cpp", "gbm", _register)
load = _lib.load
available = _lib.available


def _as_c(a):
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeGBMRegressor:
    """LightGBM-semantics regressor over cpp/gbm.cpp, with the reference's
    model parameters (learning_rate, num_leaves, min_data, max_depth,
    sub_feature) and training parameters (number_boosting_rounds,
    early_stopping_rounds). `predict` uses best_iteration, as lightgbm
    does. Its pickled state, {"params", "blob"}, is the JAX package's."""

    def __init__(self, learning_rate=0.01, num_leaves=500, min_data=100,
                 max_depth=20, sub_feature=1.0, lambda_l2=0.0,
                 min_sum_hessian=1e-3, max_bin=255,
                 number_boosting_rounds=500, early_stopping_rounds=10,
                 seed=1234):
        self.params = dict(
            learning_rate=float(learning_rate),
            num_leaves=int(num_leaves), min_data=int(min_data),
            max_depth=int(max_depth), sub_feature=float(sub_feature),
            lambda_l2=float(lambda_l2),
            min_sum_hessian=float(min_sum_hessian), max_bin=int(max_bin),
            number_boosting_rounds=int(number_boosting_rounds),
            early_stopping_rounds=int(early_stopping_rounds), seed=int(seed))
        self._handle = None
        self.best_iteration_ = 0
        self.n_trees_ = 0

    def __del__(self):
        try:
            self._release()
        except TypeError:  # interpreter shutdown: the module's globals are gone
            pass

    def _release(self):
        if getattr(self, "_handle", None):
            load().gbm_free(self._handle)
            self._handle = None

    def _adopt(self, handle):
        lib = load()
        self._handle = handle
        self.best_iteration_ = lib.gbm_best_iteration(handle)
        self.n_trees_ = lib.gbm_num_trees(handle)

    def fit(self, X, y, X_valid=None, y_valid=None):
        lib = load()
        self._release()
        X, xp = _as_c(X)
        y, yp = _as_c(y)
        n, d = X.shape
        if X_valid is not None and len(X_valid):
            Xv, xvp = _as_c(X_valid)
            yv, yvp = _as_c(y_valid)
            nv = Xv.shape[0]
        else:
            xvp = yvp = ctypes.cast(None, ctypes.POINTER(ctypes.c_double))
            nv = 0
        p = self.params
        handle = lib.gbm_train(
            xp, yp, n, d, xvp, yvp, nv,
            p["num_leaves"], p["max_depth"], p["min_data"],
            p["learning_rate"], p["lambda_l2"], p["min_sum_hessian"],
            p["max_bin"], p["number_boosting_rounds"],
            p["early_stopping_rounds"] if nv else 0,
            p["sub_feature"], p["seed"])
        if not handle:
            raise RuntimeError("gbm_train failed")
        self._adopt(handle)
        return self

    def _require_handle(self):
        # a NULL handle would be dereferenced on the C side
        if not self._handle:
            raise RuntimeError("NativeGBMRegressor is not fitted (call fit() "
                               "or from_bytes() first)")

    def predict(self, X, num_iteration=None):
        lib = load()
        self._require_handle()
        X, xp = _as_c(np.atleast_2d(X))
        n, d = X.shape
        want = lib.gbm_num_features(self._handle)
        if d != want:  # the C side indexes rows by the model's width
            raise ValueError(
                f"X has {d} feature(s); the model was trained on {want}")
        out = np.empty(n, dtype=np.float64)
        it = self.best_iteration_ if num_iteration is None else num_iteration
        lib.gbm_predict(self._handle, xp, n, d, int(it),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out

    def to_bytes(self) -> bytes:
        lib = load()
        self._require_handle()
        need = lib.gbm_serialize(self._handle, None, 0)
        buf = ctypes.create_string_buffer(need)
        lib.gbm_serialize(self._handle, buf, need)
        return buf.raw[:need]

    @classmethod
    def from_bytes(cls, blob: bytes, **params):
        self = cls(**params)
        handle = load().gbm_deserialize(blob, len(blob))
        if not handle:
            raise ValueError("corrupt native GBM blob")
        self._adopt(handle)
        return self

    def __getstate__(self):
        return {"params": self.params, "blob": self.to_bytes()}

    def __setstate__(self, state):
        self.params = dict(state["params"])
        self._handle = None
        handle = load().gbm_deserialize(state["blob"], len(state["blob"]))
        if not handle:
            raise ValueError("corrupt native GBM blob")
        self._adopt(handle)
