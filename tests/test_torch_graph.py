"""The port's Step graph, estimator wrappers and host utilities
(mapping_tpu_torch/graph.py, sklearn_models.py, utils/misc.py) against the
JAX package's (mapping_tpu/graph.py, sklearn_models.py, utils/misc.py).

Each case of tests/test_graph.py runs in both packages and must give the
same outputs, exactly (the GBM: the same native library, the same
predictions). The port persists with plain pickle where the JAX package
uses joblib; files the JAX package wrote with joblib are read by the port
in a subprocess where joblib (and jax, flax, pandas, PIL) cannot be
imported, and the port's files are read by joblib.
"""

import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import mapping_tpu.graph as jax_graph
import mapping_tpu.sklearn_models as jax_sklearn
import mapping_tpu.utils.misc as jax_misc
import mapping_tpu_torch.graph as graph
import mapping_tpu_torch.sklearn_models as sklearn_models
import mapping_tpu_torch.utils.misc as misc

ROOT = Path(__file__).resolve().parents[1]
JAX = types.SimpleNamespace(graph=jax_graph, sk=jax_sklearn, misc=jax_misc,
                            port=False)
PORT = types.SimpleNamespace(graph=graph, sk=sklearn_models, misc=misc,
                             port=True)


def _classes(g):
    """The test transformers of tests/test_graph.py over `g`'s
    BaseTransformer (their own files are plain pickles)."""

    class AddOne(g.BaseTransformer):
        def transform(self, x, **_):
            return {"x": [v + 1 for v in x]}

    class CountingFit(g.BaseTransformer):
        fits = 0

        def __init__(self):
            self.offset = None

        def fit(self, x, **_):
            CountingFit.fits += 1
            self.offset = 10
            return self

        def transform(self, x, **_):
            return {"x": [v + self.offset for v in x]}

        def save(self, filepath):
            with open(filepath, "wb") as f:
                pickle.dump(self.offset, f)

        def load(self, filepath):
            with open(filepath, "rb") as f:
                self.offset = pickle.load(f)
            return self

    class TimesTen(g.BaseTransformer):
        def transform(self, x, **_):
            return {"x": [v * 10 for v in x]}

    return AddOne, CountingFit, TimesTen


# the ten cases of tests/test_graph.py, each over one package -------------

def lazy_pull_and_adapter(pkg, tmp):
    AddOne, _, _ = _classes(pkg.graph)
    a = pkg.graph.Step("a", AddOne(), tmp, input_data=["input"])
    b = pkg.graph.Step("b", AddOne(), tmp, input_steps=[a])
    return b.fit_transform({"input": {"x": [1, 2, 3]}})


def trainable_cache_roundtrip(pkg, tmp):
    _, CountingFit, _ = _classes(pkg.graph)
    Step = pkg.graph.Step
    s = Step("t", CountingFit(), tmp, input_data=["input"], is_trainable=True)
    out1 = s.fit_transform({"input": {"x": [1]}})
    s2 = Step("t", CountingFit(), tmp, input_data=["input"],
              is_trainable=True)
    out2 = s2.fit_transform({"input": {"x": [2]}})
    s3 = Step("t2", CountingFit(), tmp, input_data=["input"],
              is_trainable=True)
    with pytest.raises(RuntimeError, match="no cached transformer"):
        s3.transform({"input": {"x": [1]}})
    return out1, out2, CountingFit.fits


def force_fitting(pkg, tmp):
    _, CountingFit, _ = _classes(pkg.graph)
    s = pkg.graph.Step("t", CountingFit(), tmp, input_data=["input"],
                       is_trainable=True, force_fitting=True)
    s.fit_transform({"input": {"x": [1]}})
    s._output_cache = None
    return s.fit_transform({"input": {"x": [1]}}), CountingFit.fits


def adapter_reducers(pkg, tmp):
    AddOne, _, _ = _classes(pkg.graph)
    g = pkg.graph
    a = g.Step("a", AddOne(), tmp, input_data=["input"])
    b = g.Step("b", AddOne(), tmp, input_data=["input"])
    outs = []
    for reducer in (g.average_inputs, g.sum_inputs, g.stack_inputs):
        avg = g.Step("avg", g.Dummy(), tmp, input_steps=[a, b],
                     adapter={"y_pred": ([("a", "x"), ("b", "x")], reducer)})
        outs.append(avg.fit_transform(
            {"input": {"x": np.array([1.0, 3.0])}})["y_pred"])
    outs.append(g.exp_transform([np.array([0.0, 1.0])]))
    outs.append(g.squeeze_inputs([np.ones((2, 1, 3))]))
    return outs


def output_cache_and_rebind(pkg, tmp):
    AddOne, _, TimesTen = _classes(pkg.graph)
    a = pkg.graph.Step("a", AddOne(), tmp, input_data=["input"],
                       cache_output=True)
    b = pkg.graph.Step("b", AddOne(), tmp, input_steps=[a])
    first = b.fit_transform({"input": {"x": [0]}})
    b.get_step("a").transformer = TimesTen()
    b.clean_cache()
    return first, b.fit_transform({"input": {"x": [3]}})


def graph_introspection(pkg, tmp):
    AddOne, _, _ = _classes(pkg.graph)
    a = pkg.graph.Step("a", AddOne(), tmp, input_data=["input"])
    b = pkg.graph.Step("b", AddOne(), tmp, input_steps=[a])
    nodes, edges = b.graph_info()
    return sorted(nodes), sorted(edges), b.to_dot()


def xy_split(pkg, tmp):
    meta = pd.DataFrame({"img": ["a.jpg", "b.jpg"],
                         "mask": ["a.png", "b.png"], "n": [1.5, 2.5]})
    rows = meta.to_dict("records")
    split = pkg.graph.XYSplit(["img"], ["mask"])
    outs = []
    for cols, y_cols in ((["img"], ["mask"]), (["img", "n"], ["mask"])):
        split = pkg.graph.XYSplit(cols, y_cols)
        if pkg.port:
            outs.append(split.transform(rows, train_mode=True))
            outs.append(split.transform(
                [{"img": r["img"], "n": r["n"]} for r in rows],
                train_mode=True))
        else:
            outs.append(split.transform(meta, train_mode=True))
            outs.append(split.transform(meta[["img", "n"]], train_mode=True))
    return [{k: None if v is None else v.tolist() for k, v in o.items()}
            for o in outs]


def apply_transformers(pkg, tmp):
    g = pkg.graph
    t = g.make_apply_transformer(lambda a, b: a + b, output_name="s",
                                 apply_on=["xs", "ys"])
    out = t.transform(xs=[1, 2], ys=[10, 20])
    with pytest.raises(ValueError):
        t.transform(xs=[1], ys=[1, 2])
    ts = g.make_apply_transformer_stream(lambda a: a * 2, output_name="s",
                                         apply_on=["xs"])
    return out, list(ts.transform(xs=iter([1, 2, 3]))["s"])


def misc_utils(pkg, tmp):
    m = pkg.misc
    rows = [{"a": i} for i in range(5)]
    meta = rows if pkg.port else pd.DataFrame(rows)
    chunks = [list(c["a"]) if not pkg.port else [r["a"] for r in c]
              for c in m.generate_data_frame_chunks(meta, 2)]
    avg = m.Averager()
    first = avg.value
    avg.send(1.0)
    avg.send(3.0)
    x = np.random.RandomState(0).randn(2, 4, 4, 3)
    return (m.softmax(np.array([[1.0, 2.0, 3.0]])), m.softmax(x, axis=1),
            m.denormalize_img(np.zeros((2, 2, 3))),
            m.denormalize_img(x[0].transpose(2, 0, 1)), chunks,
            (first, avg.value))


def sklearn_wrappers(pkg, tmp):
    from sklearn.linear_model import LinearRegression, LogisticRegression

    X = np.arange(40, dtype=float).reshape(-1, 1)
    y = 3 * X[:, 0] + 1
    reg = pkg.sk.SklearnRegressor(LinearRegression()).fit(X, y)
    path = str(Path(tmp) / "reg.file")
    reg.save(path)
    reg2 = pkg.sk.SklearnRegressor().load(path)
    clf = pkg.sk.SklearnClassifier(LogisticRegression()).fit(X, X[:, 0] > 20)
    X2 = np.linspace(0, 40, 400).reshape(-1, 1)
    y2 = 3 * X2[:, 0] + 1
    gbm = pkg.sk.GBMRegressor(
        model_params={"learning_rate": 0.3},
        training_params={"number_boosting_rounds": 100}).fit(X2, y2)
    gbm.save(str(Path(tmp) / "gbm.file"))
    gbm2 = pkg.sk.GBMRegressor().load(str(Path(tmp) / "gbm.file"))
    return (reg.transform(X)["prediction"], reg2.transform(X)["prediction"],
            clf.transform(X)["prediction_probability"],
            gbm.transform(X2)["prediction"], gbm2.transform(X2)["prediction"])


CASES = [lazy_pull_and_adapter, trainable_cache_roundtrip, force_fitting,
         adapter_reducers, output_cache_and_rebind, graph_introspection,
         xy_split, apply_transformers, misc_utils, sklearn_wrappers]


def _assert_same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)) and not (
            want and isinstance(want[0], (int, float, str))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want)
    else:
        assert got == want


@pytest.fixture(scope="module", autouse=True)
def _native_gbm_built():
    """Build both packages' GBM library in this worker (the JAX package's
    build can lose a race to another process)."""
    from mapping_tpu.utils import native_gbm as jax_gbm
    from mapping_tpu_torch.utils import native_gbm

    for _ in range(3):
        if jax_gbm._lib.build():
            break
    assert jax_gbm.available() and native_gbm.available()


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_graph_case_matches_jax(case, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = case(JAX, str(tmp_path / "jax"))
    got = case(PORT, str(tmp_path / "port"))
    _assert_same(got, want)


# ------------------------------------------------------------------ files

def _run_blocked(code):
    """Run `code` in a subprocess where joblib, jax, flax, pandas, PIL and
    the JAX package cannot be imported."""
    prelude = ("import sys\n"
               "for m in ('joblib', 'jax', 'flax', 'pandas', 'PIL', "
               "'mapping_tpu'):\n"
               "    sys.modules[m] = None\n")
    out = subprocess.run([sys.executable, "-c", prelude + code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_step_reads_jax_joblib_outputs_without_joblib(tmp_path):
    """A JAX Step's saved output (joblib: arrays, an object array, lists)
    and its Dummy file are read by the port's Step with joblib blocked."""
    import joblib

    cache = str(tmp_path)
    output = {"x": np.arange(12, dtype=np.float32).reshape(3, 4),
              "names": np.array(["a.jpg", "b.jpg"], dtype=object),
              "meta": [{"id": 1}, (2, 3.5)], "n": np.int64(7)}

    class Emit(jax_graph.BaseTransformer):
        def transform(self, **_):
            return output

    jax_graph.Step("emit", Emit(), cache, save_output=True).fit_transform({})
    jax_graph.Dummy().save(str(tmp_path / "dummy.joblib"))
    assert joblib.load(str(tmp_path / "outputs" / "emit"))["n"] == 7
    code = (
        "import pickle, numpy as np\n"
        "from mapping_tpu_torch import graph\n"
        "from mapping_tpu_torch.utils import ndpickle\n"
        f"s = graph.Step('emit', graph.Dummy(), {cache!r}, "
        "load_saved_output=True)\n"
        "out = s.transform({})\n"
        "assert ndpickle.load_object("
        f"{str(tmp_path / 'dummy.joblib')!r}) == {{}}\n"
        "print(pickle.dumps(out).hex())\n")
    got = pickle.loads(bytes.fromhex(_run_blocked(code).strip()))
    _assert_same(got, output)
    assert got["names"].dtype == object


def test_port_files_are_read_by_joblib(tmp_path):
    """The port's step outputs, Dummy file and estimator files are plain
    pickles that joblib (so the JAX package) reads."""
    import joblib
    from sklearn.linear_model import LinearRegression

    output = {"x": np.arange(6.0), "names": ["a", "b"]}

    class Emit(graph.BaseTransformer):
        def transform(self, **_):
            return output

    graph.Step("emit", Emit(), str(tmp_path), save_output=True) \
        .fit_transform({})
    _assert_same(joblib.load(str(tmp_path / "outputs" / "emit")), output)
    graph.Dummy().save(str(tmp_path / "dummy"))
    assert joblib.load(str(tmp_path / "dummy")) == {}
    X = np.arange(10.0).reshape(-1, 1)
    reg = sklearn_models.SklearnRegressor(LinearRegression()).fit(X, 2 * X)
    reg.save(str(tmp_path / "reg"))
    jax_reg = jax_sklearn.SklearnRegressor().load(str(tmp_path / "reg"))
    np.testing.assert_array_equal(jax_reg.transform(X)["prediction"],
                                  reg.transform(X)["prediction"])


def test_estimators_read_jax_joblib_files_without_joblib(tmp_path,
                                                        monkeypatch):
    """A JAX GBMRegressor file (its native GBM, joblib) loads in the port
    with joblib blocked in a subprocess; a JAX SklearnRegressor file (an
    sklearn estimator and its arrays, joblib) loads in the port with
    joblib's loaders patched to raise (sklearn itself imports joblib, so
    it cannot be blocked there). Both predict the same numbers."""
    import joblib
    from sklearn.linear_model import LinearRegression

    X = np.linspace(0, 40, 200).reshape(-1, 1)
    y = np.sin(X[:, 0] / 5) * 10 + X[:, 0]
    gbm = jax_sklearn.GBMRegressor(
        model_params={"learning_rate": 0.3, "min_data": 5},
        training_params={"number_boosting_rounds": 50}).fit(X, y)
    gbm.save(str(tmp_path / "gbm.joblib"))
    np.save(tmp_path / "X.npy", X)
    code = (
        "import numpy as np\n"
        "from mapping_tpu_torch.sklearn_models import GBMRegressor\n"
        f"X = np.load({str(tmp_path / 'X.npy')!r})\n"
        "gbm = GBMRegressor().load("
        f"{str(tmp_path / 'gbm.joblib')!r})\n"
        "assert type(gbm.estimator).__module__ == "
        "'mapping_tpu_torch.utils.native_gbm'\n"
        f"np.save({str(tmp_path / 'gbm.npy')!r}, "
        "gbm.transform(X)['prediction'])\n")
    _run_blocked(code)
    np.testing.assert_array_equal(np.load(tmp_path / "gbm.npy"),
                                  gbm.transform(X)["prediction"])

    reg = jax_sklearn.SklearnRegressor(LinearRegression()).fit(X, y)
    reg.save(str(tmp_path / "reg.joblib"))

    def refuse(*a, **k):
        raise AssertionError("joblib called")

    monkeypatch.setattr(joblib, "load", refuse)
    monkeypatch.setattr(joblib.numpy_pickle, "load", refuse)
    port = sklearn_models.SklearnRegressor().load(str(tmp_path / "reg.joblib"))
    np.testing.assert_array_equal(port.transform(X)["prediction"],
                                  reg.transform(X)["prediction"])


def test_jax_classes_map_onto_the_port_or_are_refused(tmp_path):
    """A JAX-package class in a file loads as the port's class of the same
    module path and name; one the port lacks raises, naming it, instead of
    importing the JAX package."""
    import joblib

    from mapping_tpu.models.torch_convert import convert_unet_resnet
    from mapping_tpu_torch.utils import ndpickle

    path = str(tmp_path / "f")
    joblib.dump({"t": jax_graph.MockTransformer()}, path)
    assert type(ndpickle.load_object(path)["t"]) is graph.MockTransformer
    joblib.dump(convert_unet_resnet, path)
    with pytest.raises(pickle.UnpicklingError, match="convert_unet_resnet"):
        ndpickle.load_object(path)


def test_gbm_regressor_refuses_without_the_native_library(monkeypatch):
    """Where the native GBM does not build, fit raises with the library's
    reason; there is no sklearn fallback."""
    from mapping_tpu_torch.utils import native_gbm
    from mapping_tpu_torch.utils.native_lib import NativeLibraryUnavailable

    def unavailable():
        raise NativeLibraryUnavailable("gbm: g++ not found")

    monkeypatch.setattr(native_gbm, "load", unavailable)
    with pytest.raises(NativeLibraryUnavailable, match="g\\+\\+"):
        sklearn_models.GBMRegressor().fit(np.zeros((4, 1)), np.zeros(4))
