"""Lightweight functional DAG engine: the reference's "steps" toolkit.

Counterpart of mapping_tpu/graph.py (the reference's Step engine,
src/steps/base.py:15-325): lazy-pull execution, per-node adapters with
input reducers, trainable-transformer persistence, in-RAM output caching,
saved step outputs, graph introspection and rebinding a named step's
transformer. The pipelines (pipelines.py) wire their components directly;
this module serves code written against the reference's Step API.

Persistence is plain pickle (`utils/ndpickle.dump_object`), where the JAX
package uses joblib; a step output or an empty transformer file that the
JAX package wrote with joblib is read without joblib
(`ndpickle.load_object`). `XYSplit` takes the port's metadata rows (a list
of dicts) where the JAX package takes a DataFrame.
"""

import logging
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mapping_tpu_torch.utils import ndpickle

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# transformer protocol
# ---------------------------------------------------------------------------

class BaseTransformer:
    """fit/transform/save/load protocol (reference src/steps/base.py:254-269)."""

    def fit(self, *args, **kwargs):
        return self

    def transform(self, *args, **kwargs):
        raise NotImplementedError

    def fit_transform(self, *args, **kwargs):
        self.fit(*args, **kwargs)
        return self.transform(*args, **kwargs)

    def save(self, filepath):
        ndpickle.dump_object({}, filepath)

    def load(self, filepath):
        return self


class Dummy(BaseTransformer):
    """Pass inputs through unchanged (reference Dummy, base.py:284)."""

    def transform(self, **kwargs):
        return kwargs


class MockTransformer(BaseTransformer):
    """Persist-nothing stand-in for tests (reference base.py:272-281)."""

    def fit(self, *args, **kwargs):
        return self

    def transform(self, *args, **kwargs):
        return {"mocked_output": None}


class XYSplit(BaseTransformer):
    """Select X / y column values from metadata rows (reference
    src/steps/preprocessing/misc.py:6-31)."""

    def __init__(self, x_columns, y_columns):
        self.x_columns = list(x_columns)
        self.y_columns = list(y_columns)

    @staticmethod
    def _values(meta, columns):
        """(rows, columns) values, a text column as objects (as a
        DataFrame's `.values` gives it); one column flattened."""
        cols = [np.asarray([row[c] for row in meta]) for c in columns]
        cols = [c.astype(object) if c.dtype.kind in "US" else c
                for c in cols]
        return cols[0] if len(cols) == 1 else np.stack(cols, axis=1)

    def transform(self, meta, train_mode=True, **kwargs):
        out = {"X": self._values(meta, self.x_columns), "y": None}
        if train_mode and all(c in row for row in meta
                              for c in self.y_columns):
            out["y"] = self._values(meta, self.y_columns)
        return out


# ---------------------------------------------------------------------------
# input reducers (reference base.py:289-325, src/utils.py:227-228)
# ---------------------------------------------------------------------------

def identity_inputs(inputs):
    return inputs[0]


def squeeze_inputs(inputs):
    return np.squeeze(inputs[0], axis=1) if hasattr(inputs[0], "ndim") else inputs[0]


def stack_inputs(inputs):
    return np.stack(inputs)


def sum_inputs(inputs):
    return np.sum(np.stack(inputs), axis=0)


def average_inputs(inputs):
    return np.mean(np.stack(inputs), axis=0)


def exp_transform(inputs):
    return np.exp(inputs[0])


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

class Step:
    """One DAG node (reference Step, src/steps/base.py:15-251).

    adapter: {kwarg_name: ([(step_or_data_name, key), ...], reducer?)} —
    remaps upstream outputs to transformer kwargs; without an adapter, all
    upstream outputs merge by key.
    """

    def __init__(
        self,
        name: str,
        transformer: BaseTransformer,
        cache_dirpath: str,
        input_steps: Optional[Sequence["Step"]] = None,
        input_data: Optional[Sequence[str]] = None,
        adapter: Optional[Dict[str, Any]] = None,
        is_trainable: bool = False,
        force_fitting: bool = False,
        cache_output: bool = False,
        save_output: bool = False,
        load_saved_output: bool = False,
    ):
        self.name = name
        self.transformer = transformer
        self.input_steps = list(input_steps or [])
        self.input_data = list(input_data or [])
        self.adapter = adapter
        self.is_trainable = is_trainable
        self.force_fitting = force_fitting
        self.cache_output = cache_output
        self.save_output = save_output
        self.load_saved_output = load_saved_output
        self.cache_dirpath = cache_dirpath
        self._output_cache: Optional[Dict] = None
        for sub in ("transformers", "outputs", "tmp"):
            os.makedirs(os.path.join(cache_dirpath, sub), exist_ok=True)

    # ---------------------------------------------------------------- paths
    @property
    def transformer_path(self):
        return os.path.join(self.cache_dirpath, "transformers", self.name)

    @property
    def output_path(self):
        return os.path.join(self.cache_dirpath, "outputs", self.name)

    @property
    def transformer_is_cached(self):
        return os.path.exists(self.transformer_path)

    # ------------------------------------------------------------- plumbing
    def _gather_inputs(self, data, upstream_outputs):
        if self.adapter is None:
            merged = {}
            for name in self.input_data:
                merged.update(data[name])
            for out in upstream_outputs.values():
                merged.update(out)
            return merged
        sources = dict(upstream_outputs)
        for name in self.input_data:
            sources[name] = data[name]
        kwargs = {}
        for key, spec in self.adapter.items():
            if isinstance(spec, tuple) and len(spec) == 2 and callable(spec[1]):
                refs, reducer = spec
            else:
                refs, reducer = spec, identity_inputs
            values = [sources[src][k] for (src, k) in refs]
            kwargs[key] = reducer(values)
        return kwargs

    def _run_upstream(self, data, mode):
        outputs = {}
        for step in self.input_steps:
            if mode == "fit":
                outputs[step.name] = step.fit_transform(data)
            else:
                outputs[step.name] = step.transform(data)
        return outputs

    # ------------------------------------------------------------ execution
    def fit_transform(self, data) -> Dict:
        if self._output_cache is not None:
            return self._output_cache
        if self.load_saved_output and os.path.exists(self.output_path):
            return ndpickle.load_object(self.output_path)
        upstream = self._run_upstream(data, "fit")
        kwargs = self._gather_inputs(data, upstream)
        if self.is_trainable:
            if self.transformer_is_cached and not self.force_fitting:
                logger.info("step %s: loading cached transformer", self.name)
                self.transformer.load(self.transformer_path)
                output = self.transformer.transform(**kwargs)
            else:
                logger.info("step %s: fitting", self.name)
                output = self.transformer.fit_transform(**kwargs)
                self.transformer.save(self.transformer_path)
        else:
            output = self.transformer.transform(**kwargs)
        return self._finish(output)

    def transform(self, data) -> Dict:
        if self._output_cache is not None:
            return self._output_cache
        if self.load_saved_output and os.path.exists(self.output_path):
            return ndpickle.load_object(self.output_path)
        upstream = self._run_upstream(data, "transform")
        kwargs = self._gather_inputs(data, upstream)
        if self.is_trainable:
            if not self.transformer_is_cached:
                raise RuntimeError(
                    f"step {self.name}: no cached transformer at "
                    f"{self.transformer_path}; fit the pipeline first "
                    "(reference contract, src/steps/base.py:166-174)")
            self.transformer.load(self.transformer_path)
        output = self.transformer.transform(**kwargs)
        return self._finish(output)

    def _finish(self, output):
        if self.cache_output:
            self._output_cache = output
        if self.save_output:
            ndpickle.dump_object(output, self.output_path)
        return output

    # --------------------------------------------------------- introspection
    def clean_cache(self):
        self._output_cache = None
        for step in self.input_steps:
            step.clean_cache()

    @property
    def all_steps(self) -> Dict[str, "Step"]:
        steps = {}

        def walk(step):
            steps[step.name] = step
            for s in step.input_steps:
                walk(s)

        walk(self)
        return steps

    def get_step(self, name: str) -> "Step":
        return self.all_steps[name]

    def graph_info(self) -> Tuple[List[str], List[Tuple[str, str]]]:
        nodes = list(self.all_steps)
        edges = []
        for step in self.all_steps.values():
            for up in step.input_steps:
                edges.append((up.name, step.name))
            for d in step.input_data:
                edges.append((f"data:{d}", step.name))
        return nodes, edges

    def to_dot(self) -> str:
        """Graphviz DOT text (the reference rendered with pydot,
        src/steps/utils.py:14-30; emitting DOT keeps it dependency-free)."""
        nodes, edges = self.graph_info()
        lines = ["digraph pipeline {"]
        for n in nodes:
            lines.append(f'  "{n}";')
        for a, b in edges:
            lines.append(f'  "{a}" -> "{b}";')
        lines.append("}")
        return "\n".join(lines)

    def clean_cache_dir(self):
        """Remove persisted transformers/outputs (reference experiment wipe,
        src/pipeline_manager.py:104-105)."""
        for sub in ("transformers", "outputs", "tmp"):
            path = os.path.join(self.cache_dirpath, sub)
            shutil.rmtree(path, ignore_errors=True)
            os.makedirs(path, exist_ok=True)


# ---------------------------------------------------------------------------
# apply-transformer factories (reference src/utils.py:342-413)
# ---------------------------------------------------------------------------

def make_apply_transformer(func: Callable, output_name: str = "output",
                           apply_on: Optional[Sequence[str]] = None):
    """Wrap a per-item function into a transformer over aligned lists."""

    class StaticApplyTransformer(BaseTransformer):
        def transform(self, **kwargs):
            keys = list(apply_on) if apply_on else list(kwargs)
            iterables = [kwargs[k] for k in keys]
            n = len(iterables[0])
            if any(len(it) != n for it in iterables):
                raise ValueError("apply-transformer inputs differ in length")
            out = [func(*items) for items in zip(*iterables)]
            return {output_name: out}

    return StaticApplyTransformer()


def make_apply_transformer_stream(func: Callable, output_name: str = "output",
                                  apply_on: Optional[Sequence[str]] = None):
    """Generator variant for stream mode (reference src/utils.py:392-413)."""

    class StreamApplyTransformer(BaseTransformer):
        def transform(self, **kwargs):
            keys = list(apply_on) if apply_on else list(kwargs)

            def gen():
                iterables = [kwargs[k] for k in keys]
                for items in zip(*iterables):
                    yield func(*items)

            return {output_name: gen()}

    return StreamApplyTransformer()
