"""ndarray files that joblib reads, without joblib.

The JAX package writes the distance and size targets with `joblib.dump`
and reads them with `joblib.load` (mapping_tpu/prep/targets.py:348-351,
mapping_tpu/data/loader.py:79-84). The port keeps both directions without
joblib:
- `dump` writes a plain pickle (protocol 4) of the array. joblib's loader
  is a subclass of pickle's pure-Python unpickler, so `joblib.load` reads
  it as it reads any pickle.
- `load` reads such plain pickles and joblib's own uncompressed format. In
  the latter the pickle stream holds a `joblib.numpy_pickle.
  NumpyArrayWrapper` (subclass, shape, order, dtype and, since joblib 1.2,
  `numpy_array_alignment_bytes`); right after its BUILD opcode the file
  holds the raw array bytes: one byte giving a padding length, that many
  0xff bytes, then the data (joblib's `write_array`/`read_array`). The
  unpickler resolves only numpy's ndarray reconstruction and that wrapper;
  any other class, an object dtype and joblib's compressed files raise.
- `load_object` / `dump_object` do the same for any object (step outputs
  and estimators of `graph.py` and `sklearn_models.py`): arrays inside a
  joblib file are read as above, other globals resolve as pickle resolves
  them, and a class of the JAX package maps onto the port's class of the
  same module path and name.
"""

import importlib
import pickle

import numpy as np

_PROTOCOL = 4


def dump(array, path):
    """Write `array` (an ndarray) to `path` as a plain pickle."""
    with open(path, "wb") as f:
        pickle.dump(np.asarray(array), f, protocol=_PROTOCOL)


class _ArrayWrapper:
    """Stands in for joblib.numpy_pickle.NumpyArrayWrapper while loading:
    its state arrives through BUILD; the array bytes follow in the file."""

    def read(self, file, unpickler=None):
        """The array whose bytes follow in `file`; an array of Python
        objects (a nested pickle) only with an object `unpickler`."""
        if getattr(self, "subclass", None) is not np.ndarray:
            raise ValueError("ndpickle: only plain ndarrays are read, not "
                             f"{getattr(self, 'subclass', None)!r}")
        dtype = np.dtype(self.dtype)
        if dtype.hasobject:
            if unpickler is None:
                raise ValueError(
                    "ndpickle: arrays of Python objects are refused")
            return unpickler(file).load()
        if getattr(self, "numpy_array_alignment_bytes", None) is not None:
            file.read(file.read(1)[0])  # the padding length, then padding
        count = int(np.prod(self.shape, dtype=np.int64))
        data = file.read(count * dtype.itemsize)
        if len(data) != count * dtype.itemsize:
            raise ValueError("ndpickle: truncated array data")
        array = np.frombuffer(data, dtype=dtype, count=count).copy()
        if self.order == "F":
            return array.reshape(self.shape[::-1]).transpose()
        return array.reshape(self.shape)


def _numpy(name):
    for prefix in ("numpy._core.", "numpy.core."):
        try:
            module = importlib.import_module(prefix + name.split(".")[0])
        except ImportError:
            continue
        return getattr(module, name.split(".")[1])
    raise ImportError(f"numpy has no {name}")


_GLOBALS = {
    ("joblib.numpy_pickle", "NumpyArrayWrapper"): lambda: _ArrayWrapper,
    ("numpy", "ndarray"): lambda: np.ndarray,
    ("numpy", "dtype"): lambda: np.dtype,
    **{(f"{prefix}.multiarray", "_reconstruct"):
       (lambda: _numpy("multiarray._reconstruct"))
       for prefix in ("numpy._core", "numpy.core")},
    **{(f"{prefix}.numeric", "_frombuffer"):
       (lambda: _numpy("numeric._frombuffer"))
       for prefix in ("numpy._core", "numpy.core")},
}


class _Unpickler(pickle._Unpickler):
    """pickle's pure-Python unpickler (the C one has no dispatch table to
    hook) with the globals limited to _GLOBALS and a BUILD that replaces
    a joblib array wrapper by the array read from the file after it."""

    dispatch = pickle._Unpickler.dispatch.copy()

    def __init__(self, file):
        super().__init__(file)
        self._file = file

    def find_class(self, module, name):
        make = _GLOBALS.get((module, name))
        if make is None:
            raise pickle.UnpicklingError(
                f"ndpickle: refusing to load {module}.{name}")
        return make()

    #: the unpickler of a nested object-array pickle; None refuses one
    objects = None

    def load_build(self):
        pickle._Unpickler.load_build(self)
        if isinstance(self.stack[-1], _ArrayWrapper):
            self.stack.append(self.stack.pop().read(self._file,
                                                    self.objects))

    dispatch[pickle.BUILD[0]] = load_build


def load(path) -> np.ndarray:
    """The ndarray in `path`: a plain pickle or an uncompressed joblib
    file."""
    with open(path, "rb") as f:
        if f.read(1) != pickle.PROTO:
            raise ValueError(
                f"{path}: not an uncompressed pickle (compressed joblib "
                f"files are not read)")
        f.seek(0)
        out = _Unpickler(f).load()
    if not isinstance(out, np.ndarray):
        raise ValueError(f"{path}: holds a {type(out).__name__}, not an "
                         f"ndarray")
    return out


class _ObjectUnpickler(_Unpickler):
    """`_Unpickler` for any pickled object: globals resolve as pickle
    resolves them, except that a class of the JAX package
    (`mapping_tpu.<module>`) maps onto the port's class of the same name
    in `mapping_tpu_torch.<module>`, which reads the same state (the port
    imports nothing of the JAX package)."""

    def find_class(self, module, name):
        make = _GLOBALS.get((module, name))
        if make is not None:
            return make()
        if module == "mapping_tpu" or module.startswith("mapping_tpu."):
            port = "mapping_tpu_torch" + module[len("mapping_tpu"):]
            try:
                return getattr(importlib.import_module(port), name)
            except (ImportError, AttributeError):
                raise pickle.UnpicklingError(
                    f"ndpickle: {module}.{name} of the JAX package has no "
                    f"counterpart {port}.{name} in the port") from None
        return pickle._Unpickler.find_class(self, module, name)


_ObjectUnpickler.objects = _ObjectUnpickler


def load_object(path):
    """The object in `path`: a plain pickle, or an uncompressed joblib
    file (its arrays read as `load` reads them), with the JAX package's
    classes mapped onto the port's."""
    with open(path, "rb") as f:
        if f.read(1) != pickle.PROTO:
            raise ValueError(
                f"{path}: not an uncompressed pickle (compressed joblib "
                f"files are not read)")
        f.seek(0)
        return _ObjectUnpickler(f).load()


def dump_object(obj, path):
    """Write `obj` to `path` as a plain pickle (which joblib reads)."""
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=_PROTOCOL)
