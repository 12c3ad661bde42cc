"""Guards of the port's tests against the state of the worker they run in:
the JAX package's native decode library as a reference, and the clean-up
of large temporary files.

The JAX package builds `cpp/libdecode.so` (libjpeg and libpng) on first use
through one `cpp/libdecode.so.tmp` that every process shares, with only a
thread lock around it (`mapping_tpu/utils/native_lib.py`). An xdist worker
that loses that race keeps no library for the rest of its life, and the
JAX code then falls back without a word: `native_decode.decode_rgb` returns
None, and `load_image` reads through Pillow, whose libjpeg and PNG reading
differ from the system's on cut streams and on gAMA chunks. A test that
takes its reference from there builds the library again in its own worker
(`jax_decode_library`), and fails naming the library where it still does
not load, never as a pixel mismatch.

`drop_tmp_path` is an autouse fixture for a test module whose tests write
large files (weights, exported programs, tile folders) under `tmp_path`:
pytest keeps every test's directory to the end of the run, and the
suite's six workers then hold gigabytes of them at its peak.
"""

import shutil

import pytest

from mapping_tpu.utils import native_decode as jax_decode

MISSING = ("the JAX package's cpp/libdecode.so (libjpeg, libpng) did not "
           "build or load in this process: the reference decode is missing")


def jax_decode_library():
    """The JAX package's decode library, built again in this process up to
    three times where it is not loaded; an AssertionError naming it where
    it still is not."""
    for _ in range(3):
        if jax_decode._load() is not None:
            return jax_decode._load()
        jax_decode.build()
    raise AssertionError(MISSING)


def libjpeg_rgb(path):
    """(H, W, 3) uint8 of the JAX package's libjpeg / libpng decode of a
    file; an AssertionError naming the library where it is missing or
    declines the file."""
    jax_decode_library()
    out = jax_decode.decode_rgb(str(path))
    if out is None:  # loaded once, declining now: load it afresh
        jax_decode.build()
        out = jax_decode.decode_rgb(str(path))
    assert out is not None, f"{MISSING} (it declined {path})"
    return out


@pytest.fixture(autouse=True)
def drop_tmp_path(request):
    """Removes the test's `tmp_path` once the test is done."""
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)
