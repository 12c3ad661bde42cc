"""Build the repository's C++ host libraries (cpp/*.cpp, and the port's
own csrc/*.cpp) and load them.

Counterpart of mapping_tpu/utils/native_lib.py. The sources are built as
they are, with g++, into `build/` at the root of the checkout, named by a
hash of the source and the flags (`build/lib<name>-<hash>.so`), so a later
process in the same checkout reuses the library; a build writes a temporary
file and renames it, so processes that build at once do not see each
other's half-written output. Nothing is compiled at import time: the first
`load()` builds. A build that fails is remembered for the process and its
compiler output is kept in `error`.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from mapping_tpu_torch.kernels.build import BUILD_DIR

CPP_DIR = Path(__file__).resolve().parents[2] / "cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class NativeLibraryUnavailable(RuntimeError):
    """The library's source did not build or load here."""


class NativeLib:
    """A C++ source under `src_dir` (the root cpp/ by default),
    compiled and loaded on first use.

    register(lib) declares the argtypes and restypes once after loading;
    `link` are the linker flags (e.g. -ljpeg); `flags` are compiler flags
    this library needs beyond GXX_FLAGS (e.g. -ffp-contract=off), part of
    its hash."""

    def __init__(self, src_name: str, name: str, register, link=(),
                 src_dir: Path = CPP_DIR, flags=()):
        self.src = Path(src_dir) / src_name
        self.name = name
        self._register = register
        self._link = tuple(link)
        self.flags = GXX_FLAGS + tuple(flags)
        self._lib = None
        self.error = None
        # the loader's decode threads may ask first, at once
        self._lock = threading.Lock()

    def _target(self) -> Path:
        digest = hashlib.sha256(" ".join(self.flags + self._link).encode())
        digest.update(self.src.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

    def _build(self) -> Path:
        out = self._target()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *self.flags, str(self.src), "-o", str(tmp), *self._link],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeLibraryUnavailable(
                f"g++ could not build {self.src.name} (library {self.name}, "
                f"linked with {' '.join(self._link) or 'nothing'}):\n"
                f"{proc.stderr.strip()}")
        os.replace(tmp, out)
        return out

    def load(self):
        """The loaded ctypes library; raises NativeLibraryUnavailable if
        it does not build here."""
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                if self.error is not None:
                    raise NativeLibraryUnavailable(self.error)
                try:
                    lib = ctypes.CDLL(str(self._build()))
                except (NativeLibraryUnavailable, OSError) as e:
                    self.error = str(e)
                    raise NativeLibraryUnavailable(self.error) from e
                self._register(lib)
                self._lib = lib
        return self._lib

    def available(self) -> bool:
        try:
            self.load()
        except NativeLibraryUnavailable:
            return False
        return True
