"""Build the package's CUDA sources into shared libraries with nvcc.

Each library is compiled for Hopper (`sm_90a`) from the sources under
`mapping_tpu_torch/csrc/`, exposes a plain C interface, and is loaded with
ctypes by the kernel's wrapper. The output lands in `build/` at the root of
the checkout, named by a hash of the sources and flags, so a later call in
the same checkout reuses it. Nothing is compiled at import time.
"""

import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    """A compiled library: its path, the build's seconds (0.0 when an
    earlier build was reused) and the compiler's output (`-Xptxas -v`
    register and shared-memory report)."""

    path: Path
    seconds: float
    log: str


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: put the CUDA toolkit on PATH or set "
                       "CUDA_HOME")


def build_shared_library(name: str, sources: Sequence[Path]) -> Built:
    """Compile `sources` into `build/lib<name>-<hash>.so`, or reuse it."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return Built(out, seconds, proc.stdout + proc.stderr)
