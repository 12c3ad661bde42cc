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
from typing import Dict, Mapping, Sequence

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


def _target(name: str, sources: Sequence[Path]) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_shared_libraries(specs: Mapping[str, Sequence[Path]]
                           ) -> Dict[str, Built]:
    """Compile each library `name -> sources` into
    `build/lib<name>-<hash>.so`, or reuse it. The nvcc processes start
    together and run in parallel; `seconds` is each one's wall time until
    it was collected. A failed build raises, after stopping the others."""
    results: Dict[str, Built] = {}
    running = {}
    try:
        for name, sources in specs.items():
            out = _target(name, sources)
            if out.exists():
                results[name] = Built(out, 0.0, "")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running[name] = (out, tmp, cmd, time.perf_counter(), proc)
        for name, (out, tmp, cmd, start, proc) in running.items():
            log = proc.communicate()[0]
            seconds = time.perf_counter() - start
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with code {proc.returncode}:"
                                   f"\n{' '.join(cmd)}\n{log}")
            os.replace(tmp, out)
            results[name] = Built(out, seconds, log)
    finally:
        for *_, proc in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def build_shared_library(name: str, sources: Sequence[Path]) -> Built:
    """Compile `sources` into `build/lib<name>-<hash>.so`, or reuse it."""
    return build_shared_libraries({name: sources})[name]
