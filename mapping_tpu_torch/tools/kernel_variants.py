"""Time patched copies of the dW kernel's source side by side on one card.

    python3 -m mapping_tpu_torch.tools.kernel_variants \
        mapping_tpu_torch/tools/conv_dw_variants.json

The JSON file maps a variant's name to a list of [old, new] string
replacements applied to csrc/conv_dw.cu (an empty list is the source as
it is). Each copy is built with the package's nvcc flags into build/, the
copies in parallel, and ptxas' performance notes (C75xx), register counts
and spills are printed. Then, at the four shapes chip_smoke.py times K3
at, each variant and cuDNN's weight gradient run as CUDA-graph replays in
one process; a line per shape gives the ms of each and each variant's
error against cuDNN (relative to its largest magnitude; cuDNN rounds its
output to bf16). Variants that skip work give wrong results by design:
they tell which side of the kernel bounds it.
"""

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from mapping_tpu_torch.kernels import build
from mapping_tpu_torch.kernels import conv_dw as K

SHAPES = [(64, 32, 256, 256), (64, 64, 128, 128), (20, 32, 256, 256),
          (20, 128, 128, 128)]


def build_variants(variants):
    """name -> ctypes library of each patched copy of csrc/conv_dw.cu."""
    source = K.SOURCES[0].read_text()
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    specs = {}
    for name, replacements in variants.items():
        text = source
        for old, new in replacements:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        path = out / f"conv_dw_{name}.cu"
        path.write_text(text)
        specs[f"conv_dw_{name}"] = [path]
    builds = build.build_shared_libraries(specs)
    libs = {}
    for name in variants:
        built = builds[f"conv_dw_{name}"]
        for line in built.log.splitlines():
            if "C75" in line or "spill stores" in line or "Used" in line:
                print(f"{name}: {line.strip()[:160]}")
        lib = ctypes.CDLL(str(built.path))
        lib.conv_dw_bf16.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        libs[name] = lib
    return libs


def call(lib, x, dy, k):
    """K.conv_dw's launch through another build of the same source."""
    n, c, h, w = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    pl = K.plan(n, h, w, c, k, sms)
    out = torch.empty((c, c, k, k), dtype=torch.float32, device=x.device)
    partial = torch.empty((pl.slices, k * k * c * c), dtype=torch.float32,
                          device=x.device)
    fields = (ctypes.c_int * K._PLAN_FIELDS)(*pl[:K._PLAN_FIELDS])
    err = lib.conv_dw_bf16(x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                           out.data_ptr(), fields,
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with error {err}")
    return out


def graph_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    from mapping_tpu_torch.tools.dw_probe import dw_cudnn

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    libs = build_variants(json.loads(args.variants.read_text()))
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape in SHAPES:
        x, dy = (torch.randn(shape, generator=gen, device="cuda",
                             dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last) for _ in range(2))
        ref = dw_cudnn(x, dy, 3).float()
        cells = [f"cuDNN {graph_ms(lambda: dw_cudnn(x, dy, 3)):.4f} ms"]
        for name, lib in libs.items():
            got = call(lib, x, dy, 3)
            err = float((got - ref).abs().max() / ref.abs().max())
            ms = graph_ms(lambda: call(lib, x, dy, 3))
            cells.append(f"{name} {ms:.4f} ms (err {err:.1e})")
        print(f"{shape}: " + ", ".join(cells), flush=True)


if __name__ == "__main__":
    main()
