"""Time patched copies of a kernel's source side by side on one card.

    python3 -m mapping_tpu_torch.tools.kernel_variants conv_dw \
        mapping_tpu_torch/tools/conv_dw_variants.json
    python3 -m mapping_tpu_torch.tools.kernel_variants ccl \
        mapping_tpu_torch/tools/ccl_variants.json
    python3 -m mapping_tpu_torch.tools.kernel_variants jpeg \
        mapping_tpu_torch/tools/jpeg_variants.json

The JSON file maps a variant's name to a list of [old, new] string
replacements applied to the kernel's source, csrc/conv_dw.cu, csrc/ccl.cu
or csrc/jpeg_pixels.cu (an empty list is the source as it is; every
occurrence of
`old` is replaced). Each copy is built with the package's nvcc flags into
build/, the copies in parallel, and ptxas' performance notes (C75xx),
register counts, shared memory and spills are printed. Then each variant
runs as CUDA-graph replays in one process:

- conv_dw: at the four shapes chip_smoke.py times K3 at, beside cuDNN's
  weight gradient; a line per shape gives the ms of each and each
  variant's error against cuDNN (relative to its largest magnitude; cuDNN
  rounds its output to bf16).
- ccl: `ccl_label_raw` (K1) and `ccl_label` (K1 with K2 fused) on a
  (20, 300, 300) batch of noise of density 0.5 and on every mask batch
  that chip_smoke.py saved under build/ccl_masks/ (the serving, evaluate
  and building masks); a line per batch and entry point gives the ms of
  each and whether its labels equal the plain version's.
- jpeg: `jpeg_pixels` on batches of 1, 20 and 256 300^2 tiles (4:2:0,
  quality 95, seeded noise over a gradient, like chip_smoke.py's), each
  variant timed as CUDA-graph replays of 20 calls, in turns (a, b, ...,
  b, a); a line per batch gives each variant's ms and whether its RGB
  equals the plain version's.

Variants that skip work give wrong results by design: they tell which
part of the kernel bounds it.
"""

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from mapping_tpu_torch.kernels import build
from mapping_tpu_torch.kernels import ccl as ccl_kernels
from mapping_tpu_torch.kernels import conv_dw as dw_kernels
from mapping_tpu_torch.kernels import jpeg as jpeg_kernels

SHAPES = [(64, 32, 256, 256), (64, 64, 128, 128), (20, 32, 256, 256),
          (20, 128, 128, 128)]
SOURCES = {"conv_dw": dw_kernels.SOURCES[0], "ccl": ccl_kernels.SOURCES[0],
           "jpeg": jpeg_kernels.SOURCES[0]}
MASKS = build.BUILD_DIR / "ccl_masks"


def patched_sources(kernel, variants):
    """name -> the kernel's source with the variant's replacements; raises
    where a replaced string is not in the source."""
    source = SOURCES[kernel].read_text()
    texts = {}
    for name, replacements in variants.items():
        text = source
        for old, new in replacements:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        texts[name] = text
    return texts


def build_variants(kernel, variants):
    """name -> ctypes library of each patched copy of the kernel's
    source."""
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    specs = {}
    for name, text in patched_sources(kernel, variants).items():
        path = out / f"{kernel}_{name}.cu"
        path.write_text(text)
        specs[f"{kernel}_{name}"] = [path]
    builds = build.build_shared_libraries(specs)
    libs = {}
    for name in variants:
        built = builds[f"{kernel}_{name}"]
        for line in built.log.splitlines():
            if "C75" in line or "spill stores" in line or "Used" in line:
                print(f"{name}: {line.strip()[:160]}")
        libs[name] = ctypes.CDLL(str(built.path))
    return libs


def conv_dw_call(lib, x, dy, k):
    """dw_kernels.conv_dw's launch through another build of the source."""
    n, c, h, w = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    pl = dw_kernels.plan(n, h, w, c, k, sms)
    out = torch.empty((c, c, k, k), dtype=torch.float32, device=x.device)
    partial = torch.empty((pl.slices, k * k * c * c), dtype=torch.float32,
                          device=x.device)
    fields = (ctypes.c_int * dw_kernels._PLAN_FIELDS)(
        *pl[:dw_kernels._PLAN_FIELDS])
    err = lib.conv_dw_bf16(x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                           out.data_ptr(), fields,
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with error {err}")
    return out


def ccl_call(fn, mask, work, poison=False):
    """One of the ccl entry points through another build of the source:
    `work` int32 of scratch, the labels out. With `poison` the output
    starts as -1, so that a variant which skips a pass cannot pass for
    right on what an earlier call left in the same memory."""
    n, h, w = mask.shape
    scratch = torch.empty(work, dtype=torch.int32, device=mask.device)
    out = torch.full(mask.shape, -1, dtype=torch.int32, device=mask.device) \
        if poison else torch.empty(mask.shape, dtype=torch.int32,
                                   device=mask.device)
    err = fn(mask.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, h, w,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{fn.__name__}: launch failed with error {err}")
    return out


def kernel_events(fn):
    """[(kernel name, device µs)] of the CUDA kernels one call of `fn`
    launches, in launch order, from a torch.profiler trace (events of
    category "kernel"; written to and removed from build/)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    trace = build.BUILD_DIR / "kernel_events_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    trace.unlink()
    kernels = sorted((e["ts"], e["name"], float(e.get("dur", 0)))
                     for e in events
                     if e.get("ph") == "X" and e.get("cat") == "kernel")
    return [(name, dur) for _, name, dur in kernels]


def short_name(kernel):
    """A kernel's name without namespace, template arguments' types and
    parameters: `resolve<true>`, `tile_label`."""
    name = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    return name.split("::")[-1].replace("void ", "")


def graph_ms(fn, reps=20, calls=1):
    """Device ms per call: `calls` calls captured in one CUDA graph, the
    graph replayed `reps` times between events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
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
    return start.elapsed_time(end) / reps / calls


def jpeg_tiles(n=20, side=300, seed=8):
    """Coefficients of `n` seeded 300^2 tiles at quality 95, 4:2:0."""
    import numpy as np

    from mapping_tpu_torch.utils import jpeg

    rng = np.random.RandomState(seed)
    ramp = np.linspace(0, 180, side)[None, :, None]
    return [jpeg.read(jpeg.encode(
        (rng.randint(0, 70, (side, side, 3)) + ramp).astype(np.uint8), 95,
        "4:2:0")) for _ in range(n)]


def time_jpeg(libs):
    import numpy as np

    for lib in libs.values():
        lib.jpeg_pixels.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    items = jpeg_tiles()
    g = items[0].geometry
    rec = jpeg_kernels.geometry_record(g)
    for batch in (1, 20, 256):
        pick = [items[i % len(items)] for i in range(batch)]
        coef = torch.from_numpy(np.stack([c.coef for c in pick])).cuda()
        quant = torch.from_numpy(np.stack([c.quant for c in pick])).cuda()
        want = jpeg_kernels.pixels_plain(coef, quant, g)
        out = torch.empty_like(want)

        def call(lib):
            err = lib.jpeg_pixels(coef.data_ptr(), quant.data_ptr(),
                                  out.data_ptr(), batch,
                                  ctypes.addressof(rec),
                                  torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed with error {err}")

        exact = {}
        for name, lib in libs.items():
            out.zero_()
            call(lib)
            exact[name] = torch.equal(out, want)
        names = list(libs) + list(libs)[::-1]
        times = {name: [] for name in libs}
        for name in names:
            times[name].append(graph_ms(lambda: call(libs[name]), 50, 20))
        print(f"batch {batch}: " + ", ".join(
            f"{name} {min(t):.5f} ms "
            f"({'exact' if exact[name] else 'wrong'})"
            for name, t in times.items()), flush=True)


def time_conv_dw(libs):
    from mapping_tpu_torch.tools.dw_probe import dw_cudnn

    for lib in libs.values():
        lib.conv_dw_bf16.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape in SHAPES:
        x, dy = (torch.randn(shape, generator=gen, device="cuda",
                             dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last) for _ in range(2))
        ref = dw_cudnn(x, dy, 3).float()
        cells = [f"cuDNN {graph_ms(lambda: dw_cudnn(x, dy, 3)):.4f} ms"]
        for name, lib in libs.items():
            got = conv_dw_call(lib, x, dy, 3)
            err = float((got - ref).abs().max() / ref.abs().max())
            ms = graph_ms(lambda: conv_dw_call(lib, x, dy, 3))
            cells.append(f"{name} {ms:.4f} ms (err {err:.1e})")
        print(f"{shape}: " + ", ".join(cells), flush=True)


def time_ccl(libs):
    from mapping_tpu_torch.ops.ccl import _label_raw, _renumber

    for lib in libs.values():
        for fn in (lib.ccl_label_raw, lib.ccl_label):
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
    gen = torch.Generator().manual_seed(0)
    batches = {"density 0.5": torch.rand((20, 300, 300), generator=gen) < 0.5}
    for path in sorted(MASKS.glob("*.pt")):
        batches[path.stem.replace("_", " ")] = torch.load(path)
    for what, mask in batches.items():
        mask = mask.to("cuda").contiguous()
        n, h, w = mask.shape
        raw = _label_raw(mask, h + w)
        plain = {"ccl_label_raw": raw, "ccl_label": _renumber(raw)}
        work = {"ccl_label_raw": n * h * w,
                "ccl_label": ccl_kernels.label_plan(n, h, w).work}
        for entry, want in plain.items():
            cells = []
            for name, lib in libs.items():
                fn = getattr(lib, entry)
                exact = torch.equal(
                    ccl_call(fn, mask, work[entry], poison=True), want)
                ms = graph_ms(lambda: ccl_call(fn, mask, work[entry]), 100)
                per_kernel = " + ".join(
                    f"{short_name(k)} {us:.1f}" for k, us in kernel_events(
                        lambda: ccl_call(fn, mask, work[entry])))
                cells.append(f"{name} {ms:.4f} ms "
                             f"({'exact' if exact else 'wrong'}; µs "
                             f"{per_kernel})")
            print(f"{entry} {tuple(mask.shape)} {what}:\n  " + "\n  ".join(
                cells), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=sorted(SOURCES))
    ap.add_argument("variants", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    libs = build_variants(args.kernel,
                          json.loads(args.variants.read_text()))
    {"conv_dw": time_conv_dw, "ccl": time_ccl,
     "jpeg": time_jpeg}[args.kernel](libs)


if __name__ == "__main__":
    main()
