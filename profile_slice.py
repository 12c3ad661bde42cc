#!/usr/bin/env python3
"""Where the port's serving slice spends its time on one CUDA card.

    python3 profile_slice.py [--out DIR] [--repeats 5] [--batches 10]

Builds the slice of chip_smoke.py (a ResNet101 unet_weighted pipeline, 32
filters, deconv, BN folded, bfloat16, batch 20, random weights from a
seeded torch.Generator) and measures, in this order:

  1. throughput with no profiler attached: `repeats` runs of
     `transform_arrays` over `batches` batches of 20 uint8 300^2 tiles,
     images/s per run on the host clock (a run ends when its last labels
     are on the host);
  2. the stages of one batch, synchronised between stages, in CUDA events
     (host clock for the whole batch), median, min and max of 10;
  3. the CCL kernels on the slice's own masks against their plain versions;
  4. a torch.profiler trace of 5 pipelined batches through
     `transform_arrays`: device busy time (the union of kernel, memcpy and
     memset intervals), the span from the first to the last of them, the
     idle share 1 - busy / span, busy time by category, and kernels per
     batch. The profiler slows the host, so this run's span is not a
     throughput.

Prints every result and the card's name and power limit, and writes them
to DIR/profile_slice.json with the gzipped chrome trace beside it.
"""

import argparse
import gzip
import json
import statistics
import time
from pathlib import Path

import torch

import chip_smoke
from chip_smoke import BATCH, DEVICE, TILE

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: busy-time categories, matched in order against the event's name
CATEGORIES = (
    ("ccl kernels", ("init_runs", "merge_cols", "resolve", "count_roots",
                     "scan_chunks", "gather_ranks")),
    ("conv/gemm", ("conv", "gemm", "xmma", "nvjet", "cutlass", "cudnn")),
    ("scatter (scores)", ("scatter",)),
    ("resize", ("upsample", "interp")),
    ("memcpy HtoD", ("Memcpy HtoD",)),
    ("memcpy DtoH", ("Memcpy DtoH",)),
    ("memcpy/memset other", ("Memcpy", "Memset")),
)


def summary(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def throughput(pipe, tiles, repeats):
    rates = []
    for _ in range(repeats):
        start = time.perf_counter()
        n = sum(1 for _ in pipe.transform_arrays(tiles))
        rates.append(n / (time.perf_counter() - start))
    return rates


def stage_times(pipe, tiles_u8, reps=10):
    """ms per stage of one batch, each stage bracketed by CUDA events and
    followed by a synchronise."""
    from mapping_tpu_torch.data.augment import resize_bilinear
    from mapping_tpu_torch.data.loader import infer_batch_resize
    from mapping_tpu_torch.infer.postprocess import fused_postprocess
    from mapping_tpu_torch.infer.serving import labels_i16
    from mapping_tpu_torch.ops.ccl import connected_components

    post = dict(target_size=(TILE, TILE), category_layers=(1, 1),
                active_layers=(1,))

    def timed(fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    stages = {}
    for _ in range(reps + 1):  # the first round warms up
        row = {}
        t0 = time.perf_counter()
        u8, row["H2D of the uint8 tiles (pageable)"] = timed(
            lambda: torch.as_tensor(tiles_u8).to(DEVICE))
        x, row["preprocess (/255, antialiased resize, normalise)"] = timed(
            infer_batch_resize, u8, pipe.loader.size)
        probs, row["forward + softmax"] = timed(
            pipe.trainer.probs_apply_fn(), x)
        mask, row["resize to 300^2 + threshold"] = timed(
            lambda: resize_bilinear(probs, (TILE, TILE))[..., 1] > 0.5)
        _, row["CCL kernels (label_raw + renumber)"] = timed(
            connected_components, mask)
        outs, row["whole fused_postprocess"] = timed(
            lambda: fused_postprocess(probs, **post))
        _, row["D2H of int16 labels, scores, areas (pageable)"] = timed(
            lambda: [o.cpu() for o in (labels_i16(outs[0]),) + outs[1:]])
        row["host wall for the batch (ms)"] = 1e3 * (time.perf_counter() - t0)
        for name, ms in row.items():
            stages.setdefault(name, []).append(ms)
    return {name: summary(ms[1:]) for name, ms in stages.items()}


def ccl_on_slice_masks(pipe, tiles_u8):
    from mapping_tpu_torch.data.augment import resize_bilinear
    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.ops.ccl import _label_raw, _renumber

    probs = chip_smoke.probs_of(pipe, tiles_u8)
    mask = (resize_bilinear(probs, (TILE, TILE))[..., 1] > 0.5).contiguous()
    kernel = chip_smoke.cuda_ms(lambda: K.renumber(K.label_raw(mask)), 50)
    plain = chip_smoke.cuda_ms(lambda: _renumber(_label_raw(mask, 2 * TILE)),
                               5)
    return {"components_max": int(K.renumber(K.label_raw(mask)).amax()),
            "kernel_ms": kernel, "plain_ms": plain}


def device_trace(pipe, tiles_u8, trace_path):
    from torch.profiler import ProfilerActivity, profile

    n_batches = len(tiles_u8) // BATCH
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        list(pipe.transform_arrays(tiles_u8))
        torch.cuda.synchronize()
    raw = trace_path.with_suffix("")
    prof.export_chrome_trace(str(raw))
    trace = json.loads(raw.read_text())
    with gzip.open(trace_path, "wt") as f:
        json.dump(trace, f)
    raw.unlink()
    return busy_breakdown(trace.get("traceEvents", []), n_batches)


def busy_breakdown(events, n_batches):
    """Busy time, span, idle share and busy time by category (ms) of the
    device events in a chrome trace."""
    spans, by_cat, n_kernels = [], {}, 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t, d = float(e["ts"]), float(e.get("dur", 0))
        spans.append((t, t + d))
        n_kernels += e["cat"] == "kernel"
        name = e.get("name", "")
        cat = next((c for c, keys in CATEGORIES
                    if any(k in name for k in keys)), "elementwise and other")
        by_cat[cat] = by_cat.get(cat, 0.0) + d / 1e3
    if not spans:
        raise RuntimeError("the trace holds no device events")
    spans.sort()
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3
    span = (max(e for _, e in spans) - spans[0][0]) / 1e3
    return {"batches": n_batches, "busy_ms": busy, "span_ms": span,
            "idle_share": 1.0 - busy / span,
            "kernels_per_batch": n_kernels / n_batches,
            "busy_ms_by_category": dict(sorted(by_cat.items(),
                                               key=lambda kv: -kv[1]))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/profile_slice",
                    help="directory for profile_slice.json and the trace")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--batches", type=int, default=10)
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    smi = chip_smoke.card()
    gen = torch.Generator().manual_seed(0)
    tiles = chip_smoke.make_tiles(gen, args.batches * BATCH)
    pipe = chip_smoke.serving_pipeline(gen, tiles[:BATCH])[0]
    list(pipe.transform_arrays(tiles[:2 * BATCH]))  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    result = {"card": smi, "batch": BATCH, "tile": TILE,
              "model": "ResNet101 UNet, 32 filters, deconv, bf16"}
    rates = throughput(pipe, tiles, args.repeats)
    result["images_per_s_no_profiler"] = rates
    print(f"throughput, no profiler, {args.repeats} runs of {args.batches} "
          f"batches of {BATCH}: {', '.join(f'{r:.2f}' for r in rates)} "
          f"images/s (median {statistics.median(rates):.2f}) on {smi}")
    result["stage_ms"] = stage_times(pipe, tiles[:BATCH])
    for name, s in result["stage_ms"].items():
        print(f"stage {name}: median {s['median']:.4f} ms "
              f"(min {s['min']:.4f}, max {s['max']:.4f})")
    result["ccl_slice_masks"] = ccl_on_slice_masks(pipe, tiles[:BATCH])
    print(f"CCL on the slice's masks: {result['ccl_slice_masks']}")
    result["trace"] = device_trace(pipe, tiles[:5 * BATCH],
                                   out / "slice_trace.json.gz")
    tr = result["trace"]
    print(f"trace of {tr['batches']} batches under torch.profiler: device "
          f"busy {tr['busy_ms']:.2f} ms of a {tr['span_ms']:.2f} ms span, "
          f"idle share {tr['idle_share']:.3f}, "
          f"{tr['kernels_per_batch']:.0f} kernels per batch")
    total = sum(tr["busy_ms_by_category"].values())
    for cat, ms in tr["busy_ms_by_category"].items():
        print(f"  {cat}: {ms:.3f} ms ({ms / total:.3f} of the device "
              f"events' summed time)")
    (out / "profile_slice.json").write_text(json.dumps(result, indent=1))
    print(smi)


if __name__ == "__main__":
    main()
