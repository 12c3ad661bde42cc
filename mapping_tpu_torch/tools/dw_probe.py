"""Filter-gradient (dW) probe of the train step's small-channel convs.

Counterpart of tools/dw_probe.py, the entry point of the dW kernel
(kernels/conv_dw.py, which replaces that file's Pallas `_dw_kernel`).

    python3 -m mapping_tpu_torch.tools.dw_probe [--iters 12] [--batch 64]
    python3 -m mapping_tpu_torch.tools.dw_probe --step-profile [--batch 20]

On one CUDA card, for the JAX probe's shapes, (3,3,32,32) at batch x 256^2
and (3,3,64,64) at batch x 128^2 in bfloat16, it times with CUDA events:

  cudnn     torch's conv weight gradient, what the port's train step runs
            (in place of the JAX probe's `xla`)
  pad_co    the same cuDNN call with dy's channels zero-padded to 128
  pad_cico  the same with both channel counts padded to 128
  plain     ops/conv_dw.conv_dw_plain (float32 matmuls, one per tap)
  kernel    the CUDA kernel; the JAX probe's `pallas` and `pallas9` are two
            designs of the one kernel the port has

and prints one line per (shape, variant): ms per call, TFLOP/s (2 N H W k^2
C^2 operations) and rel_err, max |variant - cudnn| / max |cudnn| (the JAX
probe's measure against what its train step runs), then a JSON list.

`train_step_dw` runs the kernel on the tensors of a real train step: the
input and output gradient of named convs, captured in one `fit` step.

`--step-profile` traces 3 train steps of the default UNetTrainer
(ResNet101, bfloat16, 256^2, seeded weights, random inputs) under
torch.profiler and prints the device time per step, the share of it in
cuDNN's weight-gradient kernels (names holding "wgrad"), the kernels per
step, the peak device memory and the 12 longest kernels by total time.
"""

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from mapping_tpu_torch.kernels.conv_dw import conv_dw
from mapping_tpu_torch.ops.conv_dw import conv_dw_plain

SHAPES = [(256, 32, 3), (128, 64, 3)]  # (H = W, C, k), the JAX probe's


def dw_cudnn(x, dy, k):
    c_in, c_out = x.shape[1], dy.shape[1]
    return torch.nn.grad.conv2d_weight(x, (c_out, c_in, k, k), dy,
                                       padding=k // 2)


def _pad_channels(t, to):
    return F.pad(t, (0, 0, 0, 0, 0, to - t.shape[1])).contiguous(
        memory_format=torch.channels_last)


def dw_pad_co(x, dy, k, pad_to=128):
    return dw_cudnn(x, _pad_channels(dy, pad_to), k)[:dy.shape[1]]


def dw_pad_cico(x, dy, k, pad_to=128):
    return dw_pad_co(_pad_channels(x, pad_to), dy, k, pad_to)[:, :x.shape[1]]


VARIANTS = {"cudnn": dw_cudnn, "pad_co": dw_pad_co, "pad_cico": dw_pad_cico,
            "plain": conv_dw_plain, "kernel": conv_dw}


def cuda_ms(fn, iters):
    """Median over 3 runs of the mean ms per call of `iters` back-to-back
    calls, between CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[1]


def train_step_dw(trainer, batch, names: Sequence[str]) -> Dict[str, dict]:
    """One optimizer step of `trainer` (UNetTrainer.fit over the single
    `batch`) with the input x and output gradient dy of each named 3x3
    conv captured; returns {name: {"x", "dy", "autograd" (the step's
    weight.grad, float32), "kernel" (conv_dw on x and dy)}}."""
    captured = {name: {} for name in names}
    handles = []

    def hook(name):
        def forward_hook(module, args, out):
            captured[name]["x"] = args[0].detach()
            out.register_hook(
                lambda g: captured[name].__setitem__("dy", g.detach()))
        return forward_hook

    for name in names:
        handles.append(
            trainer.model.get_submodule(name).register_forward_hook(hook(name)))
    try:
        trainer.fit(([batch], 1))
    finally:
        for handle in handles:
            handle.remove()
    for name in names:
        conv = trainer.model.get_submodule(name)
        got = captured[name]
        got["autograd"] = conv.weight.grad.detach().float()
        got["kernel"] = conv_dw(got["x"], got["dy"], conv.kernel_size[0])
    return captured


def step_profile(batch: int, steps: int = 3) -> dict:
    """Device kernel time of `steps` default train steps, by kernel name."""
    from mapping_tpu_torch.train.trainer import UNetTrainer

    trainer = UNetTrainer({"encoder": "ResNet101", "dtype": "bfloat16"},
                          {"lr": 5e-4, "weight_decay": 1e-4},
                          {"imsize": (256, 256)}, {"epochs": 1})
    gen = torch.Generator(device="cuda").manual_seed(0)
    image = torch.randn((batch, 256, 256, 3), generator=gen, device="cuda")
    mask = (image.mean(-1, keepdim=True) > 0).float()
    target = torch.cat([mask, 5 * (1 - mask), 8 * mask], dim=-1)
    one = {"image": image, "target": target}
    trainer.fit(([one] * 2, 2))  # warm-up
    torch.cuda.synchronize()
    start = time.perf_counter()
    trainer.fit(([one] * steps, steps))
    host_ms = 1e3 * (time.perf_counter() - start) / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=acts) as prof:
        trainer.fit(([one] * steps, steps))
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    by_name: Dict[str, float] = {}
    n_kernels = 0
    for e in events:
        if e.get("cat") == "kernel":
            n_kernels += 1
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    if not by_name:
        raise RuntimeError("the trace holds no kernels")
    total = sum(by_name.values())
    wgrad = sum(ms for name, ms in by_name.items() if "wgrad" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"batch": batch, "steps": steps,
            "host_ms_per_step_no_profiler": host_ms,
            "kernel_ms_per_step": total / steps,
            "kernels_per_step": n_kernels / steps,
            "peak_device_memory_gib": peak / 2 ** 30,
            "wgrad_ms_per_step": wgrad / steps, "wgrad_share": wgrad / total,
            "top_kernels_ms_per_step": {n: ms / steps for n, ms in top}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--batch", type=int, default=None,
                    help="64 for the probe shapes, 20 for --step-profile")
    ap.add_argument("--step-profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dw_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    if args.step_profile:
        result = step_profile(args.batch or 20)
        print(f"train step, batch {result['batch']}: "
              f"{result['host_ms_per_step_no_profiler']:.3f} ms/step on the "
              f"host clock (loss read back every step), device kernels "
              f"{result['kernel_ms_per_step']:.3f} ms/step, cuDNN wgrad "
              f"{result['wgrad_ms_per_step']:.3f} ms/step = share "
              f"{result['wgrad_share']:.4f}; "
              f"{result['kernels_per_step']:.0f} kernels per step, peak "
              f"device memory {result['peak_device_memory_gib']:.2f} GiB")
        print(json.dumps(result))
        return
    batch = args.batch or 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for h, c, k in SHAPES:
        def randn():
            return torch.randn((batch, c, h, h), generator=gen,
                               device="cuda", dtype=torch.bfloat16).contiguous(
                memory_format=torch.channels_last)

        x, dy = randn(), randn()
        gflop = 2 * batch * h * h * k * k * c * c / 1e9
        ref = dw_cudnn(x, dy, k).float()
        shape = f"({k},{k},{c},{c})@b{batch}x{h}"
        for name, fn in VARIANTS.items():
            got = fn(x, dy, k).float()
            err = float((got - ref).abs().max() / ref.abs().max())
            ms = cuda_ms(lambda: fn(x, dy, k), args.iters)
            results.append({"shape": shape, "variant": name, "ms": ms,
                            "tflops": gflop / ms, "rel_err": err})
            print(f"{shape:>24} {name:>9}: {ms:9.4f} ms "
                  f"{gflop / ms:7.2f} TFLOP/s  rel_err {err:.2e}", flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
