#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (mapping_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with an NVIDIA Hopper
card, the CUDA toolkit (nvcc) and PyTorch built for CUDA; neither JAX nor
the JAX package is imported. Phases, each printing what it found:

  1. the card: refuses to run without CUDA; prints the card's name and
     power limit as nvidia-smi gives them;
  2. build: compiles mapping_tpu_torch/csrc/ccl.cu and conv_dw.cu for
     sm_90a into build/, one nvcc per source, started together (and the
     parent tree's sources when a copy of it lies under build/old/); fails
     if `-Xptxas -v` reports a spill;
  3. kernels: the CUDA CCL kernels against their plain PyTorch versions
     and scipy.ndimage.label, exact, on test cases and serving shapes, then
     times at (20, 300, 300): kernel, plain, torch.unique's inverse as a
     yardstick for the renumbering, and the parent tree's kernels where
     present;
  4. slice: a ResNet101 UNetPipeline (32 filters, deconv, BN folded,
     bfloat16, random weights from a seeded torch.Generator) serves 3
     batches of 20 uint8 300^2 tiles through `transform`; the CCL launch
     counts of that run must be above 0, the kernel path must equal the
     plain path on the same probabilities, a float32 pipeline on the card
     must agree with a float32 forward on the CPU, and one batch of dense
     probabilities must go through the overflow escalation;
  5. conv_dw: the CUDA filter-gradient kernel against its plain PyTorch
     version (max |kernel - plain| <= 1e-4 max |plain|) on k = 3 with
     C = 32, 64, 128, k = 5, a batch of 1, H != W and an all-zero dy, and
     bit-identical on a rerun; then kernel, cuDNN's weight gradient and
     plain times at the dW probe's shapes, (64, 32, 256, 256) and
     (64, 64, 128, 128), and the train step's dec0.conv (20, 32, 256, 256)
     and dec1.block.0.conv (20, 128, 128, 128), with the parent tree's
     kernel where present;
  6. train: a ResNet101 UNetTrainer at the JAX config's defaults (bf16,
     batch 20, 256^2, weighted loss, Adam with L2 on conv kernels) with
     seeded random weights fits one epoch of augmented 300^2 tiles; the
     losses must be finite, and must fall over 5 steps on one batch
     repeated; one float32 step on the card must match one on the CPU;
     the dW kernel, run by the dW probe on the input and output gradient
     of dec0.conv and dec1.block.0.conv captured in a bf16 step, must
     match the plain version and autograd's weight gradient; the trained
     weights serve one batch through the pipeline. The kernels' launch
     counts are read from that run;
  7. evaluate: a CrowdAI-style val split of 110 synthetic 300^2 tiles
     (tests/fixtures/synthetic.py `_make_image`, up to 20 buildings), PNG
     written with the standard library, and its COCO annotation.json, under
     build/chip_smoke_evaluate/. Seeded random ResNet101 weights saved with
     torch.save come in through `import_checkpoint`; then the CLI
     (`python3 -m mapping_tpu_torch.main`) runs `evaluate -p unet_weighted`
     at the JAX config's defaults in a subprocess, and in this process
     evaluate at the defaults, with erosion 3 and dilation 2, with the
     crop_and_pad loader and reflect padding, and predict_on_dir. Every
     run must write a prediction.json of 300^2 masks for the 110 images
     (the duplicated tail images dropped), AP/AR in [0, 1], and launch the
     CCL kernels (twice as often with erosion on). The postprocess with
     erosion and dilation must give the same labels, areas and scores
     through the kernels as through the plain CCL on the same
     probabilities, and the split's ground truth scored as predictions
     must give AP = AR = 1. Prints the default run's images/s and its
     seconds in decode, on the device, in annotation + RLE and in COCOeval
     (host clock).

Kernel and cuDNN times are device times: the call is captured once in a
CUDA graph and the graph replayed between CUDA events, so the host's launch
overhead is not in them. Plain versions and torch.unique (which read
results back to the host) are timed as calls back to back between CUDA
events. Every comparison runs in turns (a, b, b, a) in this one process.

Prints one JSON line on the kernels (time, plain time, bound and what sets
it, library time), then as its last line {"ok": true, "device": {...}}.
Any failure raises: the exit code is not 0 and no result is printed.
"""

import json
import math
import re
import shutil
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_BATCHES, BATCH, TILE = 3, 20, 300
DEVICE = "cuda"
SOURCES = {"ccl_label_raw": "mapping_tpu_torch/csrc/ccl.cu",
           "ccl_renumber": "mapping_tpu_torch/csrc/ccl.cu",
           "conv_dw": "mapping_tpu_torch/csrc/conv_dw.cu"}
REPLACES = {"ccl_label_raw": "mapping_tpu/ops/ccl_pallas.py:127",
            "ccl_renumber": "mapping_tpu/ops/ccl_pallas.py:141",
            "conv_dw": "tools/dw_probe.py:70"}
TRAIN_SIZE, TRAIN_STEPS = (256, 256), 5
#: NCHW shapes K3 is timed at: the JAX dW probe's two (tools/dw_probe.py)
#: and the default train step's dec0.conv and dec1.block.0.conv
DW_TIMED = {"probe C=32": (64, 32, 256, 256), "probe C=64": (64, 64, 128, 128),
            "dec0.conv": (20, 32, 256, 256),
            "dec1.block.0.conv": (20, 128, 128, 128)}
DW_MAIN = "dec0.conv"  # the shape of the kernels line
DW_TOL, DW_AUTOGRAD_TOL = 1e-4, 2e-2
#: a copy of the parent tree (git archive) to time the kernels against
OLD_TREE = ROOT / "build" / "old"
EVAL_TILES = 110  # 5 full batches of 20 and a ragged tail of 10
EVAL_DIR = ROOT / "build" / "chip_smoke_evaluate"
#: parameters of phase 7 over the JAX config's defaults (ResNet101, bf16,
#: batch 20, 300^2 -> 256^2 -> 300^2)
EVAL_PARAMS = {}
EVAL_DEPTH = 101


def card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA card")
    if not (ROOT / "mapping_tpu_torch").is_dir():
        raise SystemExit(f"chip_smoke: no mapping_tpu_torch package beside "
                         f"{Path(__file__).name}; run it from a checkout")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return line


def ccl_cases(gen):
    """name -> (N, H, W) bool mask on the card."""
    def noise(n, h, w, density):
        return torch.rand((n, h, w), generator=gen) < density

    rects = torch.zeros((2, 48, 48), dtype=torch.bool)
    for b in range(2):
        for _ in range(6):
            y, x = torch.randint(0, 38, (2,), generator=gen).tolist()
            h, w = torch.randint(3, 12, (2,), generator=gen).tolist()
            rects[b, y:y + h, x:x + w] = True
    spiral = torch.zeros((1, 32, 32), dtype=torch.bool)
    spiral[0, 2, 2:30] = True
    spiral[0, 2:30, 29] = True
    spiral[0, 29, 4:30] = True
    spiral[0, 6:30, 4] = True
    spiral[0, 6, 4:26] = True
    dots = torch.zeros((2, TILE, TILE), dtype=torch.bool)
    dots[:, ::2, ::2] = True  # 22,500 single-pixel components per image
    snake = torch.zeros((1, TILE, TILE), dtype=torch.bool)
    snake[0, ::2] = True  # one 45,150-pixel path: rows joined at alternate ends
    snake[0, 1::4, -1] = True
    snake[0, 3::4, 0] = True
    cases = {
        "rects": rects, "noise48": noise(1, 48, 48, 0.45), "spiral": spiral,
        "empty16": torch.zeros((1, 16, 16), dtype=torch.bool),
        "full16": torch.ones((1, 16, 16), dtype=torch.bool),
        **{f"batch20_d{d}": noise(BATCH, TILE, TILE, d)
           for d in (0.3, 0.5, 0.7)},
        "noise304": noise(2, 304, 304, 0.5),
        "nonsquare": noise(3, 40, 57, 0.55),
        "wide": noise(2, 120, 333, 0.6),
        "empty20": torch.zeros((BATCH, TILE, TILE), dtype=torch.bool),
        "full20": torch.ones((BATCH, TILE, TILE), dtype=torch.bool),
        "dots": dots, "snake": snake,
    }
    return {k: v.to(DEVICE) for k, v in cases.items()}


def cuda_ms(fn, reps):
    """ms per call of `reps` calls back to back between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Device ms per call: `fn` captured once in a CUDA graph (after one
    call outside it), the graph replayed `reps` times between events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    return cuda_ms(graph.replay, reps)


def in_turns(fns, timer, reps):
    """{name: (first, second)}: the timings in the order a, b, ..., b, a."""
    order = list(fns) + list(fns)[::-1]
    got = {name: [] for name in fns}
    for name in order:
        got[name].append(timer[name](fns[name], reps[name]))
    return {name: tuple(v) for name, v in got.items()}


def old_kernels():
    """Callables of the parent tree's K2 and K3 from the copy under
    OLD_TREE, built in build_phase, or {} when there is no copy."""
    import ctypes
    import importlib.util

    from mapping_tpu_torch.kernels import build

    if not (OLD_TREE / "mapping_tpu_torch" / "csrc").is_dir():
        return {}
    csrc = OLD_TREE / "mapping_tpu_torch" / "csrc"
    libs = build.build_shared_libraries(
        {"old_ccl": [csrc / "ccl.cu"], "old_conv_dw": [csrc / "conv_dw.cu"]})
    ccl = ctypes.CDLL(str(libs["old_ccl"].path))
    ccl.ccl_renumber.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    dw = ctypes.CDLL(str(libs["old_conv_dw"].path))
    dw.conv_dw_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    spec = importlib.util.spec_from_file_location(
        "old_conv_dw", OLD_TREE / "mapping_tpu_torch" / "kernels" /
        "conv_dw.py")
    old_plan = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old_plan)

    def renumber(labels):
        n, h, w = labels.shape
        rank, out = torch.empty_like(labels), torch.empty_like(labels)
        err = ccl.ccl_renumber(labels.data_ptr(), rank.data_ptr(),
                               out.data_ptr(), n, h, w,
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old ccl_renumber: error {err}")
        return out

    def conv_dw(x, dy, k):
        n, c, h, w = x.shape
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rows, fpw, _, slices, _ = old_plan.plan(n, h, w, c, k, sms)
        partial = torch.empty((slices, k * k * c * c), dtype=torch.float32,
                              device=x.device)
        out = torch.empty((c, c, k, k), dtype=torch.float32, device=x.device)
        err = dw.conv_dw_bf16(x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                              out.data_ptr(), n, h, w, c, k, rows, fpw, slices,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old conv_dw: error {err}")
        return out

    return {"ccl_renumber": renumber, "conv_dw": conv_dw}


def kernel_phase(gen):
    from scipy import ndimage

    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.ops.ccl import _label_raw, _renumber

    err = {"ccl_label_raw": 0, "ccl_renumber": 0}
    for name, m in ccl_cases(gen).items():
        h, w = m.shape[-2:]
        raw_k = K.label_raw(m)
        ren_k = K.renumber(raw_k)
        raw_p = _label_raw(m, h + w)
        ren_p = _renumber(raw_p)
        ren_from_plain = K.renumber(raw_p)
        torch.cuda.synchronize()
        e_raw = int((raw_k.long() - raw_p.long()).abs().max())
        e_ren = max(int((ren_k.long() - ren_p.long()).abs().max()),
                    int((ren_from_plain.long() - ren_p.long()).abs().max()))
        ren_np, m_np = ren_k.cpu().numpy(), m.cpu().numpy()
        n_comp = [ndimage.label(m_np[b])[1] for b in range(m_np.shape[0])]
        scipy_ok = all(np.array_equal(ren_np[b], ndimage.label(m_np[b])[0])
                       for b in range(m_np.shape[0]))
        print(f"kernel case {name} {tuple(m.shape)}: components max "
              f"{max(n_comp)}, |raw kernel - plain| {e_raw}, "
              f"|renumber kernel - plain| {e_ren}, scipy equal {scipy_ok} "
              f"(tolerance: exact)")
        if e_raw or e_ren or not scipy_ok:
            raise AssertionError(f"CCL kernel disagrees on case {name}")
        err["ccl_label_raw"] = max(err["ccl_label_raw"], e_raw)
        err["ccl_renumber"] = max(err["ccl_renumber"], e_ren)

    # times at the serving shape, in turns
    m = (torch.rand((BATCH, TILE, TILE), generator=gen) < 0.5).to(DEVICE)
    raw = K.label_raw(m)
    offset = (torch.arange(BATCH, device=DEVICE, dtype=torch.int32)
              * (TILE * TILE + 1)).view(-1, 1, 1)
    shifted = raw + offset  # labels of all images in one numbering
    old = old_kernels().get("ccl_renumber")
    if old is not None and not torch.equal(old(raw), K.renumber(raw)):
        raise AssertionError("the parent tree's ccl_renumber disagrees")
    runs = {
        "ccl_label_raw": {"plain": lambda: _label_raw(m, 2 * TILE),
                          "kernel": lambda: K.label_raw(m)},
        "ccl_renumber": {"plain": lambda: _renumber(raw),
                         "torch.unique": lambda: torch.unique(
                             shifted, sorted=True, return_inverse=True),
                         "kernel": lambda: K.renumber(raw),
                         **({"parent kernel": lambda: old(raw)} if old else {})},
    }
    timer = {"plain": cuda_ms, "torch.unique": cuda_ms, "kernel": graph_ms,
             "parent kernel": graph_ms}
    reps = {"plain": 5, "torch.unique": 20, "kernel": 100, "parent kernel": 100}
    times = {}
    for name, fns in runs.items():
        got = in_turns(fns, timer, reps)
        lib = got.get("torch.unique")
        times[name] = (sum(got["kernel"]) / 2, sum(got["plain"]) / 2,
                       None if lib is None else sum(lib) / 2)
        print(f"time {name} (20, 300, 300) density 0.5: " + ", ".join(
            f"{what} {a:.4f} / {b:.4f} ms" for what, (a, b) in got.items())
            + ("" if old else "; no parent tree under build/old"))
    return err, times

def random_model(depth, gen):
    """UNetResNet weights from `gen`: He-normal convs (the last conv of
    each residual branch scaled by 0.2, so that the residual stream does
    not double per block), small biases, BN affine parameters and running
    statistics randomised. Each transposed conv is a random channel mix
    times the bilinear 4x4 kernel: random 4x4 taps would print a
    checkerboard on the output, and thresholding that gives thousands of
    one-pixel instances per tile instead of blobs."""
    from mapping_tpu_torch.models.unet_resnet import UNetResNet

    model = UNetResNet(depth)
    tap = torch.tensor([1.0, 3.0, 3.0, 1.0]) / 4
    with torch.no_grad():
        for name, p in model.named_parameters():
            mod = model.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(mod, torch.nn.ConvTranspose2d) and p.dim() == 4:
                mix = torch.randn(p.shape[:2], generator=gen)
                p.copy_(mix[..., None, None] * torch.outer(tap, tap)
                        * math.sqrt(2.0 / p.shape[0]))
            elif p.dim() == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                gain = 0.2 if name.endswith("conv3.weight") else 1.0
                p.copy_(torch.randn(p.shape, generator=gen)
                        * gain * math.sqrt(2.0 / fan_in))
            elif ".bn" in name or ".downsample.1." in name:
                base = 1.0 if name.endswith("weight") else 0.0
                p.copy_(base + 0.1 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(0.01 * torch.randn(p.shape, generator=gen))
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.num_features
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                mod.running_var.copy_(0.75 + 0.5 * torch.rand(c, generator=gen))
    return model


def centre_logits(model, images):
    """Rescale the final conv so that the class logit difference over
    `images` has mean 0 and standard deviation 4: about half the pixels
    are foreground and probabilities do not saturate."""
    model = model.to(DEVICE).eval()
    with torch.no_grad():
        logits = model(images.permute(0, 3, 1, 2))
        diff = logits[:, 1] - logits[:, 0]
        centre, scale = diff.mean(), 4.0 / diff.std()
        w, b = model.final.weight, model.final.bias
        w[1] = w[0] + scale * (w[1] - w[0])
        b[1] = b[0] + scale * (b[1] - b[0] - centre)
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def make_tiles(gen, n):
    """n blobby uint8 (TILE, TILE, 3) tiles: upsampled low-res noise."""
    low = torch.rand((n, 3, 19, 19), generator=gen)
    return (torch.nn.functional.interpolate(
        low, size=(TILE, TILE), mode="bilinear", align_corners=False)
        * 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous().numpy()


def pipeline(params, state=None, device=None):
    """The port's unet_weighted inference pipeline for the JAX parameter
    dict `params` (defaults from the JAX config), serving `state`."""
    from mapping_tpu_torch.config import build_config
    from mapping_tpu_torch.pipelines import PIPELINES

    config = build_config(overrides={**params, "device": device or DEVICE})
    pipe = PIPELINES["unet_weighted"]["inference"](config)
    return pipe if state is None else pipe.set_weights(state)


def probs_of(pipe, tiles_u8):
    """Softmax probabilities of the pipeline's forward on uint8 tiles."""
    return pipe.trainer.probs_apply_fn()(pipe.loader.infer_preprocess(tiles_u8))


def serving_pipeline(gen, probe_tiles):
    """The slice's pipeline: ResNet101, 32 filters, deconv, bf16, batch
    BATCH, random weights from `gen` with logits centred on `probe_tiles`.
    Returns (pipeline, params, state)."""
    from mapping_tpu_torch.data.loader import infer_batch_resize

    params = {"encoder": "ResNet101", "model_dtype": "bfloat16",
              "batch_size_inference": BATCH}
    probe = infer_batch_resize(torch.from_numpy(probe_tiles).to(DEVICE),
                               (256, 256))
    state = centre_logits(random_model(101, gen), probe)
    return pipeline(params, state), params, state


def slice_phase(gen, smi):
    from mapping_tpu_torch.data.augment import resize_bilinear
    from mapping_tpu_torch.infer.postprocess import fused_postprocess
    from mapping_tpu_torch.infer.serving import FusedServe
    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.ops.ccl import _label_raw, _renumber
    from mapping_tpu_torch.ops.instance import instance_areas_and_prob_sums

    tiles = make_tiles(gen, N_BATCHES * BATCH)
    pipe, params, state = serving_pipeline(gen, tiles[:BATCH])

    list(pipe.transform_arrays(tiles[:BATCH]))  # warm-up: cuDNN, allocator
    torch.cuda.synchronize()
    K.reset_launches()
    start = time.perf_counter()
    rows = list(pipe.transform_arrays(tiles))
    seconds = time.perf_counter() - start
    launches = dict(K.LAUNCHES)
    print(f"slice: ResNet101 bf16, {N_BATCHES} batches of {BATCH} tiles "
          f"{TILE}^2 in {seconds:.4f} s: {seconds / N_BATCHES:.4f} s/batch, "
          f"{len(rows) / seconds:.2f} images/s on {smi}")
    print(f"slice: CCL launches in that run {launches}")
    if len(rows) != N_BATCHES * BATCH:
        raise AssertionError(f"transform yielded {len(rows)} images")
    if min(launches.values()) < 1:
        raise AssertionError("the slice did not go through the CCL kernels")
    n_inst = [len(trimmed[1]) for _, trimmed in rows]
    for lab, trimmed in rows:
        if lab.shape != (2, TILE, TILE) or lab[0].any():
            raise AssertionError(f"bad labels {lab.shape}")
        if not np.isfinite(trimmed[1]).all() or min(trimmed[1], default=1) <= 0:
            raise AssertionError("scores must be finite and positive")
    print(f"slice: instances per image min {min(n_inst)} max {max(n_inst)}")
    if max(n_inst) == 0:
        raise AssertionError("no instances at all")

    # kernel path vs plain path on the same probabilities
    post = dict(target_size=(TILE, TILE), category_layers=(1, 1),
                active_layers=(1,))
    probs = probs_of(pipe, tiles[:BATCH])
    labels, scores, areas = fused_postprocess(probs, **post)
    layer = resize_bilinear(probs, (TILE, TILE))[..., 1]
    plain = _renumber(_label_raw(layer > 0.5, 2 * TILE))
    p_areas, p_sums = instance_areas_and_prob_sums(plain, layer, 256)
    p_areas, p_sums = p_areas[:, 1:], p_sums[:, 1:]
    p_scores = torch.where(
        p_areas > 0,
        p_sums / p_areas.clamp(min=1).float() * p_areas.float().sqrt(), 0.0)
    if not (torch.equal(labels[:, 1], plain)
            and torch.equal(areas[:, 1], p_areas)
            and torch.allclose(scores[:, 1], p_scores, rtol=1e-6, atol=0)):
        raise AssertionError("kernel path differs from the plain path")
    print(f"slice: kernel path = plain path on batch 0 "
          f"({int(plain.amax())} instances max)")

    # float32 on the card vs float32 on the CPU, 2 images
    params32 = {**params, "model_dtype": "float32"}
    p_card = probs_of(pipeline(params32, state), tiles[:2]).cpu()
    p_cpu = probs_of(pipeline(params32, state, device="cpu"), tiles[:2])
    p_bf16 = probs[:2].cpu()
    err32 = float((p_card - p_cpu).abs().max())
    print(f"slice: float32 probabilities card vs CPU max |diff| {err32:.3e}; "
          f"bf16 vs float32 CPU max |diff| "
          f"{float((p_bf16 - p_cpu).abs().max()):.3e}")
    if not err32 < 1e-3:
        raise AssertionError("float32 forward on the card disagrees with CPU")

    # overflow escalation through FusedServe.collect
    p1 = torch.zeros((2, TILE, TILE))
    p1[0, ::6, ::6] = 1.0  # 2,500 components: pad 256 -> 4096
    p1[1, ::3, ::3] = 1.0  # 10,000 components: past the 4096 ceiling
    dense = torch.stack([1 - p1, p1], dim=-1).to(DEVICE)
    serve = FusedServe(lambda x: x, **post)
    labels_o, scores_o, areas_o = serve(dense)
    counts = labels_o[:, 1].max(axis=(1, 2))
    print(f"overflow: components {counts.tolist()}, instance pad "
          f"{scores_o.shape[-1]}, first image's instances all scored "
          f"{bool((areas_o[0, 1, :2500] == 1).all())}")
    if scores_o.shape[-1] != 4096 or counts.tolist() != [2500, 10000] \
            or not (areas_o[0, 1, :2500] == 1).all() \
            or (areas_o[0, 1, 2500:] != 0).any():
        raise AssertionError("overflow escalation did not run as expected")
    return launches


def build_phase():
    from mapping_tpu_torch.kernels import build, ccl, conv_dw

    specs = {k.LIBRARY: k.SOURCES for k in (ccl, conv_dw)}
    if (OLD_TREE / "mapping_tpu_torch" / "csrc").is_dir():
        csrc = OLD_TREE / "mapping_tpu_torch" / "csrc"
        specs.update(old_ccl=[csrc / "ccl.cu"],
                     old_conv_dw=[csrc / "conv_dw.cu"])
    for name, built in build.build_shared_libraries(specs).items():
        print(f"build: {built.path.name} in {built.seconds:.2f} s")
        for line in built.log.splitlines():
            print(f"build: {line}")
            spill = re.search(r"(\d+) bytes spill stores", line)
            if spill and int(spill.group(1)) and not name.startswith("old"):
                raise AssertionError(f"{name}: ptxas reports a spill: {line}")


def conv_dw_phase():
    from mapping_tpu_torch.kernels import conv_dw as K
    from mapping_tpu_torch.ops.conv_dw import conv_dw_plain
    from mapping_tpu_torch.tools.dw_probe import dw_cudnn

    gen = torch.Generator(device=DEVICE).manual_seed(5)

    def randn(shape, channels_last=True):
        t = torch.randn(shape, generator=gen, device=DEVICE,
                        dtype=torch.bfloat16)
        return t.contiguous(memory_format=torch.channels_last) \
            if channels_last else t

    cases = {  # name -> (x shape, k)
        "k3_c32": ((8, 32, 64, 64), 3), "k3_c64": ((8, 64, 64, 64), 3),
        "k3_c128": ((4, 128, 32, 32), 3), "k5_c32": ((4, 32, 40, 40), 5),
        "batch1": ((1, 32, 256, 256), 3), "h_ne_w_nchw": ((3, 32, 37, 300), 3),
        "zero_dy": ((2, 32, 64, 64), 3)}
    max_err = 0.0
    for name, (shape, k) in cases.items():
        x = randn(shape, channels_last=name != "h_ne_w_nchw")
        dy = torch.zeros_like(x) if name == "zero_dy" else randn(
            shape, channels_last=name != "h_ne_w_nchw")
        got, again = K.conv_dw(x, dy, k), K.conv_dw(x, dy, k)
        want = conv_dw_plain(x, dy, k)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"conv_dw case {name} x {tuple(shape)} k {k}: max |kernel - "
              f"plain| {err:.3e}, max |plain| {scale:.3e}, rerun "
              f"bit-identical {torch.equal(got, again)} (tolerance "
              f"{DW_TOL} max |plain|)")
        if not err <= DW_TOL * scale or not torch.equal(got, again):
            raise AssertionError(f"conv_dw disagrees on case {name}")
        max_err = max(max_err, err)

    # times at the probe's and the train step's shapes, in turns
    old = old_kernels().get("conv_dw")
    timer = {"plain": cuda_ms, "cuDNN": graph_ms, "kernel": graph_ms,
             "parent kernel": graph_ms}
    reps = {"plain": 3, "cuDNN": 20, "kernel": 20, "parent kernel": 20}
    times = {}
    for label, shape in DW_TIMED.items():
        x, dy = randn(shape), randn(shape)
        fns = {"plain": lambda: conv_dw_plain(x, dy, 3),
               "cuDNN": lambda: dw_cudnn(x, dy, 3),
               "kernel": lambda: K.conv_dw(x, dy, 3),
               **({"parent kernel": lambda: old(x, dy, 3)} if old else {})}
        want = fns["plain"]()
        err = float((fns["kernel"]() - want).abs().max())
        if not err <= DW_TOL * float(want.abs().max()):
            raise AssertionError(f"conv_dw disagrees at {shape}")
        max_err = max(max_err, err)
        got = in_turns(fns, timer, reps)
        times[label] = (sum(got["kernel"]) / 2, sum(got["plain"]) / 2,
                        sum(got["cuDNN"]) / 2)
        print(f"time conv_dw {label} {shape} k 3 bf16: " + ", ".join(
            f"{what} {a:.4f} / {b:.4f} ms" for what, (a, b) in got.items())
            + f"; max |kernel - plain| {err:.3e}"
            + ("" if old else "; no parent tree under build/old"))
    return max_err, times[DW_MAIN]


def stand_in_targets(tiles):
    """[mask, distance, sqrt(size)] uint16 targets of the tiles' bright
    blobs, made on the host with scipy (component sizes from
    ndimage.label, distance to the nearest blob from
    distance_transform_edt), in the JAX loader's uint16 format. A stand-in
    until prepare_masks is ported (ROADMAP Slice C)."""
    from scipy import ndimage

    out = np.zeros(tiles.shape[:3] + (3,), np.uint16)
    for i, tile in enumerate(tiles):
        mask = tile.mean(-1) > 140
        labels, _ = ndimage.label(mask)
        sizes = np.bincount(labels.ravel())[labels] * mask
        out[i, ..., 0] = mask
        out[i, ..., 1] = ndimage.distance_transform_edt(~mask).astype(np.uint16)
        out[i, ..., 2] = np.sqrt(sizes).astype(np.uint16)
    return out


def trainer(model_dtype, state, device=None):
    """A UNetTrainer at the JAX config's defaults (mapping_tpu/config.py:
    ResNet101, 32 filters, deconv, 2 classes, weighted loss w0 50, sigma
    10, dice 0.2 softmax with smooth 1, CE 1.0, Adam lr 5e-4 with L2 1e-4
    on conv kernels, flat rate) holding the weights `state`."""
    from mapping_tpu_torch.train.trainer import UNetTrainer

    t = UNetTrainer(
        model_params={"encoder": "ResNet101", "dtype": model_dtype},
        optimizer_params={"lr": 5e-4, "gamma": 1.0, "weight_decay": 1e-4},
        loss_params={"w0": 50, "sigma": 10, "imsize": TRAIN_SIZE,
                     "dice_weight": 0.2, "bce_weight": 1.0, "smooth": 1,
                     "dice_activation": "softmax"},
        training_config={"epochs": 1, "steps_per_call": 1},
        input_size=TRAIN_SIZE, device=device or DEVICE)
    t.model.load_state_dict(state)
    return t


def train_phase(gen, smi):
    from mapping_tpu_torch.data.loader import (in_memory_train_flow,
                                               train_batch_resize)
    from mapping_tpu_torch.kernels import ccl, conv_dw
    from mapping_tpu_torch.ops.conv_dw import conv_dw_plain
    from mapping_tpu_torch.tools.dw_probe import train_step_dw

    tiles = make_tiles(gen, (TRAIN_STEPS + 1) * BATCH)
    targets = stand_in_targets(tiles)
    print(f"train: targets are a host stand-in (scipy ndimage.label sizes, "
          f"distance_transform_edt distances) until prepare_masks is ported; "
          f"foreground share {targets[..., 0].mean():.3f}")
    state = random_model(101, gen).state_dict()
    tr = trainer("bfloat16", state)

    def batch(lo, hi):
        return train_batch_resize(
            None, torch.from_numpy(tiles[lo:hi]).to(DEVICE),
            torch.from_numpy(targets[lo:hi]).to(DEVICE), TRAIN_SIZE,
            augment=False)

    one = batch(0, BATCH)
    tr.fit(([one], 1))  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    ccl.reset_launches()
    conv_dw.reset_launches()
    # the slice: one epoch of augmented batches, the dW probe on one bf16
    # step's tensors, and serving with the trained weights
    flow = in_memory_train_flow(tiles[BATCH:], targets[BATCH:], BATCH,
                                TRAIN_SIZE, torch.Generator().manual_seed(1),
                                device=DEVICE)
    start = time.perf_counter()
    tr.fit(flow)
    seconds = time.perf_counter() - start
    losses = tr.train_losses
    captured = train_step_dw(tr, one, ["dec0.conv", "dec1.block.0.conv"])
    pipe = pipeline({"encoder": "ResNet101", "model_dtype": "bfloat16",
                     "batch_size_inference": BATCH}, tr.state_dict())
    rows = list(pipe.transform_arrays(tiles[:BATCH]))
    torch.cuda.synchronize()
    launches = {**ccl.LAUNCHES, **conv_dw.LAUNCHES}
    print(f"train: ResNet101 bf16, {len(losses)} steps of {BATCH} tiles "
          f"300^2 -> {TRAIN_SIZE[0]}^2 with augmentation in {seconds:.4f} s: "
          f"{1e3 * seconds / len(losses):.2f} ms/step, "
          f"{BATCH * len(losses) / seconds:.2f} images/s (the loss is read "
          f"back to the host after every step, included) on {smi}")
    print(f"train: losses {[round(l, 5) for l in losses]}")
    print(f"train: launches in that run {launches}")
    if len(losses) < TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"bad losses {losses}")
    if min(launches.values()) < 1:
        raise AssertionError("the slice did not go through every kernel")
    if len(rows) != BATCH or any(lab.shape != (2, TILE, TILE)
                                 for lab, _ in rows):
        raise AssertionError("the trained weights did not serve the batch")
    print(f"train: served {len(rows)} tiles with the trained weights, "
          f"instances per image max {max(len(t[1]) for _, t in rows)}")

    # the dW kernel on the step's own tensors
    for name, got in captured.items():
        plain = conv_dw_plain(got["x"], got["dy"], 3)
        scale = float(plain.abs().max())
        e_plain = float((got["kernel"] - plain).abs().max())
        e_auto = float((got["kernel"] - got["autograd"]).abs().max())
        print(f"train: conv_dw on {name} x {tuple(got['x'].shape)}: max "
              f"|kernel - plain| {e_plain:.3e}, max |kernel - autograd "
              f"(cuDNN bf16)| {e_auto:.3e}, max |plain| {scale:.3e} "
              f"(tolerances {DW_TOL} and {DW_AUTOGRAD_TOL} max |plain|)")
        if not (e_plain <= DW_TOL * scale and e_auto <= DW_AUTOGRAD_TOL * scale):
            raise AssertionError(f"conv_dw disagrees on {name}'s tensors")

    # the loss falls over 5 steps on one un-augmented batch repeated
    tr.fit(([one] * 5, 5))
    print(f"train: 5 steps on one batch, losses "
          f"{[round(l, 5) for l in tr.train_losses]}")
    if not tr.train_losses[-1] < tr.train_losses[0]:
        raise AssertionError("the loss did not fall on a repeated batch")

    # one float32 step on the card against one on the CPU, 2 tiles
    two = {k: v[:2] for k, v in batch(0, 2).items()}
    steps = {}
    for device in (DEVICE, "cpu"):
        t32 = trainer("float32", state, device)
        t32.fit(([{k: v.to(device) for k, v in two.items()}], 1))
        steps[device] = (t32.train_losses[0], t32.state_dict())
    (l_card, s_card), (l_cpu, s_cpu) = steps[DEVICE], steps["cpu"]
    e_stat = max(float((s_card[k] - s_cpu[k]).abs().max())
                 / float(s_cpu[k].abs().max()) for k in s_cpu if "running" in k)
    print(f"train: float32 step card vs CPU: loss {l_card:.6f} vs "
          f"{l_cpu:.6f} (relative {abs(l_card - l_cpu) / abs(l_cpu):.3e}, "
          f"tolerance 1e-4), BatchNorm running statistics max |diff| "
          f"{e_stat:.3e} of each tensor's max (tolerance 1e-3)")
    if not (abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu) and e_stat <= 1e-3):
        raise AssertionError("float32 train step on the card disagrees")
    return launches


def write_png(path, rgb):
    """(H, W, 3) uint8 as an 8-bit RGB PNG without row filters."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                  0, 0))
                     + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                     + chunk(b"IEND", b""))


def write_val_split(root, n, seed):
    """n synthetic CrowdAI-style 300^2 tiles (up to 20 buildings each) as
    root/val/images/*.png with root/val/annotation.json; returns them."""
    import importlib.util

    # by path: an installed package named `tests` may shadow the repo's
    spec = importlib.util.spec_from_file_location(
        "synthetic_fixture", ROOT / "tests" / "fixtures" / "synthetic.py")
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    rng = np.random.RandomState(seed)
    images = root / "val" / "images"
    images.mkdir(parents=True)
    dataset = {"images": [], "annotations": [], "categories": [
        {"id": 100, "name": "building", "supercategory": "building"}]}
    tiles = []
    for i in range(n):
        tile, anns = fixture._make_image(rng, h=TILE, w=TILE,
                                         max_buildings=20)
        name = f"val_{i:05d}.png"
        write_png(images / name, tile)
        tiles.append(tile)
        dataset["images"].append({"id": i + 1, "file_name": name,
                                  "height": TILE, "width": TILE})
        for ann in anns:
            dataset["annotations"].append(
                {**ann, "id": len(dataset["annotations"]) + 1,
                 "image_id": i + 1})
    (root / "val" / "annotation.json").write_text(json.dumps(dataset))
    return np.stack(tiles)


def write_config(name, params):
    """A parameter file (neptune.yaml layout) of `params`."""
    path = EVAL_DIR / f"{name}.yaml"
    path.write_text("parameters:\n" + "".join(
        f"  {k}: {json.dumps(v)}\n" for k, v in params.items()))
    return str(path)


def check_prediction(path, image_ids, what):
    """prediction.json parses, holds 300^2 masks of the expected images,
    and finite scores; returns it."""
    prediction = json.loads(Path(path).read_text())
    if not prediction:
        raise AssertionError(f"{what}: empty prediction")
    for p in prediction:
        if p["segmentation"]["size"] != [TILE, TILE] \
                or p["image_id"] not in image_ids \
                or not math.isfinite(p["score"]):
            raise AssertionError(f"{what}: bad instance {p}")
    print(f"evaluate: {what}: {len(prediction)} instances on "
          f"{len({p['image_id'] for p in prediction})} images")
    return prediction


def last_scores(experiment):
    """(AP, AR) of the last evaluate, from metrics.jsonl."""
    lines = (experiment / "metrics.jsonl").read_text().splitlines()[-2:]
    scores = {json.loads(l)["channel"]: json.loads(l)["y"] for l in lines}
    ap, ar = scores["Precision"], scores["Recall"]
    if not (0.0 <= ap <= 1.0 and 0.0 <= ar <= 1.0):
        raise AssertionError(f"AP/AR out of range: {ap}, {ar}")
    return ap, ar


def evaluate_phase(gen, smi):
    from mapping_tpu_torch import main as cli
    from mapping_tpu_torch.data.augment import resize_bilinear
    from mapping_tpu_torch.data.coco import COCOIndex
    from mapping_tpu_torch.data.loader import infer_batch_resize, load_image
    from mapping_tpu_torch.eval.cocoeval import coco_evaluation
    from mapping_tpu_torch.infer import postprocess
    from mapping_tpu_torch.kernels import ccl as K
    from mapping_tpu_torch.ops.ccl import _label_raw, _renumber
    from mapping_tpu_torch.utils import native_decode

    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    data, experiment = EVAL_DIR / "data", EVAL_DIR / "experiment"
    tiles = write_val_split(data, EVAL_TILES, seed=8)
    gt_path = data / "val" / "annotation.json"
    image_ids = set(range(1, EVAL_TILES + 1))
    if native_decode.available():
        print("evaluate: native decoder (cpp/decode.cpp, libjpeg + libpng) "
              "built; tiles are PNG")
    else:
        fake_jpeg = EVAL_DIR / "not_decodable.jpg"
        fake_jpeg.write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
        try:
            load_image(fake_jpeg)
        except RuntimeError as e:
            print(f"evaluate: native decoder unavailable here, PNG goes "
                  f"through the stdlib reader and JPEG raises: {e}")
        else:
            raise AssertionError("a JPEG decoded without the native decoder")

    base = {"data_dir": str(data), "meta_dir": str(EVAL_DIR / "meta"),
            "experiment_dir": str(experiment), "device": DEVICE,
            **EVAL_PARAMS}
    configs = {
        "default": write_config("default", base),
        "erode3_dilate2": write_config("erode3_dilate2", {
            **base, "erode_selem_size": 3, "dilate_selem_size": 2}),
        "crop_and_pad_reflect": write_config("crop_and_pad_reflect", {
            **base, "loader_mode": "crop_and_pad", "pad_method": "reflect"}),
    }
    probe = infer_batch_resize(torch.from_numpy(tiles[:BATCH]).to(DEVICE),
                               (256, 256))
    state = centre_logits(random_model(EVAL_DEPTH, gen), probe)
    checkpoint = EVAL_DIR / "reference.pth"
    torch.save(state, checkpoint)
    cli.main(["--config", configs["default"], "prepare_metadata", "-val"])
    cli.main(["--config", configs["default"], "import_checkpoint", "-p",
              "unet_weighted", "--path", str(checkpoint)])

    # the CLI as a user runs it
    start = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "mapping_tpu_torch.main", "--config",
         configs["default"], "evaluate", "-p", "unet_weighted"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise AssertionError(f"the CLI failed:\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
    print(f"evaluate: CLI subprocess `evaluate -p unet_weighted` exited 0 "
          f"in {time.perf_counter() - start:.2f} s; its log ends:")
    for line in out.stdout.strip().splitlines()[-4:]:
        print(f"evaluate:   {line}")
    check_prediction(experiment / "prediction.json", image_ids,
                     "CLI subprocess")
    print(f"evaluate: CLI subprocess AP/AR {last_scores(experiment)}")

    runs = {}
    for name in configs:
        torch.cuda.synchronize()
        K.reset_launches()
        manager = cli.main(["--config", configs[name], "evaluate", "-p",
                            "unet_weighted"])
        torch.cuda.synchronize()
        runs[name] = (manager.timings, dict(K.LAUNCHES))
        check_prediction(experiment / "prediction.json", image_ids, name)
        print(f"evaluate: {name}: AP/AR {last_scores(experiment)}, CCL "
              f"launches {runs[name][1]}, host seconds {manager.timings}")
    K.reset_launches()
    manager = cli.main(["--config", configs["default"], "predict_on_dir",
                        "-p", "unet_weighted", "--dir_path",
                        str(data / "val" / "images"), "--prediction_path",
                        str(EVAL_DIR / "predict_on_dir.json")])
    torch.cuda.synchronize()
    runs["predict_on_dir"] = (manager.timings, dict(K.LAUNCHES))
    check_prediction(EVAL_DIR / "predict_on_dir.json",
                     set(range(EVAL_TILES)), "predict_on_dir")
    print(f"evaluate: predict_on_dir: CCL launches {runs['predict_on_dir'][1]}")
    for name, (timings, launches) in runs.items():
        if timings["images"] != EVAL_TILES or min(launches.values()) < 1:
            raise AssertionError(f"{name}: {timings['images']} images, "
                                 f"launches {launches}")
    l_plain, l_erode = runs["default"][1], runs["erode3_dilate2"][1]
    if any(l_erode[k] != 2 * l_plain[k] for k in l_plain):
        raise AssertionError(f"erosion should double the CCL launches: "
                             f"{l_plain} -> {l_erode}")
    t = runs["default"][0]
    print(f"evaluate: default run, {t['images']} images in "
          f"{t['total_s']:.4f} s: {t['images'] / t['total_s']:.2f} images/s "
          f"end to end; decode {t['decode_s']:.4f} s (loader threads), "
          f"device (dispatch to collect) {t['device_s']:.4f} s, annotation "
          f"+ RLE {t['annotation_s']:.4f} s, COCOeval {t['cocoeval_s']:.4f} "
          f"s (host clock) on {smi}")

    # kernel path = plain path under erosion and dilation, on one batch's
    # probabilities resized to 300^2 on the card
    pipe = pipeline({"model_dtype": "bfloat16", **EVAL_PARAMS}, state)
    probs = resize_bilinear(probs_of(pipe, tiles[:BATCH]), (TILE, TILE))
    post = dict(target_size=(TILE, TILE), category_layers=(1, 1),
                active_layers=(1,), erode_size=3, dilate_size=2)
    kernel = postprocess.fused_postprocess(probs, **post)
    saved = postprocess.connected_components
    postprocess.connected_components = lambda mask: _renumber(
        _label_raw(mask != 0, mask.shape[-2] + mask.shape[-1]))
    try:
        plain = postprocess.fused_postprocess(probs, **post)
    finally:
        postprocess.connected_components = saved
    if not (torch.equal(kernel[0], plain[0]) and torch.equal(kernel[2],
                                                             plain[2])
            and torch.allclose(kernel[1], plain[1], rtol=1e-5, atol=0)):
        raise AssertionError("erode/dilate postprocess: kernel path differs "
                             "from the plain path")
    print(f"evaluate: erode 3 + dilate 2 postprocess, kernel path = plain "
          f"path on one batch ({int(kernel[0].amax())} instances max; labels "
          f"and areas exact, scores 1e-5 relative)")

    # the evaluator on the split's ground truth, written as predictions
    coco = COCOIndex(str(gt_path))
    dets = []
    for ann in coco.anns.values():
        rle = coco.ann_to_rle(ann)
        dets.append({"image_id": ann["image_id"], "category_id": 100,
                     "score": 1.0, "segmentation": {
                         "size": rle["size"],
                         "counts": rle["counts"].decode()}})
    gt_pred = EVAL_DIR / "ground_truth_as_prediction.json"
    gt_pred.write_text(json.dumps(dets))
    ap, ar = coco_evaluation(str(gt_path), str(gt_pred), coco.get_img_ids(),
                             [100], verbose=False)
    print(f"evaluate: ground truth as predictions ({len(dets)} instances): "
          f"AP {ap} AR {ar}")
    if not ap == ar == 1.0:
        raise AssertionError("ground truth as predictions must score 1")
    return {k: sum(launches[k] for _, launches in runs.values())
            for k in K.LAUNCHES}


def main():
    smi = card()
    from mapping_tpu_torch.kernels import bounds

    build_phase()
    gen = torch.Generator().manual_seed(0)
    err, times = kernel_phase(gen)
    launches = slice_phase(gen, smi)
    err["conv_dw"], times["conv_dw"] = conv_dw_phase()
    launches["conv_dw"] = train_phase(gen, smi)["conv_dw"]
    for name, n in evaluate_phase(gen, smi).items():
        launches[name] += n
    n, c, h, w = DW_TIMED[DW_MAIN]
    bound = {"ccl_label_raw": bounds.ccl_label_raw(BATCH, TILE, TILE),
             "ccl_renumber": bounds.ccl_renumber(BATCH, TILE, TILE),
             "conv_dw": bounds.conv_dw(n, c, h, w, 3)}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bound[name][0],
         "bound_by": bound[name][1], "library_ms": times[name][2]}
        for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
