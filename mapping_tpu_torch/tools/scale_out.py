"""Data parallel across the cards of one machine: serving throughput, the
train step against one process, and the step time; with --spatial, one
large tile's rows split over the cards instead.

    python3 -m mapping_tpu_torch.tools.scale_out [--cards N] [--spatial]

Over the first N visible cards (default: all of them), seeded random
ResNet101 weights at the JAX config's defaults (bf16, batch 20, 256^2 in,
300^2 out), tiles and targets made on the host from a seed:
- serve: FusedServe (the BN-folded forward, softmax and the fused
  postprocess with the CUDA `label`) on one card at 20 images a batch and
  over the mesh of the N cards at N x 20: images/s (host clock, one batch
  in flight, after a warm-up), the host ms of `dispatch` (enqueueing every
  shard) and of `collect` per batch, and from a torch.profiler trace of a
  few mesh batches each card's kernel-busy ms per batch. Raises unless
  every image gets the one-card labels (a replica on another card runs
  a copy of the weights made there);
- step: one float64 step (dropout_2d 0.1) of the trainer on N ranks (one
  process per card, NCCL) against one process on the same global batch
  of 20 images: loss, the worst gradient (of its tensor's largest
  magnitude) and the running statistics; raises beyond GRAD_TOL and
  STAT_TOL;
- train: STEPS bf16 steps of 20 images per rank on the N ranks (global
  N x 20) beside one process at 20: ms/step and images/s (host clock,
  each loss read back);
- norm: on the first card alone, the bf16 step with the data-parallel
  step's global BatchNorm under a group of one rank (no communication)
  beside the plain step: ms/step, and the device time and device events
  of one more step under torch.profiler.
With --spatial, only this part:
- spatial: one SPATIAL_SIDE^2 tile of upsampled noise through FusedServe
  on one card and with `spatial=True` over the N cards (a band of rows
  each, the row exchange between them), ResNet101 bf16 with the logit
  difference centred on the tile: ms per tile (host clock, synchronised,
  after a warm-up), the exchange's bytes and largest transfer of one
  call, each card's kernel-busy ms per tile from a torch.profiler trace,
  and the labels against one card's: they may differ only at pixels whose
  one-card probability lies within max |p_spatial - p_one| of the
  threshold (raises otherwise, or where that band passes BAND_CEIL).
Prints one JSON line per part, then one with the card's name and power
limit.
"""

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from mapping_tpu_torch.config import build_config
from mapping_tpu_torch.constants import CATEGORY_IDS
from mapping_tpu_torch.data.loader import eval_batch_resize
from mapping_tpu_torch.infer.postprocess import active_layers_for
from mapping_tpu_torch.infer.serving import FusedServe
from mapping_tpu_torch.parallel import distributed
from mapping_tpu_torch.parallel.mesh import make_mesh, shard_batch
from mapping_tpu_torch.train.trainer import UNetTrainer

TILE = 300
ENCODER, SIZE, BATCH = "ResNet101", 256, 20
#: timed train steps, timed serving batches, traced serving batches
STEPS, REPS, TRACED = 5, 10, 3
#: the float64 step on the ranks against one process: of each gradient
#: tensor's largest magnitude, and of the running statistics' (the gates
#: of chip_smoke.py phase 14 (c))
GRAD_TOL, STAT_TOL = 1e-3, 1e-4
#: --spatial: the tile's side, and the most its probabilities may move
#: (chip_smoke.py phase 14 (a)'s ceiling)
SPATIAL_SIDE, BAND_CEIL = 4096, 1e-2


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def trainer(dtype, device, mesh=None, **model):
    """A UNetTrainer at the JAX config's defaults for ENCODER at SIZE, in
    `dtype`, with model_params `model` over them."""
    unet = build_config(overrides={"encoder": ENCODER, "image_h": SIZE,
                                   "image_w": SIZE}).unet
    return UNetTrainer(
        model_params={**unet.model_params, "dtype": dtype, **model},
        optimizer_params=unet.optimizer_params, loss_params=unet.loss,
        training_config={"epochs": 1}, input_size=(SIZE, SIZE),
        device=device, mesh=mesh)


def data(n, seed=0):
    """n blobby uint8 tiles, their [mask, distance, size] targets, and
    both resized to SIZE (float32, on the CPU)."""
    gen = torch.Generator().manual_seed(seed)
    low = torch.rand((n, 4, 19, 19), generator=gen)
    up = torch.nn.functional.interpolate(low, size=(TILE, TILE),
                                         mode="bilinear",
                                         align_corners=False)
    tiles = (up[:, :3] * 255).to(torch.uint8).permute(0, 2, 3, 1)
    mask = (up[:, 3] > 0.5).to(torch.float32)
    targets = torch.stack([mask, torch.zeros_like(mask),
                           torch.ones_like(mask)], -1)
    return eval_batch_resize(tiles, targets, (SIZE, SIZE))


def _kernel_busy_ms(prof, n_batches):
    """{device index: ms of kernels per batch} of a torch.profiler trace
    (nothing where the trace holds no device kernels)."""
    busy = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy[e.device_index] = busy.get(e.device_index, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    return {k: v / n_batches for k, v in sorted(busy.items())}


def serve(devices):
    t = trainer("bfloat16", devices[0])
    post = dict(target_size=(TILE, TILE), category_layers=(1, 1),
                active_layers=active_layers_for(CATEGORY_IDS, (1, 1)))
    probs = t.probs_apply_fn()
    one = FusedServe(probs, **post)
    mesh = FusedServe(probs, mesh=make_mesh(devices), **post)
    images = data(len(devices) * BATCH)["image"].to(devices[0])

    def rate(fs, x):
        fs(x)  # warm-up: cuDNN plans, a copy of the weights per card
        _sync(devices[0])
        host = {"dispatch": 0.0, "collect": 0.0}
        start = time.perf_counter()
        pending = None
        for _ in range(REPS):
            t0 = time.perf_counter()
            handle = fs.dispatch(x)
            t1 = time.perf_counter()
            if pending is not None:
                fs.collect(pending)
            host["dispatch"] += t1 - t0
            host["collect"] += time.perf_counter() - t1
            pending = handle
        fs.collect(pending)
        seconds = time.perf_counter() - start
        return (REPS * len(x) / seconds,
                {k: 1e3 * v / REPS for k, v in host.items()})

    single_rate, single_host = rate(one, images[:BATCH])
    mesh_rate, mesh_host = rate(mesh, images)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(devices[0]).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(TRACED):
            mesh(images)
        _sync(devices[0])
    got = mesh(images)[0]
    want = np.concatenate([one(part)[0] for part in images.split(BATCH)])
    same = int(sum(np.array_equal(g, w) for g, w in zip(got, want)))
    if same != len(got):
        raise AssertionError(f"scale_out: the mesh gives the one-card labels "
                             f"on {same} of {len(got)} images")
    return {"part": "serve", "cards": len(devices), "batch": BATCH,
            "one_card_images_per_s": single_rate,
            "mesh_images_per_s": mesh_rate,
            "speedup": mesh_rate / single_rate,
            "one_card_host_ms": single_host, "mesh_host_ms": mesh_host,
            "mesh_kernel_busy_ms_per_batch": _kernel_busy_ms(prof, TRACED),
            "images_with_one_card_labels": f"{same} of {len(got)}"}


def _tile(side, device, seed=0):
    """One (1, side, side, 3) normalised tile of upsampled noise."""
    gen = torch.Generator().manual_seed(seed)
    low = torch.rand((1, 3, side // 64, side // 64), generator=gen)
    up = torch.nn.functional.interpolate(low, size=(side, side),
                                         mode="bilinear",
                                         align_corners=False)
    return (up.permute(0, 2, 3, 1) * 2 - 1).to(device)


def spatial(devices):
    from mapping_tpu_torch.data.augment import resize_bilinear
    from mapping_tpu_torch.parallel.spatial import EXCHANGE

    t = trainer("bfloat16", devices[0])
    image = _tile(SPATIAL_SIDE, devices[0])
    with torch.no_grad():  # the class logit difference: mean 0, std 4
        d = t.model(image.permute(0, 3, 1, 2))
        d = d[:, 1] - d[:, 0]
        scale, w, b = 4.0 / d.std(), t.model.final.weight, t.model.final.bias
        w[1] = w[0] + scale * (w[1] - w[0])
        b[1] = b[0] + scale * (b[1] - b[0] - d.mean())
    post = dict(target_size=(TILE, TILE), category_layers=(1, 1),
                active_layers=active_layers_for(CATEGORY_IDS, (1, 1)))
    probs = t.probs_apply_fn()
    one = FusedServe(probs, **post)
    split = FusedServe(probs, mesh=make_mesh(devices), spatial=True, **post)

    def ms(fs):
        fs(image)  # warm-up: cuDNN plans, a copy of the weights per card
        for d in devices:
            _sync(d)
        start = time.perf_counter()
        for _ in range(REPS):
            out = fs(image)
        return out, 1e3 * (time.perf_counter() - start) / REPS

    want, one_ms = ms(one)
    got, split_ms = ms(split)
    EXCHANGE.reset()
    split(image)
    exchange = EXCHANGE.as_dict()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(TRACED):
            split(image)
        for d in devices:
            _sync(d)
    with torch.inference_mode():
        p_one = resize_bilinear(one._probs(image), (TILE, TILE))[..., 1]
        p_split = split.spatial(image)[..., 1]
    band = float((p_split - p_one).abs().max())
    near = ((p_one - 0.5).abs() <= band).cpu().numpy()
    differ = (got[0][:, 1] > 0) != (want[0][:, 1] > 0)
    if band > BAND_CEIL or (differ & ~near).any():
        raise AssertionError(f"scale_out: spatial labels differ beyond the "
                             f"band {band:.3g} at "
                             f"{int((differ & ~near).sum())} pixels")
    return {"part": "spatial", "cards": len(devices), "side": SPATIAL_SIDE,
            "one_card_ms": one_ms, "spatial_ms": split_ms,
            "speedup": one_ms / split_ms, "exchange_per_call": exchange,
            "spatial_kernel_busy_ms_per_tile": _kernel_busy_ms(prof,
                                                               TRACED),
            "max_abs_dp": band, "pixels_differ": int(differ.sum()),
            "labels_equal": bool(np.array_equal(got[0], want[0])),
            "instances": int(want[0].max())}


def step_outputs(t, batch):
    """One step of trainer `t` on `batch`: (loss, gradients, BatchNorm
    running statistics)."""
    t._ensure_state()
    loss = float(t._train_steps([{k: v.to(t.device, t.dtype)
                                  for k, v in batch.items()}], 0)
                 ["loss"][0])
    return (loss, {n: p.grad for n, p in t.model.named_parameters()},
            {k: v for k, v in t.model.state_dict().items()
             if "running" in k})


def float64_trainer(device, mesh=None):
    t = trainer("float32", device, mesh, dropout_2d=0.1)
    t.model.to(torch.float64)
    t.dtype = torch.float64
    return t


def timed_steps(t, batch, steps):
    """ms of each of `steps` steps on `batch` (the loss read back)."""
    t._ensure_state()
    batch = {k: v.to(t.device) for k, v in batch.items()}
    out = []
    for i in range(steps):
        start = time.perf_counter()
        t._train_steps([batch], i)["loss"].tolist()
        out.append(1e3 * (time.perf_counter() - start))
    return out


def _settings():
    return {"ENCODER": ENCODER, "SIZE": SIZE, "BATCH": BATCH,
            "STEPS": STEPS}


def rank_job(settings, reference_path):
    """On a rank (which imports this module anew: `settings` are the
    parent's sizes): the float64 step against the reference, then the
    bf16 step times at BATCH images per rank."""
    globals().update(settings)
    ref = torch.load(reference_path, weights_only=True)
    rank, world = distributed.rank(), distributed.world()
    device = distributed.group_mesh().devices[rank].type
    t = float64_trainer(device, "auto")
    shard = shard_batch(ref["batch"], make_mesh(["cpu"] * world))[rank]
    loss, grads, stats = step_outputs(t, shard)
    errors = {n: float((g.cpu() - ref["grads"][n]).abs().max())
              / (float(ref["grads"][n].abs().max()) or 1.0)
              for n, g in grads.items()}
    worst = max(errors, key=errors.get)
    stat_err = max(float((v.cpu() - ref["stats"][k]).abs().max())
                   / (float(ref["stats"][k].abs().max()) or 1.0)
                   for k, v in stats.items())
    del t, grads, stats
    if device == "cuda":
        torch.cuda.empty_cache()
    t = trainer("bfloat16", device, "auto")
    ms = timed_steps(t, data(BATCH, seed=1 + rank), STEPS)
    return {"rank": rank, "backend": torch.distributed.get_backend(),
            "loss": loss, "grad_err": errors[worst], "worst": worst,
            "stat_err": stat_err, "ms": ms}


def train(devices):
    batch = data(BATCH)
    t = float64_trainer(devices[0])
    loss, grads, stats = step_outputs(t, batch)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.pt")
        torch.save({"batch": batch,
                    "grads": {n: g.cpu() for n, g in grads.items()},
                    "stats": {k: v.cpu() for k, v in stats.items()}}, path)
        del t, grads, stats
        ms_one = timed_steps(trainer("bfloat16", devices[0]),
                             data(BATCH, seed=1), STEPS)
        if torch.device(devices[0]).type == "cuda":
            torch.cuda.empty_cache()
        start = time.perf_counter()
        ranks = distributed.spawn(rank_job, devices, _settings(), path)
        seconds = time.perf_counter() - start
    for r in ranks:
        if not (r["grad_err"] <= GRAD_TOL and r["stat_err"] <= STAT_TOL):
            raise AssertionError(f"scale_out: rank {r['rank']}'s float64 "
                                 f"step differs from one process's: {r}")
    ms_ranks = max(np.median(r["ms"][1:] or r["ms"]) for r in ranks)
    ms_single = float(np.median(ms_one[1:] or ms_one))
    return [{"part": "step", "cards": len(devices), "global_batch": BATCH,
             "backend": ranks[0]["backend"], "single_loss": loss,
             "ranks": [{k: r[k] for k in ("rank", "loss", "grad_err",
                                          "worst", "stat_err")}
                       for r in ranks],
             "spawn_to_exit_s": seconds},
            {"part": "train", "cards": len(devices),
             "batch_per_rank": BATCH, "one_process_ms": ms_one,
             "rank_ms": [r["ms"] for r in ranks],
             "one_process_images_per_s": 1e3 * BATCH / ms_single,
             "ranks_images_per_s": 1e3 * BATCH * len(devices) / ms_ranks}]


class _OneRank:
    """The collectives of a DataParallel over a group of one rank: they
    do nothing, and the global BatchNorm runs all its own work."""

    rank, world = 0, 1

    @staticmethod
    def all_reduce(t):
        return t

    @staticmethod
    def all_gather(t):
        return t[None]

    @staticmethod
    def sum(t):
        return t

    def average_gradients(self, module):
        pass


def norm(device):
    from mapping_tpu_torch.train.step import make_train_step_multi

    batch = data(BATCH, seed=1)
    out = {"part": "norm", "batch": BATCH}
    for name, dp in (("plain", None), ("global_batch_norm", _OneRank())):
        t = trainer("bfloat16", device)
        t._ensure_state()
        t._train_steps = make_train_step_multi(
            t._loss_fn, t.model, t.optimizer, t.scheduler, t.dtype,
            seed=t.seed, data_parallel=dp)
        ms = timed_steps(t, batch, STEPS)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            timed_steps(t, batch, 1)
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        out[name] = {"ms": ms, "device_ms": sum(
            e.self_device_time_total for e in events) / 1e3,
            "device_events": sum(e.count for e in events)}
        del t
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def run(devices):
    """Every part over `devices` (cards, or CPU replicas and gloo ranks
    for a rehearsal, whose times are no card's): the JSON lines."""
    return [serve(devices)] + train(devices) + [norm(devices[0])]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=None)
    ap.add_argument("--spatial", action="store_true",
                    help="only the spatial part: one large tile's rows "
                         "over the cards")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scale_out: no CUDA card is visible")
    devices = [f"cuda:{i}" for i in
               range(args.cards or torch.cuda.device_count())]
    for line in ([spatial(devices)] if args.spatial else run(devices)):
        print(json.dumps(line), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"devices": devices, "card": card}))


if __name__ == "__main__":
    main()
