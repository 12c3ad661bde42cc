"""Train, eval and predict steps.

Counterpart of mapping_tpu/train/step.py. A step here is eager PyTorch on
the model's device: images (N, H, W, 3) float32 are handed to the model as
a permuted NCHW view, which is channels_last memory, the layout the model's
weights are kept in. Parameters stay float32; a bfloat16 model runs its
convs under autocast, and a float32 model runs with TF32 off for the step
only (full float32, as the JAX package computes it). The filter gradients
come from autograd (cuDNN on a card), as the JAX step takes them from XLA's
vjp; the dW kernel (kernels/conv_dw.py) runs through tools/dw_probe.py.

A multi-head model (UNetMultitask) returns a list of logits: the train
step averages the heads' losses, each head on its own target where the
batch gives a list of targets, else all on the one target (the JAX
step). The eval and predict steps take one map and refuse a list
(`single_logits`), where the JAX package's fail on it.

`remat` re-runs the forward in the backward pass
(torch.utils.checkpoint), like jax.checkpoint in the JAX step. A re-run
forward would update the BatchNorm running statistics a second time, so
the re-run holds them (momentum 0): one step updates them once, as in JAX.

Dropout draws from the step's own random state: the forward and backward
run with the default generators of the CPU and of the model's card forked
and seeded from (`seed`, step number), as the JAX step folds the step into
its dropout key, so a step's masks depend on nothing else the process
drew, and a remat re-run (which restores the forked state) draws them
again.

Data parallel (`data_parallel`, a parallel.distributed.DataParallel): the
step runs on one rank of a process group with the rank's shard of the
global batch. For the forward and backward every BatchNorm takes the
statistics of the global batch and every dropout draws the global batch's
mask and keeps the rank's rows (models/resnet.BatchNorm2d,
models/blocks.batch_dropout); the loss must be the global one
(train/losses.make_loss_fn with `reduce`); after the backward the
gradients are averaged over the ranks. The step then equals the
single-process step on the concatenated batch, and every rank's weights
stay the same. `place_for_mesh` puts a model and a global batch in that
layout.
"""

import contextlib
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mapping_tpu_torch.models.blocks import ElementDropout, SpatialDropout
from mapping_tpu_torch.models.resnet import BatchNorm2d


@contextlib.contextmanager
def _no_tf32(active):
    """Turn TF32 off for matmuls and cuDNN convs while the block enqueues
    its kernels, and restore the process's settings after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if active:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _autocast(device: torch.device, dtype: torch.dtype):
    """The context a forward of `dtype` runs in on `device`."""
    if dtype in (torch.float32, torch.float64):
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


@contextlib.contextmanager
def _running_stats_held(model: nn.Module):
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 0.0
    try:
        yield
    finally:
        for m, momentum in zip(bns, saved):
            m.momentum = momentum


@contextlib.contextmanager
def _eval_mode(model: nn.Module):
    was_training = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was_training)


@contextlib.contextmanager
def _step_rng(device: torch.device, seed: int, step: int):
    """The default generators of the CPU and of `device` forked, and
    seeded from (seed, step), for the block."""
    value = (int(seed) << 32) + int(step)
    cuda = [device.index] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda, device_type="cuda"):
        torch.random.default_generator.manual_seed(value)
        if cuda:
            torch.cuda.default_generators[device.index].manual_seed(value)
        yield


@contextlib.contextmanager
def _global_batch(model: nn.Module, data_parallel):
    """BatchNorms and dropouts of `model` over the global batch of
    `data_parallel`'s group for the block (nothing without one)."""
    if data_parallel is None:
        yield
        return
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    drops = [m for m in model.modules()
             if isinstance(m, (SpatialDropout, ElementDropout))]
    for m in norms:
        m.group = data_parallel
    for m in drops:
        m.shard = (data_parallel.rank, data_parallel.world)
    try:
        yield
    finally:
        for m in norms:
            m.group = None
        for m in drops:
            m.shard = None


def place_for_mesh(model: nn.Module, batch, mesh):
    """(model with rank 0's weights, this rank's shard of the global
    `batch` on the rank's device), on a rank of a process group over
    `mesh`: the counterpart of the JAX package's place_for_mesh, which
    replicates the state and shards the batch for one SPMD step."""
    from mapping_tpu_torch.parallel import distributed
    from mapping_tpu_torch.parallel.mesh import shard_batch

    return (distributed.broadcast_module(model),
            shard_batch(batch, mesh)[distributed.rank()])


MULTI_HEAD = ("a multi-head model (UNetMultitask, nr_outputs > 1) returns "
              "one logits map per head: it trains on the mean of the heads' "
              "losses, but validation and serving take one map (the JAX "
              "package's eval and predict steps fail on a list of logits)")


def single_logits(logits):
    """`logits` of a one-head model; a list of them raises (MULTI_HEAD)."""
    if isinstance(logits, (list, tuple)):
        raise TypeError(MULTI_HEAD)
    return logits


def _nhwc_logits(logits):
    return logits.float().permute(0, 2, 3, 1)


def heads_loss(loss_fn: Callable, logits, target):
    """loss_fn of one logits map, or the mean over the heads of a list of
    maps, each against its own entry of a list `target` or all against
    the one `target`."""
    if not isinstance(logits, (list, tuple)):
        return loss_fn(_nhwc_logits(logits), target)
    targets = (target if isinstance(target, (list, tuple))
               else [target] * len(logits))
    return sum(loss_fn(_nhwc_logits(lg), tg)
               for lg, tg in zip(logits, targets)) / len(logits)


def _nchw(images):
    return images.permute(0, 3, 1, 2)


def _forward(model, images, remat):
    if not remat:
        return model(_nchw(images))
    return checkpoint(
        model, _nchw(images), use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            _running_stats_held(model)))


def make_train_step(loss_fn: Callable, model: nn.Module,
                    optimizer: torch.optim.Optimizer,
                    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler]
                    = None, dtype: torch.dtype = torch.bfloat16,
                    remat: bool = False, seed: int = 0,
                    data_parallel=None):
    """Returns (batch, step=0) -> {"loss": 0-dim float32 tensor} that runs
    one optimizer step on `model` in place (BatchNorm in training mode,
    its running statistics updated) and steps `scheduler` after it;
    dropout draws from (`seed`, `step`).

    batch: {"image": (N, H, W, 3) float32, "target": (N, H, W, 1+K)} on the
    model's device. loss_fn(logits (N, H, W, C) float32, target) -> scalar.
    The loss is returned on the device; reading it synchronises. With
    `data_parallel` the batch is this rank's shard and loss_fn the global
    loss (module docstring)."""
    device = next(model.parameters()).device

    def train_step(batch: Dict[str, torch.Tensor], step: int = 0):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with _no_tf32(dtype == torch.float32), \
                _step_rng(device, seed, step), \
                _global_batch(model, data_parallel):
            with _autocast(device, dtype):
                logits = _forward(model, batch["image"], remat)
            loss = heads_loss(loss_fn, logits, batch["target"])
            loss.backward()
        if data_parallel is not None:
            data_parallel.average_gradients(model)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {"loss": loss.detach()}

    return train_step


def make_train_step_multi(loss_fn: Callable, model: nn.Module,
                          optimizer: torch.optim.Optimizer,
                          scheduler=None, dtype: torch.dtype = torch.bfloat16,
                          remat: bool = False, seed: int = 0,
                          data_parallel=None):
    """Returns (batches, first_step=0) -> {"loss": (K,) tensor}: K single
    steps, one per batch, in order, numbered from `first_step` (the JAX
    package scans them in one dispatch; eager PyTorch has no dispatch to
    save)."""
    step = make_train_step(loss_fn, model, optimizer, scheduler, dtype, remat,
                           seed, data_parallel)

    def train_steps(batches: Sequence[Dict[str, torch.Tensor]],
                    first_step: int = 0):
        return {"loss": torch.stack([step(b, first_step + i)["loss"]
                                     for i, b in enumerate(batches)])}

    return train_steps


def make_eval_step(loss_fn: Callable, model: nn.Module,
                   dtype: torch.dtype = torch.bfloat16):
    """Returns batch -> validation loss (0-dim tensor): BatchNorm with its
    running statistics, no gradient; the model's train/eval mode is left
    as it was."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(batch):
        with _eval_mode(model), _no_tf32(dtype == torch.float32), \
                _autocast(device, dtype):
            logits = single_logits(model(_nchw(batch["image"])))
        return loss_fn(_nhwc_logits(logits), batch["target"])

    return eval_step


def make_predict_step(model: nn.Module, dtype: torch.dtype = torch.bfloat16):
    """Returns images (N, H, W, 3) -> float32 softmax probabilities
    (N, H, W, C); the model's train/eval mode is left as it was."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def predict_step(images):
        with _eval_mode(model), _no_tf32(dtype == torch.float32), \
                _autocast(device, dtype):
            logits = single_logits(model(_nchw(images)))
        return torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)

    return predict_step
