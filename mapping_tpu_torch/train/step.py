"""Train, eval and predict steps.

Counterpart of mapping_tpu/train/step.py. A step here is eager PyTorch on
the model's device: images (N, H, W, 3) float32 are handed to the model as
a permuted NCHW view, which is channels_last memory, the layout the model's
weights are kept in. Parameters stay float32; a bfloat16 model runs its
convs under autocast, and a float32 model runs with TF32 off for the step
only (full float32, as the JAX package computes it). The filter gradients
come from autograd (cuDNN on a card), as the JAX step takes them from XLA's
vjp; the dW kernel (kernels/conv_dw.py) runs through tools/dw_probe.py.

`remat` re-runs the forward in the backward pass
(torch.utils.checkpoint), like jax.checkpoint in the JAX step. A re-run
forward would update the BatchNorm running statistics a second time, so
the re-run holds them (momentum 0): one step updates them once, as in JAX.
"""

import contextlib
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mapping_tpu_torch.pipelines import _no_tf32


def _autocast(device: torch.device, dtype: torch.dtype):
    """The context a forward of `dtype` runs in on `device`."""
    if dtype == torch.float32:
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
                    remat: bool = False):
    """Returns batch -> {"loss": 0-dim float32 tensor} that runs one
    optimizer step on `model` in place (BatchNorm in training mode, its
    running statistics updated) and steps `scheduler` after it.

    batch: {"image": (N, H, W, 3) float32, "target": (N, H, W, 1+K)} on the
    model's device. loss_fn(logits (N, H, W, C) float32, target) -> scalar.
    The loss is returned on the device; reading it synchronises."""
    device = next(model.parameters()).device

    def train_step(batch: Dict[str, torch.Tensor]):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with _no_tf32(dtype == torch.float32):
            with _autocast(device, dtype):
                logits = _forward(model, batch["image"], remat)
            loss = loss_fn(logits.float().permute(0, 2, 3, 1),
                           batch["target"])
            loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {"loss": loss.detach()}

    return train_step


def make_train_step_multi(loss_fn: Callable, model: nn.Module,
                          optimizer: torch.optim.Optimizer,
                          scheduler=None, dtype: torch.dtype = torch.bfloat16,
                          remat: bool = False):
    """Returns batches -> {"loss": (K,) tensor}: K single steps, one per
    batch, in order (the JAX package scans them in one dispatch; eager
    PyTorch has no dispatch to save)."""
    step = make_train_step(loss_fn, model, optimizer, scheduler, dtype, remat)

    def train_steps(batches: Sequence[Dict[str, torch.Tensor]]):
        return {"loss": torch.stack([step(b)["loss"] for b in batches])}

    return train_steps


def make_eval_step(loss_fn: Callable, model: nn.Module,
                   dtype: torch.dtype = torch.bfloat16):
    """Returns batch -> validation loss (0-dim tensor): BatchNorm with its
    running statistics, no gradient."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        with _no_tf32(dtype == torch.float32), _autocast(device, dtype):
            logits = model(_nchw(batch["image"]))
        return loss_fn(logits.float().permute(0, 2, 3, 1), batch["target"])

    return eval_step


def make_predict_step(model: nn.Module, dtype: torch.dtype = torch.bfloat16):
    """Returns images (N, H, W, 3) -> float32 softmax probabilities
    (N, H, W, C)."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def predict_step(images):
        model.eval()
        with _no_tf32(dtype == torch.float32), _autocast(device, dtype):
            logits = model(_nchw(images))
        return torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)

    return predict_step
