"""Optimizer factory: Adam with L2 on conv kernels only, staircase LR decay.

Counterpart of mapping_tpu/train/state.py `make_optimizer`. The JAX chain
`add_decayed_weights(mask=_kernel_mask)` then `adam` adds weight_decay * w
to the gradient before Adam (L2, not AdamW), which is torch Adam's
`weight_decay`, given here to one param group only: the weights of every
Conv2d and ConvTranspose2d (the Flax "kernel" leaves). BatchNorm scales
(which torch also calls `weight`) and all biases are not decayed. Adam's
eps 1e-8 (eps_root 0) and betas are torch's defaults.

The staircase exponential schedule multiplies the rate by gamma every
`decay_every_steps` optimizer steps (optax.exponential_decay with
staircase=True): a StepLR stepped once per optimizer step.
"""

from typing import Optional, Tuple

import torch
from torch import nn

_KERNEL_MODULES = (nn.Conv2d, nn.ConvTranspose2d)


def _param_groups(model: nn.Module, weight_decay: float):
    kernels = {id(m.weight) for m in model.modules()
               if isinstance(m, _KERNEL_MODULES)}
    params = list(model.parameters())
    decayed = [p for p in params if id(p) in kernels]
    rest = [p for p in params if id(p) not in kernels]
    return [{"params": decayed, "weight_decay": weight_decay},
            {"params": rest, "weight_decay": 0.0}]


def make_optimizer(model: nn.Module, lr: float, gamma: Optional[float] = None,
                   decay_every_steps: int = 1, weight_decay: float = 0.0
                   ) -> Tuple[torch.optim.Adam,
                              Optional[torch.optim.lr_scheduler.StepLR]]:
    """(Adam over `model`'s parameters, the staircase schedule or None).

    gamma None means a flat rate; otherwise call `scheduler.step()` after
    every `optimizer.step()`."""
    optimizer = torch.optim.Adam(_param_groups(model, weight_decay), lr=lr)
    if gamma is None:
        return optimizer, None
    return optimizer, torch.optim.lr_scheduler.StepLR(
        optimizer, step_size=decay_every_steps, gamma=gamma)
