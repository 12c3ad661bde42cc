"""Inference-time BatchNorm folding.

Counterpart of mapping_tpu/models/fold_bn.py `fold_batch_stats`: at
inference a BatchNorm is an affine map with frozen statistics, so it folds
into the conv before it (w' = w * g / sqrt(v + eps) per output channel,
b' = beta - mean * g / sqrt(v + eps)), and the BatchNorm becomes the
identity. Pairs are found by name, as torchvision names them: `bnN` follows
`convN`, and in a `downsample` Sequential `1` follows `0`.
"""

import torch
from torch import nn


def _conv_name(bn_name: str):
    if bn_name.startswith("bn") and bn_name[2:].isdigit():
        return "conv" + bn_name[2:]
    if bn_name == "1":
        return "0"
    return None


@torch.no_grad()
def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    bias = bn.bias - bn.running_mean * scale
    if conv.bias is not None:
        bias = bias + conv.bias * scale
    conv.weight.mul_(scale.reshape(-1, 1, 1, 1))
    conv.bias = nn.Parameter(bias)


def fold_batch_stats(model: nn.Module) -> nn.Module:
    """Fold every conv -> BatchNorm2d pair of `model` in place (the
    BatchNorm becomes nn.Identity) and return the model, for eval only."""
    pairs = []
    for parent in model.modules():
        for name, child in parent.named_children():
            conv_name = _conv_name(name)
            if isinstance(child, nn.BatchNorm2d) and conv_name:
                conv = getattr(parent, conv_name, None)
                if isinstance(conv, nn.Conv2d):
                    pairs.append((parent, name, conv, child))
    for parent, name, conv, bn in pairs:
        _fold(conv, bn)
        setattr(parent, name, nn.Identity())
    return model
