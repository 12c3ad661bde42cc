"""Segmentation losses: plain CE, distance/size-weighted CE, soft dice, mixer.

Counterpart of mapping_tpu/train/losses.py, with its conventions: logits
(N, H, W, C) (a permuted view of the model's NCHW output), integer class
targets (N, H, W), and weighted targets stacked along the last axis as
(N, H, W, 1+K) = [mask, distance, size]. All weight math runs in float32.
The JAX package picks each pixel's log-probability with a one-hot product
(a TPU scatter workaround); here it is a gather.
"""

import math
from functools import partial
from typing import Callable, Optional, Sequence

import torch


def _per_pixel_ce(logits, labels):
    """Softmax cross-entropy per pixel, float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)


def multiclass_segmentation_loss(logits, target):
    """Mean softmax CE; target (N, H, W) int or (N, H, W, 1)."""
    if target.dim() == logits.dim():
        target = target[..., 0]
    return _per_pixel_ce(logits, target).mean()


def _distance_weights(d, w0, sigma):
    w = 1.0 + w0 * torch.exp(-(d.float() ** 2) / (sigma ** 2))
    return torch.where(d == 0, 1.0, w)


def _size_weights(sizes, c):
    s = torch.where(sizes == 0, 1.0, sizes.float())
    return torch.where(s == 1, 1.0, c / s)


def get_weights(weight_channels, w0, sigma, imsize):
    """Per-pixel CE weights from [distance, size] channels (..., H, W, 2):
    (1 + w0 exp(-d^2 / sigma^2), 1 where d = 0) * (C / size, 1 where the
    size is 0 or 1), C = sqrt(H * W) / 2."""
    c = math.sqrt(imsize[0] * imsize[1]) / 2.0
    return (_distance_weights(weight_channels[..., 0], w0, sigma)
            * _size_weights(weight_channels[..., 1], c))


def multiclass_weighted_cross_entropy(logits, target, weights_function=None):
    """Weighted CE: target (N, H, W, 1+K); channel 0 = class mask, channels
    1..K feed weights_function (or channel 1 is the weight directly)."""
    if weights_function is None:
        weights = target[..., 1].float()
    else:
        weights = weights_function(target[..., 1:])
    return (_per_pixel_ce(logits, target[..., 0]) * weights).mean()


def dice_loss(probs, target, smooth=0.0, eps=1e-7):
    """1 - 2|p∩t| / (|p|+|t|), batch-global sums."""
    probs = probs.float()
    target = target.float()
    num = 2.0 * (probs * target).sum() + smooth
    den = probs.sum() + target.sum() + smooth + eps
    return 1.0 - num / den


def multiclass_dice_loss(logits, target, smooth=0.0, activation="softmax",
                         excluded_classes: Sequence[int] = ()):
    """Sum of per-class dice over non-excluded channels. target: (N, H, W)
    int."""
    if activation == "softmax":
        probs = torch.softmax(logits.float(), dim=-1)
    elif activation == "sigmoid":
        probs = torch.sigmoid(logits.float())
    else:
        raise NotImplementedError("only sigmoid and softmax are implemented")
    loss = 0.0
    for class_nr in range(logits.shape[-1]):
        if class_nr in excluded_classes:
            continue
        loss = loss + dice_loss(probs[..., class_nr], target == class_nr,
                                smooth)
    return loss


def mixed_dice_cross_entropy_loss(
    logits,
    target,
    dice_weight=0.5,
    cross_entropy_weight=0.5,
    smooth=0.0,
    dice_activation="softmax",
    cross_entropy_loss: Optional[Callable] = None,
    excluded_classes: Sequence[int] = (0,),
):
    """dice_weight * dice + cross_entropy_weight * ce. target: (N, H, W, 1+K)
    stacked [mask, weight channels...]; dice reads channel 0, a weighted CE
    gets the whole stack."""
    mask = target[..., 0].long()
    dice = multiclass_dice_loss(logits, mask, smooth, dice_activation,
                                excluded_classes)
    if cross_entropy_loss is None:
        ce = multiclass_segmentation_loss(logits, mask)
    else:
        ce = cross_entropy_loss(logits, target)
    return dice_weight * dice + cross_entropy_weight * ce


def make_loss_fn(loss_name: str, params: dict) -> Callable:
    """'ce' (plain) or 'weighted' (distance/size weighted CE + dice); the
    keys of `params` and their defaults are the JAX package's."""
    if loss_name == "ce":
        def plain(logits, target):
            if target.dim() == logits.dim():
                target = target[..., 0]
            return multiclass_segmentation_loss(logits, target)
        return plain
    if loss_name == "weighted":
        weights_function = partial(
            get_weights,
            w0=params.get("w0", 50.0),
            sigma=params.get("sigma", 10.0),
            imsize=params.get("imsize", (256, 256)),
        )
        return partial(
            mixed_dice_cross_entropy_loss,
            dice_weight=params.get("dice_weight", 0.2),
            cross_entropy_weight=params.get("bce_weight", 1.0),
            smooth=params.get("smooth", 0.0),
            dice_activation=params.get("dice_activation", "softmax"),
            cross_entropy_loss=partial(multiclass_weighted_cross_entropy,
                                       weights_function=weights_function),
        )
    raise KeyError(f"unknown loss {loss_name!r}")
