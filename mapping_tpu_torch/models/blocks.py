"""Decoder building blocks of the U-Net family (NCHW inside).

Counterpart of mapping_tpu/models/blocks.py. Parameter names follow the
reference's torch modules (`conv`, `block.0`, `block.1`, ...) so a
reference checkpoint loads unchanged.
"""

import torch
import torch.nn.functional as F
from torch import nn


class ConvRelu(nn.Module):
    """3x3 same-padded conv + ReLU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x):
        return F.relu(self.conv(x))


def upsample2x(x):
    """Bilinear 2x upsample of an NCHW tensor (half-pixel, as
    jax.image.resize "linear" and torch nn.Upsample(mode="bilinear"))."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class Upsample2x(nn.Module):
    def forward(self, x):
        return upsample2x(x)


class DecoderBlock(nn.Module):
    """TernausNet V1 (UNet11): ConvRelu(mid) -> ConvTranspose2d(3x3, stride
    2, pad 1, output_pad 1) -> ReLU.

    That torch deconv is the Flax ConvTranspose with explicit padding
    ((1, 2), (1, 2)) and a spatially flipped kernel
    (mapping_tpu/models/torch_convert.py `_decoder_block_v1`)."""

    def __init__(self, cin, mid, cout):
        super().__init__()
        self.block = nn.Sequential(
            ConvRelu(cin, mid),
            nn.ConvTranspose2d(mid, cout, 3, stride=2, padding=1,
                               output_padding=1),
            nn.ReLU(inplace=True))

    def forward(self, x):
        return self.block(x)


class DecoderBlockV2(nn.Module):
    """is_deconv: ConvRelu(mid) -> ConvTranspose2d(4x4, stride 2, pad 1) ->
    ReLU; otherwise bilinear 2x upsample -> ConvRelu(mid) -> ConvRelu(out).

    A torch ConvTranspose2d with k=4, s=2, p=1 is the Flax ConvTranspose
    with "SAME" padding and a spatially flipped kernel
    (mapping_tpu/models/torch_convert.py `_deconv`)."""

    def __init__(self, cin, mid, cout, is_deconv=True):
        super().__init__()
        if is_deconv:
            self.block = nn.Sequential(
                ConvRelu(cin, mid),
                nn.ConvTranspose2d(mid, cout, 4, stride=2, padding=1),
                nn.ReLU(inplace=True))
        else:
            self.block = nn.Sequential(
                Upsample2x(), ConvRelu(cin, mid), ConvRelu(mid, cout))

    def forward(self, x):
        return self.block(x)


def batch_dropout(x, p: float, training: bool, shard, per_channel: bool):
    """Dropout of NCHW `x`: whole channels with `per_channel`, else single
    elements; the identity in eval mode or at p = 0. `shard` = (rank,
    world), set by a data-parallel train step: the mask is drawn for the
    global batch of world * len(x) images and this rank keeps its rows,
    so that the ranks together drop what one process drops on the global
    batch from the same generator state (train/step.py seeds it per
    step on every rank)."""
    if not training or p == 0:
        return x
    if p == 1:
        return x * 0
    rank, world = shard or (0, 1)
    b = x.shape[0]
    shape = (b * world, x.shape[1]) + ((1, 1) if per_channel
                                       else tuple(x.shape[2:]))
    # drawn in float32 whatever x's dtype: the same masks in every dtype
    keep = torch.empty(shape, device=x.device).bernoulli_(1 - p)
    return x * keep[rank * b:(rank + 1) * b].div_(1 - p).to(x.dtype)


class SpatialDropout(nn.Dropout2d):
    """Channel-wise dropout before the final 1x1 conv; the identity in
    eval mode (`batch_dropout`)."""

    shard = None

    def forward(self, x):
        return batch_dropout(x, self.p, self.training, self.shard, True)


class ElementDropout(nn.Dropout):
    """Elementwise dropout (`batch_dropout`)."""

    shard = None

    def forward(self, x):
        return batch_dropout(x, self.p, self.training, self.shard, False)
