"""Decoder building blocks of the U-Net family (NCHW inside).

Counterpart of mapping_tpu/models/blocks.py. Parameter names follow the
reference's torch modules (`conv`, `block.0`, `block.1`, ...) so a
reference checkpoint loads unchanged.
"""

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


class SpatialDropout(nn.Dropout2d):
    """Channel-wise dropout before the final 1x1 conv; the identity in
    eval mode."""
