"""VGG-encoder U-Nets: UNet11 (TernausNet) and UNetVGG16 (NCHW).

Counterpart of mapping_tpu/models/vgg.py. The encoder is torchvision's
VGG `features` nn.Sequential (3x3 conv + ReLU, 2x2 max pools, no
BatchNorm), so its parameters sit under `encoder.{i}` at torchvision's
indices: a reference checkpoint loads unchanged, and a torchvision
`features.N` file grafts by a rename. Decoder keys are the reference's
(`center.block.0.conv.weight`, ..., `dec1.conv.weight`, `final.weight`).
Input sides must be divisible by 32. Returns float32 logits
(N, num_classes, H, W).
"""

import torch
from torch import nn

from mapping_tpu_torch.models.blocks import (ConvRelu, DecoderBlock,
                                             DecoderBlockV2, SpatialDropout)

VGG11_CFG = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


def vgg_features(cfg):
    """torchvision's `make_layers` without BatchNorm: "M" a 2x2 max pool,
    an int a 3x3 conv + ReLU; the Sequential's indices are torchvision's."""
    layers, cin = [], 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU(inplace=True)]
            cin = v
    return nn.Sequential(*layers)


def _stages(encoder, x):
    """([conv1, ..., conv5], pooled conv5): the ReLU output of each
    stage's last conv, taken before the max pool that ends the stage."""
    feats = []
    for layer in encoder:
        if isinstance(layer, nn.MaxPool2d):
            feats.append(x)
        x = layer(x)
    return feats, x


class UNet11(nn.Module):
    """TernausNet: VGG11 encoder, V1 decoder blocks (stride-2 3x3
    deconvs), skip concats down to dec1. The centre takes the pooled
    512-channel conv5; the reference's `num_filters * 16` input width
    holds at its default of 32 filters only, so the widths here come from
    the encoder (the JAX module infers them the same way)."""

    def __init__(self, num_classes=2, num_filters=32):
        super().__init__()
        nf = num_filters
        self.encoder = vgg_features(VGG11_CFG)
        self.center = DecoderBlock(512, nf * 16, nf * 8)
        self.dec5 = DecoderBlock(512 + nf * 8, nf * 16, nf * 8)
        self.dec4 = DecoderBlock(512 + nf * 8, nf * 16, nf * 4)
        self.dec3 = DecoderBlock(256 + nf * 4, nf * 8, nf * 2)
        self.dec2 = DecoderBlock(128 + nf * 2, nf * 4, nf)
        self.dec1 = ConvRelu(64 + nf, nf)
        self.final = nn.Conv2d(nf, num_classes, 1)

    def forward(self, x):
        (conv1, conv2, conv3, conv4, conv5), pooled = _stages(self.encoder,
                                                              x)
        dec = self.center(pooled)
        dec = self.dec5(torch.cat([dec, conv5], 1))
        dec = self.dec4(torch.cat([dec, conv4], 1))
        dec = self.dec3(torch.cat([dec, conv3], 1))
        dec = self.dec2(torch.cat([dec, conv2], 1))
        dec = self.dec1(torch.cat([dec, conv1], 1))
        return self.final(dec).float()


class UNetVGG16(nn.Module):
    """VGG16 encoder, V2 decoder blocks (deconv or bilinear), skip concats
    down to dec1, spatial dropout, then a 1x1 final conv."""

    def __init__(self, num_classes=2, num_filters=32, dropout_2d=0.0,
                 is_deconv=True):
        super().__init__()
        nf = num_filters
        self.encoder = vgg_features(VGG16_CFG)
        self.center = DecoderBlockV2(512, nf * 16, nf * 8, is_deconv)
        self.dec5 = DecoderBlockV2(512 + nf * 8, nf * 16, nf * 8, is_deconv)
        self.dec4 = DecoderBlockV2(512 + nf * 8, nf * 16, nf * 8, is_deconv)
        self.dec3 = DecoderBlockV2(256 + nf * 8, nf * 8, nf * 2, is_deconv)
        self.dec2 = DecoderBlockV2(128 + nf * 2, nf * 4, nf, is_deconv)
        self.dec1 = ConvRelu(64 + nf, nf)
        self.dropout = SpatialDropout(dropout_2d)
        self.final = nn.Conv2d(nf, num_classes, 1)

    def forward(self, x):
        (conv1, conv2, conv3, conv4, conv5), pooled = _stages(self.encoder,
                                                              x)
        dec = self.center(pooled)
        dec = self.dec5(torch.cat([dec, conv5], 1))
        dec = self.dec4(torch.cat([dec, conv4], 1))
        dec = self.dec3(torch.cat([dec, conv3], 1))
        dec = self.dec2(torch.cat([dec, conv2], 1))
        dec = self.dec1(torch.cat([dec, conv1], 1))
        return self.final(self.dropout(dec)).float()
