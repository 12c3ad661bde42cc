"""U-Net with a ResNet encoder, the production model family (NCHW).

Counterpart of mapping_tpu/models/unet_resnet.py. State-dict keys are the
reference checkpoint's (`encoder.conv1.weight`,
`center.block.0.conv.weight`, ..., `final.weight`). Input sides must be
divisible by 64. Returns float32 logits (N, num_classes, H, W).
"""

import torch
from torch import nn

from mapping_tpu_torch.models.blocks import (ConvRelu, DecoderBlockV2,
                                             SpatialDropout)
from mapping_tpu_torch.models.resnet import ResNetEncoder


class UNetResNet(nn.Module):
    """Center on pooled conv5; skip concats on dec5..dec2; dec1/dec0
    without skips; spatial dropout, then a 1x1 final conv."""

    def __init__(self, encoder_depth=34, num_classes=2, num_filters=32,
                 dropout_2d=0.0, is_deconv=True):
        super().__init__()
        nf = num_filters
        self.encoder = ResNetEncoder(encoder_depth)
        bottom = self.encoder.bottom_channels
        self.pool = nn.MaxPool2d(2, 2)
        self.center = DecoderBlockV2(bottom, nf * 16, nf * 8, is_deconv)
        self.dec5 = DecoderBlockV2(bottom + nf * 8, nf * 16, nf * 8, is_deconv)
        self.dec4 = DecoderBlockV2(bottom // 2 + nf * 8, nf * 16, nf * 8,
                                   is_deconv)
        self.dec3 = DecoderBlockV2(bottom // 4 + nf * 8, nf * 8, nf * 2,
                                   is_deconv)
        self.dec2 = DecoderBlockV2(bottom // 8 + nf * 2, nf * 4, nf * 4,
                                   is_deconv)
        self.dec1 = DecoderBlockV2(nf * 4, nf * 4, nf, is_deconv)
        self.dec0 = ConvRelu(nf, nf)
        self.dropout = SpatialDropout(dropout_2d)
        self.final = nn.Conv2d(nf, num_classes, 1)

    def forward(self, x):
        conv1, conv2, conv3, conv4, conv5 = self.encoder(x)
        dec = self.center(self.pool(conv5))
        dec = self.dec5(torch.cat([dec, conv5], 1))
        dec = self.dec4(torch.cat([dec, conv4], 1))
        dec = self.dec3(torch.cat([dec, conv3], 1))
        dec = self.dec2(torch.cat([dec, conv2], 1))
        dec = self.dec0(self.dec1(dec))
        return self.final(self.dropout(dec)).float()


class AlbuNet(UNetResNet):
    """ResNet34 U-Net without the pre-final dropout (the reference's
    AlbuNet; same state-dict keys as UNetResNet(34))."""

    def __init__(self, num_classes=2, num_filters=32, is_deconv=True):
        super().__init__(34, num_classes, num_filters, 0.0, is_deconv)
