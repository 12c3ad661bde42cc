"""The from-scratch U-Net (`encoder: from_scratch`) and its multi-head
variant (NCHW).

Counterpart of mapping_tpu/models/scratch.py, with its module names
(`input_block.conv0` / `bn0`, `down{i}`, `floor`, `up_sample{i}`, `up{i}`,
`classification_block`, `output`, `output_leg{i}`), so the map from a
Flax tree is a rename and BatchNorm folding pairs `bnN` with `convN`.

- BatchNorm is the port's Flax-variance `BatchNorm2d` (momentum 0.1 is
  Flax's 0.9; eps 1e-5).
- Dropout is elementwise, after every block but the classification block.
- Max pool: kernel `pool_kernel`, stride `pool_stride`, padding
  (pk - ps + 1) // 2 when pk > ps (Flax pads with -inf, as torch does).
- Upsampling: a bias-free ConvTranspose2d(3 ps, stride ps, padding ps),
  which is Flax's "SAME" transpose (symmetric pad_len / 2 = 2 ps - 1 on
  the dilated input) with the kernel flipped.
- Skip concats put the skip first: [skip, up].

As in the JAX module nothing is asserted about the input sides: where
pool_stride ** repeat_blocks does not divide them, an upsampled map and
its skip differ in size and the concat raises, in both packages.
"""

import torch
from torch import nn

from mapping_tpu_torch.models.blocks import ElementDropout
from mapping_tpu_torch.models.resnet import BatchNorm2d


class ConvBlock(nn.Module):
    """Two conv (+ BatchNorm) + ReLU layers, then dropout unless
    `dropout_last` is off."""

    def __init__(self, cin, cout, kernel, batch_norm, dropout,
                 dropout_last=True):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, cout, kernel, padding="same")
        self.bn0 = BatchNorm2d(cout, eps=1e-5) if batch_norm else None
        self.conv1 = nn.Conv2d(cout, cout, kernel, padding="same")
        self.bn1 = BatchNorm2d(cout, eps=1e-5) if batch_norm else None
        self.dropout = (ElementDropout(dropout)
                        if dropout > 0 and dropout_last else None)

    def forward(self, x):
        for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
            x = conv(x)
            if bn is not None:
                x = bn(x)
            x = torch.relu(x)
        return x if self.dropout is None else self.dropout(x)


class UNet(nn.Module):
    """Input block (n_filters) -> repeat_blocks x [down block (doubling),
    max pool] -> floor block -> repeat_blocks x [transposed-conv upsample,
    concat the skip, up block] -> classification block -> 1x1 output."""

    def __init__(self, conv_kernel=3, pool_kernel=3, pool_stride=2,
                 repeat_blocks=2, n_filters=8, batch_norm=True, dropout=0.1,
                 in_channels=3, out_channels=2, nr_outputs=1):
        super().__init__()
        nf, k, ps = n_filters, conv_kernel, pool_stride
        self.repeat_blocks = repeat_blocks
        self.nr_outputs = nr_outputs

        def block(cin, cout, **kw):
            return ConvBlock(cin, cout, k, batch_norm, dropout, **kw)

        self.input_block = block(in_channels, nf)
        cin = nf
        for i in range(repeat_blocks):
            setattr(self, f"down{i}", block(cin, nf * 2 ** (i + 1)))
            cin = nf * 2 ** (i + 1)
        pad = (pool_kernel - ps + 1) // 2 if pool_kernel > ps else 0
        self.pool = nn.MaxPool2d(pool_kernel, ps, padding=pad)
        self.floor = block(cin, nf * 2 ** (repeat_blocks + 1))
        cin = nf * 2 ** (repeat_blocks + 1)
        for i in reversed(range(repeat_blocks)):
            up = nf * 2 ** (i + 1)
            setattr(self, f"up_sample{i}", nn.ConvTranspose2d(
                cin, up, 3 * ps, stride=ps, padding=ps, bias=False))
            setattr(self, f"up{i}", block(2 * up, up))
            cin = up
        self.classification_block = block(cin, nf, dropout_last=False)
        self._heads(nf, out_channels)

    def _heads(self, nf, out_channels):
        self.output = nn.Conv2d(nf, out_channels, 1)

    def backbone(self, x):
        x = self.input_block(x)
        skips = []
        for i in range(self.repeat_blocks):
            x = getattr(self, f"down{i}")(x)
            skips.append(x)
            x = self.pool(x)
        x = self.floor(x)
        for i in reversed(range(self.repeat_blocks)):
            x = getattr(self, f"up_sample{i}")(x)
            x = getattr(self, f"up{i}")(torch.cat([skips[i], x], 1))
        return self.classification_block(x)

    def forward(self, x):
        return self.output(self.backbone(x)).float()


class UNetMultitask(UNet):
    """`nr_outputs` 1x1 heads (`output_leg{i}`) on the shared backbone;
    returns a list of float32 logits, one per head."""

    def _heads(self, nf, out_channels):
        for i in range(self.nr_outputs):
            setattr(self, f"output_leg{i}", nn.Conv2d(nf, out_channels, 1))

    def forward(self, x):
        x = self.backbone(x)
        return [getattr(self, f"output_leg{i}")(x).float()
                for i in range(self.nr_outputs)]
