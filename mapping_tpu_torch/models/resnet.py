"""ResNet encoders (torchvision topology, NCHW).

Counterpart of mapping_tpu/models/resnet.py. Module names are
torchvision's (`conv1`, `bn1`, `layer1.0.conv1`, `layer1.0.downsample.0`,
...) so a reference checkpoint's `encoder.*` keys load unchanged. The stem
pool is a plain 2x2/2 max pool, as in the reference UNet's conv1.
"""

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose training-mode running variance follows Flax.

    Flax's BatchNorm (momentum 0.9, the same as torch's 0.1) updates the
    running variance with the biased batch variance; torch uses the
    unbiased one, n / (n - 1) times larger. The batch norm here updates a
    copy of the running variance (autograd keeps the buffer it was given),
    and the increment momentum * unbiased is scaled back by (n - 1) / n
    into the buffer. State-dict keys, eval mode and the normalisation
    itself are nn.BatchNorm2d's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        var = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                           True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            keep = (1.0 - self.momentum) * self.running_var
            self.running_var.copy_((var - keep) * ((n - 1) / n) + keep)
        return out


def conv_bn(cin, cout, kernel, stride=1):
    """Bias-free conv and its BatchNorm (eps 1e-5), as a (conv, bn) pair."""
    return (nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                      bias=False),
            BatchNorm2d(cout, eps=1e-5))


def _downsample(cin, cout, stride):
    return nn.Sequential(*conv_bn(cin, cout, 1, stride))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1, self.bn1 = conv_bn(cin, planes, 3, stride)
        self.conv2, self.bn2 = conv_bn(planes, planes, 3)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (_downsample(cin, planes, stride) if downsample
                           else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here, torchvision v1.5) -> 1x1 x4."""

    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1, self.bn1 = conv_bn(cin, planes, 1)
        self.conv2, self.bn2 = conv_bn(planes, planes, 3, stride)
        self.conv3, self.bn3 = conv_bn(planes, planes * 4, 1)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (_downsample(cin, planes * 4, stride) if downsample
                           else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


CONFIGS = {
    34: (BasicBlock, (3, 4, 6, 3), 512),
    101: (Bottleneck, (3, 4, 23, 3), 2048),
    152: (Bottleneck, (3, 8, 36, 3), 2048),
}


class ResNetEncoder(nn.Module):
    """Returns the five stage outputs used as U-Net skips: the pooled stem
    (H/4), layer1 (H/4), layer2 (H/8), layer3 (H/16), layer4 (H/32)."""

    def __init__(self, depth=34):
        super().__init__()
        block, layers, self.bottom_channels = CONFIGS[depth]
        self.conv1, self.bn1 = conv_bn(3, 64, 7, 2)
        self.relu = nn.ReLU(inplace=True)
        self.pool = nn.MaxPool2d(2, 2)
        cin = 64
        for stage, n_blocks in enumerate(layers):
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                down = b == 0 and (s != 1 or cin != planes * block.expansion)
                blocks.append(block(cin, planes, s, down))
                cin = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = self.pool(self.relu(self.bn1(self.conv1(x))))
        feats = [x]
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(x)
        return feats
