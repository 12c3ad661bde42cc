"""UNet++, the nested U-Net (`encoder: UNetPlusPlus`; NCHW).

Counterpart of mapping_tpu/models/unetpp.py (Zhou et al., arXiv:1807.10165):
node X[i][j] = block(concat(X[i][0..j-1], up(X[i+1][j-1]))), each block two
bias-free 3x3 convs with the port's Flax-variance BatchNorm and ReLU.
Down the first column a 2x2 VALID max pool; up, the half-pixel bilinear
2x upsample (`blocks.upsample2x`, jax.image.resize "linear"). With
`deep_supervision` the output is the mean of the 1x1 heads on
X[0][1..depth-1]. Module names are the Flax ones (`x{i}_{j}.conv0`, `bn0`,
`final`, `head_{j}`). Input sides must be divisible by 2 ** (depth - 1).
"""

import torch
from torch import nn

from mapping_tpu_torch.models.blocks import upsample2x
from mapping_tpu_torch.models.resnet import conv_bn


class NodeBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv0, self.bn0 = conv_bn(cin, cout, 3)
        self.conv1, self.bn1 = conv_bn(cout, cout, 3)

    def forward(self, x):
        x = torch.relu(self.bn0(self.conv0(x)))
        return torch.relu(self.bn1(self.conv1(x)))


class UNetPlusPlus(nn.Module):
    def __init__(self, num_classes=2, n_filters=32, depth=5,
                 deep_supervision=False):
        super().__init__()
        self.depth = depth
        self.deep_supervision = deep_supervision
        feats = [n_filters * 2 ** i for i in range(depth)]
        for i in range(depth):
            cin = 3 if i == 0 else feats[i - 1]  # RGB tiles
            setattr(self, f"x{i}_0", NodeBlock(cin, feats[i]))
        for j in range(1, depth):
            for i in range(depth - j):
                setattr(self, f"x{i}_{j}",
                        NodeBlock(j * feats[i] + feats[i + 1], feats[i]))
        self.pool = nn.MaxPool2d(2, 2)
        if deep_supervision:
            for j in range(1, depth):
                setattr(self, f"head_{j}", nn.Conv2d(feats[0], num_classes,
                                                     1))
        else:
            self.final = nn.Conv2d(feats[0], num_classes, 1)

    def forward(self, x):
        d = self.depth
        grid = [[None] * d for _ in range(d)]
        for i in range(d):
            inp = x if i == 0 else self.pool(grid[i - 1][0])
            grid[i][0] = getattr(self, f"x{i}_0")(inp)
        for j in range(1, d):
            for i in range(d - j):
                cat = torch.cat(grid[i][:j] + [upsample2x(grid[i + 1][j - 1])],
                                1)
                grid[i][j] = getattr(self, f"x{i}_{j}")(cat)
        if self.deep_supervision:
            heads = [getattr(self, f"head_{j}")(grid[0][j])
                     for j in range(1, d)]
            return (sum(heads) / len(heads)).float()
        return self.final(grid[0][d - 1]).float()
