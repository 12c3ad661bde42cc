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
    itself are nn.BatchNorm2d's.

    Data parallel: while a train step on a rank sets `group` (a
    parallel.distributed.DataParallel), the statistics are those of the
    global batch, as in the JAX package's mesh step, and the running
    statistics take the global mean and biased variance
    (`_GlobalBatchNorm`)."""

    group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        if self.group is not None:
            out, mean, var = _GlobalBatchNorm.apply(
                x, self.weight, self.bias, self.eps, self.group)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var)
            return out
        var = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                           True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            keep = (1.0 - self.momentum) * self.running_var
            self.running_var.copy_((var - keep) * ((n - 1) / n) + keep)
        return out


def _per_channel(v):
    return v[None, :, None, None]


def _at_least_f32(t):
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _dense(t):
    """t itself where it is contiguous in NCHW or channels-last order."""
    if t.is_contiguous() or t.is_contiguous(
            memory_format=torch.channels_last):
        return t
    return t.contiguous()


def _global_stats(x, eps, group):
    """Per-channel (mean, invstd, biased var) of the group's global batch,
    by one all-gather of each rank's count, mean and spread; and the
    ranks' counts. On a card, torch's fused batch-norm statistics (the
    kernels of nn.SyncBatchNorm): Welford's mean and invstd per rank,
    combined by the parallel Welford of batch_norm_gather_stats_with_counts.
    On the CPU, each rank's mean and M2 = sum((x - mean)^2) (two passes)
    combined by Chan's formula. Both are exact in real arithmetic and free
    of the cancellation of E[x^2] - mean^2."""
    c, count = x.shape[1], x.numel() // x.shape[1]
    if x.is_cuda:
        mean, invstd = torch.batch_norm_stats(x, eps)
        stats = group.all_gather(torch.cat([mean, invstd,
                                            mean.new_full((1,), count)]))
        counts = stats[:, -1]
        # running statistics to update with momentum 0, which only set the
        # kernel's type to the statistics' (else x's, bf16 under autocast);
        # the caller updates its own with the biased variance
        unused = mean.new_empty((2, c))
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, stats[:, :c].contiguous(), stats[:, c:2 * c].contiguous(),
            unused[0], unused[1], 0.0, eps, counts)
        return mean, invstd, invstd.pow(-2) - eps, counts
    var, mean = torch.var_mean(_at_least_f32(x), (0, 2, 3), correction=0)
    stats = group.all_gather(torch.cat([mean, var * count,
                                        mean.new_full((1,), count)]))
    means, m2s, counts = stats[:, :c], stats[:, c:2 * c], stats[:, -1:]
    n = counts.sum()
    mean = (counts * means).sum(0) / n
    var = (m2s.sum(0) + (counts * (means - mean).square()).sum(0)) / n
    return mean, torch.rsqrt(var + eps), var, counts[:, 0]


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch norm over the global batch of a process group:
    x (N, C, H, W) on this rank -> (y in x's dtype, mean, biased var),
    with one collective each way (`_global_stats`; the backward
    all-reduces its two per-channel sums, of dy and of dy * (x - mean)).
    dx is the global batch's; the weight and bias gradients are this
    rank's part (the step averages them over the ranks). On a card the
    forward and backward are torch's fused batch-norm kernels, as in
    nn.SyncBatchNorm (which itself runs only on cards and keeps torch's
    unbiased running variance); on the CPU, float32 (or float64) tensor
    ops."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        x = _dense(x)
        mean, invstd, var, counts = _global_stats(x, eps, group)
        if x.is_cuda:
            out = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        else:
            out = ((_at_least_f32(x) - _per_channel(mean))
                   * _per_channel(invstd * weight)
                   + _per_channel(bias)).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, counts)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        c = x.shape[1]
        if x.is_cuda:
            dy = _dense(dy)
            sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, weight, True, True, True)
            sums = ctx.group.sum(torch.cat([sum_dy, sum_dy_xmu]))
            dx = torch.batch_norm_backward_elemt(
                dy, x, mean, invstd, weight, sums[:c], sums[c:],
                counts.to(torch.int32))
            return dx, dw, db, None, None
        dyf = _at_least_f32(dy)
        xmu = _at_least_f32(x) - _per_channel(mean)
        db = dyf.sum((0, 2, 3))
        sum_dy_xmu = (dyf * xmu).sum((0, 2, 3))
        sums = ctx.group.sum(torch.cat([db, sum_dy_xmu])) / counts.sum()
        dx = ((dyf - _per_channel(sums[:c])
               - xmu * _per_channel(invstd.square() * sums[c:]))
              * _per_channel(invstd * weight))
        return dx.to(dy.dtype), sum_dy_xmu * invstd, db, None, None


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
