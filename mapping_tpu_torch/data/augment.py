"""Image normalisation and resizing on the device.

Counterpart of mapping_tpu/data/augment.py `_MEAN`/`_STD`,
`normalize_image` and `resize_bilinear`. Images keep the JAX package's
NHWC layout.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

from mapping_tpu_torch.constants import MEAN, STD


def _channel_stats(device):
    return (torch.tensor(MEAN, dtype=torch.float32, device=device),
            torch.tensor(STD, dtype=torch.float32, device=device))


def normalize_image(image):
    """uint8/float (B, H, W, 3) -> ImageNet-normalised float32 (0..1
    scale; integer images are divided by 255 first)."""
    x = image.to(torch.float32)
    if not image.dtype.is_floating_point:
        x = x / 255.0
    mean, std = _channel_stats(x.device)
    return (x - mean) / std


def resize_bilinear(x, size: Tuple[int, int]):
    """(B, H, W, C) float -> (B, size[0], size[1], C), half-pixel bilinear.

    jax.image.resize(..., "linear") widens its kernel along every axis that
    shrinks, so this antialiases whenever either axis shrinks; torch's
    antialiased filter is the same triangle there and plain bilinear along
    an axis that grows."""
    h, w = x.shape[1], x.shape[2]
    shrink = size[0] < h or size[1] < w
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return y.permute(0, 2, 3, 1)
