"""Inference preprocessing of a uint8 batch on the device.

Counterpart of mapping_tpu/data/loader.py `_infer_batch_resize` (the
`resize` loader mode). Host decode of image files is not ported yet.
"""

from typing import Tuple

import torch

from mapping_tpu_torch.data.augment import normalize_image, resize_bilinear


def infer_batch_resize(image_u8: torch.Tensor, size: Tuple[int, int]):
    """(B, H, W, 3) uint8 -> (B, size[0], size[1], 3) float32: /255, bilinear
    resize to `size`, ImageNet normalisation; on the input's device."""
    img = resize_bilinear(image_u8.to(torch.float32) / 255.0, size)
    return normalize_image(img)
