"""Bilinear resize with skimage.transform.resize(order=1) semantics.

Counterpart of mapping_tpu/ops/resize.py (`jax.image.resize`, "linear"):
half-pixel centres, and a triangle filter widened along an axis that
shrinks (antialiased), which `data/augment.resize_bilinear` computes.
"""

from typing import Tuple

import torch

from mapping_tpu_torch.data.augment import resize_bilinear


def resize_hw(image, target_size: Tuple[int, int]) -> torch.Tensor:
    """Resize (..., H, W) bilinearly to (..., *target_size), in float32."""
    x = torch.as_tensor(image, dtype=torch.float32)
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    flat = x.reshape(-1, h, w).permute(1, 2, 0)[None]  # (1, H, W, N)
    out = resize_bilinear(flat, tuple(target_size))[0].permute(2, 0, 1)
    return out.reshape(lead + tuple(out.shape[-2:]))


def resize_chw(image, target_size: Tuple[int, int]) -> torch.Tensor:
    """(C, H, W) -> (C, target_h, target_w)."""
    return resize_hw(image, tuple(target_size))
