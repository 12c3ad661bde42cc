"""Batch preprocessing on the device, and an in-memory training flow.

Counterpart of mapping_tpu/data/loader.py for the `resize` loader mode:
`infer_batch_resize` (`_infer_batch_resize`), `eval_batch_resize`,
`train_batch_resize` and `_resize_target`, and `in_memory_train_flow`,
which keeps the `(flow, steps)` contract of `SegmentationLoader._train_gen`
for tiles already in host memory. Targets are (B, H, W, 3) [mask, distance,
size] and may arrive as uint16 (the JAX loader's host format); they are
cast to float32 on the device. Host decode of image files and the
crop/pad loader modes are not ported yet (ROADMAP items 3 and 12).
"""

from typing import Optional, Tuple

import numpy as np
import torch

from mapping_tpu_torch.data.augment import (apply_fast_augment,
                                            normalize_image, resize_bilinear,
                                            resize_nearest,
                                            sample_fast_augment)


def infer_batch_resize(image_u8: torch.Tensor, size: Tuple[int, int]):
    """(B, H, W, 3) uint8 -> (B, size[0], size[1], 3) float32: /255, bilinear
    resize to `size`, ImageNet normalisation; on the input's device."""
    img = resize_bilinear(image_u8.to(torch.float32) / 255.0, size)
    return normalize_image(img)


def _resize_target(target, size: Tuple[int, int]):
    """[mask, distance, size] float targets -> `size`: nearest for the mask
    and size channels, bilinear for the distance."""
    near = resize_nearest(target[..., [0, 2]], size)
    lin = resize_bilinear(target[..., 1:2], size)
    return torch.cat([near[..., :1], lin, near[..., 1:]], dim=-1)


def train_batch_resize(generator: Optional[torch.Generator], image_u8,
                       target, size: Tuple[int, int], augment: bool = True):
    """A training batch on the inputs' device: (B, H, W, 3) uint8 images and
    (B, H, W, 3) targets -> {"image": normalised float32 at `size`,
    "target": float32 at `size`}. With `augment`, fast_seq parameters are
    drawn from `generator` and applied before the resize."""
    img = image_u8.to(torch.float32) / 255.0
    target = target.to(torch.float32)
    if augment:
        img, target = apply_fast_augment(
            img, target, sample_fast_augment(img.shape[0], generator))
    img = resize_bilinear(img, size)
    return {"image": normalize_image(img),
            "target": _resize_target(target, size)}


def eval_batch_resize(image_u8, target, size: Tuple[int, int]):
    """A validation batch: no augmentation; `target` may be None."""
    out = {"image": infer_batch_resize(image_u8, size)}
    if target is not None:
        out["target"] = _resize_target(target.to(torch.float32), size)
    return out


class _TrainFlow:
    """One pass per iteration over host arrays, in a new order each time."""

    def __init__(self, images, targets, batch_size, size, generator, device,
                 augment):
        self.images, self.targets = images, targets
        self.batch_size, self.size = batch_size, tuple(size)
        self.generator, self.device = generator, torch.device(device)
        self.augment = augment
        self.steps = -(-len(images) // batch_size)

    def __iter__(self):
        if self.images is None:
            raise RuntimeError("the flow is closed")
        order = torch.randperm(len(self.images),
                               generator=self.generator).numpy()
        for i in range(self.steps):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            image_b = torch.from_numpy(self.images[idx]).to(self.device)
            target_b = torch.from_numpy(self.targets[idx]).to(self.device)
            yield train_batch_resize(self.generator, image_b, target_b,
                                     self.size, self.augment)

    def __len__(self):
        return self.steps

    def close(self):
        """Drop the references to the host arrays; the flow cannot be
        iterated again."""
        self.images = self.targets = None


def in_memory_train_flow(images_u8: np.ndarray, targets: np.ndarray,
                         batch_size: int, size: Tuple[int, int],
                         generator: torch.Generator, device="cuda",
                         augment: bool = True):
    """(flow, steps) over (N, H, W, 3) uint8 tiles and (N, H, W, 3) targets
    (uint16 or float) held in host memory: each pass reshuffles with
    `generator`, copies each batch to `device` and preprocesses it there
    with `train_batch_resize` (augmentation parameters from the same
    generator). The last batch of a pass may be smaller."""
    flow = _TrainFlow(images_u8, targets, batch_size, size, generator, device,
                      augment)
    return flow, flow.steps
