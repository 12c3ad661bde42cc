"""Image normalisation, resizing and training augmentation on the device.

Counterpart of mapping_tpu/data/augment.py `_MEAN`/`_STD`,
`normalize_image`, `resize_bilinear`, `resize_nearest`, and `fast_augment`
(the reference's fast_seq: 1-2 of {fliplr(0.5), flipud(0.5), affine
rotate +-10 deg, translate +-10 %}, applied jointly to images and targets).
Images keep the JAX package's NHWC layout.

The augmentation is split in two: `sample_fast_augment` draws every
image's parameters from a torch.Generator on the host, and
`apply_fast_augment` applies given parameters on the tensors' device. The
random streams of the two frameworks cannot match, so the tests hold the
applier against the JAX ops with fixed parameters.
"""

import math
from typing import Dict, Tuple

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


def resize_nearest(x, size: Tuple[int, int]):
    """(B, H, W, C) -> (B, size[0], size[1], C), nearest neighbour at
    half-pixel centres: source index floor((i + 0.5) * (1 / out) * in) in
    float32, which is how XLA evaluates jax.image.resize "nearest". torch's
    "nearest-exact" rounds otherwise where the product is near an integer
    (50 -> 41 picks another neighbour for one of 41 rows)."""
    def index(n_in, n_out):
        i = torch.arange(n_out, dtype=torch.float32, device=x.device)
        return torch.floor((i + 0.5) * (1.0 / n_out) * n_in).long()

    return x[:, index(x.shape[1], size[0])][:, :, index(x.shape[2], size[1])]


def _affine_grid(h, w, angle_deg, tx_frac, ty_frac):
    """Per-image sampling coordinates (B, H, W) for a rotation by
    `angle_deg` (B,) degrees about the image centre plus a translation by
    (tx_frac * w, ty_frac * h): imgaug Affine semantics, as in the JAX
    package. All float32."""
    dev = angle_deg.device
    theta = (-angle_deg.float() * math.pi / 180.0)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    cos, sin = torch.cos(theta), torch.sin(theta)
    src_y = cos * yy - sin * xx + cy - ty_frac.float()[:, None, None] * h
    src_x = sin * yy + cos * xx + cx - tx_frac.float()[:, None, None] * w
    return src_y, src_x


def _sample(img, src_y, src_x, order):
    """img (B, H, W, C) at (B, H, W) coordinates: bilinear (order 1) or
    nearest (order 0, half-to-even rounding); outside the image is 0."""
    b, h, w = img.shape[:3]
    batch = torch.arange(b, device=img.device)[:, None, None]

    def gather(yi, xi):
        vals = img[batch, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        return vals * inside[..., None].to(img.dtype)

    if order == 0:
        return gather(torch.round(src_y).long(), torch.round(src_x).long())
    y0 = torch.floor(src_y).long()
    x0 = torch.floor(src_x).long()
    fy = (src_y - y0)[..., None]
    fx = (src_x - x0)[..., None]
    top = gather(y0, x0) * (1 - fx) + gather(y0, x0 + 1) * fx
    bot = gather(y0 + 1, x0) * (1 - fx) + gather(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def sample_fast_augment(n: int, generator: torch.Generator
                        ) -> Dict[str, torch.Tensor]:
    """Parameters of fast_seq for `n` images, drawn on the host: SomeOf(1-2)
    of the three ops, each chosen flip firing with probability 0.5, and an
    unchosen affine set to the identity (angle and translations 0)."""
    n_ops = torch.randint(1, 3, (n,), generator=generator)
    order = torch.argsort(torch.rand((n, 3), generator=generator), dim=1)
    rank = torch.argsort(order, dim=1)  # position of each op in the order
    selected = rank < n_ops[:, None]
    coin = torch.rand((n, 2), generator=generator) < 0.5
    u = torch.rand((n, 3), generator=generator) * 2 - 1
    affine = selected[:, 2].float()
    return {"fliplr": selected[:, 0] & coin[:, 0],
            "flipud": selected[:, 1] & coin[:, 1],
            "angle": u[:, 0] * 10.0 * affine,
            "tx": u[:, 1] * 0.1 * affine,
            "ty": u[:, 2] * 0.1 * affine}


def apply_fast_augment(images, targets, params: Dict[str, torch.Tensor]):
    """images (B, H, W, 3) float, targets (B, H, W, 3) float [mask,
    distance, size] -> both flipped (left-right, then up-down) and warped
    per `params`: images and distances bilinear, mask and size nearest, as
    in the JAX `_fast_augment_one`."""
    h, w = images.shape[1:3]
    dev = images.device
    p = {k: v.to(dev) for k, v in params.items()}
    lr = p["fliplr"][:, None, None, None]
    ud = p["flipud"][:, None, None, None]
    images = torch.where(lr, images.flip(2), images)
    targets = torch.where(lr, targets.flip(2), targets)
    images = torch.where(ud, images.flip(1), images)
    targets = torch.where(ud, targets.flip(1), targets)
    src_y, src_x = _affine_grid(h, w, p["angle"], p["tx"], p["ty"])
    images = _sample(images, src_y, src_x, order=1)
    nearest = _sample(targets[..., [0, 2]], src_y, src_x, order=0)
    linear = _sample(targets[..., 1:2], src_y, src_x, order=1)
    return images, torch.cat([nearest[..., :1], linear, nearest[..., 1:]],
                             dim=-1)
