"""Image normalisation, resizing and training augmentation on the device.

Counterpart of mapping_tpu/data/augment.py `_MEAN`/`_STD`,
`normalize_image`, `resize_bilinear` (and its weights along one axis,
`resize_matrix`), `resize_nearest`, the fixed pads of
the `crop_and_pad` loader mode (`pad_fixed`), its random and centre crops
(`random_crop`, `center_crop`), and `fast_augment` (the reference's
fast_seq: 1-2 of {fliplr(0.5), flipud(0.5), affine rotate +-10 deg,
translate +-10 %}, applied jointly to images and targets), and the
colour shift of test-time augmentation (`color_shift`, the reference's
color_seq). Images keep the JAX package's NHWC layout.

Each random transform is split in two: `sample_fast_augment`,
`sample_random_crop` and `sample_color_shift` draw every image's
parameters from a torch.Generator on the host, and `apply_fast_augment`,
`random_crop` and `color_shift` apply given parameters on the tensors'
device. The random streams of the two
frameworks cannot match, so the tests hold the appliers against the JAX
ops with the JAX draw's parameters.
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
    y = _bilinear(x.permute(0, 3, 1, 2), size, size[0] < h or size[1] < w)
    return y.permute(0, 2, 3, 1)


def _bilinear(x, size, antialias: bool):
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=antialias)


def resize_matrix(n_in: int, n_out: int, antialias: bool,
                  dtype=torch.float64, device="cpu") -> torch.Tensor:
    """(n_out, n_in): the weights of `resize_bilinear` along one
    axis, `antialias` as it decides for the whole 2-D resize (on when
    either axis shrinks), so that resizing that axis is R @ x, as that
    filter computes them in `dtype` on `device`. Read off
    the resize of an identity (channel c holds the unit row c), two
    columns wide: torch's antialiased filter mixes the rows of a map one
    column wide."""
    eye = torch.eye(n_in, dtype=dtype, device=device).reshape(
        1, n_in, n_in, 1)
    return _bilinear(eye.expand(-1, -1, -1, 2), (n_out, 2),
                     antialias)[0, :, :, 0].t()


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


def _pad_nhwc(x, pad: Tuple[int, int], mode: str):
    hp, wp = pad
    y = F.pad(x.permute(0, 3, 1, 2), (wp, wp, hp, hp), mode=mode)
    return y.permute(0, 2, 3, 1)


def pad_replicate(x, pad: Tuple[int, int]):
    """Edge-replicate pad of (B, H, W, C) by (h_pad, w_pad) per side
    (cv2.BORDER_REPLICATE)."""
    return _pad_nhwc(x, pad, "replicate")


def pad_reflect(x, pad: Tuple[int, int]):
    """Reflect pad of (B, H, W, C) by (h_pad, w_pad) per side without
    repeating the border pixel (gfedcb|abcdefgh|gfedcb):
    cv2.BORDER_REFLECT_101, which is torch's "reflect"."""
    return _pad_nhwc(x, pad, "reflect")


#: the reference's PadFixed.PAD_FUNCTION dispatch
PAD_FUNCTION = {"replicate": pad_replicate, "reflect": pad_reflect}


def pad_fixed(x, pad: Tuple[int, int], method: str = "replicate"):
    """Pad by the configured method name; an unknown one raises."""
    try:
        return PAD_FUNCTION[method](x, pad)
    except KeyError:
        raise ValueError(
            f"unknown pad_method {method!r}; expected one of "
            f"{sorted(PAD_FUNCTION)}") from None


def center_crop(x, size: Tuple[int, int]):
    """(B, H, W, C) -> the centred (B, size[0], size[1], C) window."""
    h, w = x.shape[1:3]
    top, left = (h - size[0]) // 2, (w - size[1]) // 2
    return x[:, top:top + size[0], left:left + size[1]]


def sample_random_crop(n: int, image_hw: Tuple[int, int],
                       size: Tuple[int, int], generator: torch.Generator):
    """(tops, lefts) int64 of `n` crops of `size` from images of
    `image_hw`, each uniform over the offsets that fit, drawn on the
    host."""
    (h, w), (ch, cw) = image_hw, size
    if ch > h or cw > w:
        raise ValueError(f"crop {size} larger than the images {image_hw}")
    return (torch.randint(0, h - ch + 1, (n,), generator=generator),
            torch.randint(0, w - cw + 1, (n,), generator=generator))


def random_crop(images, targets, tops, lefts, size: Tuple[int, int]):
    """The joint crop of the reference's RandomCropFixedSize: image i and
    its targets cut to `size` at (tops[i], lefts[i])."""
    ch, cw = size
    rows = torch.as_tensor(tops, device=images.device)[:, None] + torch.arange(
        ch, device=images.device)
    cols = torch.as_tensor(lefts, device=images.device)[:, None] \
        + torch.arange(cw, device=images.device)
    batch = torch.arange(images.shape[0], device=images.device)[:, None, None]
    index = (batch, rows[:, :, None], cols[:, None, :])
    return images[index], targets[index]


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


def sample_color_shift(generator: torch.Generator):
    """(choice, add) of one colour shift, drawn on the host: a channel
    0..5 (0-2 H, S, V; 3-5 R, G, B) and an amount from U(0, 100)."""
    choice = int(torch.randint(0, 6, (), generator=generator))
    add = float(torch.rand((), generator=generator, dtype=torch.float64))
    return choice, 100.0 * add


def color_shift(image, choice: int, add: float):
    """(H, W, 3) float RGB in 0..255 -> the same with one channel shifted:
    an RGB channel (choice 3-5) += add, clipped to 0..255, or an HSV one
    (0-2) in OpenCV's uint8 scale, H 0..180 wrapping and S, V 0..255
    clipped, then back to RGB (the reference's color_seq)."""
    if choice >= 3:
        out = image.clone()
        out[..., choice - 3] = torch.clamp(image[..., choice - 3] + add, 0,
                                           255)
        return out
    hsv = _rgb_to_hsv(image / 255.0)
    scale = 180.0 if choice == 0 else 255.0
    value = hsv[..., choice] * scale + add
    value = (torch.remainder(value, 180.0) if choice == 0
             else torch.clamp(value, 0, 255))
    hsv = hsv.clone()
    hsv[..., choice] = value / scale
    return torch.clamp(_hsv_to_rgb(hsv) * 255.0, 0, 255)


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    safe = torch.clamp(delta, min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, 0.0, h)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i, 6.0).to(torch.int64)
    sector = [i == k for k in range(6)]

    def select(values):
        out = torch.zeros_like(v)
        for cond, val in zip(sector, values):
            out = torch.where(cond, val, out)
        return out

    # the JAX package's sector table, whose green and blue rows differ
    # from colorsys' in sectors 2-5; the port keeps it
    return torch.stack([select([v, q, p, p, t, v]),
                        select([t, v, q, p, p, q]),
                        select([p, p, t, v, q, v])], dim=-1)
