"""Host resizes byte-exact with Pillow's: bilinear for uint8 RGB images,
bilinear and nearest for float32 (mode "F") planes.

The JAX package resizes a request tile or an artifact's input on the host
with `Image.fromarray(arr).resize((w, h), Image.BILINEAR)`
(mapping_tpu/infer/daemon.py:404-409, infer/artifact.py:448-452). The port
does not import Pillow, so this is that resample in numpy (Pillow's
libImaging/Resample.c): a separable triangle filter over pixel centres,
whose support widens by the scale on a downscale (so it antialiases),
weights normalised per output pixel and rounded to 22-bit fixed point,
a horizontal pass rounded to uint8, then a vertical pass over the rows
the horizontal pass kept. Only the image's own box is resampled (no
`box`, no `reducing_gap`), as `Image.resize` does by default.

The JAX loader resizes the targets of a batch of mixed tile sizes through
Pillow's mode "F" (mapping_tpu/data/loader.py `_assemble`):
`resize_bilinear_f32` is that filter in floating point (float64 weights
normalised by their sequential sum, a float64 sum per output stored as
float32, per pass) and `resize_nearest_f32` Pillow's nearest scale.
"""

import math
from typing import Tuple

import numpy as np

_PRECISION_BITS = 32 - 8 - 2  # Resample.c PRECISION_BITS


def _coefficients(in_size: int, out_size: int):
    """(bounds (out, 2) [first source index, count], integer weights
    (out, ksize)) of Resample.c `precompute_coeffs` +
    `normalize_coeffs_8bpc` for the bilinear filter (support 1)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax)
        w = np.maximum(1.0 - np.abs((x + xmin - center + 0.5) * ss), 0.0)
        total = w.sum()
        if total != 0.0:
            w = w / total
        weights[xx, :xmax] = w
        bounds[xx] = xmin, xmax
    fixed = weights * (1 << _PRECISION_BITS)
    fixed = np.where(fixed < 0, np.trunc(fixed - 0.5), np.trunc(fixed + 0.5))
    return bounds, fixed.astype(np.int64)


def _clip8(acc):
    out = np.right_shift(acc, _PRECISION_BITS)
    out = np.where(acc >= (1 << _PRECISION_BITS << 8), 255, out)
    return np.where(acc <= 0, 0, out).astype(np.uint8)


def _resample(image, bounds, weights, axis):
    """One pass along `axis` (0 rows, 1 columns) of an (H, W, C) uint8
    image; the taps past each output's count carry weight 0."""
    n_in = image.shape[axis]
    idx = np.minimum(bounds[:, :1] + np.arange(weights.shape[1]), n_in - 1)
    taps = np.take(image.astype(np.int64), idx, axis=axis)
    if axis == 0:  # (out, k, W, C)
        acc = np.einsum("okwc,ok->owc", taps, weights)
    else:  # (H, out, k, C)
        acc = np.einsum("hokc,ok->hoc", taps, weights)
    return _clip8(acc + (1 << (_PRECISION_BITS - 1)))


def resize_bilinear_u8(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (size[0], size[1], C) uint8, equal byte for byte
    to `Image.fromarray(image).resize((size[1], size[0]),
    Image.BILINEAR)` for RGB images."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3:
        raise ValueError(f"expected (H, W, C) uint8, got {image.dtype} "
                         f"{image.shape}")
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = image.shape[:2]
    if out_h < 1 or out_w < 1:
        raise ValueError(f"bad target size {size}")
    if (out_h, out_w) == (in_h, in_w):
        return image.copy()
    bounds_h, weights_h = _coefficients(in_w, out_w)
    bounds_v, weights_v = _coefficients(in_h, out_h)
    out = image
    if out_w != in_w:
        # only the source rows the vertical pass reads
        first = int(bounds_v[0, 0])
        last = int(bounds_v[-1, 0] + bounds_v[-1, 1])
        out = _resample(image[first:last], bounds_h, weights_h, axis=1)
        bounds_v = bounds_v.copy()
        bounds_v[:, 0] -= first
    if out_h != in_h:
        out = _resample(out, bounds_v, weights_v, axis=0)
    return np.ascontiguousarray(out)


def _float_weights(in_size: int, out_size: int):
    """(bounds, float64 weights) of `precompute_coeffs` for the 32-bit
    float passes: the weights normalised by their sequential sum, not
    rounded to fixed point."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ss = 1.0 / filterscale
        w = [max(1.0 - abs((x + xmin - center + 0.5) * ss), 0.0)
             for x in range(xmax)]
        total = 0.0
        for v in w:
            total += v
        weights[xx, :xmax] = [v / total for v in w] if total != 0.0 else w
        bounds[xx] = xmin, xmax
    return bounds, weights


def _resample_f32(image, bounds, weights, axis):
    """One float pass along `axis` of an (H, W) float32 image: each
    output is the sequential float64 sum over its taps, stored as
    float32, as Resample.c's 32bpc passes do."""
    n_in = image.shape[axis]
    idx = np.minimum(bounds[:, :1] + np.arange(weights.shape[1]), n_in - 1)
    acc = 0.0
    for j in range(weights.shape[1]):
        taps = np.take(image, idx[:, j], axis=axis).astype(np.float64)
        w = weights[:, j][:, None] if axis == 0 else weights[:, j][None, :]
        acc = acc + taps * w
    return np.asarray(acc, np.float32)


def resize_bilinear_f32(image: np.ndarray, size: Tuple[int, int]
                        ) -> np.ndarray:
    """(H, W) float32 -> size, equal to `Image.fromarray(image, "F")
    .resize((size[1], size[0]), Image.BILINEAR)`: the triangle filter of
    `resize_bilinear_u8` in floating point, horizontal pass first."""
    image = np.asarray(image, np.float32)
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = image.shape
    out = image
    bounds_v, weights_v = _float_weights(in_h, out_h)
    if out_w != in_w:
        first = int(bounds_v[0, 0])
        last = int(bounds_v[-1, 0] + bounds_v[-1, 1])
        out = _resample_f32(image[first:last], *_float_weights(in_w, out_w),
                            axis=1)
        bounds_v = bounds_v.copy()
        bounds_v[:, 0] -= first
    if out_h != in_h:
        out = _resample_f32(out, bounds_v, weights_v, axis=0)
    return np.ascontiguousarray(out, np.float32)


def resize_nearest_f32(image: np.ndarray, size: Tuple[int, int]
                       ) -> np.ndarray:
    """(H, W) -> size, equal to Pillow's NEAREST resize of a mode "F"
    image (Geometry.c `ImagingScaleAffine`): per axis the source position
    starts at scale / 2 and grows by scale = in / out, summed in float64
    one step at a time, and is truncated to an index."""
    image = np.asarray(image)

    def index(n_in, n_out):
        scale = n_in / n_out
        pos = np.cumsum(np.concatenate([[scale * 0.5],
                                        np.full(n_out - 1, scale)]))
        return np.minimum(pos.astype(np.int64), n_in - 1)

    return image[index(image.shape[0], int(size[0]))][
        :, index(image.shape[1], int(size[1]))]
