"""Grey/binary morphology with a square footprint.

Counterpart of mapping_tpu/ops/morphology.py (skimage `rectangle(k, k)`
erosion and dilation): a k x k min or max filter over the last two axes,
built from F.pad and max_pool2d, erosion being the negated max-pool of the
negated image. skimage centres an even footprint at index k // 2, so
erosion pads (k // 2, k - 1 - k // 2) on each axis and dilation the mirror
image. Erosion pads with the dtype's maximum, so the image border does not
erode; dilation pads with its minimum.

max_pool2d takes no integer tensors on CUDA, so every dtype is pooled in
float32 and cast back: exact for masks and for integer values below 2^24
in magnitude, which CCL labels are (at most H * W, 90,000 on a 300^2 tile).
"""

import torch
import torch.nn.functional as F


def _window_pad(k: int):
    before = k // 2
    return before, k - 1 - before


def _extreme(dtype, which):
    if dtype == torch.bool:
        return float(which == "max")
    if dtype.is_floating_point:
        return float("inf") if which == "max" else float("-inf")
    info = torch.iinfo(dtype)
    return float(info.max if which == "max" else info.min)


def _max_filter(x, size, pad, fill):
    """k x k max over the last two axes of a float32 tensor padded by
    `pad` = (before, after) on both axes with `fill`."""
    lead = x.shape[:-2]
    y = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    y = F.pad(y, (pad[0], pad[1], pad[0], pad[1]), value=fill)
    y = F.max_pool2d(y, size, stride=1)
    return y.reshape(lead + y.shape[-2:])


def erode(image: torch.Tensor, size: int) -> torch.Tensor:
    """Min filter with a size x size square over the last two axes."""
    if size <= 0:
        return image
    out = -_max_filter(-image.to(torch.float32), size, _window_pad(size),
                       -_extreme(image.dtype, "max"))
    return out.to(image.dtype)


def dilate(image: torch.Tensor, size: int) -> torch.Tensor:
    """Max filter with a size x size square over the last two axes."""
    if size <= 0:
        return image
    lo, hi = _window_pad(size)
    out = _max_filter(image.to(torch.float32), size, (hi, lo),
                      _extreme(image.dtype, "min"))
    return out.to(image.dtype)
