"""Mean-field CRF refinement of softmax maps.

Counterpart of mapping_tpu/ops/crf.py (the reference's experimental
`dense_crf`: pydensecrf's DenseCRF2D with a Gaussian smoothness term and a
bilateral appearance term, Potts compatibility, N mean-field iterations).
No pipeline uses it. XLA compiled the JAX version without a Pallas kernel,
so this is plain torch, on the inputs' device.

Two appearance-kernel evaluators, chosen by bandwidth as in JAX:
- windowed (small sxy): every pair within a (2r + 1)^2 window,
  r = ceil(3 sxy), weights exp(-|dp|^2 / 2 sxy^2 - |dI|^2 / 2 srgb^2);
- bilateral grid (sxy >= 4 under "auto"): splat onto a 5-D (y/sxy,
  x/sxy, r/srgb, g/srgb, b/srgb) grid (`index_add_`), a [1, 4, 6, 4, 1]
  blur along each axis, and a multilinear slice back, with the self term
  removed. On the card `index_add_` adds in no fixed order, so the grid
  is reproducible only to float rounding.

The smoothness kernel is an exact separable Gaussian with edge padding.
Update: Q <- softmax(log U + compat_g (k_g * Q - Q) + compat_b (k_b * Q)).
"""

import itertools
import math

import torch


def _gaussian_kernel1d(sigma, radius, device):
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return k / torch.sum(k)


def _gaussian_blur(x, sigma, radius):
    """Separable Gaussian over (H, W, C), edge-padded."""
    k = _gaussian_kernel1d(sigma, radius, x.device)
    for axis in (0, 1):
        n = x.shape[axis]
        base = torch.arange(n, device=x.device)
        taps = torch.stack([
            x.index_select(axis, torch.clamp(base + i - radius, 0, n - 1))
            for i in range(2 * radius + 1)])
        x = torch.einsum("k,khwc->hwc", k, taps)
    return x


def _shift(x, dy, dx):
    """(H, W, C) shifted so that out[y, x] = in[y + dy, x + dx],
    zero-filled."""
    h, w = x.shape[:2]
    out = torch.zeros_like(x)
    out[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)] = \
        x[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)]
    return out


def _bilateral_message(q, image, sxy, srgb, radius):
    """Windowed bilateral filtering of Q guided by the RGB image
    (0..255), the centre excluded."""
    msg = torch.zeros_like(q)
    norm = torch.zeros(q.shape[:2] + (1,), dtype=q.dtype, device=q.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            spatial = math.exp(-(dy * dy + dx * dx) / (2.0 * sxy * sxy))
            color = torch.exp(
                -torch.sum((image - _shift(image, dy, dx)) ** 2, -1,
                           keepdim=True) / (2.0 * srgb * srgb))
            wgt = spatial * color
            msg = msg + wgt * _shift(q, dy, dx)
            norm = norm + wgt
    return msg / torch.clamp_min(norm, 1e-8)


def _shift_axis(g, axis, offset):
    """Shift along `axis` by `offset`, zero-filled."""
    n, k = g.shape[axis], abs(offset)
    if k >= n:
        return torch.zeros_like(g)
    zeros = torch.zeros_like(g.narrow(axis, 0, k))
    if offset > 0:
        return torch.cat([zeros, g.narrow(axis, 0, n - k)], axis)
    return torch.cat([g.narrow(axis, k, n - k), zeros], axis)


def _grid_blur_axis(g, axis):
    """[1, 4, 6, 4, 1] blur along one grid axis, zero boundary."""
    return (6.0 * g
            + 4.0 * (_shift_axis(g, axis, 1) + _shift_axis(g, axis, -1))
            + (_shift_axis(g, axis, 2) + _shift_axis(g, axis, -2)))


def _bilateral_grid_message(q, image, sxy, srgb):
    """Fully connected bilateral filtering of Q (H, W, C) through a 5-D
    bilateral grid, the self term removed; image (H, W, 3) in 0..255."""
    h, w, c = q.shape
    dev = q.device
    gy = int(math.ceil((h - 1) / sxy)) + 3
    gx = int(math.ceil((w - 1) / sxy)) + 3
    gc = int(math.ceil(255.0 / srgb)) + 3

    yy = (torch.arange(h, dtype=torch.float32, device=dev) / sxy)[:, None] \
        .expand(h, w)
    xx = (torch.arange(w, dtype=torch.float32, device=dev) / sxy)[None, :] \
        .expand(h, w)
    coords = torch.cat([yy[..., None] + 1.0, xx[..., None] + 1.0,
                        image.to(torch.float32) / srgb + 1.0], -1)
    lo = torch.floor(coords)
    frac = coords - lo
    lo = lo.to(torch.int64)

    dims = (gy, gx, gc, gc, gc)
    strides = torch.tensor([math.prod(dims[i + 1:]) for i in range(5)],
                           dtype=torch.int64, device=dev)
    vals = torch.cat([q, torch.ones((h, w, 1), dtype=q.dtype, device=dev)],
                     -1).reshape(-1, c + 1)

    corner_ids, corner_wts = [], []
    for corner in itertools.product((0, 1), repeat=5):
        off = torch.tensor(corner, dtype=torch.int64, device=dev)
        wgt = torch.prod(torch.where(off == 1, frac, 1.0 - frac), -1)
        corner_ids.append(torch.sum((lo + off) * strides, -1).reshape(-1))
        corner_wts.append(wgt.reshape(-1))
    grid = torch.zeros((math.prod(dims), c + 1), dtype=torch.float32,
                       device=dev)
    grid.index_add_(0, torch.cat(corner_ids),
                    vals.repeat(32, 1) * torch.cat(corner_wts)[:, None])

    g = grid.reshape(dims + (c + 1,))
    for axis in range(5):
        g = _grid_blur_axis(g, axis)
    g = g.reshape(-1, c + 1)

    out = torch.zeros((h * w, c + 1), dtype=torch.float32, device=dev)
    for idx, wgt in zip(corner_ids, corner_wts):
        out = out + wgt[:, None] * g[idx]
    out = out.reshape(h, w, c + 1)
    norm, msg = out[..., -1:], out[..., :-1]
    self_mass = torch.prod(6.0 - 4.0 * frac + 4.0 * frac * frac, -1,
                           keepdim=True)
    return (msg - self_mass * q) / torch.clamp_min(norm - self_mass, 1e-8)


def dense_crf(image, probs, iterations: int = 5,
              compat_gaussian: float = 3.0, sxy_gaussian: float = 1.0,
              compat_bilateral: float = 10.0, sxy_bilateral: float = 1.0,
              srgb: float = 50.0, radius_gaussian: int = 0,
              radius_bilateral: int = 0, bilateral_mode: str = "auto"):
    """Refine class probabilities with a mean-field CRF.

    image: (H, W, 3) RGB in [0, 1] (denormalised); probs: (H, W, C)
    softmax probabilities; radius_*: stencil radii, 0 = ceil(3 sigma);
    bilateral_mode: "window" | "grid" | "auto" (the grid from sxy_bilateral
    >= 4). Returns (H, W, C) float32 probabilities."""
    image = torch.as_tensor(image)
    probs = torch.as_tensor(probs, device=image.device)
    if radius_gaussian <= 0:
        radius_gaussian = int(math.ceil(3.0 * sxy_gaussian))
    if radius_bilateral <= 0:
        radius_bilateral = int(math.ceil(3.0 * sxy_bilateral))
    if bilateral_mode == "auto":
        bilateral_mode = "grid" if sxy_bilateral >= 4.0 else "window"

    image255 = image.to(torch.float32) * 255.0
    q = probs.to(torch.float32)
    log_unary = torch.log(torch.clamp_min(q, 1e-8))
    for _ in range(iterations):
        m_gauss = _gaussian_blur(q, sxy_gaussian, radius_gaussian) - q
        if bilateral_mode == "grid":
            m_bilat = _bilateral_grid_message(q, image255, sxy_bilateral,
                                              srgb)
        else:
            m_bilat = _bilateral_message(q, image255, sxy_bilateral, srgb,
                                         radius_bilateral)
        q = torch.softmax(log_unary + compat_gaussian * m_gauss
                          + compat_bilateral * m_bilat, -1)
    return q


def dense_crf_batch(images, probs, **kwargs):
    """Batch form: images (B, H, W, 3), probs (B, H, W, C)."""
    images = torch.as_tensor(images)
    probs = torch.as_tensor(probs, device=images.device)
    return torch.stack([dense_crf(im, p, **kwargs)
                        for im, p in zip(images, probs)])
