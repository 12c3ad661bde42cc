"""Exact Euclidean distance transform, as torch ops on any device.

Counterpart of mapping_tpu/ops/edt.py `edt` and `distance_stack_top2`, with
the same float32 arithmetic, so that finite distances come out bit-equal:
  1. the distance along each row to the nearest seed column: the nearest
     seed to the left is a running max of seed columns (cummax), the one to
     the right a running min from the right (reversed cummin), 1e12 where a
     row has none;
  2. the squared row distance g^2, clipped at 1e12, then the exact 2-D
     squared distance D^2(y, x) = min_y' (g^2(y', x) + (y - y')^2), a
     min-plus over the rows evaluated for `chunk` output rows at a time, so
     the (..., chunk, H, W) intermediate stays bounded; then sqrt.
Squares of integers below 2^24 are exact in float32, so the minimum picks
the same value as in the JAX package. The JAX package computes this outside
any Pallas kernel; so does the port.
"""

import torch

BIG = 1e12


def _row_distance(seeds):
    """seeds (..., H, W) bool -> float32 distance along each row to the
    nearest seed."""
    col = torch.arange(seeds.shape[-1], dtype=torch.float32,
                       device=seeds.device)
    left = torch.cummax(torch.where(seeds, col, -BIG), dim=-1).values
    right = torch.cummin(torch.where(seeds, col, BIG).flip(-1),
                         dim=-1).values.flip(-1)
    return torch.minimum(col - left, right - col)


def edt(mask, chunk=16):
    """Distance from each pixel to the nearest nonzero pixel of `mask`
    (..., H, W): scipy.ndimage.distance_transform_edt(mask == 0), zero on
    the mask. float32, of the mask's shape, on its device."""
    seeds = mask != 0
    g = _row_distance(seeds)
    g2 = torch.clamp(g * g, max=BIG)
    h = seeds.shape[-2]
    ys = torch.arange(h, dtype=torch.float32, device=seeds.device)
    blocks = []
    for y0 in range(0, h, chunk):
        y_out = ys[y0:y0 + chunk]
        dy2 = (y_out[:, None] - ys[None, :]) ** 2  # (rows, H)
        vals = g2[..., None, :, :] + dy2[:, :, None]  # (..., rows, H, W)
        blocks.append(torch.amin(vals, dim=-2))
    # float32 sqrt correctly rounded on every device: torch's vectorised
    # CPU sqrt is off by one ulp on some inputs (1421 among them)
    return torch.sqrt(torch.cat(blocks, dim=-2).double()).float()


def distance_stack_top2(distances, valid):
    """The reference's clean_distances on a stack of per-object distances.

    distances (N, H, W) float, valid (N,) bool -> (dist_sum, second): the
    sum of the two smallest distances of the valid objects at each pixel
    and the second smallest; with one valid object the second is its own
    distance, with none both are zero."""
    d = torch.where(valid[:, None, None], distances.to(torch.float32), BIG)
    top2 = torch.topk(d, 2, dim=0, largest=False).values
    n_valid = int(valid.sum())
    nearest = top2[0] if n_valid >= 1 else torch.zeros_like(top2[0])
    second = top2[1] if n_valid >= 2 else nearest
    return nearest + second, second
