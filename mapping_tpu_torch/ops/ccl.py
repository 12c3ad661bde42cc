"""Connected-component labelling (4-connectivity), scipy.ndimage.label order.

Counterpart of mapping_tpu/ops/ccl.py. `connected_components` sends a CUDA
tensor to the hand-written kernels (mapping_tpu_torch/kernels/ccl.py) and a
CPU tensor to the plain versions below; any other device raises. The plain
versions run on any device: the tests hold them against the JAX package,
and the chip check holds the kernels against them.
"""

import torch

from mapping_tpu_torch.kernels import ccl as ccl_kernels

_INF = torch.iinfo(torch.int64).max


def _run_ids(mask):
    """(M, A, B) bool -> run id of every pixel along the last axis (valid at
    foreground pixels; runs numbered in memory order)."""
    left = torch.zeros_like(mask)
    left[..., 1:] = mask[..., :-1]
    return torch.cumsum((mask & ~left).reshape(-1), 0) - 1


def _segment_min(values, ids, n_runs):
    mins = torch.full((n_runs,), _INF, dtype=values.dtype,
                      device=values.device)
    mins.scatter_reduce_(0, ids, values, "amin")
    return mins[ids]


def _label_raw(mask, max_iters):
    """(..., H, W) bool -> int32 labels, 1 + the row-major index of each
    component's minimal pixel, background 0.

    Same algorithm as the JAX version: every foreground pixel starts with
    its own index + 1, and row and column sweeps take the minimum over each
    horizontal and vertical run, alternately, until nothing changes (at most
    `max_iters` rounds). A sweep is a segmented min: scatter_reduce("amin")
    over run ids from a cumsum of run starts."""
    shape = mask.shape
    h, w = shape[-2], shape[-1]
    m = mask.reshape(-1, h, w).to(torch.bool)
    dev = m.device
    flat = m.reshape(-1)
    row_idx = torch.nonzero(flat).squeeze(1)  # foreground, row-major order
    out = torch.zeros(flat.shape, dtype=torch.int32, device=dev)
    if row_idx.numel() == 0:
        return out.reshape(shape)
    row_ids = _run_ids(m)[row_idx]
    mt = m.transpose(1, 2).contiguous()
    col_ids = _run_ids(mt)[mt.reshape(-1)]
    # position in the row-major foreground list of each pixel, col-major
    pos = torch.empty(flat.shape, dtype=torch.int64, device=dev)
    pos[row_idx] = torch.arange(row_idx.numel(), device=dev)
    ids = torch.arange(flat.numel(), device=dev).reshape(m.shape)
    perm = pos[ids.transpose(1, 2).reshape(-1)[mt.reshape(-1)]]
    n_row, n_col = int(row_ids[-1]) + 1, int(col_ids.max()) + 1

    values = row_idx % (h * w) + 1
    for _ in range(max_iters):
        new = _segment_min(values, row_ids, n_row)
        new[perm] = _segment_min(new[perm], col_ids, n_col)
        changed = bool((new != values).any())
        values = new
        if not changed:
            break
    out[row_idx] = values.to(torch.int32)
    return out.reshape(shape)


def _renumber(labels):
    """`_label_raw` labels -> consecutive 1..N per image (0 stays 0).

    A pixel is its component's root iff its label is its own index + 1;
    ranking roots by a row-major cumsum and gathering the rank at each
    pixel's root gives scipy.ndimage.label's numbering."""
    shape = labels.shape
    h, w = shape[-2], shape[-1]
    flat = labels.reshape(-1, h * w).to(torch.int64)
    lin = torch.arange(1, h * w + 1, device=labels.device)
    ranks = torch.cumsum((flat == lin).to(torch.int64), dim=-1)
    root = torch.clamp(flat - 1, min=0)
    out = torch.where(flat > 0, torch.gather(ranks, 1, root), 0)
    return out.reshape(shape).to(torch.int32)


def connected_components(mask, max_iters=None, renumber=True):
    """Label 4-connected components of a (..., H, W) mask batch.

    Args:
        mask: bool or integer tensor; nonzero is foreground.
        max_iters: sweep cap of the plain version (default H + W, always
            enough). The CUDA kernels converge exactly and take no cap: a
            value other than None raises for a CUDA tensor.
        renumber: consecutive 1..N per image in scipy.ndimage.label order;
            otherwise 1 + the index of each component's minimal pixel.

    Returns:
        int32 labels of the mask's shape, on the mask's device.
    """
    mask = mask != 0
    h, w = mask.shape[-2], mask.shape[-1]
    if mask.device.type == "cuda":
        if max_iters is not None:
            raise ValueError("the CUDA union-find converges exactly and "
                             "takes no max_iters")
        flat = mask.reshape(-1, h, w).contiguous()
        labels = ccl_kernels.label_raw(flat)
        if renumber:
            labels = ccl_kernels.renumber(labels)
        return labels.reshape(mask.shape)
    if mask.device.type != "cpu":
        raise ValueError(f"connected_components: no CCL for {mask.device}")
    labels = _label_raw(mask, h + w if max_iters is None else max_iters)
    return _renumber(labels) if renumber else labels
