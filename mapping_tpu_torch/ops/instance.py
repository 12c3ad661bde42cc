"""Per-instance reductions over labelled masks.

Counterpart of mapping_tpu/ops/instance.py `instance_areas`,
`instance_prob_sums`, `instance_areas_and_prob_sums`, `size_matrix` and
`instance_feature_tensor` (the scoring models' nine features per
instance, `FEATURE_COLUMNS`). The JAX version reduces with a one-hot
matmul and a bf16 hi/lo split of the probabilities, a TPU workaround for
serialized scatters; the contract it meets is exact int32 areas and
float32 probability sums, and scatter_add_ / scatter_reduce_ meet it here.
They accumulate in float64: a float32 running sum over an instance of tens
of thousands of pixels drifts by ~1e-5 relative, and JAX's hi/lo split
differs from the exact sum by about 2^-16 relative.
"""

import math

import torch


def instance_prob_sums(labels, probabilities, max_instances):
    """labels (..., H, W) int in 0..N, probabilities (..., H, W) float ->
    (..., max_instances + 1) float32 sums of the probability over each
    label, index 0 the background. Labels above `max_instances` count
    nowhere, as jax.ops.segment_sum drops out-of-range segments."""
    lead = tuple(labels.shape[:-2])
    m = math.prod(lead)
    n = max_instances + 1
    idx = labels.reshape(m, -1).to(torch.int64)
    idx = torch.where(idx > max_instances, n, idx)  # one dropped slot
    sums = torch.zeros((m, n + 1), dtype=torch.float64, device=labels.device)
    sums.scatter_add_(1, idx, probabilities.reshape(m, -1).to(torch.float64))
    return sums[:, :n].to(torch.float32).reshape(lead + (n,))


def instance_areas_and_prob_sums(labels, probabilities, max_instances):
    """labels (M, H, W) int in 0..N, probabilities (M, H, W) float ->
    areas (M, max_instances + 1) int32, sums (M, max_instances + 1) float32.

    Index 0 is the background. Labels above `max_instances` count nowhere,
    as in the JAX version."""
    return (instance_areas(labels, max_instances),
            instance_prob_sums(labels, probabilities, max_instances))


def instance_areas(labels, max_instances):
    """labels (..., H, W) int in 0..N -> (..., max_instances + 1) int32
    pixel counts, index 0 the background. Labels above `max_instances`
    count nowhere, as jax.ops.segment_sum drops them."""
    lead = tuple(labels.shape[:-2])
    n = max_instances + 1
    idx = labels.reshape(math.prod(lead), -1).to(torch.int64)
    idx = torch.where(idx > max_instances, n, idx)  # one dropped slot
    areas = torch.zeros((idx.shape[0], n + 1), dtype=torch.int64,
                        device=labels.device)
    areas.scatter_add_(1, idx, torch.ones_like(idx))
    return areas[:, :n].to(torch.int32).reshape(lead + (n,))


def size_matrix(labels, max_instances):
    """labels (..., H, W) -> int32 area of each pixel's component, 1 on the
    background (the reference's get_size_matrix).

    As in the JAX version, a label above `max_instances` reads slot
    `max_instances`: the areas drop such labels, and the gather clamps its
    index, so every component numbered `max_instances` or more gets the
    area of component `max_instances` (0 if it has none)."""
    areas = instance_areas(labels, max_instances)
    areas[..., 0] = 1
    idx = torch.clamp(labels, max=max_instances).to(torch.int64)
    flat = areas.reshape(-1, max_instances + 1)
    return torch.gather(flat, 1, idx.reshape(flat.shape[0], -1)).reshape(
        labels.shape)


#: column order of instance_feature_tensor (the GT iou and the threshold
#: are added on the host, scoring.features_from_tensor)
FEATURE_COLUMNS = ("area", "mean_prob", "max_prob", "bbox_ar", "bbox_area",
                   "bbox_fill", "min_dist_to_border", "max_dist_to_border",
                   "contour_length")


def _interior(labels):
    """Foreground pixels whose 4 neighbours carry their label; a neighbour
    outside the image counts as the same label."""
    inside = labels > 0
    same = torch.ones_like(inside)
    same[:, 1:] &= labels[:, 1:] == labels[:, :-1]
    same[:, :-1] &= labels[:, :-1] == labels[:, 1:]
    same[:, :, 1:] &= labels[:, :, 1:] == labels[:, :, :-1]
    same[:, :, :-1] &= labels[:, :, :-1] == labels[:, :, 1:]
    return inside & same


def instance_feature_tensor(labels, probabilities, max_instances):
    """labels (M, H, W) int in 0..N, probabilities (M, H, W) float ->
    (M, max_instances, 9) float32 in FEATURE_COLUMNS order for instances
    1..max_instances; slots without pixels are rows of zeros, and labels
    above `max_instances` count nowhere.

    contour_length = area - interior pixels (`_interior`), the JAX
    version's count, which equals the host oracle's 4-neighbour erosion
    (scoring._contour_length) also where dilated instances touch."""
    m, h, w = labels.shape
    n = max_instances + 1
    dev = labels.device
    idx = labels.reshape(m, -1).to(torch.int64)
    idx = torch.where(idx > max_instances, n, idx)  # one dropped slot

    def scatter(values, reduce, init, dtype):
        out = torch.full((m, n + 1), init, dtype=dtype, device=dev)
        values = values.to(dtype).expand(m, -1)
        if reduce == "sum":
            out.scatter_add_(1, idx, values)
        else:
            out.scatter_reduce_(1, idx, values, reduce)
        return out[:, 1:n]

    rows = torch.arange(h, device=dev).repeat_interleave(w)[None]
    cols = torch.arange(w, device=dev).repeat(h)[None]
    area = scatter(torch.ones_like(idx), "sum", 0, torch.int64)
    prob_sum = scatter(probabilities.reshape(m, -1), "sum", 0, torch.float64)
    interior = scatter(_interior(labels).reshape(m, -1), "sum", 0,
                       torch.int64)
    pmax = scatter(probabilities.reshape(m, -1), "amax", 0, torch.float32)
    big = 1 << 30
    rmin = scatter(rows, "amin", big, torch.int64)
    rmax = scatter(rows, "amax", -1, torch.int64)
    cmin = scatter(cols, "amin", big, torch.int64)
    cmax = scatter(cols, "amax", -1, torch.int64)

    nonempty = area > 0
    area_f = area.to(torch.float32)
    mean_prob = (prob_sum / torch.clamp(area, min=1)).to(torch.float32)
    bh = torch.clamp(rmax + 1 - rmin, min=1).to(torch.float32)
    bw = torch.clamp(cmax + 1 - cmin, min=1).to(torch.float32)
    bbox_area = bh * bw
    dists = torch.stack([rmin, h - (rmax + 1), cmin, w - (cmax + 1)],
                        -1).to(torch.float32)
    contour = (area - interior).to(torch.float32)
    feats = torch.stack([area_f, mean_prob, pmax, bh / bw, bbox_area,
                         area_f / bbox_area, dists.amin(-1), dists.amax(-1),
                         contour], dim=-1)
    return torch.where(nonempty[..., None], feats, 0.0)
