"""Per-instance reductions over labelled masks.

Counterpart of mapping_tpu/ops/instance.py `instance_areas`,
`instance_prob_sums`, `instance_areas_and_prob_sums` and `size_matrix`.
The JAX version reduces with a one-hot matmul and a bf16 hi/lo split of the
probabilities, a TPU workaround for serialized scatters; the contract it
meets is exact int32 areas and float32 probability sums, and scatter_add_
meets it here. It accumulates in float64: a float32 running sum over an
instance of tens of thousands of pixels drifts by ~1e-5 relative.
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
