"""Per-instance reductions over labelled masks.

Counterpart of mapping_tpu/ops/instance.py `instance_areas_and_prob_sums`.
The JAX version reduces with a one-hot matmul and a bf16 hi/lo split of the
probabilities, a TPU workaround for serialized scatters; the contract it
meets is exact int32 areas and float32 probability sums, and scatter_add_
meets it here. It accumulates in float64: a float32 running sum over an
instance of tens of thousands of pixels drifts by ~1e-5 relative.
"""

import torch


def instance_areas_and_prob_sums(labels, probabilities, max_instances):
    """labels (M, H, W) int in 0..N, probabilities (M, H, W) float ->
    areas (M, max_instances + 1) int32, sums (M, max_instances + 1) float32.

    Index 0 is the background. Labels above `max_instances` count nowhere,
    as in the JAX version."""
    m = labels.shape[0]
    n = max_instances + 1
    idx = labels.reshape(m, -1).to(torch.int64)
    idx = torch.where(idx > max_instances, n, idx)  # one dropped slot
    areas = torch.zeros((m, n + 1), dtype=torch.int64, device=labels.device)
    areas.scatter_add_(1, idx, torch.ones_like(idx))
    sums = torch.zeros((m, n + 1), dtype=torch.float64, device=labels.device)
    sums.scatter_add_(1, idx, probabilities.reshape(m, -1).to(torch.float64))
    return areas[:, :n].to(torch.int32), sums[:, :n].to(torch.float32)
