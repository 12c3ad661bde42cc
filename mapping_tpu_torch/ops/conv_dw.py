"""Filter gradient (dW) of a stride-1 SAME convolution, plain PyTorch.

The plain version of the CUDA kernel in mapping_tpu_torch/kernels/conv_dw.py
(which replaces the TPU kernel `_dw_kernel`, tools/dw_probe.py:70). The
tests hold it against the JAX package's `dw_pallas` and `dw_xla` and
against torch's own conv weight gradient; the chip check holds the kernel
against it. Nothing on the training path calls it: the train step takes
its dW from autograd.
"""

import torch
import torch.nn.functional as F


def conv_dw_plain(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """x (N, C_in, H, W), dy (N, C_out, H, W), odd k -> the float32 weight
    gradient (C_out, C_in, k, k) of the stride-1 conv with k // 2 zero
    padding: x and dy are cast to float32, x is zero-padded, and each tap
    is one (N*H*W, C_in)^T @ (N*H*W, C_out) matmul on the shifted x."""
    n, ci, h, w = x.shape
    co = dy.shape[1]
    ph = k // 2
    xp = F.pad(x.float(), (ph, ph, ph, ph))
    dyf = dy.float().permute(0, 2, 3, 1).reshape(-1, co)
    out = torch.empty((co, ci, k, k), dtype=torch.float32, device=x.device)
    for dh in range(k):
        for dw in range(k):
            xs = xp[:, :, dh:dh + h, dw:dw + w].permute(0, 2, 3, 1)
            out[:, :, dh, dw] = (xs.reshape(-1, ci).t() @ dyf).t()
    return out
