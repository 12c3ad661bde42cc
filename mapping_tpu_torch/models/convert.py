"""Flax params -> torch state_dict, the inverse of
mapping_tpu/models/torch_convert.py `convert_unet_resnet`.

This carries a UNetResNet trained by the JAX package into the port. Numpy
only: the trees may hold numpy or JAX arrays, and neither framework is
imported here.

Layouts: a Flax conv kernel (kH, kW, I, O) is a torch weight (O, I, kH, kW).
A Flax ConvTranspose kernel (kH, kW, I, O) is the torch ConvTranspose2d
weight (I, O, kH, kW) spatially flipped (torch_convert.py `_deconv`), so the
flip is undone here. BatchNorm scale/bias (params) and mean/var
(batch_stats) become weight/bias/running_mean/running_var.
"""

from typing import Any, Dict

import numpy as np

from mapping_tpu_torch.models.resnet import CONFIGS


def _conv(kernel):
    return np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _deconv(kernel):
    flipped = np.asarray(kernel)[::-1, ::-1]
    return np.ascontiguousarray(np.transpose(flipped, (2, 3, 0, 1)))


def state_dict_from_flax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                         depth: int, is_deconv: bool = True
                         ) -> Dict[str, np.ndarray]:
    """(params, batch_stats) of mapping_tpu UNetResNet(depth) -> the
    reference-named torch state_dict of
    mapping_tpu_torch.models.unet_resnet.UNetResNet(depth)."""
    out: Dict[str, np.ndarray] = {}

    def conv_bias(dst, src):
        out[dst + ".weight"] = _conv(src["kernel"])
        out[dst + ".bias"] = np.asarray(src["bias"])

    def bn(dst, p, s):
        out[dst + ".weight"] = np.asarray(p["scale"])
        out[dst + ".bias"] = np.asarray(p["bias"])
        out[dst + ".running_mean"] = np.asarray(s["mean"])
        out[dst + ".running_var"] = np.asarray(s["var"])
        out[dst + ".num_batches_tracked"] = np.zeros((), np.int64)

    enc, enc_s = params["encoder"], batch_stats["encoder"]
    out["encoder.conv1.weight"] = _conv(enc["conv1"]["kernel"])
    bn("encoder.bn1", enc["bn1"], enc_s["bn1"])
    block, layers, _ = CONFIGS[depth]
    n_convs = 3 if block.expansion == 4 else 2
    for stage, n_blocks in enumerate(layers):
        for b in range(n_blocks):
            src = f"layer{stage + 1}_{b}"
            dst = f"encoder.layer{stage + 1}.{b}"
            p, s = enc[src], enc_s[src]
            for ci in range(1, n_convs + 1):
                out[f"{dst}.conv{ci}.weight"] = _conv(p[f"conv{ci}"]["kernel"])
                bn(f"{dst}.bn{ci}", p[f"bn{ci}"], s[f"bn{ci}"])
            if "downsample_conv" in p:
                out[f"{dst}.downsample.0.weight"] = _conv(
                    p["downsample_conv"]["kernel"])
                bn(f"{dst}.downsample.1", p["downsample_bn"],
                   s["downsample_bn"])
    for name in ("center", "dec5", "dec4", "dec3", "dec2", "dec1"):
        p = params[name]
        if is_deconv:
            conv_bias(f"{name}.block.0.conv", p["conv1"]["conv"])
            out[f"{name}.block.1.weight"] = _deconv(p["deconv"]["kernel"])
            out[f"{name}.block.1.bias"] = np.asarray(p["deconv"]["bias"])
        else:
            conv_bias(f"{name}.block.1.conv", p["conv1"]["conv"])
            conv_bias(f"{name}.block.2.conv", p["conv2"]["conv"])
    conv_bias("dec0.conv", params["dec0"]["conv"])
    conv_bias("final", params["final"])
    return out
