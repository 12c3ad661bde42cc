"""Flax params -> torch state_dict, the inverse of
mapping_tpu/models/torch_convert.py `convert_unet_resnet`,
`convert_albunet`, `convert_unet11` and `convert_unet_vgg16`, and by name
for the families the JAX package has no converter for (the from-scratch
UNet / UNetMultitask and UNet++).

This carries a network of any family trained by the JAX package into the
port (`state_dict_for_encoder`), and its int8 serving table with it
(`qtable_from_flax`). Numpy only: the trees may hold numpy or
JAX arrays, and neither framework is imported here.

Layouts: a Flax conv kernel (kH, kW, I, O) is a torch weight (O, I, kH, kW).
A Flax ConvTranspose kernel (kH, kW, I, O) is the torch ConvTranspose2d
weight (I, O, kH, kW) spatially flipped (torch_convert.py `_deconv`), so the
flip is undone here. BatchNorm scale/bias (params) and mean/var
(batch_stats) become weight/bias/running_mean/running_var.
"""

from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np

from mapping_tpu_torch.models.resnet import CONFIGS


def _conv(kernel):
    return np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _deconv(kernel):
    flipped = np.asarray(kernel)[::-1, ::-1]
    return np.ascontiguousarray(np.transpose(flipped, (2, 3, 0, 1)))


def _conv_bias(out, dst, src):
    out[dst + ".weight"] = _conv(src["kernel"])
    out[dst + ".bias"] = np.asarray(src["bias"])


def _deconv_bias(out, dst, src):
    out[dst + ".weight"] = _deconv(src["kernel"])
    out[dst + ".bias"] = np.asarray(src["bias"])


def _bn(out, dst, p, s):
    out[dst + ".weight"] = np.asarray(p["scale"])
    out[dst + ".bias"] = np.asarray(p["bias"])
    out[dst + ".running_mean"] = np.asarray(s["mean"])
    out[dst + ".running_var"] = np.asarray(s["var"])
    out[dst + ".num_batches_tracked"] = np.zeros((), np.int64)


def _decoder_v2(out, name, p, is_deconv):
    """DecoderBlockV2: [ConvRelu, deconv, ReLU] or [Upsample, ConvRelu,
    ConvRelu] under `name.block`."""
    if is_deconv:
        _conv_bias(out, f"{name}.block.0.conv", p["conv1"]["conv"])
        _deconv_bias(out, f"{name}.block.1", p["deconv"])
    else:
        _conv_bias(out, f"{name}.block.1.conv", p["conv1"]["conv"])
        _conv_bias(out, f"{name}.block.2.conv", p["conv2"]["conv"])


def state_dict_from_flax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                         depth: int, is_deconv: bool = True
                         ) -> Dict[str, np.ndarray]:
    """(params, batch_stats) of mapping_tpu UNetResNet(depth) -> the
    reference-named torch state_dict of
    mapping_tpu_torch.models.unet_resnet.UNetResNet(depth)."""
    out: Dict[str, np.ndarray] = {}
    enc, enc_s = params["encoder"], batch_stats["encoder"]
    out["encoder.conv1.weight"] = _conv(enc["conv1"]["kernel"])
    _bn(out, "encoder.bn1", enc["bn1"], enc_s["bn1"])
    block, layers, _ = CONFIGS[depth]
    n_convs = 3 if block.expansion == 4 else 2
    for stage, n_blocks in enumerate(layers):
        for b in range(n_blocks):
            src = f"layer{stage + 1}_{b}"
            dst = f"encoder.layer{stage + 1}.{b}"
            p, s = enc[src], enc_s[src]
            for ci in range(1, n_convs + 1):
                out[f"{dst}.conv{ci}.weight"] = _conv(p[f"conv{ci}"]["kernel"])
                _bn(out, f"{dst}.bn{ci}", p[f"bn{ci}"], s[f"bn{ci}"])
            if "downsample_conv" in p:
                out[f"{dst}.downsample.0.weight"] = _conv(
                    p["downsample_conv"]["kernel"])
                _bn(out, f"{dst}.downsample.1", p["downsample_bn"],
                    s["downsample_bn"])
    for name in ("center", "dec5", "dec4", "dec3", "dec2", "dec1"):
        _decoder_v2(out, name, params[name], is_deconv)
    _conv_bias(out, "dec0.conv", params["dec0"]["conv"])
    _conv_bias(out, "final", params["final"])
    return out


def albunet_state_dict_from_flax(params: Dict[str, Any],
                                 batch_stats: Dict[str, Any],
                                 is_deconv: bool = True
                                 ) -> Dict[str, np.ndarray]:
    """(params, batch_stats) of mapping_tpu AlbuNet, which nests
    UNetResNet(34) under the scope `unet` -> the state_dict of
    mapping_tpu_torch.models.unet_resnet.AlbuNet (UNetResNet(34)'s
    keys)."""
    return state_dict_from_flax(params["unet"], batch_stats["unet"], 34,
                                is_deconv)


def unet11_state_dict_from_flax(params: Dict[str, Any]
                                ) -> Dict[str, np.ndarray]:
    """params of mapping_tpu UNet11 (no batch_stats: VGG has no
    BatchNorm) -> the reference-named state_dict of
    mapping_tpu_torch.models.vgg.UNet11."""
    out: Dict[str, np.ndarray] = {}
    for idx in (0, 3, 6, 8, 11, 13, 16, 18):
        _conv_bias(out, f"encoder.{idx}", params[f"conv_{idx}"])
    for name in ("center", "dec5", "dec4", "dec3", "dec2"):
        _conv_bias(out, f"{name}.block.0.conv", params[name]["conv1"]["conv"])
        _deconv_bias(out, f"{name}.block.1", params[name]["deconv"])
    _conv_bias(out, "dec1.conv", params["dec1"]["conv"])
    _conv_bias(out, "final", params["final"])
    return out


_VGG16_STAGES = {"stage1": (0, 2), "stage2": (5, 7), "stage3": (10, 12, 14),
                 "stage4": (17, 19, 21), "stage5": (24, 26, 28)}


def unet_vgg16_state_dict_from_flax(params: Dict[str, Any],
                                    is_deconv: bool = True
                                    ) -> Dict[str, np.ndarray]:
    """params of mapping_tpu UNetVGG16 -> the state_dict of
    mapping_tpu_torch.models.vgg.UNetVGG16."""
    out: Dict[str, np.ndarray] = {}
    for stage, indices in _VGG16_STAGES.items():
        for idx in indices:
            _conv_bias(out, f"encoder.{idx}", params[stage][f"conv_{idx}"])
    for name in ("center", "dec5", "dec4", "dec3", "dec2"):
        _decoder_v2(out, name, params[name], is_deconv)
    _conv_bias(out, "dec1.conv", params["dec1"]["conv"])
    _conv_bias(out, "final", params["final"])
    return out


def named_state_dict_from_flax(params: Dict[str, Any],
                               batch_stats: Dict[str, Any]
                               ) -> Dict[str, np.ndarray]:
    """(params, batch_stats) of a module whose torch counterpart keeps the
    Flax scope names (the from-scratch UNet / UNetMultitask, UNet++) ->
    its state_dict, by name: scopes joined with ".", a conv kernel (and
    bias) -> weight (and bias), the bias-free ConvTranspose of an
    `up_sample*` scope -> its flipped weight, a BatchNorm's scale / bias /
    mean / var -> weight / bias / running_mean / running_var."""
    out: Dict[str, np.ndarray] = {}

    def walk(p, s, prefix):
        for name, leaf in p.items():
            key = prefix + name
            if "kernel" in leaf:
                deconv = name.startswith("up_sample")
                out[key + ".weight"] = (_deconv if deconv else _conv)(
                    leaf["kernel"])
                if "bias" in leaf:
                    out[key + ".bias"] = np.asarray(leaf["bias"])
            elif "scale" in leaf:
                _bn(out, key, leaf, s[name])
            else:
                walk(leaf, s.get(name, {}), key + ".")

    walk(params, batch_stats or {}, "")
    return out


def state_dict_for_encoder(model_params: Dict[str, Any],
                           params: Dict[str, Any],
                           batch_stats: Dict[str, Any]
                           ) -> Dict[str, np.ndarray]:
    """(params, batch_stats) of the JAX network that `model_params` (the
    config's `unet.model_params`) builds -> the port's state_dict."""
    encoder = model_params.get("encoder", "ResNet101")
    is_deconv = bool(model_params.get("is_deconv", True))
    if encoder.startswith("ResNet"):
        return state_dict_from_flax(params, batch_stats,
                                    int(encoder[len("ResNet"):]), is_deconv)
    if encoder == "AlbuNet":
        return albunet_state_dict_from_flax(params, batch_stats, is_deconv)
    if encoder == "VGG11":
        return unet11_state_dict_from_flax(params)
    if encoder == "VGG16":
        return unet_vgg16_state_dict_from_flax(params, is_deconv)
    if encoder in ("from_scratch", "UNetPlusPlus"):
        return named_state_dict_from_flax(params, batch_stats)
    raise KeyError(f"unknown encoder {encoder!r}")


_TAG = 2.0 ** 32


def qtable_from_flax(model_params: Dict[str, Any], qtable: Dict[str, Any],
                     params: Dict[str, Any],
                     batch_stats: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Dict[str, np.ndarray]]:
    """A JAX qtable (mapping_tpu/models/quantize.py `build_qtable`: Flax
    path -> {"w": int8 HWIO kernel, "w_scale", "x_scale"[, "bias"]}) of
    the network that `model_params` builds -> the port's
    (models/quantize.py: module name -> the same, "w" in the module's
    weight layout).

    `params` / `batch_stats` are that network's trees (unfolded: a folded
    model keeps its conv paths). Each 4-D kernel is replaced by a tag, its
    id times 2^32 plus each element's flat index, and the trees go
    through `state_dict_for_encoder`: a weight's tag names the path it
    came from, and its indices say where each int8 value lands (the
    transpose, and the flip of a ConvTranspose). A qtable path that no
    module receives raises KeyError."""
    paths = {}

    def tag(tree, prefix):
        out = {}
        for key, value in tree.items():
            if isinstance(value, Mapping):
                out[key] = tag(value, prefix + (key,))
            elif key == "kernel" and np.ndim(value) == 4:
                paths[len(paths) + 1] = "/".join(prefix)
                out[key] = len(paths) * _TAG + np.arange(
                    np.size(value), dtype=np.float64).reshape(np.shape(value))
            else:
                out[key] = value
        return out

    state = state_dict_for_encoder(model_params, tag(params, ()),
                                   batch_stats or {})
    port = {}
    for key, value in state.items():
        if not key.endswith(".weight") or np.ndim(value) != 4:
            continue
        ids = np.floor(value / _TAG)
        path = paths.get(int(ids.flat[0]))
        if path not in qtable:
            continue
        entry = {k: np.asarray(v) for k, v in qtable[path].items()}
        index = (value - ids * _TAG).astype(np.int64)
        entry["w"] = entry["w"].reshape(-1)[index].astype(np.int8)
        port[key[:-len(".weight")]] = entry
    found = {paths[int(np.floor(state[m + ".weight"].flat[0] / _TAG))]
             for m in port}
    missing = set(qtable) - found
    if missing:
        raise KeyError(f"qtable paths with no port module: {sorted(missing)}")
    return port
