"""Model registry: `encoder` name -> network.

Counterpart of mapping_tpu/models/registry.py: the VGG, ResNet and
AlbuNet U-Nets by name, `from_scratch` (UNet, or UNetMultitask when
`nr_outputs` > 1) and `UNetPlusPlus`.
"""

import inspect
from typing import Any, Dict

from mapping_tpu_torch.models.scratch import UNet, UNetMultitask
from mapping_tpu_torch.models.unet_resnet import AlbuNet, UNetResNet
from mapping_tpu_torch.models.unetpp import UNetPlusPlus
from mapping_tpu_torch.models.vgg import UNet11, UNetVGG16

PRETRAINED_NETWORKS: Dict[str, Dict[str, Any]] = {
    "VGG11": {"model": UNet11, "model_config": {"num_classes": 2}},
    "VGG16": {"model": UNetVGG16,
              "model_config": {"num_classes": 2, "dropout_2d": 0.0,
                               "is_deconv": True}},
    "AlbuNet": {"model": AlbuNet,
                "model_config": {"num_classes": 2, "is_deconv": True}},
    **{f"ResNet{depth}": {
        "model": UNetResNet,
        "model_config": {"encoder_depth": depth, "num_classes": 2,
                         "num_filters": 32, "dropout_2d": 0.0,
                         "is_deconv": True}}
       for depth in (34, 101, 152)},
}

_SCRATCH_KEYS = (
    "conv_kernel", "pool_kernel", "pool_stride", "repeat_blocks", "n_filters",
    "batch_norm", "dropout", "in_channels", "out_channels", "nr_outputs",
)
_UNETPP_KEYS = ("num_classes", "n_filters", "depth", "deep_supervision")


def build_network(model_params: Dict[str, Any]):
    """model_params as in the JAX config's `unet.model_params`: `encoder`
    plus overrides of the family's constructor arguments (other keys are
    ignored, as in the JAX registry). Returns a float32 nn.Module; the
    compute dtype (`dtype`) is applied by the caller after weights load."""
    params = dict(model_params)
    encoder = params.pop("encoder", "ResNet101")
    if encoder == "from_scratch":
        cfg = {k: params[k] for k in _SCRATCH_KEYS if k in params}
        cls = UNetMultitask if cfg.get("nr_outputs", 1) > 1 else UNet
        return cls(**cfg)
    if encoder == "UNetPlusPlus":
        cfg = {k: params[k] for k in _UNETPP_KEYS if k in params}
        cfg.setdefault("num_classes", params.get("out_channels", 2))
        return UNetPlusPlus(**cfg)
    if encoder not in PRETRAINED_NETWORKS:
        raise KeyError(f"unknown encoder {encoder!r}; options: "
                       f"{sorted(PRETRAINED_NETWORKS)} or 'from_scratch'")
    spec = PRETRAINED_NETWORKS[encoder]
    fields = inspect.signature(spec["model"]).parameters
    cfg = dict(spec["model_config"])
    cfg.update({k: v for k, v in params.items() if k in fields})
    return spec["model"](**cfg)
