"""Model registry: `encoder` name -> network.

Counterpart of mapping_tpu/models/registry.py for the ResNet U-Nets.
"""

import inspect
from typing import Any, Dict

from mapping_tpu_torch.models.unet_resnet import AlbuNet, UNetResNet

PRETRAINED_NETWORKS: Dict[str, Dict[str, Any]] = {
    "AlbuNet": {"model": AlbuNet,
                "model_config": {"num_classes": 2, "is_deconv": True}},
    **{f"ResNet{depth}": {
        "model": UNetResNet,
        "model_config": {"encoder_depth": depth, "num_classes": 2,
                         "num_filters": 32, "dropout_2d": 0.0,
                         "is_deconv": True}}
       for depth in (34, 101, 152)},
}

# encoders of the JAX registry not ported yet -> their ROADMAP item
_NOT_PORTED = {"VGG11": 20, "VGG16": 20, "from_scratch": 20,
               "UNetPlusPlus": 21}


def build_network(model_params: Dict[str, Any]):
    """model_params as in the JAX config's `unet.model_params`: `encoder`
    plus overrides of the family's constructor arguments (other keys are
    ignored, as in the JAX registry). Returns a float32 nn.Module; the
    compute dtype (`dtype`) is applied by the caller after weights load."""
    params = dict(model_params)
    encoder = params.pop("encoder", "ResNet101")
    if encoder in _NOT_PORTED:
        raise NotImplementedError(
            f"encoder {encoder!r} is not ported to PyTorch yet (ROADMAP "
            f"item {_NOT_PORTED[encoder]})")
    if encoder not in PRETRAINED_NETWORKS:
        raise KeyError(f"unknown encoder {encoder!r}; options: "
                       f"{sorted(PRETRAINED_NETWORKS)}")
    spec = PRETRAINED_NETWORKS[encoder]
    fields = inspect.signature(spec["model"]).parameters
    cfg = dict(spec["model_config"])
    cfg.update({k: v for k, v in params.items() if k in fields})
    return spec["model"](**cfg)
