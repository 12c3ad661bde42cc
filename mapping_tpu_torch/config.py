"""Configuration: the neptune.yaml parameter file -> one nested config tree.

Counterpart of mapping_tpu/config.py: the same DEFAULT_PARAMS, the same
`parameters:` layout read from --config or $CONFIG_PATH, and the same tree
from `build_config`. It reads the file without pyyaml, with `parse_yaml`
below, which takes the subset such a file uses and raises on anything
else. One parameter is the port's own, `device` (default "cuda"): where
the pipelines run. A CUDA device needs a card; "cpu" runs on the host.
"""

import os
import re
from typing import Any, Dict, Optional

from mapping_tpu_torch.constants import (CATEGORY_LAYERS, SEED, X_COLUMNS,
                                         Y_COLUMNS)


class AttrDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, name):
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(value, dict) and not isinstance(value, AttrDict):
            value = AttrDict(value)
            self[name] = value
        return value

    def __setattr__(self, name, value):
        self[name] = value


def _deep_attrdict(d):
    if isinstance(d, dict):
        return AttrDict({k: _deep_attrdict(v) for k, v in d.items()})
    if isinstance(d, list):
        return [_deep_attrdict(v) for v in d]
    return d


DEFAULT_PARAMS: Dict[str, Any] = {
    # data paths
    "data_dir": "data/raw",
    "meta_dir": "data/meta",
    "masks_overlayed_prefix": "masks_overlayed",
    "experiment_dir": "data/experiments/mapping_tpu",
    # execution
    "overwrite": 0,
    "warm_start": 0,  # continue training from the cached transformer under
                      # the CURRENT yaml (the published multistage recipe,
                      # reference README.md:86-91); fresh schedule/optimizer
    "num_workers": 4,
    "num_threads": 8,
    "load_in_memory": 0,
    "pin_memory": 1,
    "evaluation_data_sample": 1000,
    "border_width": 0,
    "small_annotations_size": 14,
    "loader_mode": "resize",
    "stream_mode": 0,
    # general
    "image_h": 256,
    "image_w": 256,
    "image_channels": 3,
    # model
    "pretrained_weights": "",  # local torchvision state_dict (.pth/.npz)
    "nr_unet_outputs": 1,
    "channels_per_output": 2,
    "n_filters": 16,
    "conv_kernel": 3,
    "pool_kernel": 3,
    "pool_stride": 2,
    "repeat_blocks": 4,
    "encoder": "ResNet101",
    "model_dtype": "bfloat16",  # compute dtype (params stay float32);
                                # "float32" for bit-faithful parity checks
    # loss
    "bce_mask": 1.0,
    "dice_mask": 0.2,
    # schedule
    "epochs_nr": 100,
    "batch_size_train": 20,
    "batch_size_inference": 20,
    "lr": 0.0005,
    "momentum": 0.9,
    "gamma": 1.0,
    "patience": 30,
    "lr_factor": 0.3,
    "lr_patience": 30,
    "w0": 50,
    "sigma": 10,
    "dice_smooth": 1,
    "dice_activation": "softmax",
    "validate_with_map": 1,
    # parallelism / memory
    "data_parallel": 0,   # shard the batch over all devices ('data' axis)
    "spatial_serving": 0,  # shard image HEIGHT over the mesh at inference
                           # (serve one huge tile as a single forward; 'sp')
    "quantized_serving": 0,  # int8 PTQ convs in the serving forward
    "quant_calib_images": 32,  # activation-scale calibration sample
    "serve_batch_buckets": "1",  # extra compiled batch shapes for the online
                                 # daemon (comma-separated; the full
                                 # batch_size_inference shape is always
                                 # compiled too). "" = full batch only.
    "serve_max_pending": 0,  # daemon backpressure: queued-request cap before
                             # submissions shed with HTTP 429 (0 = 8x batch)
    "remat": 0,           # jax.checkpoint the forward (memory for FLOPs)
    # observability / recovery
    "resume_training": 1,
    "resume_every": 5,  # epochs between 'last' checkpoints (large D2H)
    "best_write_every": 5,  # max epochs between best-checkpoint disk flushes
    "train_steps_per_call": 1,  # optimizer steps per device dispatch (scan)
    "profile_trace": 0,
    "monitor_images": 0,
    # regularization
    "use_batch_norm": 1,
    "l2_reg_conv": 0.0001,
    "l2_reg_dense": 0.0,
    "dropout_conv": 0.1,
    "dropout_dense": 0.0,
    # postprocessing
    "erode_selem_size": 0,
    "dilate_selem_size": 0,
    "tta_aggregation_method": "gmean",
    "nms__iou_threshold": 0.5,
    # inference padding
    "crop_image_h": 300,
    "crop_image_w": 300,
    "h_pad": 10,
    "w_pad": 10,
    "pad_method": "replicate",
    # scoring model
    "emit_suppressed": 0,  # scoring pipelines: keep NMS-suppressed
                           # (score==0) instances in prediction.json like
                           # the reference did (~1.5k junk rows/image on the
                           # 19-layer path); 0 drops them at the writer —
                           # the eval protocol caps at maxDets=100 by score,
                           # so suppressed tails past the cap never score
    "scoring_model": "lgbm",
    "scoring_model__num_training_examples": 10000,
    "lgbm__learning_rate": 0.01,
    "lgbm__num_leaves": 500,
    "lgbm__min_data": 100,
    "lgbm__max_depth": 20,
    "lgbm__number_of_trees": 500,
    "lgbm__early_stopping": 10,
    "lgbm__train_size": 0.7,
    "lgbm__target": "iou",
    "rf__n_estimators": 500,
    "rf__criterion": "squared_error",
    "rf__max_depth": 20,
    "rf__min_samples_split": 100,
    "rf__min_samples_leaf": 100,
    "rf__max_features": 1.0,
    "rf__max_leaf_nodes": 500,
    "rf__n_jobs": 10,
    "rf__verbose": 0,
}



#: parameters of the port only, beside DEFAULT_PARAMS
PORT_PARAMS: Dict[str, Any] = {"device": "cuda"}

# ---------------------------------------------------------------------------
# the yaml subset of a parameter file
# ---------------------------------------------------------------------------

# pyyaml's (YAML 1.1) implicit scalar types; a float needs a dot, so 1e-4
# stays a string there and here
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE",
                          "off", "Off", "OFF"), False)}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_OTHER_INT = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+"
                        r"|[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_SPECIAL_FLOAT = {**dict.fromkeys(("+.inf", ".inf", "+.Inf", ".Inf", "+.INF",
                                   ".INF"), float("inf")),
                  **dict.fromkeys(("-.inf", "-.Inf", "-.INF"), float("-inf")),
                  **dict.fromkeys((".nan", ".NaN", ".NAN"), float("nan"))}
_KEY = re.compile(r"^( *)([A-Za-z_][\w.\-]*):(?: +(.*))?$")


def _plain(text, where):
    if text.startswith(("{", "&", "*", "!", "|", ">", "%", "@", "`", "- ")):
        raise ValueError(f"{where}: unsupported yaml {text!r}")
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _OTHER_INT.match(text):
        raise ValueError(f"{where}: unsupported integer form {text!r}")
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    return text


def _quoted(text, where):
    """A quoted scalar at the start of `text` -> (value, rest)."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            esc = {'"': '"', "\\": "\\", "n": "\n", "t": "\t", "/": "/"}
            if text[i + 1:i + 2] not in esc:
                raise ValueError(f"{where}: unsupported escape in {text!r}")
            out.append(esc[text[i + 1]])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), text[i + 1:]
        out.append(c)
        i += 1
    raise ValueError(f"{where}: unterminated quoted scalar {text!r}")


def _strip_comment(rest, where):
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        raise ValueError(f"{where}: unexpected {rest!r}")


def _value(text, where):
    """The value after `key: ` (comment included) -> python value."""
    text = text.strip()
    if text.startswith(("'", '"')):
        value, rest = _quoted(text, where)
        _strip_comment(rest, where)
        return value
    if text.startswith("["):
        items, text = [], text[1:].lstrip()
        if text.startswith("]"):
            _strip_comment(text[1:], where)
            return items
        while True:
            if text.startswith(("'", '"')):
                item, text = _quoted(text, where)
            else:
                m = re.match(r"^([^,\]]*)", text)
                item = _plain(m.group(1).strip(), where)
                text = text[m.end():]
                if isinstance(item, str) and (not item or "[" in item):
                    raise ValueError(f"{where}: unsupported flow list")
            items.append(item)
            text = text.lstrip()
            if text.startswith(","):
                text = text[1:].lstrip()
            elif text.startswith("]"):
                _strip_comment(text[1:], where)
                return items
            else:
                raise ValueError(f"{where}: unterminated flow list")
    m = re.search(r"(^|\s)#", text)
    if m:
        text = text[:m.start()].rstrip()
    return _plain(text, where)


def parse_yaml(text: str, name: str = "<yaml>"):
    """The yaml of a parameter file -> dict: a mapping whose values are
    scalars, flow lists of scalars, or one nested mapping of those (the
    `parameters:` section). Comments and blank lines are skipped. Scalars
    resolve as pyyaml's safe_load resolves them (null, YAML 1.1 booleans,
    decimal integers, floats with a dot, strings, quoted strings). Block
    lists, flow mappings, multi-line scalars, anchors, tags and documents
    raise ValueError."""
    top: Dict[str, Any] = {}
    section, section_indent = None, None
    for n, line in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"{where}: tab indentation")
        m = _KEY.match(line.rstrip())
        if not m:
            raise ValueError(f"{where}: unsupported yaml {stripped!r}")
        indent, key, rest = len(m.group(1)), m.group(2), m.group(3) or ""
        if indent == 0:
            if key in top:
                raise ValueError(f"{where}: duplicate key {key!r}")
            rest_is_empty = rest.strip() == "" or rest.strip().startswith("#")
            section = key if rest_is_empty else None
            section_indent = None
            top[key] = None if rest_is_empty else _value(rest, where)
            continue
        if section is None:
            raise ValueError(f"{where}: unexpected indentation")
        if section_indent is None:
            section_indent = indent
            top[section] = {}
        if indent != section_indent:
            raise ValueError(f"{where}: only one level of nesting is read")
        if key in top[section]:
            raise ValueError(f"{where}: duplicate key {key!r}")
        top[section][key] = _value(rest, where)
    return top


def load_params(config_path: Optional[str] = None) -> AttrDict:
    """Read the parameter file (a top-level `parameters:` key or a flat
    mapping) over DEFAULT_PARAMS and PORT_PARAMS."""
    params = {**DEFAULT_PARAMS, **PORT_PARAMS}
    if config_path is None:
        config_path = os.environ.get("CONFIG_PATH")
    if config_path:
        with open(config_path) as f:
            loaded = parse_yaml(f.read(), config_path)
        section = loaded.get("parameters", loaded)
        if section is None:
            section = {}  # a bare `parameters:` key with no value
        if not isinstance(section, dict):
            raise ValueError(
                f"invalid config file {config_path}: `parameters` must be "
                f"a mapping, got {type(section).__name__}")
        params.update(section)
    return AttrDict(params)


def build_config(config_path: Optional[str] = None,
                 overrides: Optional[Dict[str, Any]] = None) -> AttrDict:
    """Full solution config tree (the SOLUTION_CONFIG equivalent)."""
    params = load_params(config_path)
    if overrides:
        params.update(overrides)

    config = {
        "params": params,
        "env": {"cache_dirpath": params.experiment_dir},
        "execution": {
            "exp_root": params.experiment_dir,
            "num_workers": params.num_workers,
            "num_classes": 2,
            "img_h_w": (params.image_h, params.image_w),
            "batch_size_train": params.batch_size_train,
            "batch_size_inference": params.batch_size_inference,
            "loader_mode": params.loader_mode,
            "stream_mode": params.stream_mode,
        },
        "xy_splitter": {"x_columns": X_COLUMNS, "y_columns": Y_COLUMNS},
        "loader": {
            "mode": params.loader_mode,
            "size": (params.image_h, params.image_w),
            "pad": (params.h_pad, params.w_pad),
            "pad_method": params.pad_method,
            "batch_size_train": params.batch_size_train,
            "batch_size_inference": params.batch_size_inference,
            "seed": SEED,
            "load_in_memory": bool(params.load_in_memory),
        },
        "unet": {
            "model_params": {
                "n_filters": params.n_filters,
                "conv_kernel": params.conv_kernel,
                "pool_kernel": params.pool_kernel,
                "pool_stride": params.pool_stride,
                "repeat_blocks": params.repeat_blocks,
                "batch_norm": bool(params.use_batch_norm),
                "dropout": params.dropout_conv,
                "in_channels": params.image_channels,
                "out_channels": params.channels_per_output,
                "nr_outputs": params.nr_unet_outputs,
                "encoder": params.encoder,
                "dtype": params.model_dtype,
            },
            "optimizer_params": {"lr": params.lr, "gamma": params.gamma,
                                 "weight_decay": params.l2_reg_conv},
            "pretrained_weights": params.pretrained_weights,
            "loss": {
                "w0": params.w0,
                "sigma": params.sigma,
                "imsize": (params.image_h, params.image_w),
                "dice_weight": params.dice_mask,
                "bce_weight": params.bce_mask,
                "smooth": params.dice_smooth,
                "dice_activation": params.dice_activation,
            },
            "training": {"epochs": params.epochs_nr,
                         "steps_per_call": int(params.train_steps_per_call)},
            "callbacks": {
                "checkpoint_dir": os.path.join(params.experiment_dir,
                                               "checkpoints", "unet"),
                "minimize": not params.validate_with_map,
                "validate_with_map": bool(params.validate_with_map),
                "patience": params.patience,
                "data_dir": params.data_dir,
                "small_annotations_size": params.small_annotations_size,
                # per-epoch COCO-AP validation geometry: must match what a
                # post-hoc `evaluate` would use (the reference monitor read
                # everything from config, src/callbacks.py:108-151)
                "target_size": (params.crop_image_h, params.crop_image_w),
                "category_layers": tuple(params.get("category_layers",
                                                    CATEGORY_LAYERS)),
                "resume": bool(params.resume_training),
                "resume_every": int(params.resume_every),
                "best_write_every": int(params.best_write_every),
                "profile_trace_dir": (
                    os.path.join(params.experiment_dir, "profile")
                    if params.profile_trace else None),
                "image_monitor_dir": (
                    os.path.join(params.experiment_dir, "val_images")
                    if params.monitor_images else None),
            },
        },
        "tta_generator": {"flip_ud": True, "flip_lr": True, "rotation": True,
                          "color_shift_runs": 0},
        "tta_aggregator": {"method": params.tta_aggregation_method},
        "postprocessor": {
            "target_size": (params.crop_image_h, params.crop_image_w),
            "erode_selem_size": params.erode_selem_size,
            "dilate_selem_size": params.dilate_selem_size,
            "prediction_crop": {"h_crop": params.crop_image_h,
                                "w_crop": params.crop_image_w},
            "scoring_model": params.scoring_model,
            "lightGBM": {
                "model_params": {
                    "learning_rate": params.lgbm__learning_rate,
                    "num_leaves": params.lgbm__num_leaves,
                    "min_data": params.lgbm__min_data,
                    "max_depth": params.lgbm__max_depth,
                },
                "training_params": {
                    "number_boosting_rounds": params.lgbm__number_of_trees,
                    "early_stopping_rounds": params.lgbm__early_stopping,
                },
                "train_size": params.lgbm__train_size,
                "target": params.lgbm__target,
            },
            "random_forest": {
                "train_size": params.lgbm__train_size,
                "target": params.lgbm__target,
                "model_params": {
                    "n_estimators": params.rf__n_estimators,
                    "criterion": params.rf__criterion,
                    "max_depth": params.rf__max_depth,
                    "min_samples_split": params.rf__min_samples_split,
                    "min_samples_leaf": params.rf__min_samples_leaf,
                    "max_features": params.rf__max_features,
                    "max_leaf_nodes": params.rf__max_leaf_nodes,
                    "n_jobs": params.rf__n_jobs,
                },
            },
            "nms": {"iou_threshold": params.nms__iou_threshold},
        },
    }
    return _deep_attrdict(config)
