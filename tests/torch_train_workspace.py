"""A small experiment on the synthetic fixture for the train tests of the
port: 300^2 JPEG tiles with their COCO annotations, the target files the
port's prepare_masks writes on the CPU (the JAX package's file layout),
and the metadata.csv the JAX package writes over them; both packages read
these files. `config` writes a parameter file of one experiment; ResNet34
at 64^2 in float32 on the CPU, batch 2 for training and 4 for inference.
"""

from pathlib import Path

import yaml

from mapping_tpu.manager import PipelineManager as JaxManager
from mapping_tpu_torch.manager import PipelineManager
from tests.fixtures.synthetic import generate

PARAMS = {"encoder": "ResNet34", "model_dtype": "float32", "image_h": 64,
          "image_w": 64, "batch_size_train": 2, "batch_size_inference": 4,
          "device": "cpu", "num_threads": 2}


def config(root: Path, name, **extra):
    """The parameter file of experiment `name` under root."""
    params = {**PARAMS, "data_dir": str(root / "data"),
              "meta_dir": str(root / "meta"),
              "experiment_dir": str(root / name), **extra}
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump({"parameters": params}))
    return str(path)


def make_experiment(root: Path, n_train=4, n_val=5, seed=7):
    """Data, target files and metadata under root; returns root."""
    generate(str(root / "data"), n_train=n_train, n_val=n_val, seed=seed)
    PipelineManager(config(root, "prepare")).prepare_masks(False)
    JaxManager(config(root, "prepare")).prepare_metadata(True, True)
    return root
