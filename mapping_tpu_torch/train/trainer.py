"""UNetTrainer: the trainable U-Net of the `unet`/`unet_weighted` pipelines.

Counterpart of mapping_tpu/train/trainer.py `UNetTrainer` for one device:
it takes the JAX config's `unet` section (model_params, optimizer_params,
loss, training), builds the network from the registry with weights drawn
from `seed`, and runs the epoch/batch loop. The model lives on `device` in
channels_last memory with float32 parameters; `model_params["dtype"]`
("bfloat16", the default, or "float32") is the compute dtype of its steps.

`fit` reads the loss back to the host after every optimizer step call (one
step unless `training.steps_per_call` groups several), as the JAX loop
does; the per-step losses of the last `fit` are kept in `train_losses`.
`state_dict()` is what the serving `pipelines.UNetPipeline` takes.

Not ported yet, and raising with their ROADMAP item: callbacks and
checkpoints (11), a device mesh (16), pretrained or imported weights (6),
warm start (11).
"""

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mapping_tpu_torch.models.registry import build_network
from mapping_tpu_torch.train.losses import make_loss_fn
from mapping_tpu_torch.train.state import make_optimizer
from mapping_tpu_torch.train.step import make_eval_step, make_train_step_multi

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP item {item})")


class UNetTrainer:
    """Holds the model, its optimizer and schedule; fit/score/state_dict."""

    def __init__(self, model_params: Dict[str, Any],
                 optimizer_params: Dict[str, Any],
                 loss_params: Dict[str, Any],
                 training_config: Dict[str, Any],
                 callbacks_config: Optional[Dict[str, Any]] = None,
                 loss_name: str = "weighted",
                 input_size=(256, 256),
                 seed: int = 1234,
                 mesh=None,
                 remat: bool = False,
                 pretrained_weights: str = "",
                 device="cuda"):
        if callbacks_config:
            raise _not_ported("callbacks_config", 11)
        if mesh is not None:
            raise _not_ported("a device mesh", 16)
        if pretrained_weights:
            raise _not_ported("pretrained_weights", 6)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("UNetTrainer: CUDA device requested but "
                               "torch.cuda.is_available() is False")
        self.model_params = dict(model_params)
        self.optimizer_params = dict(optimizer_params)
        self.loss_params = dict(loss_params)
        self.training_config = dict(training_config)
        self.loss_name = loss_name
        self.input_size = tuple(input_size)
        self.seed = seed
        self.remat = remat
        self.dtype = _DTYPES[self.model_params.get("dtype", "bfloat16")]
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = build_network(self.model_params)
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self._loss_fn = make_loss_fn(loss_name, self.loss_params)
        self.optimizer = None
        self.scheduler = None
        self.train_losses: List[float] = []

    # ------------------------------------------------------------- state
    def _ensure_state(self, steps_per_epoch: int = 1):
        if self.optimizer is not None:
            return
        op = self.optimizer_params
        gamma = op.get("gamma")
        if gamma in (1.0, None):
            gamma = None  # flat rate: no schedule
        self.optimizer, self.scheduler = make_optimizer(
            self.model, lr=op.get("lr", 5e-4), gamma=gamma,
            decay_every_steps=max(steps_per_epoch, 1),
            weight_decay=op.get("weight_decay", 0.0))
        self._train_steps = make_train_step_multi(
            self._loss_fn, self.model, self.optimizer, self.scheduler,
            self.dtype, self.remat)
        self._eval_step = make_eval_step(self._loss_fn, self.model, self.dtype)

    def warm_start(self, path):
        raise _not_ported("warm start", 11)

    def import_torch_checkpoint(self, path):
        raise _not_ported("import_torch_checkpoint", 6)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's reference-named weights and BatchNorm statistics, on
        the CPU."""
        return {k: v.detach().cpu() for k, v in self.model.state_dict().items()}

    # --------------------------------------------------------------- fit
    def fit(self, datagen, validation_datagen=None, meta_valid=None):
        """Train for `training.epochs` passes over `datagen` = (flow,
        steps): each pass takes at most `steps` batches of flow, {"image":
        (N, H, W, 3), "target": (N, H, W, 1+K)} on the trainer's device.
        `validation_datagen` and `meta_valid` feed callbacks, which are not
        ported yet, and are not read."""
        flow, steps = datagen
        self._ensure_state(steps_per_epoch=steps)
        self.train_losses = []
        spc = int(self.training_config.get("steps_per_call", 1))
        pending = []

        def run_pending():
            if pending:
                losses = self._train_steps(pending)["loss"]
                self.train_losses.extend(losses.tolist())  # host sync
                pending.clear()

        for _ in range(self.training_config.get("epochs", 1)):
            for batch_id, batch in enumerate(flow):
                pending.append(batch)
                if len(pending) >= spc:
                    run_pending()
                if batch_id + 1 >= steps:
                    break
            run_pending()
        if hasattr(flow, "close"):
            flow.close()
        return self

    # -------------------------------------------------------------- eval
    def score_validation(self, validation_datagen) -> Dict[str, Any]:
        """Mean validation loss over at most `steps` batches of (flow,
        steps)."""
        self._ensure_state()
        flow, steps = validation_datagen
        losses = []
        for batch_id, batch in enumerate(flow):
            losses.append(float(self._eval_step(batch)))
            if batch_id + 1 >= steps:
                break
        return {"sum": np.mean(losses) if losses else np.nan}
