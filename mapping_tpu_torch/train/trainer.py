"""UNetTrainer: the trainable U-Net of the `unet`/`unet_weighted` pipelines.

Counterpart of mapping_tpu/train/trainer.py `UNetTrainer` for one device:
it takes the JAX config's `unet` section (model_params, optimizer_params,
loss, training, callbacks), builds the network from the registry with
weights drawn from `seed`, and runs the epoch/batch loop with the JAX
package's callbacks (train/callbacks.py `default_unet_callbacks` when a
callbacks_config is given): per-epoch validation, the best weights, early
stopping, metrics and the resume checkpoint. The model lives on `device`
in channels_last memory with float32 parameters; `model_params["dtype"]`
("bfloat16", the default, or "float32") is the compute dtype of its steps.

`fit` reads the loss back to the host after every optimizer step call (one
step unless `training.steps_per_call` groups several), as the JAX loop
does; the per-step losses of the last `fit` are kept in `train_losses`, and
`step` counts the optimizer steps of the whole schedule (a resume restores
it). `probs_apply_fn()` is what the serving pipeline and the per-epoch mAP
run: the softmax of a BN-folded copy of the model in the compute dtype,
folded again after the weights change (every optimizer step, a load, a
resume). `serve_only()` folds that copy once and frees the float32 model,
for a trainer that only serves.

Weights come and go as the reference-named state_dict: `save` writes the
port's transformer cache (torch.save, `unet.pt`), `load` reads it, a best
or resume file, or a JAX experiment's flax `unet.msgpack` (every family
of the registry), and `import_torch_checkpoint` takes a reference torch
checkpoint (ResNet, AlbuNet and VGG U-Nets); each checks every key and
shape. `save_train_state` and `load_train_state` write and read the
whole training state (the resume file). `warm_start(path)` starts the
next fit from the weights in `path` with a fresh optimizer, step 0 and a
fresh schedule. `pretrained_weights`
names a local torchvision encoder file (.pth or .npz), grafted onto the
encoder the first time the float32 model is used, as the JAX package
grafts it when it creates its state: fit, save, serving, and before any
weights are loaded, which then replace it.

`mesh` (None, "auto" or a parallel.mesh.Mesh) is the data-parallel
mesh of the JAX trainer. "auto" is the mesh of the active process group
where there is one, else every visible card where there is more than one,
else None: with one device the plain path runs, as the JAX trainer's
"auto" does. On a rank of a process group (parallel/distributed.py) the
trainer sits on the rank's device and trains data-parallel: the weights
are broadcast from rank 0 when the state is made, every step reduces
BatchNorm statistics, the loss and the gradients over the group
(train/step.py), so that a step equals the single-process step on the
global batch, and validation runs on rank 0 alone while the others wait
for its value (train/callbacks.py). Outside a group a mesh is a serving
mesh: `probs_apply_fn` runs on whichever device its input lies on, with
one BN-folded copy of the weights per device (`serving_model(device)`,
parallel/mesh.py `Replicas`), and `fit` raises.
"""

import copy
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mapping_tpu_torch.models.convert import state_dict_for_encoder
from mapping_tpu_torch.models.fold_bn import fold_batch_stats
from mapping_tpu_torch.models.registry import build_network
from mapping_tpu_torch.models.scratch import UNetMultitask
from mapping_tpu_torch.parallel import distributed
from mapping_tpu_torch.parallel.mesh import Mesh, Replicas, make_mesh
from mapping_tpu_torch.train.callbacks import (CallbackList,
                                               default_unet_callbacks)
from mapping_tpu_torch.train.checkpoint import (load_flax_weights,
                                                load_torch_state_dict,
                                                load_train_state, load_weights,
                                                save_state_dict,
                                                save_train_state)
from mapping_tpu_torch.train.losses import make_loss_fn
from mapping_tpu_torch.train.state import make_optimizer
from mapping_tpu_torch.train.step import (MULTI_HEAD, _no_tf32,
                                          make_eval_step, make_predict_step,
                                          make_train_step_multi)

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _indexed(device: torch.device) -> torch.device:
    """A CUDA device with its index (the current card for plain "cuda")."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _resolve_mesh(mesh, device: torch.device) -> Optional[Mesh]:
    if mesh == "auto":
        if distributed.is_active():
            return distributed.group_mesh()
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            return make_mesh()
        return None
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be None, 'auto' or a Mesh, got {mesh!r}")
    return mesh


class SoftmaxProbs(torch.nn.Module):
    """images (B, H, W, 3) normalised float -> (B, H, W, C) float32
    softmax of `model` run in `compute_dtype` (float32 with TF32 off for
    the call only)."""

    def __init__(self, model, compute_dtype):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).to(self.compute_dtype)
        with _no_tf32(self.compute_dtype == torch.float32):
            logits = self.model(x)
        return torch.softmax(logits.to(torch.float32), dim=1).permute(
            0, 2, 3, 1)


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
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("UNetTrainer: CUDA device requested but "
                               "torch.cuda.is_available() is False")
        self.device = _indexed(self.device)
        self.mesh = _resolve_mesh(mesh, self.device)
        #: on a rank of a process group: what the step reduces over
        self.data_parallel = None
        if self.mesh is not None and distributed.is_active():
            if len(self.mesh) != distributed.world():
                raise ValueError(f"the mesh has {len(self.mesh)} data-axis "
                                 f"devices and the process group "
                                 f"{distributed.world()} ranks")
            rank_device = self.mesh.devices[distributed.rank()]
            if rank_device.type != self.device.type:
                raise ValueError(f"rank {distributed.rank()} is bound to "
                                 f"{rank_device}, not to a {device} device")
            self.device = rank_device
            self.data_parallel = distributed.DataParallel()
        self.model_params = dict(model_params)
        self.optimizer_params = dict(optimizer_params)
        self.loss_params = dict(loss_params)
        self.training_config = dict(training_config)
        self.callbacks_config = dict(callbacks_config or {})
        self.loss_name = loss_name
        self.input_size = tuple(input_size)
        self.seed = seed
        self.remat = remat
        self.pretrained_weights = pretrained_weights
        self._graft_pending = bool(pretrained_weights)
        self.dtype = _DTYPES[self.model_params.get("dtype", "bfloat16")]
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = build_network(self.model_params)
        self.model = model.to(self.device, memory_format=torch.channels_last)
        # the validation loss is rank 0's own; a data-parallel step's loss
        # is the global batch's
        self._loss_fn = make_loss_fn(loss_name, self.loss_params)
        self._train_loss_fn = self._loss_fn if self.data_parallel is None \
            else make_loss_fn(loss_name, self.loss_params,
                              reduce=self.data_parallel.all_reduce)
        self.optimizer = None
        self.scheduler = None
        self.train_losses: List[float] = []
        self.step = 0  # optimizer steps of the schedule
        self.validation_loss: Dict[int, Dict[str, Any]] = {}
        self.resume_info: Dict[str, Any] = {}
        self.warm_started_from = None
        self._warm_start_path = None
        # the folded serving copy, the weights' version it was made from,
        # and its copies on other devices
        self._state_version = 0
        self._folded = None
        self._folded_version = None
        self._probs_module = None
        self._replicas = Replicas()

    @property
    def is_primary(self) -> bool:
        """False on the ranks other than 0 of a data-parallel trainer: they
        write no file."""
        return self.data_parallel is None or self.data_parallel.rank == 0

    # ------------------------------------------------------------- state
    def _master(self):
        """The float32 model, with the pretrained encoder grafted on first
        use, then a pending warm start's weights loaded; raises after
        `serve_only()` freed it."""
        if self.model is None:
            raise RuntimeError("this trainer only serves: serve_only() freed "
                               "its float32 model")
        if self._graft_pending:
            self._graft_pending = False
            self._graft_pretrained(self.pretrained_weights)
        if self._warm_start_path is not None:
            self._apply_warm_start()
        return self.model

    def _graft_pretrained(self, path):
        """The encoder's weights (and BatchNorm statistics) from a local
        torchvision file, as the JAX trainer grafts them. ResNet / AlbuNet:
        by the reference's names (its `fc.` head aside;
        `num_batches_tracked` may be absent), any other missing or extra
        key, or another shape, raises. VGG: `features.N.{weight,bias}`
        become `encoder.N` where the model has that conv (the classifier
        and other indices are dropped); another shape raises. The other
        families raise, as in the JAX trainer."""
        encoder = self.model_params.get("encoder", "ResNet101")
        own = self.model.encoder.state_dict() if hasattr(
            self.model, "encoder") else {}
        if encoder.startswith("ResNet") or encoder == "AlbuNet":
            state = {k: v for k, v in load_torch_state_dict(path).items()
                     if not k.startswith("fc.")}
            optional = {k for k in own if k.endswith("num_batches_tracked")}
            missing = sorted(set(own) - set(state) - optional)
            extra = sorted(set(state) - set(own))
            if missing or extra:
                raise ValueError(
                    f"{path}: encoder keys do not match {encoder}: missing "
                    f"{missing[:5]}, unexpected {extra[:5]}")
        elif encoder.startswith("VGG"):
            state = {k[len("features."):]: v
                     for k, v in load_torch_state_dict(path).items()
                     if k.startswith("features.")
                     and k.endswith((".weight", ".bias"))}
            state = {k: v for k, v in state.items() if k in own}
        else:
            raise ValueError(
                f"pretrained weights unsupported for encoder {encoder!r}")
        for k, v in state.items():
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"{path}: shape mismatch at {k}: "
                                 f"{tuple(v.shape)} vs {tuple(own[k].shape)}")
        with torch.no_grad():
            for k, v in state.items():
                own[k].copy_(v.to(own[k].dtype))
        self._state_version += 1

    def _ensure_state(self, steps_per_epoch: int = 1):
        master = self._master()
        if self.optimizer is not None:
            return
        op = self.optimizer_params
        gamma = op.get("gamma")
        if gamma in (1.0, None):
            gamma = None  # flat rate: no schedule
        self.optimizer, self.scheduler = make_optimizer(
            master, lr=op.get("lr", 5e-4), gamma=gamma,
            decay_every_steps=max(steps_per_epoch, 1),
            weight_decay=op.get("weight_decay", 0.0))
        if self.data_parallel is not None:
            distributed.broadcast_module(master)
            self._state_version += 1
        self._train_steps = make_train_step_multi(
            self._train_loss_fn, master, self.optimizer, self.scheduler,
            self.dtype, self.remat, self.seed, self.data_parallel)
        self._eval_step = make_eval_step(self._loss_fn, master, self.dtype)
        self._predict_step = make_predict_step(master, self.dtype)

    def warm_start(self, path):
        """The next fit starts from the weights in `path` (the transformer
        cache of a completed stage, or any port or JAX checkpoint) with a
        fresh optimizer, step 0 and a fresh epoch schedule: stage 2+ of the
        multistage recipe. A resume file of an interrupted run of this
        stage, read when fit begins, wins over it."""
        self._warm_start_path = path
        if self.optimizer is not None:
            self._apply_warm_start()
        return self

    def _apply_warm_start(self):
        path, self._warm_start_path = self._warm_start_path, None
        self.load(path)
        self.optimizer = self.scheduler = None  # _ensure_state makes anew
        self.step = 0
        self.warm_started_from = path
        logger.info("warm start: loaded stage weights from %s (fresh "
                    "optimizer state and schedule)", path)

    def save_train_state(self, path, aux: Dict[str, Any]):
        """The resume file: weights, optimizer and schedule state, the step
        count and `aux` (the sidecar's dict)."""
        save_train_state(path, self._master().state_dict(),
                         self.optimizer.state_dict(),
                         None if self.scheduler is None
                         else self.scheduler.state_dict(), self.step, aux)

    def load_train_state(self, path) -> Dict[str, Any]:
        """Restore what `save_train_state` wrote into the trainer (Adam's
        moments go to the model's device); returns its `aux`."""
        payload = load_train_state(path)
        self.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        if self.scheduler is not None and payload["scheduler"] is not None:
            self.scheduler.load_state_dict(payload["scheduler"])
        self.step = int(payload["step"])
        return payload["aux"]

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's reference-named weights and BatchNorm statistics, on
        the CPU."""
        return {k: v.detach().cpu()
                for k, v in self._master().state_dict().items()}

    def load_state_dict(self, state: Dict[str, Any]):
        """Weights and BatchNorm statistics of the model from a
        reference-named state_dict (tensors or numpy arrays); a missing or
        extra key or another shape raises."""
        own = self._master().state_dict()
        missing, extra = sorted(set(own) - set(state)), sorted(set(state)
                                                              - set(own))
        if missing or extra:
            raise ValueError(f"checkpoint keys do not match the "
                             f"{self.model_params.get('encoder')} model: "
                             f"missing {missing[:5]}, unexpected {extra[:5]}")
        for k, v in state.items():
            if tuple(np.shape(v)) != tuple(own[k].shape):
                raise ValueError(f"checkpoint shape mismatch at {k}: "
                                 f"{tuple(np.shape(v))} vs "
                                 f"{tuple(own[k].shape)}")
        self.model.load_state_dict(
            {k: (v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.array(v))).to(own[k].dtype)
             for k, v in state.items()})
        self._state_version += 1
        return self

    def import_torch_checkpoint(self, path):
        """A reference torch checkpoint (plain state_dict,
        {"state_dict": ...}-wrapped or "module."-prefixed) into the model:
        the ResNet, AlbuNet and VGG U-Nets, whose names are the
        reference's; the other families raise, as the JAX package's
        `convert_full_checkpoint` does."""
        encoder = self.model_params.get("encoder", "ResNet101")
        if not (encoder.startswith(("ResNet", "VGG"))
                or encoder == "AlbuNet"):
            raise ValueError(
                f"checkpoint import unsupported for encoder {encoder!r} "
                f"(supported: ResNet34/ResNet101/ResNet152/AlbuNet/VGG11/"
                f"VGG16)")
        return self.load_state_dict(load_torch_state_dict(path))

    def save(self, filepath):
        """The port's transformer cache: torch.save of state_dict()."""
        save_state_dict(self._master().state_dict(), filepath)

    def load(self, filepath):
        """Weights from the port's cache, best or resume file (the
        optimizer state is not read) or, for a path ending in .msgpack,
        from the JAX package's flax checkpoint (params and batch_stats)."""
        if str(filepath).endswith(".msgpack"):
            state = state_dict_for_encoder(self.model_params,
                                           *load_flax_weights(filepath))
        else:
            state = load_weights(filepath)
        return self.load_state_dict(state)

    # ------------------------------------------------------------ serve
    def _refuse_multi_head(self):
        if isinstance(self.model, UNetMultitask):
            raise TypeError(MULTI_HEAD)

    def serving_model(self, device=None):
        """The BN-folded copy of the model in the compute dtype that
        `probs_apply_fn` runs, re-made when the weights changed; on
        another `device` than the trainer's, a copy of it there (one per
        device)."""
        self._refuse_multi_head()
        if self.model is not None:
            self._master()  # a pending encoder graft changes the weights
        if self._folded_version != self._state_version:
            model = copy.deepcopy(self.model).eval()
            self._folded = fold_batch_stats(model).to(
                dtype=self.dtype, memory_format=torch.channels_last)
            self._folded_version = self._state_version
        if device is None:
            return self._folded
        return self._replicas.get(self._folded,
                                  _indexed(torch.device(device)))

    def folded_float32(self):
        """A BN-folded float32 copy of the current weights in eval mode,
        made anew on each call: the weights that int8 serving quantises
        (models/quantize.py), as the JAX package quantises its folded
        float32 params. Raises after `serve_only()`."""
        self._refuse_multi_head()
        model = copy.deepcopy(self._master()).eval()
        return fold_batch_stats(model).to(memory_format=torch.channels_last)

    def serve_only(self):
        """Fold the serving copy now and free the float32 model, so that a
        trainer that only serves holds one copy of the weights on its
        device. Training, saving or loading weights afterwards raises."""
        self.serving_model()
        self.model = None
        return self

    def probs_apply_fn(self):
        """images (B, H, W, 3) normalised float -> (B, H, W, C) float32
        softmax probabilities, from a BN-folded copy of the model in the
        compute dtype (float32 runs with TF32 off for the call only), on
        the images' device (a mesh replica's). The copy is re-folded when
        the weights change."""
        self._refuse_multi_head()

        @torch.inference_mode()
        def probs(images):
            return SoftmaxProbs(self.serving_model(images.device),
                                self.dtype)(images)

        probs.module = self.probs_module
        return probs

    def probs_module(self):
        """The same function as `probs_apply_fn` as a module over the
        current BN-folded copy, outside inference mode, for torch.export
        (infer/artifact.py) and a spatial trace (infer/serving.py); it
        does not follow later weight changes, and it is the same object
        until they change."""
        model = self.serving_model()
        if getattr(self._probs_module, "model", None) is not model:
            self._probs_module = SoftmaxProbs(model, self.dtype)
        return self._probs_module

    # --------------------------------------------------------------- fit
    def fit(self, datagen, validation_datagen=None, meta_valid=None):
        """Train for `training.epochs` passes over `datagen` = (flow,
        steps): each pass takes at most `steps` batches of flow, {"image":
        (N, H, W, 3), "target": (N, H, W, 1+K)} on the trainer's device.
        The callbacks get `validation_datagen` and `meta_valid` (the
        validation rows); a resume checkpoint continues the schedule at
        the epoch after its own, and the best weights, where kept, are
        loaded at the end. On a mesh, each rank's flow yields its shard of
        the global batch (data/loader.py `shard`)."""
        if self.mesh is not None and self.data_parallel is None:
            raise RuntimeError(
                "a trainer with a mesh trains on the ranks of a process "
                "group, one per device (parallel.distributed.spawn; the "
                "train command starts them); here there is none")
        flow, steps = datagen
        self._ensure_state(steps_per_epoch=steps)
        self.train_losses = []
        self.validation_loss = {}
        self.resume_info = {}
        callbacks = self._build_callbacks()
        self._callbacks = callbacks  # ResumeCheckpoint gathers their states
        callbacks.set_params(self, validation_datagen=validation_datagen,
                             meta_valid=meta_valid)
        callbacks.on_train_begin()
        epochs = self.training_config.get("epochs", 1)
        start_epoch = self.resume_info.get("next_epoch", 0)
        if start_epoch:
            logger.info("resuming epoch schedule at %d/%d", start_epoch,
                        epochs)
        spc = int(self.training_config.get("steps_per_call", 1))
        pending = []

        def run_pending():
            if not pending:
                return
            # one step: its hooks bracket it; a group: the hooks follow,
            # once per loss (the JAX loop's two paths)
            single = len(pending) == 1
            if single:
                callbacks.on_batch_begin()
            losses = self._train_steps(pending, self.step)["loss"].tolist()
            self.step += len(pending)
            self._state_version += 1  # the folded serving copy is stale
            self.train_losses.extend(losses)
            for loss in losses:
                if not single:
                    callbacks.on_batch_begin()
                callbacks.on_batch_end(metrics={"loss": loss})
            pending.clear()

        for epoch_id in range(start_epoch, epochs):
            callbacks.on_epoch_begin()
            for batch_id, batch in enumerate(flow):
                pending.append(batch)
                if len(pending) >= spc:
                    run_pending()
                if batch_id + 1 >= steps:
                    break
            run_pending()
            callbacks.on_epoch_end()
            if callbacks.training_break():
                logger.info("early stopping at epoch %d", epoch_id)
                break
        if hasattr(flow, "close"):
            flow.close()  # retire the next epoch's decode prefetch
        callbacks.on_train_end()
        if self.data_parallel is not None:
            distributed.barrier()  # rank 0 has written best.pt
        # hand back the best weights where a checkpoint kept them
        best = os.path.join(self.callbacks_config.get("checkpoint_dir", ""),
                            "best.pt")
        if self.callbacks_config.get("checkpoint_dir") and \
                os.path.exists(best):
            self.load(best)
        return self

    def _build_callbacks(self) -> CallbackList:
        if self.callbacks_config:
            return default_unet_callbacks(self.callbacks_config)
        return CallbackList([])

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
