"""Rank jobs of tests/test_torch_parallel.py, run by
mapping_tpu_torch.parallel.distributed.spawn on gloo ranks on the CPU.

A spawned rank imports this module by name, so it imports only torch and
the port (no jax). Each job returns CPU tensors and plain values; every
rank returns a float64 checksum of each gradient (the test holds them
equal across the ranks), and rank 0 the gradients too.
"""

import numpy as np
import torch

from mapping_tpu_torch.data.loader import (SegmentationLoader,
                                           in_memory_train_flow,
                                           train_batch_crop)
from mapping_tpu_torch.models.unet_resnet import UNetResNet
from mapping_tpu_torch.parallel import distributed
from mapping_tpu_torch.parallel.mesh import shard_batch
from mapping_tpu_torch.train.losses import make_loss_fn
from mapping_tpu_torch.train.state import make_optimizer
from mapping_tpu_torch.train.step import (make_train_step,
                                          make_train_step_multi,
                                          place_for_mesh)
from mapping_tpu_torch.train.trainer import UNetTrainer

LOSS_PARAMS = {"w0": 50, "sigma": 10, "imsize": (64, 64), "dice_weight": 0.2,
               "bce_weight": 1.0, "smooth": 1, "dice_activation": "softmax"}
SEED = 7


def model_from(init, dropout, dtype=torch.float32):
    model = UNetResNet(34, dropout_2d=dropout)
    model.load_state_dict({k: torch.as_tensor(np.array(v))
                           for k, v in init.items()})
    return model.to(dtype=dtype, memory_format=torch.channels_last)


def step_outputs(model, loss):
    """(loss, gradients, BatchNorm running statistics) after a step."""
    return {"loss": float(loss),
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()},
            "stats": {k: v.detach().clone()
                      for k, v in model.state_dict().items()
                      if "running" in k}}


def checksum(tensors):
    return {k: (float(v.double().sum()), float(v.double().abs().sum()))
            for k, v in tensors.items()}


def one_step(init, batch, dropout, dp=None, dtype=torch.float32):
    """One weighted-loss step of UNetResNet34 (Adam + L2) in `dtype`; with
    `dp`, on this rank's shard of `batch`."""
    model = model_from(init, dropout, dtype)
    batch = {k: v.to(dtype) for k, v in batch.items()}
    if dp is not None:
        model, batch = place_for_mesh(model, batch, distributed.group_mesh())
    optimizer, scheduler = make_optimizer(model, lr=5e-4, weight_decay=1e-4)
    loss_fn = make_loss_fn("weighted", LOSS_PARAMS,
                           reduce=None if dp is None else dp.all_reduce)
    step = make_train_step(loss_fn, model, optimizer, scheduler, dtype,
                           seed=SEED, data_parallel=dp)
    return step_outputs(model, step(batch, 3)["loss"])


def multi_steps(init, batches, dp=None, spc=2):
    """The losses of len(batches) steps taken `spc` at a time."""
    model = model_from(init, 0.0)
    if dp is not None:
        mesh = distributed.group_mesh()
        model = distributed.broadcast_module(model)
        batches = [shard_batch(b, mesh)[dp.rank] for b in batches]
    optimizer, scheduler = make_optimizer(model, lr=5e-4, weight_decay=1e-4)
    loss_fn = make_loss_fn("weighted", LOSS_PARAMS,
                           reduce=None if dp is None else dp.all_reduce)
    steps = make_train_step_multi(loss_fn, model, optimizer, scheduler,
                                  torch.float32, seed=SEED, data_parallel=dp)
    losses = []
    for i in range(0, len(batches), spc):
        losses += steps(batches[i:i + spc], i)["loss"].tolist()
    return losses


def trainer_fit(init, images, targets, spc, shard=None):
    """UNetTrainer.fit, 1 epoch over in-memory tiles (batch 4, 64^2), on
    the group's mesh when `shard` is given; the per-step losses."""
    trainer = UNetTrainer(
        model_params={"encoder": "ResNet34", "dtype": "float32"},
        optimizer_params={"lr": 5e-4, "gamma": 0.5, "weight_decay": 1e-4},
        loss_params=LOSS_PARAMS,
        training_config={"epochs": 1, "steps_per_call": spc},
        input_size=(64, 64), device="cpu",
        mesh="auto" if shard is not None else None)
    trainer.load_state_dict(init)
    flow = in_memory_train_flow(images, targets, 4, (64, 64),
                                torch.Generator().manual_seed(5),
                                device="cpu", shard=shard)
    trainer.fit(flow)
    return trainer.train_losses


def flow_batches(images, targets, files, shard=None):
    """Two passes of the in-memory flow, one crop-mode batch and one pass
    of the file flow (the loader's shuffle and host generator), as this
    rank sees them."""
    flow, _ = in_memory_train_flow(images, targets, 4, (64, 64),
                                   torch.Generator().manual_seed(3),
                                   device="cpu", shard=shard)
    out = {"memory": [b for _ in range(2) for b in flow]}
    gen = torch.Generator().manual_seed(4)
    rows = list(range(len(images)))
    if shard is not None:
        b = len(rows) // shard[1]
        rows = rows[shard[0] * b:(shard[0] + 1) * b]
    out["crop"] = [train_batch_crop(gen, torch.from_numpy(images[rows]),
                                    torch.from_numpy(targets[rows]),
                                    (48, 48), shard=shard)]
    loader = SegmentationLoader(size=(64, 64), batch_size_train=2,
                                device="cpu", shard=shard)
    flow, _ = loader.transform(*files)["datagen"]
    out["files"] = list(flow)
    flow.close()
    return out


def rank_job(init, batch, batches, images, targets, files):
    """Everything tests/test_torch_parallel.py holds for two ranks, in one
    spawn."""
    dp = distributed.DataParallel()
    shard = (dp.rank, dp.world)
    out = {"rank": dp.rank,
           "dropout": one_step(init, batch, 0.1, dp, torch.float64),
           "plain": one_step(init, batch, 0.0, dp),
           "multi": multi_steps(init, batches, dp, spc=2),
           "single_calls": multi_steps(init, batches, dp, spc=1),
           "fit": {spc: trainer_fit(init, images, targets, spc, shard)
                   for spc in (1, 2)},
           "batches": flow_batches(images, targets, files, shard)}
    for name in ("dropout", "plain"):
        out[name]["checksum"] = checksum(out[name]["grads"])
        if dp.rank:
            del out[name]["grads"]
    return out


def rendezvous_job():
    """(rank, world, the all-reduced sum of rank + 1): the group formed."""
    total = torch.tensor([distributed.rank() + 1.0])
    torch.distributed.all_reduce(total)
    return distributed.rank(), distributed.world(), float(total)
