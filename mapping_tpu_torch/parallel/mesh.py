"""Device mesh and batch sharding over the data-parallel axis 'data'.

Counterpart of mapping_tpu/parallel/mesh.py. A JAX mesh is one SPMD
program over a grid of devices; in the port a `Mesh` is the ordered list
of devices of the 'data' axis, each of which runs one replica:
- serving (infer/serving.py `FusedServe(mesh=...)`) runs one process with
  a copy of the weights on each device (`Replicas`) and a contiguous shard
  of the batch on each;
- training runs one process per device (parallel/distributed.py) and
  reduces the loss, BatchNorm statistics and gradients over the process
  group, so that a step equals the single-process step on the global
  batch.
The 'model' axis of the JAX mesh holds no sharding in either package; it
stays at size 1 here (`shape`).

`shard_batch` and `shard_batch_stacked` cut axis 0 (or axis 1 of a
(K, B, ...) stack of K batches) into contiguous equal shards, one per
device, on that device; a batch that does not divide raises, as JAX's
NamedSharding does. `Replicas` keeps one copy of a module per device, and
`shard_pytree_replicated` is the list of them over a mesh.
"""

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """The devices of the 'data' axis, in order."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {DATA_AXIS: len(self.devices), MODEL_AXIS: 1}

    def __len__(self):
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `devices` (default: every visible CUDA card, which
    raises where there is none)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA card is visible; pass the "
                               "devices (for example ['cpu', 'cpu'])")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return Mesh(devices)


def _split(x, n: int, axis: int, devices) -> List:
    if x.shape[axis] % n:
        raise ValueError(f"batch axis {axis} of size {x.shape[axis]} does "
                         f"not divide over the {n}-device data axis")
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return [part.to(d, non_blocking=True)
            for part, d in zip(torch.chunk(x, n, dim=axis), devices)]


def _shard(tree, mesh: Mesh, axis: int):
    n = len(mesh)
    if isinstance(tree, dict):
        parts = {k: _shard(v, mesh, axis) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_shard(v, mesh, axis) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    return _split(tree, n, axis, mesh.devices)


def shard_batch(batch, mesh: Mesh) -> List:
    """One shard of `batch` (a tensor, an array, or a dict / list of them)
    per device, cut from axis 0 in order and placed there."""
    return _shard(batch, mesh, 0)


def shard_batch_stacked(batches, mesh: Mesh) -> List:
    """The same for a (K, B, ...) stack of K batches: axis 1, the
    per-step batch axis, is cut (the layout of the multi-step train)."""
    return _shard(batches, mesh, 1)


def _device_of(tree) -> Optional[torch.device]:
    values = tree.state_dict().values() if isinstance(
        tree, torch.nn.Module) else tree.values()
    first = next(iter(values), None)
    return None if first is None else first.device


class Replicas:
    """One copy of a module (or a state dict of tensors) per device:
    `get(tree, device)` is the tree itself on its own device, and on any
    other a copy made there on first use. The copies belong to one tree
    object: another object (new weights) drops them. A tree changed in
    place keeps stale copies, so a caller whose weights change makes a
    new object (the trainer folds a new serving copy)."""

    def __init__(self):
        self._source = None
        self._copies = {}

    def get(self, tree, device):
        device = torch.device(device)
        home = _device_of(tree)
        if home is None or home == device:
            return tree
        if tree is not self._source:
            self._source, self._copies = tree, {}
        if device not in self._copies:
            self._copies[device] = (
                copy.deepcopy(tree).to(device)
                if isinstance(tree, torch.nn.Module)
                else {k: v.to(device) for k, v in tree.items()})
        return self._copies[device]


def shard_pytree_replicated(tree, mesh: Mesh,
                            replicas: Optional[Replicas] = None) -> List:
    """A copy of a module or a state dict on each device of `mesh`, in
    mesh order (`Replicas`; pass one to keep the copies across calls)."""
    replicas = replicas or Replicas()
    return [replicas.get(tree, d) for d in mesh.devices]
