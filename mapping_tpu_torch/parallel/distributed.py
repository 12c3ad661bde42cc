"""Process groups for data-parallel training: one process per device.

The JAX package trains on a mesh as one program that XLA partitions; it
needs no process group. PyTorch's idiom is one process per device (a
rank), joined by a `torch.distributed` process group; this module is that
part of the port.

- `spawn(fn, devices, *args)` starts one process per device with the
  spawn start method (a forked process cannot use CUDA once the parent
  initialised it), makes each a rank of a process group over a free local
  TCP port, runs fn(*args) there and returns the ranks' return values.
  A rank that raises makes `spawn` raise (the others are stopped).
- The backend: NCCL when every rank has a card of its own; gloo on the
  CPU and when ranks share a card (NCCL refuses two ranks on one device).
  A group that fails to start raises; nothing falls back to another
  backend.
- Helpers for a rank: `rank`, `world`, `is_primary`, `barrier`,
  `broadcast_module` (parameters and buffers from rank 0),
  `primary_value` (a value computed on rank 0 alone, the others waiting
  for it), `group_mesh` (the mesh of the group's devices) and
  `DataParallel`, what the train step reduces over: a differentiable
  all-reduce of sums (whose backward sums the gradients over the ranks)
  for the loss, the all-gather and all-reduce of the global BatchNorm
  (models/resnet.py), and the gradient average.

Why the average divides by the world size: every rank computes the global
loss from all-reduced sums, so each rank's backward sees the sum of the
ranks' identical output gradients, W times the true one, on the paths
through its own data. Summing the ranks' gradients and dividing by W
gives the gradient of the single-process step on the global batch.
"""

import datetime
import os
import socket
import tempfile
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from mapping_tpu_torch.parallel.mesh import Mesh

#: how long a rank waits in a collective for the others
TIMEOUT = datetime.timedelta(minutes=10)

# the mesh of this process's group (a process joins at most one)
_GROUP = {"mesh": None}


def backend_for(devices: Sequence) -> str:
    """'nccl' when every device is a distinct card, 'gloo' on the CPU or
    when ranks share a card; a mix of CPU and cards raises."""
    devices = [torch.device(d) for d in devices]
    kinds = {d.type for d in devices}
    if kinds == {"cuda"}:
        return "nccl" if len(set(devices)) == len(devices) else "gloo"
    if kinds == {"cpu"}:
        return "gloo"
    raise ValueError(f"ranks must all be on the CPU or all on cards, got "
                     f"{[str(d) for d in devices]}")


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def is_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_active() else 0


def world() -> int:
    return dist.get_world_size() if is_active() else 1


def is_primary() -> bool:
    return rank() == 0


def barrier():
    """Wait for every rank (nothing without a group)."""
    if is_active():
        dist.barrier()


def init(rank_: int, devices: Sequence, address: str,
         backend: Optional[str] = None) -> Mesh:
    """Join the process group at `address` as rank `rank_` of
    len(devices), bound to devices[rank_]; returns the group's mesh."""
    devices = [torch.device(d) for d in devices]
    device = devices[rank_]
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank_} is bound to {device}, and no "
                               f"CUDA card is visible")
        torch.cuda.set_device(device)
    else:  # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    dist.init_process_group(backend or backend_for(devices),
                            init_method=address, world_size=len(devices),
                            rank=rank_, timeout=TIMEOUT)
    _GROUP["mesh"] = Mesh(devices)
    return _GROUP["mesh"]


def group_mesh() -> Mesh:
    """The mesh of the active group: each rank's device, in rank order."""
    if not is_active() or _GROUP["mesh"] is None:
        raise RuntimeError("no process group is active")
    return _GROUP["mesh"]


def _worker(rank_, fn, devices, address, backend, args, out_dir):
    init(rank_, devices, address, backend)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank_}.pt"))
    finally:
        dist.destroy_process_group()
        _GROUP["mesh"] = None


def spawn(fn: Callable, devices: Sequence, *args,
          backend: Optional[str] = None) -> List:
    """fn(*args) on one process per device, each a rank of a process
    group (backend by `backend_for` unless given); the ranks' return
    values in rank order. fn must be importable (it is pickled by name),
    and its return value is pickled back: keep tensors on the CPU."""
    import torch.multiprocessing as mp

    devices = [str(torch.device(d)) for d in devices]
    backend = backend or backend_for(devices)
    address = f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_worker, args=(fn, devices, address, backend,
                                          args, out_dir),
                           nprocs=len(devices), join=True,
                           start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(len(devices))]


def broadcast_module(module: torch.nn.Module):
    """Every parameter and buffer of `module` from rank 0, in place."""
    if world() == 1:
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            flat = t.data.contiguous()  # a channels_last weight is copied
            dist.broadcast(flat, src=0)
            if flat.data_ptr() != t.data.data_ptr():
                t.data.copy_(flat)
    return module


def primary_value(compute: Callable):
    """compute() on rank 0 alone, its value handed to every rank (the
    others wait for it): one decision, the same everywhere."""
    if world() == 1:
        return compute()
    box = [compute() if is_primary() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


class DataParallel:
    """What a train step on rank `rank` of `world` reduces over: the
    active process group."""

    def __init__(self):
        if not is_active():
            raise RuntimeError("DataParallel needs an active process group "
                               "(parallel.distributed.spawn)")
        self.rank = rank()
        self.world = world()

    @staticmethod
    def all_reduce(t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, differentiable: the backward
        sums the output gradients over the ranks too."""
        return _AllReduceSum.apply(t)

    @staticmethod
    def all_gather(t: torch.Tensor) -> torch.Tensor:
        """The ranks' `t`, stacked in rank order (not differentiable)."""
        parts = [torch.empty_like(t) for _ in range(world())]
        dist.all_gather(parts, t.contiguous())
        return torch.stack(parts)

    @staticmethod
    def sum(t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, in place (not differentiable)."""
        dist.all_reduce(t)
        return t

    def average_gradients(self, module: torch.nn.Module):
        """Each parameter's gradient := the mean over the ranks, by one
        all-reduce of the flattened gradients."""
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        if not grads:
            return
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat)
        flat.div_(self.world)
        for g, reduced in zip(grads, torch._utils._unflatten_dense_tensors(
                flat, grads)):
            g.copy_(reduced)
