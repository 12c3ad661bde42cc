"""Data parallelism: the device mesh and the process groups of training.

Counterpart of mapping_tpu/parallel. The reference's only parallelism is
single-process `nn.DataParallel` (src/models.py:65): replicate the module,
scatter the batch over the local GPUs. The JAX package runs one SPMD
program over a mesh's 'data' axis. The port serves in one process with a
replica per device (infer/serving.py) and trains with one process per
device (parallel/distributed.py), both over a `Mesh` (parallel/mesh.py).
"""

from mapping_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                             Replicas, make_mesh, shard_batch,
                                             shard_batch_stacked,
                                             shard_pytree_replicated)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "Replicas",
    "make_mesh",
    "shard_batch",
    "shard_batch_stacked",
    "shard_pytree_replicated",
]
