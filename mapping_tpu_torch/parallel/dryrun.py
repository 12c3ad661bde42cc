"""A small multi-device dry run of the data-parallel paths on the CPU.

    python3 -m mapping_tpu_torch.parallel.dryrun [N]

Counterpart of the JAX package's `dryrun_multichip(n)`
(`__graft_entry__.py`), which jits a train step over a virtual n-device
CPU mesh. Here the same work runs over N gloo ranks on the CPU (default
2), at 64^2 on a ResNet34 U-Net of 4 filters with the weighted loss:
- one data-parallel train step and a K = 2 multi-step, on N spawned
  ranks (parallel/distributed.py), each with its shard of a global batch
  of 2 N images (train/step.py `place_for_mesh`); the ranks' losses and
  weights must agree;
- then, in this process, over a mesh of N CPU replicas with the trained
  weights: sharded serving and sharded TTA serving (infer/sharded.py),
  and the product FusedServe with the feature tensor.
Returns (and prints) what each part found; any failure raises.
"""

import sys

import numpy as np
import torch

from mapping_tpu_torch.parallel import distributed
from mapping_tpu_torch.parallel.mesh import Mesh

H = W = 64
PARAMS = {"encoder": "ResNet34", "num_filters": 4}


def _model():
    from mapping_tpu_torch.models.registry import build_network

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return build_network(PARAMS).to(memory_format=torch.channels_last)


def _global_batch(n_images):
    rng = np.random.RandomState(0)
    img = rng.rand(n_images, H, W, 3).astype(np.float32)
    mask = (img.mean(-1) > 0.5).astype(np.float32)
    target = np.stack([mask, np.zeros_like(mask), np.ones_like(mask)], -1)
    return {"image": torch.from_numpy(img), "target": torch.from_numpy(target)}


def _rank_steps(n_images):
    """One step, then K = 2 steps, on this rank's shard; returns the
    losses and rank 0's weights."""
    from mapping_tpu_torch.train.losses import make_loss_fn
    from mapping_tpu_torch.train.state import make_optimizer
    from mapping_tpu_torch.train.step import (make_train_step_multi,
                                              place_for_mesh)

    dp = distributed.DataParallel()
    model, batch = place_for_mesh(_model(), _global_batch(n_images),
                                  distributed.group_mesh())
    optimizer, scheduler = make_optimizer(model, lr=5e-4, gamma=0.99,
                                          weight_decay=1e-4)
    steps = make_train_step_multi(
        make_loss_fn("weighted", {"imsize": (H, W)}, reduce=dp.all_reduce),
        model, optimizer, scheduler, torch.float32, data_parallel=dp)
    one = steps([batch])["loss"]
    two = steps([batch, batch], first_step=1)["loss"]
    return {"losses": torch.cat([one, two]).tolist(),
            "weights": {k: v.detach().clone()
                        for k, v in model.state_dict().items()}}


def dryrun_multichip(n_devices: int = 2) -> dict:
    from mapping_tpu_torch.data.tta import tta_specs
    from mapping_tpu_torch.infer.serving import FusedServe
    from mapping_tpu_torch.infer.sharded import (make_sharded_infer,
                                                 make_sharded_tta_infer)
    from mapping_tpu_torch.train.trainer import SoftmaxProbs

    devices = ["cpu"] * n_devices
    ranks = distributed.spawn(_rank_steps, devices, 2 * n_devices)
    losses = np.array([r["losses"] for r in ranks])
    if not (np.isfinite(losses).all() and (losses == losses[0]).all()):
        raise AssertionError(f"the ranks' losses differ or are not "
                             f"finite: {losses}")
    for name, want in ranks[0]["weights"].items():
        for r in ranks[1:]:
            if not torch.equal(r["weights"][name], want):
                raise AssertionError(f"rank weights differ at {name}")

    mesh = Mesh(devices)
    model = _model()
    model.load_state_dict(ranks[0]["weights"])
    model.eval()
    images = _global_batch(2 * n_devices)["image"]
    post = dict(target_size=(H, W), category_layers=(1, 1),
                active_layers=(1,))

    def apply_fn(m, im):
        return m(im.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    labels, _ = make_sharded_infer(apply_fn, mesh, **post)(model, images)
    tta_labels, _ = make_sharded_tta_infer(
        apply_fn, mesh, tta_specs(flip_ud=True, flip_lr=True, rotation=True),
        method="gmean", **post)(model, images)
    serve = FusedServe(SoftmaxProbs(model, torch.float32), mesh=mesh,
                       compute_features=True, **post)
    s_labels, _, _, s_feats = serve(images)
    if s_feats.shape[:2] != (2 * n_devices, 2):
        raise AssertionError(f"feature tensor of shape {s_feats.shape}")
    found = {"losses": losses[0].tolist(),
             "max_labels": int(labels.max()),
             "max_tta_labels": int(tta_labels.max()),
             "max_served_labels": int(s_labels.max()),
             "features_shape": list(s_feats.shape)}
    print(f"dryrun_multichip({n_devices}): {found}")
    return found


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
