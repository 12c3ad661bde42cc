"""Data parallelism of the port (ROADMAP item 16) against the JAX package.

The JAX side runs on the root conftest's 8 virtual CPU devices; the port
serves over a mesh of CPU replicas (["cpu", "cpu"]) in this process and
trains on two gloo ranks on the CPU (parallel/distributed.py `spawn`,
rank jobs in tests/torch_parallel_workers.py). Tolerances (each test
states its own too):
- mesh serving = single-device serving of the port: labels and areas
  exact, scores 1e-4 relative; against the JAX package's mesh FusedServe
  the rule of tests/test_torch_serving.py (labels equal except at pixels
  whose resized probability lies within 1e-4 of the threshold; images
  whose labels agree: areas exact, scores 1e-4 relative);
- a two-rank step = the port's single-process step on the concatenated
  batch, in float64: loss 1e-5 relative, every gradient 1e-4 of its
  tensor's largest magnitude, BatchNorm running statistics 1e-4 of
  theirs. Float64, because in float32 the order of the sums (one batch
  against two shards) flips ReLUs in the deep blocks, where a 64^2 input
  leaves 2 x 2 pixels, and moves some gradient tensors far more than 1e-4
  of their largest magnitude;
  = the JAX trainer's float32 step on a 2-device mesh, on the batch of
  tests/test_torch_train.py: loss 1e-4 relative, gradients 1e-3 of the
  largest (the rule of its single-device step);
- loss sequences (steps_per_call) 1e-6 relative between the two groupings
  of the same steps on the mesh, 1e-5 against one process for the first
  step and 1e-3 for the later ones (Adam's sign steps amplify rounding);
- batches: the ranks' batches concatenate to the single-process batch
  exactly.
"""

import json
import logging
import os
import shutil

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mapping_tpu.config import build_config as jax_build_config
from mapping_tpu.data import tta as jax_tta
from mapping_tpu.data.augment import resize_bilinear as jax_resize
from mapping_tpu.data.loader import _infer_batch_resize
from mapping_tpu.infer import daemon as jax_daemon
from mapping_tpu.infer.serving import FusedServe as JaxFusedServe
from mapping_tpu.infer.sharded import (make_sharded_infer as jax_sharded,
                                       make_sharded_tta_infer as
                                       jax_sharded_tta)
from mapping_tpu.models import UNet as FlaxUNet
from mapping_tpu.models.torch_convert import convert_unet_resnet
from mapping_tpu.models.unet_resnet import UNetResNet as FlaxUNetResNet
from mapping_tpu.parallel import (batch_sharding, make_mesh as jax_make_mesh,
                                  shard_batch_stacked as jax_stacked)
from mapping_tpu.train import losses as jax_losses
from mapping_tpu.train.state import create_train_state
from mapping_tpu.train.state import make_optimizer as jax_make_optimizer
from mapping_tpu.train.step import make_train_step as jax_make_train_step
from mapping_tpu.train.step import place_for_mesh as jax_place_for_mesh
from mapping_tpu_torch import manager as port_manager
from mapping_tpu_torch.config import build_config
from mapping_tpu_torch.data import tta
from mapping_tpu_torch.data.metadata import read_metadata
from mapping_tpu_torch.infer import daemon as port_daemon
from mapping_tpu_torch.infer.postprocess import postprocess_probabilities
from mapping_tpu_torch.infer.serving import FusedServe
from mapping_tpu_torch.infer.sharded import (make_sharded_infer,
                                             make_sharded_tta_infer)
from mapping_tpu_torch.models import convert
from mapping_tpu_torch.models.convert import state_dict_from_flax
from mapping_tpu_torch.models.scratch import UNet
from mapping_tpu_torch.parallel import (Replicas, make_mesh, shard_batch,
                                        shard_batch_stacked,
                                        shard_pytree_replicated)
from mapping_tpu_torch.parallel import distributed
from mapping_tpu_torch.parallel.dryrun import dryrun_multichip
from mapping_tpu_torch.pipelines import _xy
from mapping_tpu_torch.train.checkpoint import load_train_state
from tests import torch_parallel_workers as workers
from tests.test_torch_serving import (PARAMS, POST, _jax_serve, _pipeline,
                                      _state_dict, _tiles)
from tests.test_torch_train import (_assert_close_per_tensor, _capture, _rel,
                                    _step_batch)
from tests.torch_train_workspace import config, make_experiment

torch.set_num_threads(2)

CPU2 = ["cpu", "cpu"]


# ------------------------------------------------------------------ mesh

@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_and_shards_match_jax(n):
    """make_mesh's axes and shape (the model axis at 1), and the shard
    shapes of shard_batch (axis 0) and shard_batch_stacked (axis 1), as
    JAX places them."""
    jmesh = jax_make_mesh(jax.devices()[:n])
    mesh = make_mesh(["cpu"] * n)
    assert dict(jmesh.shape) == mesh.shape
    assert len(mesh.devices) == jmesh.shape["data"] == len(mesh)
    x = np.arange(8 * 4 * 3, dtype=np.float32).reshape(8, 4, 3)
    want = sorted({tuple(s.data.shape) for s in jax.device_put(
        x, batch_sharding(jmesh)).addressable_shards})
    got = shard_batch({"image": x}, mesh)
    assert sorted({tuple(s["image"].shape) for s in got}) == want
    assert np.array_equal(np.concatenate([s["image"].numpy() for s in got]),
                          x)
    stack = np.stack([x, x + 1])
    want = sorted({tuple(s.data.shape) for s in jax_stacked(
        stack, jmesh).addressable_shards})
    got = shard_batch_stacked([stack], mesh)
    assert sorted({tuple(s[0].shape) for s in got}) == want


def test_mesh_refusals_match_jax():
    """A batch that does not divide the data axis raises in both
    packages; so does an empty mesh in the port, and the default mesh
    where no card is visible."""
    with pytest.raises(ValueError, match="at least one device"):
        make_mesh([])
    x = np.zeros((3, 4), np.float32)
    with pytest.raises(ValueError):
        jax.device_put(x, batch_sharding(jax_make_mesh(jax.devices()[:2])))
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(x, make_mesh(CPU2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_mesh()


def test_replicas_are_one_copy_per_device():
    """shard_pytree_replicated: the module itself on its own device (one
    copy per distinct device), state dicts as well. Replicas: a copy on
    another device is made once per module object, and a new object
    (new weights) drops it. The 'meta' device stands for another card:
    its copies hold no data, only their identity and device are read."""
    module = torch.nn.Linear(3, 2)
    copies = shard_pytree_replicated(module, make_mesh(CPU2))
    assert copies[0] is module and copies[1] is module
    state = shard_pytree_replicated(module.state_dict(), make_mesh(CPU2))
    assert all(torch.equal(s["weight"], module.weight) for s in state)
    replicas = Replicas()
    other = replicas.get(module, "meta")
    assert other is not module and other.weight.device.type == "meta"
    assert replicas.get(module, "meta") is other
    assert replicas.get(module, "cpu") is module
    newer = torch.nn.Linear(3, 2)
    fresh = replicas.get(newer, "meta")
    assert fresh is not other and replicas.get(newer, "meta") is fresh
    on_meta = replicas.get(module.state_dict(), "meta")
    assert on_meta["weight"].device.type == "meta"


# --------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def mesh_served():
    """The port's FusedServe on one device and on ["cpu", "cpu"], and the
    JAX FusedServe on a 2-device mesh, over the same 4 tiles: plain, with
    TTA, with the feature tensor, and with an instance pad of half the
    largest component count, so that the densest images escalate once."""
    tiles = _tiles(n=4)
    size = (PARAMS["image_h"], PARAMS["image_w"])
    images = np.array(_infer_batch_resize(jnp.asarray(tiles), size)["image"])
    state = _state_dict(images)
    _, jax_probs_fn, folded = _jax_serve(state)
    probs_fn = _pipeline(PARAMS, state).trainer.probs_apply_fn()
    jmesh = jax_make_mesh(jax.devices()[:2])
    x = torch.from_numpy(images)
    counts = FusedServe(probs_fn, **POST)(x)[0].max()
    runs = {"plain": {}, "tta": {"tta_specs": "all"},
            "features": {"compute_features": True},
            "overflow": {"max_instances": (int(counts) + 1) // 2}}
    probs = {}
    out = {}
    for name, kw in runs.items():
        port_kw, jax_kw = dict(kw), dict(kw)
        if "tta_specs" in kw:
            port_kw["tta_specs"] = tta.tta_specs()
            jax_kw["tta_specs"] = jax_tta.tta_specs()
        jax_serve = JaxFusedServe(jax_probs_fn, lambda: folded, mesh=jmesh,
                                  **POST, **jax_kw)
        key = "tta" if "tta_specs" in kw else "plain"
        if key not in probs:
            probs[key] = np.asarray(jax_resize(jax.jit(jax_serve._probs)(
                folded, jnp.asarray(images)), POST["target_size"]))
        out[name] = {
            "single": FusedServe(probs_fn, **POST, **port_kw)(x),
            "mesh": FusedServe(probs_fn, mesh=make_mesh(CPU2), **POST,
                               **port_kw)(x),
            "jax": jax_serve(jnp.asarray(images)),
            "probs": probs[key], "pad": kw.get("max_instances")}
    return out


@pytest.mark.parametrize("name", ["plain", "tta", "features", "overflow"])
def test_mesh_serving_equals_single_device(mesh_served, name):
    """Labels and areas exact, scores (and features) 1e-4 relative."""
    single, mesh = mesh_served[name]["single"], mesh_served[name]["mesh"]
    assert len(single) == len(mesh)
    np.testing.assert_array_equal(mesh[0], single[0])
    np.testing.assert_array_equal(mesh[2], single[2])
    np.testing.assert_allclose(mesh[1], single[1], rtol=1e-4, atol=0)
    if name == "features":
        np.testing.assert_allclose(mesh[3], single[3], rtol=1e-4, atol=1e-6)
    assert single[0].max() > 0
    pad = mesh_served[name]["pad"]
    if pad:  # the densest images escalated once, on the first device
        assert single[1].shape[-1] == mesh[1].shape[-1] == 2 * pad
        assert single[0].max() > pad


@pytest.mark.parametrize("name", ["plain", "tta", "features", "overflow"])
def test_mesh_serving_matches_jax_mesh(mesh_served, name):
    """The port's mesh FusedServe against JAX's on a 2-device mesh, by the
    per-pixel rule of tests/test_torch_serving.py."""
    run = mesh_served[name]
    got, want = run["mesh"], [np.asarray(o) for o in run["jax"]]
    near = np.abs(run["probs"][..., 1] - 0.5) < 1e-4
    assert got[0].shape == want[0].shape
    assert not (got[0][:, 1] != want[0][:, 1])[~near].any()
    same = [i for i in range(len(want[0]))
            if np.array_equal(got[0][i], want[0][i])]
    assert len(same) >= len(want[0]) - 1 and want[0][:, 1].max() > 0
    width = min(got[1].shape[-1], want[1].shape[-1])
    np.testing.assert_array_equal(got[2][same][..., :width],
                                  want[2][same][..., :width])
    np.testing.assert_allclose(got[1][same][..., :width],
                               want[1][same][..., :width], rtol=1e-4, atol=0)


def test_mesh_serving_refuses_a_batch_that_does_not_divide():
    serve = FusedServe(lambda im: torch.softmax(im[..., :2], -1),
                       mesh=make_mesh(CPU2), **POST)
    with pytest.raises(ValueError, match="does not divide"):
        serve(torch.rand(3, 8, 8, 3))


def test_int8_forward_serves_on_each_mesh_device():
    """The int8 forward's snapshot is copied once to a device it has not
    seen, keyed by its snapshot, and serves the same probabilities."""
    from mapping_tpu_torch.models.quantize import QuantizedProbs

    module = torch.nn.Conv2d(3, 2, 1)
    packed = {"module": module}

    def get_packed():
        return packed

    get_packed.set_async = lambda flag: None
    get_packed.stats = {}
    probs = QuantizedProbs(lambda p, im: p["module"](im), get_packed)
    x = torch.rand(1, 3, 4, 4)
    assert torch.equal(probs(x), module(x))
    out = probs(x.to("meta"))  # 'meta' stands for another card
    assert out.device.type == "meta" and out.shape == (1, 2, 4, 4)
    there = probs._replicas.get(module, "meta")
    assert there is not module and there.weight.device.type == "meta"
    assert probs._replicas.get(module, "meta") is there
    packed["module"] = torch.nn.Conv2d(3, 2, 1)  # a recalibrated snapshot
    probs(x.to("meta"))
    assert probs._replicas.get(packed["module"], "meta") is not there


# ------------------------------------------------------- sharded infer

def _scratch_case(seed):
    """tests/test_sharded_infer.py's model (the scratch UNet, 4 filters,
    2 blocks, float32) with its Flax initialisation carried to the port."""
    model = FlaxUNet(n_filters=4, repeat_blocks=2, dtype=jnp.float32)
    x = jnp.asarray(np.random.RandomState(seed).rand(8, 64, 64, 3),
                    jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), x, train=False)
    port = UNet(n_filters=4, repeat_blocks=2)
    port.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in
                          convert.named_state_dict_from_flax(
                              variables["params"],
                              variables["batch_stats"]).items()})
    return model, variables, port.eval(), x


def _port_apply(m, im):
    return m(im.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("kind", ["plain", "tta"])
def test_sharded_infer_matches_jax(kind):
    """make_sharded_infer / make_sharded_tta_infer over 8 CPU replicas on
    tests/test_sharded_infer.py's cases (seeds 0 and 1): labels equal to
    the port's single-device postprocess of the same probabilities and
    scores 1e-4 (as the JAX test holds its own), and equal to JAX's
    sharded labels but where a pixel lies within 1e-4 of the threshold."""
    model, variables, port, x = _scratch_case(0 if kind == "plain" else 1)
    post = dict(target_size=(64, 64), category_layers=(1, 1),
                active_layers=(1,))
    mesh = make_mesh(["cpu"] * 8)
    jmesh = jax_make_mesh()

    def apply_fn(v, im):
        return model.apply(v, im, train=False)

    xt = torch.from_numpy(np.array(x))
    if kind == "plain":
        labels, scores = make_sharded_infer(_port_apply, mesh, **post)(port,
                                                                      xt)
        jl, _ = jax_sharded(apply_fn, jmesh, **post)(variables, x)
        with torch.no_grad():
            probs = torch.softmax(_port_apply(port, xt), -1)
        jprobs = np.asarray(jax.nn.softmax(apply_fn(variables, x), -1))
    else:
        labels, scores = make_sharded_tta_infer(
            _port_apply, mesh, tta.tta_specs(), "gmean", **post)(port, xt)
        jl, _ = jax_sharded_tta(apply_fn, jmesh, jax_tta.tta_specs(),
                                method="gmean", **post)(variables, x)
        with torch.no_grad():
            probs = tta.tta_wrap_predict(
                lambda f: torch.softmax(_port_apply(port, f), -1),
                tta.tta_specs(), "gmean")(xt)
        jprobs = np.asarray(jax_tta.tta_wrap_predict(
            lambda f: jax.nn.softmax(apply_fn(variables, f), -1),
            jax_tta.tta_specs(), "gmean")(x))
    ref_labels, ref_scores, _ = postprocess_probabilities(probs, **post)
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    np.testing.assert_allclose(scores.numpy(), ref_scores, rtol=1e-4,
                               atol=1e-4)
    near = np.abs(jprobs[..., 1] - 0.5) < 1e-4
    assert not (labels.numpy()[:, 0] != np.asarray(jl)[:, 0])[~near].any()
    assert labels.shape == np.asarray(jl).shape and labels.max() > 0


# ---------------------------------------------------------------- daemon

class _StubServe:
    enable_async_recalibration = staticmethod(lambda: False)

    def __init__(self, mesh):
        self.mesh = mesh

    def dispatch(self, images):
        return images

    def collect(self, handle):
        n = handle.shape[0]
        return (np.zeros((n, 2, 300, 300), np.int16),
                np.zeros((n, 2, 256), np.float32),
                np.zeros((n, 2, 256), np.int32))


class _StubPipeline:
    """What both daemons read of a pipeline, with a stand-in serve."""

    def __init__(self, mesh, cache):
        self.trainer = type("T", (), {"mesh": mesh})()
        self.trainer_cache_path = cache
        self._weights_loaded = True
        self.category_layers = (1, 1)
        self.loader = type("L", (), {
            "mode": "resize", "device": torch.device("cpu"),
            "infer_preprocess": staticmethod(lambda b: b)})()
        self._mesh = mesh

    def _ensure_weights(self):
        pass

    def serve_program(self, return_features=False):
        return _StubServe(self._mesh)


def _port_warnings_reach_caplog(monkeypatch):
    """The port's CLI (`main._init_logger`) stops its logger propagating
    for the rest of the process, so a test that reads the port's warnings
    from `caplog` (which listens at the root logger) would depend on which
    files its worker ran first: let them propagate for this test."""
    monkeypatch.setattr(logging.getLogger("mapping_tpu_torch"), "propagate",
                        True)


@pytest.mark.parametrize("buckets", ["1,2,3,4,5", "3", ""])
def test_daemon_bucket_filter_matches_jax(tmp_path, caplog, monkeypatch,
                                          buckets):
    """On a 2-device mesh both daemons keep the buckets that divide and
    the full batch (6); the port warns about the rest (the JAX logger
    does not propagate to pytest's capture)."""
    _port_warnings_reach_caplog(monkeypatch)
    cache = tmp_path / "unet.msgpack"
    cache.write_bytes(b"")
    overrides = {"batch_size_inference": 6, "serve_batch_buckets": buckets}
    kept = []
    for mod, cfg, mesh in (
            (jax_daemon, jax_build_config(None, overrides=overrides),
             jax_make_mesh(jax.devices()[:2])),
            (port_daemon, build_config(overrides=overrides),
             make_mesh(CPU2))):
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            daemon = mod.daemon_from_pipeline(_StubPipeline(mesh, str(cache)),
                                              cfg, port=0)
        daemon.server.server_close()
        daemon.batcher.close()
        kept.append(list(daemon.batcher._buckets))
    assert kept[0] == kept[1]
    assert ("dropped" in caplog.text) == (buckets != "")
    if buckets == "1,2,3,4,5":
        assert kept[1] == [2, 4, 6]


def test_daemon_bucket_filter_after_the_cli_logger(tmp_path, caplog,
                                                   monkeypatch):
    """The bucket filter's warning is read after the port's CLI has set up
    its logger in this process, as any earlier in-process CLI test of the
    worker leaves it."""
    from mapping_tpu_torch import main as port_main
    logger = logging.getLogger("mapping_tpu_torch")
    saved = logger.handlers[:], logger.level, logger.propagate
    try:
        port_main._init_logger()
        test_daemon_bucket_filter_matches_jax(tmp_path, caplog, monkeypatch,
                                              "1,2,3,4,5")
    finally:
        monkeypatch.undo()
        logger.handlers[:] = saved[0]
        logger.setLevel(saved[1])
        logger.propagate = saved[2]


# -------------------------------------------------------- training ranks

def _batch(n, seed=3):
    image, target = _step_batch(n, seed=seed)
    return {"image": torch.from_numpy(image),
            "target": torch.from_numpy(target)}


def _u8_tiles(n=8, hw=80, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, hw, hw, 3)).astype(np.uint8)
    mask = (images.mean(-1) > 127).astype(np.uint16)
    targets = np.stack([mask, rng.randint(0, 9, (n, hw, hw)) * (1 - mask),
                        np.where(mask > 0, 4, 0)], -1).astype(np.uint16)
    return images, targets


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """4 train and 5 val tiles with the port's target files and the JAX
    metadata (tests/torch_train_workspace.py); removed with the module
    (the runs on it leave two experiments' checkpoints)."""
    root = make_experiment(tmp_path_factory.mktemp("parallel"))
    yield root
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def ranks(experiment):
    """tests/torch_parallel_workers.rank_job on two gloo ranks, and the
    same work in this process without a group."""
    torch.manual_seed(0)
    from mapping_tpu_torch.models.unet_resnet import UNetResNet

    init = {k: v.numpy() for k, v in UNetResNet(34).state_dict().items()}
    batch = _batch(2)
    batches = [_batch(4, seed=s) for s in (11, 12)]
    images, targets = _u8_tiles()
    files = _xy([r for r in read_metadata(experiment / "meta" /
                                          "metadata.csv")
                 if r["is_train"] == 1])
    got = distributed.spawn(workers.rank_job, CPU2, init, batch, batches,
                            images, targets, files)
    single = {"dropout": workers.one_step(init, batch, 0.1,
                                          dtype=torch.float64),
              "multi": workers.multi_steps(init, batches, spc=1),
              "fit": workers.trainer_fit(init, images, targets, 1),
              "batches": workers.flow_batches(images, targets, files)}
    return {"init": init, "batch": batch, "ranks": got, "single": single}


def test_two_rank_step_equals_single_process_step(ranks):
    """Float64, dropout 0.1 on: the loss 1e-5 relative, every gradient
    1e-4 of its tensor's largest magnitude, on both ranks alike (the
    gradients are all-reduced: the other rank's checksums equal rank 0's
    exactly)."""
    r0, r1 = ranks["ranks"]
    want = ranks["single"]["dropout"]
    for r in (r0, r1):
        assert _rel(r["dropout"]["loss"], want["loss"]) <= 1e-5
    _assert_close_per_tensor(r0["dropout"]["grads"], want["grads"], 1e-4,
                             "grad")
    assert r1["dropout"]["checksum"] == r0["dropout"]["checksum"]
    assert r0["dropout"]["loss"] != r0["plain"]["loss"]  # dropout acts


def test_two_rank_running_statistics_equal_single_process(ranks):
    """BatchNorm running mean and (biased, Flax) variance after the step:
    1e-4 of each tensor's largest magnitude, the same on both ranks."""
    r0, r1 = ranks["ranks"]
    want = ranks["single"]["dropout"]["stats"]
    _assert_close_per_tensor(r0["dropout"]["stats"], want, 1e-4, "stat")
    for name, v in r0["dropout"]["stats"].items():
        assert torch.equal(v, r1["dropout"]["stats"][name])


@pytest.fixture(scope="module")
def jax_mesh_step(ranks):
    """The JAX trainer's step on a 2-device mesh (place_for_mesh), the
    same weights (carried into Flax) and batch, gradients captured."""
    params, stats = convert_unet_resnet(ranks["init"], 34, True)
    model = FlaxUNetResNet(encoder_depth=34, num_classes=2, num_filters=32,
                           dtype=jnp.float32)
    tx = optax.chain(_capture(), jax_make_optimizer(lr=5e-4,
                                                    weight_decay=1e-4))
    state = create_train_state(model, jax.random.PRNGKey(0), (1, 64, 64, 3),
                               tx)
    state = state.replace(params=params, batch_stats=stats,
                          opt_state=tx.init(params))
    batch = {k: jnp.asarray(v.numpy()) for k, v in ranks["batch"].items()}
    state, batch = jax_place_for_mesh(state, batch,
                                      jax_make_mesh(jax.devices()[:2]))
    step = jax_make_train_step(jax_losses.make_loss_fn(
        "weighted", workers.LOSS_PARAMS))
    state, metrics = step(state, batch)
    return {"loss": float(metrics["loss"]),
            "want": state_dict_from_flax(jax.device_get(state.opt_state[0]),
                                         jax.device_get(state.batch_stats),
                                         34)}


def test_two_rank_step_matches_jax_mesh_step(ranks, jax_mesh_step):
    """Dropout off (the Flax ResNet U-Net has none): loss 1e-4 relative,
    gradients 1e-3 and running statistics 1e-4 of each tensor's largest
    magnitude."""
    got = ranks["ranks"][0]["plain"]
    want = jax_mesh_step["want"]
    assert _rel(got["loss"], jax_mesh_step["loss"]) <= 1e-4
    _assert_close_per_tensor(got["grads"], {n: want[n] for n in got["grads"]},
                             1e-3, "grad")
    _assert_close_per_tensor(got["stats"], {n: want[n] for n in got["stats"]},
                             1e-4, "stat")


def test_steps_per_call_on_the_mesh_keeps_the_losses(ranks):
    """Two steps taken 2 at a time = one at a time (1e-6 relative), and =
    one process (first step 1e-5, the rest 1e-3 relative); the trainer's
    fit likewise with steps_per_call 1 and 2."""
    r0, r1 = ranks["ranks"]
    single = ranks["single"]
    for r in (r0, r1):
        np.testing.assert_allclose(r["multi"], r["single_calls"], rtol=1e-6)
        np.testing.assert_allclose(r["fit"][2], r["fit"][1], rtol=1e-6)
    for got, want in ((r0["multi"], single["multi"]),
                      (r0["fit"][1], single["fit"])):
        assert len(got) == len(want) and np.isfinite(got).all()
        assert _rel(got[0], want[0]) <= 1e-5
        np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("kind", ["memory", "crop", "files"])
def test_rank_batches_concatenate_to_the_single_process_batch(ranks, kind):
    """Each rank's slice, with the augmentation drawn for the global
    batch, concatenates to the single-process flow's batch exactly."""
    got = [r["batches"][kind] for r in ranks["ranks"]]
    want = ranks["single"]["batches"][kind]
    assert len(got[0]) == len(got[1]) == len(want) > 0
    for a, b, w in zip(got[0], got[1], want):
        for key in ("image", "target"):
            assert torch.equal(torch.cat([a[key], b[key]]), w[key]), key


def test_uneven_global_batch_raises():
    images, targets = _u8_tiles(n=5)
    from mapping_tpu_torch.data.loader import in_memory_train_flow

    with pytest.raises(ValueError, match="does not divide"):
        in_memory_train_flow(images, targets, 4, (64, 64),
                             torch.Generator(), device="cpu", shard=(0, 2))


TRAIN = {"epochs_nr": 1, "resume_every": 1, "best_write_every": 1,
         "evaluation_data_sample": 5}


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _channels(root):
    return [json.loads(line)["channel"] for line in
            (root / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def trained_on_ranks(experiment):
    """`train -p unet_weighted` (mAP validation) in one process and on two
    gloo ranks through the manager's train_on_ranks, 1 epoch; then, with
    the cache and the stage marker removed (a run killed after epoch 0),
    the rank run again with 2 epochs, which resumes from its last.pt."""
    root = experiment
    port_manager.PipelineManager(config(root, "single", **TRAIN)).train(
        "unet_weighted", False)
    cfg = build_config(config(root, "ranks", **TRAIN))
    port_manager.train_on_ranks("unet_weighted", False, cfg, CPU2)
    first = {"files": _files(root / "ranks"),
             "channels": _channels(root / "ranks"),
             "aux": json.loads((root / "ranks" / "checkpoints" / "unet" /
                                "last.pt.aux.json").read_text())}
    # what a run killed after its first epoch leaves: no cache, no marker
    (root / "ranks" / "transformers" / "unet.pt").unlink()
    (root / "ranks" / "checkpoints" / "unet" / "STAGE_COMPLETE").unlink()
    cfg = build_config(config(root, "ranks", **{**TRAIN, "epochs_nr": 2}))
    port_manager.train_on_ranks("unet_weighted", False, cfg, CPU2)
    return {"root": root, "first": first}


def test_rank_run_writes_the_single_process_files(trained_on_ranks):
    """Rank 0 alone writes: the same files as the single-process run, and
    each metric once (no line from the other rank)."""
    root, first = trained_on_ranks["root"], trained_on_ranks["first"]
    assert first["files"] == _files(root / "single") == sorted([
        "checkpoints/unet/STAGE_COMPLETE", "checkpoints/unet/best.pt",
        "checkpoints/unet/last.pt", "checkpoints/unet/last.pt.aux.json",
        "metrics.jsonl", "transformers/unet.pt"])
    assert first["channels"] == _channels(root / "single")
    assert first["aux"]["epoch_id"] == 0


def test_rank_run_resumes_from_last_pt(trained_on_ranks):
    """The second rank run resumes at epoch 1: last.pt holds 2 epochs of
    2 steps (4 train tiles, global batch 2), the sidecar epoch 1, and the
    metrics of both epochs follow each other once."""
    root = trained_on_ranks["root"] / "ranks"
    ck = root / "checkpoints" / "unet"
    assert load_train_state(ck / "last.pt")["step"] == 4
    assert json.loads((ck / "last.pt.aux.json").read_text())["epoch_id"] == 1
    channels = _channels(root)
    assert channels.count("unet epoch_val sum") == 2
    assert channels.count("unet batch loss") == 4


def test_spawn_holds_its_rendezvous_port(monkeypatch):
    """spawn's ranks meet at a store the parent serves on a port the OS
    gave it, and the port is held from that moment on (binding it again
    fails), so no other process can take it before the ranks connect.
    The parent used to pick a free port, release it and let rank 0 bind
    it seconds later, after the ranks had started: a window in which
    another process's connection could take the port."""
    import socket

    created = []
    server = distributed.dist.TCPStore

    def store(*args, **kwargs):
        made = server(*args, **kwargs)
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            with pytest.raises(OSError):
                s.bind(("127.0.0.1", made.port))
        created.append((args, kwargs, made.port))
        return made

    monkeypatch.setattr(distributed.dist, "TCPStore", store)
    got = distributed.spawn(workers.rendezvous_job, CPU2)
    assert got == [(0, 2, 3.0), (1, 2, 3.0)]
    (args, kwargs, port), = created
    assert args[1] == 0 and kwargs["is_master"] and port > 0


# -------------------------------------------------------------- dry run

def test_dryrun_multichip_runs():
    """dryrun_multichip(2): one step and a K = 2 multi-step on two gloo
    ranks with equal losses and weights, then sharded, sharded TTA and
    feature serving over two CPU replicas."""
    found = dryrun_multichip(2)
    assert len(found["losses"]) == 3 and np.isfinite(found["losses"]).all()
    assert found["features_shape"] == [4, 2, 256, 9]


def test_parallel_modules_import_without_jax():
    """The new modules import with jax, flax, PIL, pandas and sklearn
    blocked, and pull in nothing of the JAX package."""
    import subprocess
    import sys

    code = ("import sys, importlib\n"
            "for m in ('jax', 'flax', 'PIL', 'pandas', 'sklearn'):\n"
            "    sys.modules[m] = None\n"
            "for n in ('parallel', 'parallel.mesh', 'parallel.distributed',"
            " 'parallel.dryrun', 'infer.sharded'):\n"
            "    importlib.import_module('mapping_tpu_torch.' + n)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'flax', 'mapping_tpu') and sys.modules[k] is not None]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr


def test_scale_out_tool_runs_on_cpu_replicas(monkeypatch):
    """tools/scale_out.py's parts over two CPU replicas and gloo ranks at
    ResNet34, 64^2, batch 4 (a rehearsal: its times are no card's): the
    mesh serves the one-device labels, the float64 step on the ranks is
    one process's within 1e-10 of each tensor's max, and every part
    reports. On a machine without a card its command refuses."""
    from mapping_tpu_torch.tools import scale_out

    for name, value in (("ENCODER", "ResNet34"), ("SIZE", 64), ("BATCH", 4),
                        ("STEPS", 1), ("REPS", 1), ("TRACED", 1)):
        monkeypatch.setattr(scale_out, name, value)
    parts = {line["part"]: line for line in scale_out.run(CPU2)}
    assert parts["serve"]["images_with_one_card_labels"] == "8 of 8"
    assert parts["serve"]["mesh_kernel_busy_ms_per_batch"] == {}
    assert all(r["grad_err"] <= 1e-10 and r["stat_err"] <= 1e-10
               for r in parts["step"]["ranks"])
    assert len(parts["train"]["rank_ms"]) == 2
    assert set(parts["norm"]) >= {"plain", "global_batch_norm"}
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA card"):
            scale_out.main([])
