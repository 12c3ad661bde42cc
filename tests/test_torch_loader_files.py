"""The file-backed train data path of the port against the JAX package: the
crops of the `crop_and_pad` mode, `load_target`, and SegmentationLoader's
training and validation flows over image and mask files.

Files: the synthetic fixture's train split (6 JPEG tiles of 300^2) and the
target files the port's prepare_masks writes for it on the CPU.

Tolerances: crops exact; the flows' batches with augmentation off, in the
JAX package's file order for the same seed: 1e-6 absolute, except where
the batch is resized (the `resize` mode, 300^2 -> 64^2, antialiased):
images 1e-5 absolute, as the resize has been held since the training
slice, and targets 1e-6 relative (distances reach ~500). The random
draws themselves (augmentation, crop offsets) come from a torch.Generator
and cannot match JAX's, so the crop is held against JAX's with the
offsets JAX drew.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from mapping_tpu.data import augment as jax_augment
from mapping_tpu.data.loader import SegmentationLoader as JaxLoader
from mapping_tpu.data.loader import _train_batch_crop
from mapping_tpu_torch import main as cli
from mapping_tpu_torch.data import augment
from mapping_tpu_torch.data import loader as port_loader
from mapping_tpu_torch.data.loader import (SegmentationLoader,
                                           train_batch_crop)
from tests.fixtures.synthetic import generate

torch.set_num_threads(2)

SIZE = (64, 64)


def _jax_crop_offsets(rng, b, hw, size):
    """The offsets jax_augment.random_crop draws from `rng`."""
    tops, lefts = [], []
    for key in jax.random.split(rng, b):
        ky, kx = jax.random.split(key)
        tops.append(int(jax.random.randint(ky, (), 0, hw[0] - size[0] + 1)))
        lefts.append(int(jax.random.randint(kx, (), 0, hw[1] - size[1] + 1)))
    return torch.tensor(tops), torch.tensor(lefts)


def _batch(seed, b=3, hw=(37, 45)):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, *hw, 3).astype(np.float32),
            rng.rand(b, *hw, 3).astype(np.float32))


@pytest.mark.parametrize("size", [(16, 20), (37, 45), (1, 1)])
def test_random_crop_matches_jax_with_its_offsets(size):
    images, target = _batch(0)
    rng = jax.random.PRNGKey(size[0])
    want = jax_augment.random_crop(rng, jnp.asarray(images),
                                   jnp.asarray(target), size)
    tops, lefts = _jax_crop_offsets(rng, 3, images.shape[1:3], size)
    got = augment.random_crop(torch.from_numpy(images),
                              torch.from_numpy(target), tops, lefts, size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sample_random_crop_stays_inside():
    gen = torch.Generator().manual_seed(0)
    tops, lefts = augment.sample_random_crop(500, (37, 45), (16, 20), gen)
    assert tops.min() == 0 and tops.max() == 21
    assert lefts.min() == 0 and lefts.max() == 25
    with pytest.raises(ValueError, match="larger"):
        augment.sample_random_crop(1, (10, 10), (11, 4), gen)


@pytest.mark.parametrize("size", [(16, 20), (36, 44), (37, 45)])
def test_center_crop_matches_jax(size):
    images, _ = _batch(1)
    np.testing.assert_array_equal(
        augment.center_crop(torch.from_numpy(images), size).numpy(),
        np.asarray(jax_augment.center_crop(jnp.asarray(images), size)))


def test_train_batch_crop_without_augmentation_matches_jax():
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (2, 40, 44, 3)).astype(np.uint8)
    target = rng.randint(0, 50, (2, 40, 44, 3)).astype(np.uint16)
    want = _train_batch_crop(jax.random.PRNGKey(0), jnp.asarray(images),
                             jnp.asarray(target), (32, 32), augment=False)
    got = train_batch_crop(None, torch.from_numpy(images),
                           torch.from_numpy(target), (32, 32), augment=False)
    for k in ("image", "target"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=0)


def test_train_batch_crop_with_augmentation_is_a_crop_of_the_warp():
    """With augmentation, the batch is fast_seq's warp (drawn first) cut at
    the offsets drawn next, from the same generator."""
    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (3, 40, 44, 3)).astype(np.uint8)
    target = rng.randint(0, 50, (3, 40, 44, 3)).astype(np.uint16)
    got = train_batch_crop(torch.Generator().manual_seed(5),
                           torch.from_numpy(images), torch.from_numpy(target),
                           (32, 32))
    gen = torch.Generator().manual_seed(5)
    params = augment.sample_fast_augment(3, gen)
    img, tgt = augment.apply_fast_augment(
        torch.from_numpy(images).float() / 255,
        torch.from_numpy(target).float(), params)
    img, tgt = augment.random_crop(img, tgt, *augment.sample_random_crop(
        3, (40, 44), (32, 32), gen), (32, 32))
    assert torch.equal(got["image"], augment.normalize_image(img))
    assert torch.equal(got["target"], tgt)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(image paths, mask paths) of the fixture's train split, its targets
    written by the port's prepare_masks on the CPU."""
    root = tmp_path_factory.mktemp("loader_files")
    generate(str(root / "data"), n_train=6, n_val=1, seed=11)
    config = root / "c.yaml"
    config.write_text(yaml.safe_dump({"parameters": {
        "data_dir": str(root / "data"), "meta_dir": str(root / "meta"),
        "experiment_dir": str(root / "exp"), "device": "cpu"}}))
    cli.main(["--config", str(config), "prepare_masks"])
    images = sorted((root / "data" / "train" / "images").iterdir())
    masks = [str(root / "meta" / "masks_overlayed_eroded_0_dilated_0"
                 / "train" / "masks" / (p.stem + ".png")) for p in images]
    return [str(p) for p in images], masks


def test_load_target_matches_jax(files):
    from mapping_tpu.data.loader import load_target as jax_load_target

    for mask_path in files[1]:
        got = port_loader.load_target(mask_path)
        assert got.dtype == np.uint16 and got.shape == (300, 300, 3)
        np.testing.assert_array_equal(got, jax_load_target(mask_path))


def test_load_target_without_distance_and_size_files(tmp_path):
    from mapping_tpu.data.loader import load_target as jax_load_target
    from mapping_tpu_torch.utils.png import write_png_gray

    (tmp_path / "masks").mkdir()
    path = str(tmp_path / "masks" / "a.png")
    write_png_gray(path, np.eye(5, dtype=np.uint8))
    got = port_loader.load_target(path)
    np.testing.assert_array_equal(got, jax_load_target(path))
    assert (got[..., 1] == 0).all() and (got[..., 2] == 1).all()


def _loaders(mode, **kw):
    common = dict(mode=mode, size=SIZE, pad=(6, 6), pad_method="reflect",
                  batch_size_train=4, batch_size_inference=4, seed=7,
                  augment=False)
    common.update(kw)
    return JaxLoader(**common), SegmentationLoader(device="cpu", **common)


def _assert_batches_equal(got, want, resized):
    tol = {"image": dict(atol=1e-5 if resized else 1e-6, rtol=0),
           "target": dict(atol=1e-6, rtol=1e-6 if resized else 0)}
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert tuple(g[k].shape) == tuple(w[k].shape), k
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       **tol[k])


@pytest.mark.parametrize("mode", ["resize", "crop_and_pad"])
def test_train_flow_matches_jax_file_order(files, mode):
    """Two epochs of 6 files in batches of 4 (a ragged last batch of 2):
    the same files in the same order as the JAX loader for one seed (a new
    order each epoch), and the same batches without augmentation."""
    jax_loader, loader = _loaders(mode)
    (jflow, jsteps), _ = jax_loader.transform(*files).values()
    (flow, steps), valid = loader.transform(*files).values()
    assert steps == jsteps == 2 and valid == (None, None)
    got = [b for _ in range(2) for b in flow]
    want = [b for _ in range(2) for b in jflow]
    _assert_batches_equal(got, want, mode == "resize")
    assert not torch.equal(got[0]["image"][:2], got[2]["image"][:2])
    assert flow._next is not None  # the third epoch's prefetch
    flow.close()
    assert flow._next is None


def test_train_flow_augments_with_the_loader_generator(files):
    _, loader = _loaders("resize", augment=True)
    flow, steps = loader.transform(*files)["datagen"]
    first = list(flow)
    flow.close()
    assert len(first) == steps == 2
    _, again = _loaders("resize", augment=True)
    flow, _ = again.transform(*files)["datagen"]
    for a, b in zip(first, flow):
        assert torch.equal(a["image"], b["image"])
        assert torch.equal(a["target"], b["target"])
    flow.close()


@pytest.mark.parametrize("mode", ["resize", "crop_and_pad"])
def test_validation_flows_match_jax(files, mode):
    """Validation batches with targets stay ragged (4 + 2); crop_and_pad
    pads the target with the images' pad method; the inference flow of
    the same files pads its tail with duplicates."""
    jax_loader, loader = _loaders(mode)
    x, y = files
    want = jax_loader.transform(x[:1], y[:1], x, y)["validation_datagen"]
    got = loader.transform(x[:1], y[:1], x, y)["validation_datagen"]
    assert got[1] == want[1] == 2
    _assert_batches_equal(list(got[0]), list(want[0]), mode == "resize")
    want = jax_loader.transform(x, y, train_mode=False)["datagen"][0]
    got = loader.transform(x, y, train_mode=False)["datagen"][0]
    batches = list(got)
    assert [b["image"].shape[0] for b in batches] == [4, 2]
    _assert_batches_equal(batches, list(want), mode == "resize")
    infer = loader.transform(x, None, train_mode=False)["datagen"][0]
    assert infer.n_images == 6
    assert [b["image"].shape[0] for b in infer] == [4, 4]


def test_load_in_memory_caches_targets(files, monkeypatch):
    calls = []
    real = port_loader.load_target
    monkeypatch.setattr(port_loader, "load_target",
                        lambda p: calls.append(p) or real(p))
    _, loader = _loaders("resize", load_in_memory=True)
    flow, _ = loader.transform(*files)["datagen"]
    for _ in range(3):
        list(flow)
    flow.close()
    assert sorted(calls) == sorted(files[1])


def _mixed_files(root):
    """Three tiles of 300^2, 256^2 and 320^2 (random PNG images, masks of
    a few rectangles, distances up to ~500 and sizes as the JAX package
    writes them) -> (image paths, mask paths)."""
    from mapping_tpu_torch.utils import ndpickle
    from mapping_tpu_torch.utils.png import encode_png, write_png_gray

    rng = np.random.RandomState(5)
    images, masks = [], []
    for i, side in enumerate((300, 256, 320)):
        for sub in ("images", "masks", "distances", "sizes"):
            (root / sub).mkdir(exist_ok=True)
        image = root / "images" / f"t{i}.png"
        image.write_bytes(encode_png(rng.randint(
            0, 256, (side, side, 3)).astype(np.uint8)))
        mask = np.zeros((side, side), np.uint8)
        for _ in range(4):
            y, x = rng.randint(0, side - 40, 2)
            mask[y:y + rng.randint(5, 40), x:x + rng.randint(5, 40)] = 1
        write_png_gray(str(root / "masks" / f"t{i}.png"), mask)
        ndpickle.dump((rng.rand(side, side) * 500).astype(np.float32),
                      str(root / "distances" / f"t{i}"))
        ndpickle.dump(rng.randint(1, 3000, (side, side)).astype(np.uint16),
                      str(root / "sizes" / f"t{i}"))
        images.append(str(image))
        masks.append(str(root / "masks" / f"t{i}.png"))
    return images, masks


@pytest.mark.parametrize("size", [(256, 256), (64, 48)])
def test_mixed_tile_sizes_raise(tmp_path, size):
    """A batch of 300^2, 256^2 and 320^2 tiles is resized on the host to
    the loader's size as the JAX loader does it through Pillow: images
    byte for byte, targets (float32 for such a batch) exactly; a batch of
    one size keeps uint16 targets."""
    images, masks = _mixed_files(tmp_path)
    jax_loader, loader = _loaders("resize", size=size)
    idxs = np.arange(3)
    want_x, want_y = jax_loader._assemble(images, masks, idxs)
    got_x, got_y, _ = loader._assemble(images, masks, idxs)
    assert got_x.dtype == torch.uint8 and got_y.dtype == np.float32
    assert got_x.shape == size_b(size, 3) and got_y.shape == size_b(size, 3)
    np.testing.assert_array_equal(got_x.numpy(), want_x)
    np.testing.assert_array_equal(got_y, want_y)
    same_x, same_y, _ = loader._assemble(images, masks, np.array([1]))
    assert same_y.dtype == np.uint16 and same_x.shape == (1, 256, 256, 3)
    np.testing.assert_array_equal(
        same_y, jax_loader._assemble(images, masks, np.array([1]))[1])


def size_b(size, b):
    return (b,) + tuple(size) + (3,)


def test_mixed_tile_sizes_flow_through_training_and_inference(tmp_path):
    """The same mixed files through the training flow (no augmentation)
    and the inference flow: the JAX loader's batches within the resized
    tolerance."""
    images, masks = _mixed_files(tmp_path)
    jax_loader, loader = _loaders("resize", batch_size_train=3,
                                  batch_size_inference=3)
    (jflow, _), _ = jax_loader.transform(images, masks).values()
    (flow, _), _ = loader.transform(images, masks).values()
    _assert_batches_equal(list(flow), list(jflow), True)
    flow.close()
    want = jax_loader.transform(images, None, train_mode=False)["datagen"]
    got = loader.transform(images, None, train_mode=False)["datagen"]
    _assert_batches_equal(list(got[0]), list(want[0]), True)
