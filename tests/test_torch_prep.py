"""Target preparation of the port against the JAX package, on the same
decoded numpy masks: the distance transform, the size matrix, the batched
device function in every mode, and the chunked path for images with more
objects than MAX_OBJECTS.

Tolerances: all exact. The distance transform keeps the JAX package's
float32 arithmetic (integer squares, a min-plus over rows, a correctly
rounded sqrt), so distances are bit-equal, and so equal as float16.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapping_tpu_torch.ops import edt
from mapping_tpu_torch.ops import instance
from mapping_tpu_torch.prep import targets

jax_edt = importlib.import_module("mapping_tpu.ops.edt")
jax_instance = importlib.import_module("mapping_tpu.ops.instance")
jax_targets = importlib.import_module("mapping_tpu.prep.targets")

torch.set_num_threads(2)


def _masks(kind, rng):
    if kind == "random":
        return rng.rand(3, 17, 23) < 0.08
    if kind == "dense":
        return rng.rand(2, 40, 31) < 0.5
    if kind == "empty":
        return np.zeros((1, 16, 20), bool)
    if kind == "full":
        return np.ones((1, 16, 20), bool)
    m = np.zeros((2, 37, 29), bool)  # single pixels, one at a corner
    m[0, 20, 11] = True
    m[1, 36, 0] = True
    return m


@pytest.mark.parametrize("kind", ["random", "dense", "empty", "full",
                                  "single_pixel"])
def test_edt_matches_jax(kind):
    m = _masks(kind, np.random.RandomState(1))
    want = np.asarray(jax_edt.edt(jnp.asarray(m)))
    got = edt.edt(torch.from_numpy(m))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_edt_chunk_does_not_change_the_result():
    m = _masks("random", np.random.RandomState(2))
    want = edt.edt(torch.from_numpy(m))
    for chunk in (1, 5, 64):
        assert torch.equal(edt.edt(torch.from_numpy(m), chunk=chunk), want)


@pytest.mark.parametrize("valid", [[0, 0, 0, 0], [0, 1, 0, 0], [1, 0, 1, 0],
                                   [1, 1, 1, 1]])
def test_distance_stack_top2_matches_jax(valid):
    rng = np.random.RandomState(3)
    d = (rng.rand(4, 9, 11) * 20).astype(np.float32)
    d[2, :3] = d[0, :3]  # ties
    v = np.array(valid, bool)
    want = jax_edt.distance_stack_top2(jnp.asarray(d), jnp.asarray(v))
    got = edt.distance_stack_top2(torch.from_numpy(d), torch.from_numpy(v))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("max_instances", [4, 8, 20])
def test_instance_areas_and_size_matrix_match_jax(max_instances):
    """Labels 0..11: with max_instances 4 and 8 some lie above the pad,
    where the areas drop them and size_matrix reads the last slot (the
    JAX gather clamps its index)."""
    labels = np.random.RandomState(4).randint(0, 12, (19, 21)).astype(
        np.int32)
    lab = torch.from_numpy(labels)
    np.testing.assert_array_equal(
        instance.instance_areas(lab, max_instances).numpy(),
        np.asarray(jax_instance.instance_areas(jnp.asarray(labels),
                                               max_instances)))
    want = np.asarray(jax_instance.size_matrix(jnp.asarray(labels),
                                               max_instances))
    got = instance.size_matrix(lab, max_instances).numpy()
    np.testing.assert_array_equal(got, want)
    above = labels > max_instances
    if above.any():
        assert (got[above] == (labels == max_instances).sum()).all()
    batched = instance.size_matrix(torch.stack([lab, lab.flip(0)]),
                                   max_instances)
    assert torch.equal(batched[0], lab.new_tensor(got))
    assert torch.equal(batched[1], lab.new_tensor(got).flip(0))


def _object_stack(seed, b=3, n=8, h=48, w=40):
    """Rectangles of 2-13 pixels a side, 1..n per image, plus an object
    only in the 2-pixel frame (dropped) and an object big enough to erode
    but thin enough to be erased by erosion 3."""
    rng = np.random.RandomState(seed)
    stack = np.zeros((b, n, h, w), bool)
    valid = np.zeros((b, n), bool)
    for i in range(b):
        n_real = rng.randint(2, n + 1)
        for j in range(n_real):
            y, x = rng.randint(0, h - 13), rng.randint(0, w - 13)
            hh, ww = rng.randint(2, 14, 2)
            stack[i, j, y:y + hh, x:x + ww] = True
        valid[i, :n_real] = True
    stack[0, 0] = False
    stack[0, 0, :2, 5:30] = True  # border-only: dropped
    stack[1, 1] = False
    stack[1, 1, 20:22, 2:38] = True  # 72 pixels > 3^2, erased by erosion 3
    valid[2, 3] = False  # an invalid slot holding a mask
    return stack, valid


#: (erode, dilate, small_annotations_size, border_width)
MODES = {"plain": (0, 0, 3, 0), "erode_restore": (3, 0, 3, 0),
         "erode_dilate": (3, 2, 3, 0), "border": (0, 0, 3, 2),
         "erode_border": (2, 0, 3, 3), "all": (2, 1, 3, 2),
         "default_small": (3, 0, 14, 2)}


@pytest.mark.parametrize("mode", list(MODES))
def test_prepare_batch_matches_jax(mode):
    """The batched device function against `_prepare_device_batch` and,
    image by image, `_prepare_device`: masks, distances, second and
    sizes exact."""
    stack, valid = _object_stack(seed=len(mode))
    args = MODES[mode]
    got = targets.prepare_batch(torch.from_numpy(stack),
                                torch.from_numpy(valid), *args)
    want = jax_targets._prepare_device_batch(jnp.asarray(stack),
                                             jnp.asarray(valid), *args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for i in range(stack.shape[0]):
        one = jax_targets._prepare_device(jnp.asarray(stack[i]),
                                          jnp.asarray(valid[i]), *args)
        for g, w in zip(got, one):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["plain", "erode_dilate", "erode_border"])
def test_prepare_batch_raw_top2_matches_jax(mode):
    stack, valid = _object_stack(seed=7)
    e, d, s, _ = MODES[mode]
    got = targets.prepare_batch(torch.from_numpy(stack),
                                torch.from_numpy(valid), e, d, s, 0,
                                raw_top2=True)
    for i in range(stack.shape[0]):
        want = jax_targets._prepare_device(jnp.asarray(stack[i]),
                                           jnp.asarray(valid[i]), e, d, s, 0,
                                           raw_top2=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


def test_more_components_than_max_objects_follow_the_jax_clamp():
    """Two dotted objects make 200 components: the sizes of components
    numbered above MAX_OBJECTS read slot 128 in both packages (ROADMAP
    §3, a reference quirk kept)."""
    stack = np.zeros((1, 8, 64, 64), bool)
    stack[0, 0, 4:30:2, 4:60:4] = True  # 13 x 14 single pixels
    stack[0, 1, 34:60:2, 4:60:4] = True
    valid = np.zeros((1, 8), bool)
    valid[0, :2] = True
    got = targets.prepare_batch(torch.from_numpy(stack),
                                torch.from_numpy(valid))
    want = jax_targets._prepare_device_batch(jnp.asarray(stack),
                                             jnp.asarray(valid), 0, 0, 14, 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].sum() == 364
    assert (got[3] == 1).all()  # every dot has area 1, 129+ read slot 128


def _rect(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), np.uint8)
    m[y0:y1, x0:x1] = 1
    return m


def _crowded(h, w, n, seed):
    rng = np.random.RandomState(seed)
    masks = []
    for _ in range(n):
        y, x = rng.randint(4, h - 8), rng.randint(4, w - 8)
        masks.append(_rect(h, w, y, y + 4, x, x + 4))
    return masks


@pytest.mark.parametrize("n,kwargs", [
    (0, {}), (1, {}), (5, {"border_width": 2}),
    (11, {"erode": 2, "small_annotations_size": 3}),
    (20, {"erode": 2, "dilate": 1, "small_annotations_size": 3,
          "border_width": 3})])
def test_prepare_image_targets_matches_jax(n, kwargs):
    h = w = 40
    masks = _crowded(h, w, n, seed=n)
    want = jax_targets.prepare_image_targets(masks, (h, w), **kwargs)
    got = targets.prepare_image_targets(masks, (h, w), device="cpu",
                                        **kwargs)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("case", ["border_only_chunk", "single_valid"])
def test_chunked_path_matches_jax(monkeypatch, case):
    """More objects than MAX_OBJECTS (patched small in both packages, as
    tests/test_prep.py does): raw per-chunk top 2, merged with the global
    valid count; includes a chunk of border-only objects and a single
    valid object among border-only fillers."""
    h = w = 48 if case == "border_only_chunk" else 32
    if case == "border_only_chunk":
        masks = _crowded(h, w, 14, seed=3)
        fillers, limit, kwargs = range(4), 8, {"border_width": 4}
    else:
        masks = [_rect(h, w, 10, 14, 10, 14)]
        fillers, limit, kwargs = range(11), 4, {}
    for k in fillers:
        m = np.zeros((h, w), np.uint8)
        m[0, 5 + k] = 1
        masks.append(m)
    monkeypatch.setattr(jax_targets, "MAX_OBJECTS", limit)
    monkeypatch.setattr(targets, "MAX_OBJECTS", limit)
    want = jax_targets.prepare_image_targets(masks, (h, w), **kwargs)
    got = targets.prepare_image_targets(masks, (h, w), device="cpu",
                                        **kwargs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_chunked_merge_matches_the_single_chunk():
    """The port against itself at the real MAX_OBJECTS: 150 objects take
    the chunked path, and give the same targets as one call with every
    object in one stack (the merge is a selection, so exactly)."""
    h = w = 40
    masks = _crowded(h, w, 150, seed=5)
    got = targets.prepare_image_targets(masks, (h, w), border_width=2,
                                        device="cpu")
    stack = torch.from_numpy(np.stack(masks).astype(bool))[None]
    mask, dist, second, _ = targets.prepare_batch(
        stack, torch.ones((1, 150), dtype=torch.bool), border_width=2)
    np.testing.assert_array_equal(got["mask"], mask[0].numpy())
    np.testing.assert_array_equal(got["distances"],
                                  dist[0].to(torch.float16).numpy())
    np.testing.assert_array_equal(got["second"], second[0].numpy())
    from scipy import ndimage

    labels, _ = ndimage.label(got["mask"] == 1)
    counts = np.bincount(labels.ravel())
    counts[0] = 1
    np.testing.assert_array_equal(got["sizes"], counts[labels])


def test_prepare_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        targets.prepare_image_targets([_rect(16, 16, 4, 9, 4, 9)], (16, 16),
                                      device="cuda")
