"""Morphology, the erode/dilate postprocess and the pad loader mode of the
port against the JAX package, on the same numpy inputs.

Tolerances: erosion and dilation exact (bool masks and int32 labels);
postprocess labels and areas exact, scores 1e-5 relative (float32 sums in
another order); the fixed pads exact; the pad-mode preprocess 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapping_tpu.data import augment as jax_augment
from mapping_tpu.data.loader import SegmentationLoader as JaxLoader
from mapping_tpu.data.loader import _infer_batch_pad
from mapping_tpu.infer import postprocess as jax_post
from mapping_tpu.ops import morphology as jax_morph
from mapping_tpu_torch.data import augment
from mapping_tpu_torch.data.loader import SegmentationLoader, infer_batch_pad
from mapping_tpu_torch.infer import postprocess as port_post
from mapping_tpu_torch.ops import morphology

from tests.test_torch_postprocess import _assert_away_from_thresholds, _probs

torch.set_num_threads(2)


def _inputs(kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "bool":
        return rng.rand(2, 3, 17, 23) > 0.4
    return (rng.randint(0, 1000, (2, 3, 17, 23))
            * (rng.rand(2, 3, 17, 23) > 0.3)).astype(np.int32)


@pytest.mark.parametrize("kind", ["bool", "int32"])
@pytest.mark.parametrize("size", [1, 2, 3, 4, 5, 6])
def test_erode_dilate_match_jax(kind, size):
    """Exact, for odd and even footprints (origin at k // 2). A bool mask
    goes to the JAX functions as uint8, the way fused_postprocess erodes
    one: their reduce_window starts a bool max from -inf cast to bool,
    which is True, so JAX's own dilate of a bool array is all True."""
    x = _inputs(kind, seed=size)
    jax_x = x.astype(np.uint8) if kind == "bool" else x
    for port_fn, jax_fn in ((morphology.erode, jax_morph.erode),
                            (morphology.dilate, jax_morph.dilate)):
        want = np.asarray(jax_fn(jnp.asarray(jax_x), size)).astype(x.dtype)
        got = port_fn(torch.from_numpy(x), size)
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_morphology_size_zero_is_identity():
    x = torch.from_numpy(_inputs("int32"))
    assert morphology.erode(x, 0) is x and morphology.dilate(x, 0) is x


@pytest.mark.parametrize("shape,target,layers,active,seed", [
    ((4, 64), (80, 80), (1, 1), (1,), 0),
    ((2, 256), (300, 300), (1, 1), (1,), 0),
    ((2, 64), (48, 48), (1, 2), None, 1),
])
def test_erode_dilate_postprocess_matches_jax(shape, target, layers, active,
                                              seed):
    """fused_postprocess with erode 3 and dilate 2, float32: labels and
    areas exact, scores 1e-5 relative."""
    probs = _probs(*shape, seed=seed)
    _assert_away_from_thresholds(probs, target, layers)
    kw = dict(target_size=target, category_layers=layers,
              active_layers=active, erode_size=3, dilate_size=2)
    want = [np.asarray(o) for o in
            jax_post.fused_postprocess(jnp.asarray(probs), **kw)]
    got = [o.numpy() for o in
           port_post.fused_postprocess(torch.from_numpy(probs), **kw)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=0)
    plain = np.asarray(jax_post.fused_postprocess(
        jnp.asarray(probs), target_size=target, category_layers=layers,
        active_layers=active)[0])
    assert want[0].max() > 0 and not np.array_equal(plain, want[0])


def _blob_grid(dots_from):
    """(300, 300) probabilities of 300 separate 4x4 squares on a 6-pixel
    grid, 50 per row; squares from index `dots_from` on (in scipy order)
    are single pixels, which a 3x3 erosion erases."""
    p1 = np.full((300, 300), 0.1, np.float32)
    for i in range(300):
        y, x = 6 * (i // 50), 6 * (i % 50)
        if i < dots_from:
            p1[y:y + 4, x:x + 4] = 0.9
        else:
            p1[y, x] = 0.9
    return p1


def test_restore_erased_clamp_and_escalation_match_jax():
    """More than 256 components with erosion on. Image 0: labels 257+ are
    dots; the restore clamps them to slot 256, a square that survived, so
    they stay erased and the image ends with exactly 256 instances (no
    escalation). Image 1: 300 squares all survive erosion, so the image
    overflows the pad and is re-run with the escalated pad 512."""
    p1 = np.stack([_blob_grid(256), _blob_grid(300)])
    probs = np.stack([1.0 - p1, p1], axis=-1)
    kw = dict(target_size=(300, 300), category_layers=(1, 1),
              active_layers=(1,), erode_size=3, dilate_size=2)
    want = jax_post.postprocess_probabilities(probs, **kw)
    got = port_post.postprocess_probabilities(torch.from_numpy(probs), **kw)
    counts = want[0][:, 1].max(axis=(1, 2)).tolist()
    assert counts == [256, 300] and want[1].shape[-1] == 512
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=0)


@pytest.mark.parametrize("method", ["replicate", "reflect"])
@pytest.mark.parametrize("pad", [(10, 10), (3, 5)])
def test_pad_fixed_matches_jax(method, pad):
    x = np.random.RandomState(1).rand(2, 12, 15, 3).astype(np.float32)
    want = np.asarray(jax_augment.pad_fixed(jnp.asarray(x), pad, method))
    got = augment.pad_fixed(torch.from_numpy(x), pad, method)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_fixed_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown pad_method"):
        augment.pad_fixed(torch.zeros(1, 4, 4, 3), (1, 1), "wrap")
    with pytest.raises(ValueError, match="unknown pad_method"):
        SegmentationLoader(pad_method="wrap", device="cpu")


@pytest.mark.parametrize("method", ["replicate", "reflect"])
def test_pad_mode_infer_preprocess_matches_jax(method):
    """The crop_and_pad loader's preprocess, 1e-5: 300^2 -> 320^2."""
    u8 = np.random.RandomState(2).randint(0, 256, (2, 300, 300, 3),
                                          dtype=np.uint8)
    want = np.asarray(JaxLoader(mode="crop_and_pad", pad_method=method)
                      .infer_preprocess(u8))
    got = SegmentationLoader(mode="crop_and_pad", pad_method=method,
                             device="cpu").infer_preprocess(u8)
    assert tuple(got.shape) == want.shape == (2, 320, 320, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    direct = np.asarray(_infer_batch_pad(jnp.asarray(u8), (10, 10),
                                         method)["image"])
    np.testing.assert_allclose(
        infer_batch_pad(torch.from_numpy(u8), (10, 10), method).numpy(),
        direct, atol=1e-5, rtol=0)
