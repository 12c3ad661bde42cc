"""The port's preprocessing and postprocessing against the JAX package.

Inputs are made with numpy and fed to both. Tolerances: preprocessing
1e-5 (float32 resize and normalisation); labels and areas exact; scores
1e-5 relative (the JAX sums ride a bf16 hi/lo split to ~7 digits, the port
accumulates in float64 and rounds the sums to float32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapping_tpu.data.augment import resize_bilinear as jax_resize
from mapping_tpu.data.loader import _infer_batch_resize
from mapping_tpu.infer import postprocess as jax_post
from mapping_tpu_torch.data.loader import infer_batch_resize
from mapping_tpu_torch.infer import postprocess as port_post

torch.set_num_threads(2)


def _probs(b, hw, seed, cells=8):
    """Blobby 2-class softmax probabilities: upsampled low-res noise."""
    rng = np.random.RandomState(seed)
    low = rng.randn(b, cells, cells).astype(np.float32) * 20.0
    logit = np.asarray(jax_resize(jnp.asarray(low)[..., None], (hw, hw)))[..., 0]
    p1 = 1.0 / (1.0 + np.exp(-logit))
    return np.stack([1.0 - p1, p1], axis=-1).astype(np.float32)


def _assert_away_from_thresholds(probs, target, layers, margin=1e-5):
    """Exact label equality is only meaningful when no resized probability
    sits within float32 resize noise of its layer's threshold; the seeds
    below were chosen so that none does."""
    p = np.asarray(jax_resize(jnp.asarray(probs), target))
    for t, ch in jax_post.layer_thresholds(layers):
        assert np.abs(p[..., ch] - t).min() > margin


def test_infer_batch_resize_matches_jax():
    u8 = np.random.RandomState(0).randint(0, 256, (3, 300, 300, 3),
                                          dtype=np.uint8)
    want = np.asarray(_infer_batch_resize(jnp.asarray(u8), (256, 256))["image"])
    got = infer_batch_resize(torch.from_numpy(u8), (256, 256))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,target,layers,active,seed", [
    ((4, 64), (80, 80), (1, 1), (1,), 0),
    ((2, 256), (300, 300), (1, 1), (1,), 0),
    ((2, 64), (48, 48), (1, 2), None, 1),
])
def test_fused_postprocess_matches_jax(shape, target, layers, active, seed):
    probs = _probs(*shape, seed=seed)
    _assert_away_from_thresholds(probs, target, layers)
    kw = dict(target_size=target, category_layers=layers,
              active_layers=active)
    want = [np.asarray(o) for o in
            jax_post.fused_postprocess(jnp.asarray(probs), **kw)]
    got = [o.numpy() for o in
           port_post.fused_postprocess(torch.from_numpy(probs), **kw)]
    assert [g.dtype for g in got] == [w.dtype for w in want]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=0)
    assert want[0].max() > 0


def test_overflow_escalation_matches_jax():
    """A noise map with far more than 64 components per image: both
    re-run the dense images with a doubled pad until it fits."""
    rng = np.random.RandomState(4)
    p1 = np.where(rng.rand(3, 48, 48) > 0.5, 0.9, 0.1).astype(np.float32)
    p1[0, :, :] = 0.9  # one image with a single component
    probs = np.stack([1.0 - p1, p1], axis=-1)
    kw = dict(target_size=(48, 48), category_layers=(1, 1),
              active_layers=(1,), max_instances=64)
    want = jax_post.postprocess_probabilities(probs, **kw)
    got = port_post.postprocess_probabilities(torch.from_numpy(probs), **kw)
    assert want[1].shape[-1] > 64  # the escalation really ran
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=0)


def test_layer_helpers_match_jax():
    for layers in ((1, 1), (1, 19), (2, 3)):
        assert port_post.layer_thresholds(layers) == \
            jax_post.layer_thresholds(layers)
        ids = [None, 100]
        assert port_post.active_layers_for(ids, layers) == \
            jax_post.active_layers_for(ids, layers)


def test_unported_options_raise():
    probs = torch.from_numpy(_probs(1, 64, 0))
    with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
        port_post.fused_postprocess(probs, erode_size=2)
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        port_post.fused_postprocess(probs, compute_features=True)
