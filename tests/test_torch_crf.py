"""The port's dense CRF (mapping_tpu_torch/ops/crf.py) against the JAX
package's (mapping_tpu/ops/crf.py), on the scenes of tests/test_crf.py, in
both appearance modes: the windowed stencil and the bilateral grid.

Tolerance: 1e-5 absolute on the probabilities and messages on the CPU
(the two frameworks sum the stencil and the grid's splat in other
orders). On the card `index_add_` adds the splat in no fixed order;
`chip_smoke.py` holds the card against the CPU within 1e-4.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapping_tpu.ops import crf as jax_crf
from mapping_tpu_torch.ops import crf
from tests.test_crf import _fc_oracle, _scene

torch.set_num_threads(2)

#: mode -> the dense_crf arguments of tests/test_crf.py for it
MODES = {
    "window": {},
    "grid": dict(iterations=3, sxy_bilateral=8.0, srgb=40.0,
                 compat_bilateral=6.0),
}
TOL = 1e-5


def _both(image, probs, **kw):
    want = np.asarray(jax_crf.dense_crf(jnp.asarray(image),
                                        jnp.asarray(probs), **kw))
    got = crf.dense_crf(torch.from_numpy(image), torch.from_numpy(probs),
                        **kw).numpy()
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_dense_crf_matches_jax(mode, seed):
    image, probs, _ = _scene(seed=seed)
    got, want = _both(image, probs, **MODES[mode])
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_explicit_mode_equals_auto(mode):
    """`bilateral_mode` set by name gives what "auto" picks for the
    bandwidth, in both packages."""
    image, probs, _ = _scene(seed=3)
    kw = {**MODES[mode], "iterations": 2}
    got, want = _both(image, probs, bilateral_mode=mode, **kw)
    np.testing.assert_allclose(got, want, atol=TOL)
    auto = crf.dense_crf(torch.from_numpy(image), torch.from_numpy(probs),
                         **kw).numpy()
    np.testing.assert_array_equal(got, auto)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_crf_improves_noisy_unary(mode):
    image, probs, gt = _scene()
    refined = crf.dense_crf(torch.from_numpy(image), torch.from_numpy(probs),
                            **MODES[mode]).numpy()
    before = ((probs[..., 1] > 0.5) == gt).mean()
    after = ((refined[..., 1] > 0.5) == gt).mean()
    assert after >= before and after > 0.97


@pytest.mark.parametrize("mode", sorted(MODES))
def test_crf_preserves_probability_simplex(mode):
    image, probs, _ = _scene(seed=1)
    refined = crf.dense_crf(torch.from_numpy(image), torch.from_numpy(probs),
                            **{**MODES[mode], "iterations": 3}).numpy()
    np.testing.assert_allclose(refined.sum(-1), 1.0, atol=1e-4)
    assert refined.min() >= 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_crf_batch_matches_jax(mode):
    scenes = [_scene(seed=s) for s in (2, 4)]
    images = np.stack([s[0] for s in scenes])
    probs = np.stack([s[1] for s in scenes])
    kw = {**MODES[mode], "iterations": 2}
    want = np.asarray(jax_crf.dense_crf_batch(jnp.asarray(images),
                                              jnp.asarray(probs), **kw))
    got = crf.dense_crf_batch(torch.from_numpy(images),
                              torch.from_numpy(probs), **kw).numpy()
    assert got.shape == (2, 48, 48, 2)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_bilateral_messages_match_jax_and_the_oracle():
    """Each appearance message alone: the windowed one and the grid's
    against JAX's within 1e-5, and the grid against the fully connected
    brute-force oracle within tests/test_crf.py's bounds."""
    rng = np.random.RandomState(0)
    h = w = 24
    img = (rng.rand(h, w, 3) * 255).astype(np.float32)
    img[:, :12] *= 0.3
    q1 = np.clip(0.15 + 0.7 * (np.arange(h)[:, None] > 8)
                 * (np.arange(w)[None, :] < 16)
                 + 0.1 * rng.randn(h, w), 0.01, 0.99).astype(np.float32)
    q = np.stack([1 - q1, q1], -1)
    tq, timg = torch.from_numpy(q), torch.from_numpy(img)
    want = np.asarray(jax_crf._bilateral_message(jnp.asarray(q),
                                                 jnp.asarray(img), 1.0, 50.0,
                                                 3))
    got = crf._bilateral_message(tq, timg, 1.0, 50.0, 3).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    for sxy, srgb in [(6.0, 64.0), (12.0, 40.0)]:
        want = np.asarray(jax.jit(partial(
            jax_crf._bilateral_grid_message, sxy=sxy, srgb=srgb))(
                jnp.asarray(q), jnp.asarray(img)))
        got = crf._bilateral_grid_message(tq, timg, sxy, srgb).numpy()
        np.testing.assert_allclose(got, want, atol=TOL)
        oracle = _fc_oracle(q, img, sxy, srgb)
        assert np.abs(got - oracle).max() < 0.12
        assert np.corrcoef(got.ravel(), oracle.ravel())[0, 1] > 0.97
