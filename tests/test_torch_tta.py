"""Test-time augmentation and the padded centre crop, port vs JAX.

The same seeded numpy inputs go through mapping_tpu.data.tta /
mapping_tpu.data.augment.color_shift and their port counterparts, and a
small UNetResNet34 (weights carried across by the JAX package's torch
converter, BN folded, float32) serves through both packages' FusedServe
with TTA and with the centre crop.

Tolerances: the spec lists are equal; expand and inverse are exact (pure
flips and rotations); aggregates 1e-6 absolute; the colour shift on
0..255, with the JAX draws' (choice, add), 1e-4 absolute plus 1e-5
relative (the HSV round trip's float32 rounding differs by ~1e-6
relative between the frameworks); the served outputs as in
tests/test_torch_serving.py (labels equal except at pixels whose resized
probability lies within 1e-4 of the threshold, and on images whose labels
agree, areas exact and scores 1e-4 relative).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapping_tpu.data import augment as jax_augment
from mapping_tpu.data import tta as jax_tta
from mapping_tpu.data.augment import resize_bilinear as jax_resize
from mapping_tpu.data.loader import _infer_batch_resize
from mapping_tpu.infer.serving import FusedServe as JaxFusedServe
from mapping_tpu_torch.data import augment, tta
from mapping_tpu_torch.data.loader import infer_batch_pad
from mapping_tpu_torch.infer.serving import FusedServe
from tests.test_torch_serving import (PARAMS, POST, _jax_serve, _pipeline,
                                      _state_dict, _tiles)

torch.set_num_threads(2)

OPTIONS = [dict(), dict(flip_lr=False), dict(rotation=False),
           dict(flip_ud=False, flip_lr=False), dict(color_shift_runs=2),
           dict(flip_ud=False, rotation=False, color_shift_runs=1)]


@pytest.mark.parametrize("options", OPTIONS)
def test_specs_and_dedupe_match_jax(options):
    want = jax_tta.tta_specs(**options)
    got = tta.tta_specs(**options)
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    (gu, gw), (wu, ww) = tta.dedupe_specs(got), jax_tta.dedupe_specs(want)
    assert [tuple(s) for s in gu] == [tuple(s) for s in wu] and gw == ww
    if not options:
        assert (len(got), len(gu)) == (16, 12)


@pytest.mark.parametrize("k", [-3, -2, -1, 0, 1, 2, 3])
def test_rot90_direction_on_non_square_arrays(k):
    x = np.random.RandomState(k + 3).rand(2, 5, 7, 3).astype(np.float32)
    want = np.stack([np.asarray(jnp.rot90(jnp.asarray(im), k, axes=(0, 1)))
                     for im in x])
    got = torch.rot90(torch.from_numpy(x), k, dims=(1, 2)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,options", [
    ((12, 12), dict()),
    ((12, 12), dict(flip_ud=False)),
    ((9, 14), dict(rotation=False)),
])
def test_expand_and_inverse_are_exact(hw, options):
    x = np.random.RandomState(1).rand(3, *hw, 3).astype(np.float32)
    specs = [s for s in tta.tta_specs(**options)]
    want = np.asarray(jax_tta.expand_batch(jnp.asarray(x), specs))
    got = tta.expand_batch(torch.from_numpy(x), specs)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tta.inverse_batch(got, specs).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jax_tta.inverse_batch(jnp.asarray(want), specs)))
    np.testing.assert_array_equal(back, np.repeat(x[:, None], len(specs), 1))


@pytest.mark.parametrize("method", ["mean", "max", "min", "gmean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_aggregate_matches_jax(method, weighted):
    p = np.random.RandomState(2).rand(2, 12, 6, 6, 2).astype(np.float32)
    p[0, 0, 0, 0] = 0.0  # gmean's floor
    weights = [2, 1, 1, 2, 1, 1, 2, 1, 1, 2, 1, 1] if weighted else None
    want = np.asarray(jax_tta.aggregate(jnp.asarray(p), method,
                                        weights=weights))
    got = tta.aggregate(torch.from_numpy(p), method, weights=weights)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _jax_draw(key):
    """(choice, add) as mapping_tpu.data.augment.color_shift draws them."""
    k_choice, k_add = jax.random.split(key)
    return (int(jax.random.randint(k_choice, (), 0, 6)),
            float(jax.random.uniform(k_add, (), minval=0.0, maxval=100.0)))


def test_color_shift_matches_jax_on_every_channel():
    image = np.random.RandomState(3).rand(16, 16, 3).astype(np.float32) * 255
    image[0, 0] = image[0, 0, 0]  # a grey pixel: hue 0, saturation 0
    image[0, 1] = [255, 0, 0]
    seen = set()
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        choice, add = _jax_draw(key)
        if choice in seen:
            continue
        seen.add(choice)
        want = np.asarray(jax_augment.color_shift(key, jnp.asarray(image)))
        got = augment.color_shift(torch.from_numpy(image), choice, add)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4,
                                   err_msg=f"choice {choice}")
        if len(seen) == 6:
            break
    assert seen == set(range(6))


def test_color_shift_draws_are_seeded():
    a = [augment.sample_color_shift(torch.Generator().manual_seed(5))
         for _ in range(2)]
    assert a[0] == a[1] and 0 <= a[0][0] < 6 and 0 <= a[0][1] < 100
    specs = tta.tta_specs(color_shift_runs=2)
    x = torch.rand((2, 8, 8, 3)) * 255
    assert torch.equal(tta.expand_batch(x, specs), tta.expand_batch(x, specs))


def _fake_predict(flat):
    x = torch.stack([flat.mean(-1), flat[..., 0] * 0.5 + 0.1], dim=-1)
    return torch.softmax(x, dim=-1)


@pytest.mark.parametrize("method", ["mean", "max", "min", "gmean"])
def test_wrap_predict_dedupe_matches_full(method):
    x = torch.from_numpy(np.random.RandomState(4).rand(2, 16, 16, 3)
                         .astype(np.float32))
    specs = tta.tta_specs()
    full = tta.tta_wrap_predict(_fake_predict, specs, method, dedupe=False)
    deduped = tta.tta_wrap_predict(_fake_predict, specs, method)
    torch.testing.assert_close(deduped(x), full(x), rtol=0, atol=1e-6)
    calls = []
    tta.tta_wrap_predict(lambda f: calls.append(f.shape[0]) or
                         _fake_predict(f), specs, method)(x)
    assert calls == [2 * 12]  # one flat batch of the 12 unique forwards


# ------------------------------------------------------------ FusedServe

@pytest.fixture(scope="module")
def served():
    """Both packages' FusedServe outputs on the same tiles: with TTA (16
    specs, deduplicated, gmean and mean) on 64^2 inputs, and with the
    centre crop on 96^2 tiles padded by 16 (reflect) and cut back."""
    tiles = _tiles(n=2)
    size = (PARAMS["image_h"], PARAMS["image_w"])
    images = np.array(_infer_batch_resize(jnp.asarray(tiles), size)["image"])
    state = _state_dict(images)
    _, jax_probs_fn, folded = _jax_serve(state)
    port_probs_fn = _pipeline(PARAMS, state).trainer.probs_apply_fn()
    padded = infer_batch_pad(torch.from_numpy(tiles), (16, 16), "reflect")
    runs = {
        "tta gmean": (images, dict(tta_specs=tta.tta_specs(),
                                   tta_method="gmean")),
        "tta mean": (images, dict(tta_specs=tta.tta_specs(),
                                  tta_method="mean")),
        "crop": (padded.numpy(), dict(crop_size=(96, 96))),
    }
    out = {}
    for name, (x, kw) in runs.items():
        jax_kw = dict(kw)
        if "tta_specs" in kw:
            jax_kw["tta_specs"] = jax_tta.tta_specs()
        jax_serve = JaxFusedServe(jax_probs_fn, lambda: folded, **POST,
                                  **jax_kw)
        port_serve = FusedServe(port_probs_fn, **POST, **kw)
        probs = jax_serve._probs(folded, jnp.asarray(x))
        out[name] = dict(jax=jax_serve(jnp.asarray(x)),
                         port=port_serve(torch.from_numpy(x)),
                         probs=np.asarray(jax_resize(probs,
                                                     POST["target_size"])),
                         port_probs=port_serve._probs(torch.from_numpy(x)))
    return out


@pytest.mark.parametrize("name", ["tta gmean", "tta mean", "crop"])
def test_fused_serve_matches_jax(served, name):
    run = served[name]
    (jl, js, ja), (pl, ps, pa) = run["jax"], run["port"]
    got = augment.resize_bilinear(run["port_probs"], POST["target_size"])
    np.testing.assert_allclose(got.numpy(), run["probs"], atol=1e-4, rtol=0)
    near = np.abs(run["probs"][..., 1] - 0.5) < 1e-4
    assert pl.dtype == np.int16 and pl.shape == jl.shape
    assert not (pl[:, 1] != jl[:, 1])[~near].any()
    same = [i for i in range(len(jl)) if np.array_equal(pl[i], jl[i])]
    assert len(same) >= len(jl) - 1 and jl[:, 1].max() > 0
    np.testing.assert_array_equal(pa[same], ja[same])
    np.testing.assert_allclose(ps[same], js[same], rtol=1e-4, atol=0)


def test_tta_aggregation_is_applied(served):
    """The gmean and mean runs differ: each aggregates its own way."""
    assert not np.allclose(served["tta gmean"]["probs"],
                           served["tta mean"]["probs"])
