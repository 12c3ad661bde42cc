"""The port's connected-component labelling against the JAX package.

On the CPU `mapping_tpu_torch.ops.ccl.connected_components` runs the plain
torch versions; they must equal, exactly, the Pallas kernels run in
interpret mode (`label_pallas`, and `label_raw_pallas` + `_renumber`) and
scipy.ndimage.label. The CUDA kernels are held against the same plain
versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from mapping_tpu.ops.ccl import _renumber as jax_renumber
from mapping_tpu.ops.ccl_pallas import label_pallas, label_raw_pallas
from mapping_tpu_torch.ops.ccl import _label_raw, _renumber, \
    connected_components


def _cases():
    """The cases of tests/test_ccl_pallas.py, then 300^2 and 304^2 noise
    with more than 256 components and a non-square batch."""
    rng = np.random.RandomState(0)
    rects = np.zeros((2, 48, 48), bool)
    for b in range(2):
        for _ in range(6):
            y, x = rng.randint(0, 38, 2)
            h, w = rng.randint(3, 12, 2)
            rects[b, y:y + h, x:x + w] = True
    noise = rng.rand(1, 48, 48) > 0.55
    spiral = np.zeros((1, 32, 32), bool)
    spiral[0, 2, 2:30] = True
    spiral[0, 2:30, 29] = True
    spiral[0, 29, 4:30] = True
    spiral[0, 6:30, 4] = True
    spiral[0, 6, 4:26] = True
    return {
        "rects": rects, "noise": noise, "spiral": spiral,
        "empty": np.zeros((1, 16, 16), bool),
        "full": np.ones((1, 16, 16), bool),
        "noise300": rng.rand(1, 300, 300) > 0.5,
        "noise304": rng.rand(1, 304, 304) > 0.6,
        "nonsquare": rng.rand(3, 40, 57) > 0.45,
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_connected_components_matches_pallas_and_scipy(name):
    m = CASES[name]
    got = connected_components(torch.from_numpy(m)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.asarray(label_pallas(jnp.asarray(m), interpret=True)))
    for b in range(m.shape[0]):
        expected, _ = ndimage.label(m[b])
        np.testing.assert_array_equal(got[b], expected)
    if name.startswith("noise3"):
        assert got.max() > 256


@pytest.mark.parametrize("name", sorted(CASES))
def test_raw_labels_and_renumber_match_pallas(name):
    m = CASES[name]
    raw_jax = np.asarray(label_raw_pallas(jnp.asarray(m), interpret=True))
    raw = connected_components(torch.from_numpy(m), renumber=False).numpy()
    np.testing.assert_array_equal(raw, raw_jax)
    np.testing.assert_array_equal(
        _renumber(torch.tensor(raw_jax)).numpy(),
        np.asarray(jax_renumber(jnp.asarray(raw_jax))))


def test_max_iters_caps_plain_sweeps_like_jax():
    """One sweep round cannot finish the spiral; the cap is honoured the
    way the JAX scan honours it."""
    from mapping_tpu.ops.ccl import _label_raw as jax_label_raw

    m = CASES["spiral"]
    got = _label_raw(torch.from_numpy(m), 1).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_label_raw(jnp.asarray(m), 1)))
    full, _ = ndimage.label(m[0])
    assert len(np.unique(got[got > 0])) > full.max()


def test_uint8_mask_and_leading_dims():
    m = CASES["nonsquare"].reshape(3, 1, 40, 57)
    got = connected_components(torch.from_numpy(m.astype(np.uint8)))
    assert got.shape == m.shape
    for b in range(3):
        np.testing.assert_array_equal(got[b, 0].numpy(),
                                      ndimage.label(m[b, 0])[0])


def test_unsupported_device_raises():
    with pytest.raises(ValueError, match="no CCL"):
        connected_components(torch.zeros((1, 4, 4), device="meta"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back to the plain version: a CPU tensor
    raises before anything is built or launched."""
    from mapping_tpu_torch.kernels import ccl as ccl_kernels

    before = dict(ccl_kernels.LAUNCHES)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ccl_kernels.label_raw(torch.zeros((1, 4, 4), dtype=torch.bool))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ccl_kernels.renumber(torch.zeros((1, 4, 4), dtype=torch.int32))
    assert ccl_kernels.LAUNCHES == before


RENUMBER_SHAPES = [(1, 16, 16), (20, 300, 300), (2, 304, 304), (3, 40, 57),
                   (2, 120, 333)]


@pytest.mark.parametrize("shape", RENUMBER_SHAPES)
def test_renumber_chunk_plan_covers_every_pixel(shape):
    """The renumbering grid's chunks (kernels/ccl.py `renumber_plan`, CHUNK
    pixels, 32-pixel words) cover each image's H * W pixels exactly once,
    and the scratch holds a root word and a prefix per word and a count and
    a prefix per chunk."""
    from mapping_tpu_torch.kernels import ccl as ccl_kernels

    n, h, w = shape
    words, chunks, scratch = ccl_kernels.renumber_plan(n, h, w)
    hw = h * w
    assert ccl_kernels.CHUNK % 32 == 0
    assert (words - 1) * 32 < hw <= words * 32
    assert (chunks - 1) * ccl_kernels.CHUNK < hw <= chunks * ccl_kernels.CHUNK
    covered = np.zeros(hw, np.int64)
    for c in range(chunks):
        covered[c * ccl_kernels.CHUNK:(c + 1) * ccl_kernels.CHUNK] += 1
    assert (covered == 1).all()
    assert scratch == 2 * n * words + 2 * n * chunks


def _kernel_rank_formula(raw, chunk):
    """csrc/ccl.cu's renumbering arithmetic in numpy: root bits per 32-pixel
    word, roots in earlier words of the chunk, an exclusive scan of the
    chunk counts per image, and each pixel's rank computed from its root's
    word."""
    n, h, w = raw.shape
    hw = h * w
    flat = raw.reshape(n, hw).astype(np.int64)
    words, chunks = -(-hw // 32), -(-hw // chunk)
    root = np.zeros((n, words * 32), bool)
    root[:, :hw] = flat == np.arange(1, hw + 1)
    bits = root.reshape(n, words, 32)
    per_word = bits.sum(-1)
    padded = np.zeros((n, chunks * (chunk // 32)), np.int64)
    padded[:, :words] = per_word
    per_chunk = padded.reshape(n, chunks, chunk // 32)
    word_before = (np.cumsum(per_chunk, -1) - per_chunk).reshape(n, -1)
    counts = per_chunk.sum(-1)
    chunk_before = np.cumsum(counts, -1) - counts
    out = np.zeros_like(flat)
    for b in range(n):
        r = flat[b] - 1
        fg = flat[b] > 0
        rw = r[fg] >> 5
        below = np.arange(32)[None, :] < (r[fg] & 31)[:, None]
        out[b, fg] = (chunk_before[b, r[fg] // chunk] + word_before[b, rw]
                      + (bits[b, rw] & below).sum(-1) + 1)
    return out.reshape(n, h, w)


@pytest.mark.parametrize("shape", RENUMBER_SHAPES)
def test_kernel_rank_formula_matches_plain_renumber(shape):
    """The rank arithmetic of the chunked renumbering kernel, run in numpy
    on raw labels of random masks, equals the plain `_renumber` exactly."""
    from mapping_tpu_torch.kernels import ccl as ccl_kernels

    rng = np.random.RandomState(sum(shape))
    m = rng.rand(*shape) > 0.5
    raw = _label_raw(torch.from_numpy(m), shape[1] + shape[2])
    np.testing.assert_array_equal(
        _kernel_rank_formula(raw.numpy(), ccl_kernels.CHUNK),
        _renumber(raw).numpy())


@pytest.mark.parametrize("kernel,ms", [("ccl_label_raw", 0.0026866),
                                       ("ccl_renumber", 0.0042985)])
def test_ccl_bounds_at_the_serving_batch(kernel, ms):
    """Bytes bound both CCL kernels at (20, 300, 300): K1 reads 1.8 MB of
    mask and writes 7.2 MB of labels, K2 reads and writes 7.2 MB of labels,
    at 3.35 TB/s."""
    from mapping_tpu_torch.kernels import bounds

    got, what = getattr(bounds, kernel)(20, 300, 300)
    assert what == "bytes" and abs(got - ms) <= 1e-4 * ms
