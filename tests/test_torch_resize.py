"""The port's host bilinear resize (utils/resize.py) against Pillow's
`Image.resize(..., BILINEAR)`, which the JAX package's daemon and artifact
call on the host: byte for byte, on up- and downscales, non-square sizes,
a single pixel, and the identity."""

import numpy as np
import pytest
from PIL import Image

from mapping_tpu_torch.utils.resize import resize_bilinear_u8


@pytest.mark.parametrize("src,dst", [
    ((300, 300), (64, 64)),     # the artifact tests' tile: downscale
    ((300, 300), (256, 256)),   # CrowdAI tile -> the training size
    ((64, 64), (300, 300)),     # upscale
    ((256, 256), (300, 300)),
    ((320, 320), (300, 300)),   # the padded loader's size back
    ((97, 53), (200, 31)),      # one axis up, the other down
    ((5, 7), (3, 11)),
    ((13, 300), (13, 77)),      # one axis only
    ((300, 13), (77, 13)),
    ((1, 1), (4, 5)),
    ((48, 48), (48, 48)),       # identity
])
def test_resize_is_byte_exact_with_pillow(src, dst):
    rng = np.random.RandomState(sum(src) + 7 * sum(dst))
    image = rng.randint(0, 256, src + (3,)).astype(np.uint8)
    want = np.asarray(Image.fromarray(image).resize((dst[1], dst[0]),
                                                    Image.BILINEAR))
    got = resize_bilinear_u8(image, dst)
    assert got.dtype == np.uint8 and got.shape == dst + (3,)
    np.testing.assert_array_equal(got, want)


def test_resize_extremes_and_smooth_tiles_are_byte_exact():
    """Saturated values (the fixed-point clip at 0 and 255) and a smooth
    tile, as a photograph gives."""
    rng = np.random.RandomState(3)
    extremes = (rng.rand(40, 60, 3) > 0.5).astype(np.uint8) * 255
    yy, xx = np.mgrid[0:300, 0:300]
    smooth = np.stack([(yy * 255 // 299), (xx * 255 // 299),
                       ((yy + xx) * 255 // 598)], -1).astype(np.uint8)
    for image, dst in ((extremes, (17, 123)), (smooth, (64, 64)),
                       (smooth, (301, 299))):
        want = np.asarray(Image.fromarray(image).resize(
            (dst[1], dst[0]), Image.BILINEAR))
        np.testing.assert_array_equal(resize_bilinear_u8(image, dst), want)


def test_resize_refuses_other_inputs():
    with pytest.raises(ValueError, match="uint8"):
        resize_bilinear_u8(np.zeros((4, 4, 3), np.float32), (2, 2))
    with pytest.raises(ValueError, match="uint8"):
        resize_bilinear_u8(np.zeros((4, 4), np.uint8), (2, 2))
    with pytest.raises(ValueError, match="size"):
        resize_bilinear_u8(np.zeros((4, 4, 3), np.uint8), (0, 2))


# ops/resize.py against the JAX package's jax.image.resize "linear" ------

@pytest.mark.parametrize("shape,target", [
    ((2, 64, 64), (300, 300)),    # tests/test_ops_basic.py: constant field
    ((32, 32), (75, 75)),         # ... and its sampled upscale
    ((3, 300, 300), (64, 64)),    # a shrink (antialiased)
    ((300, 300), (256, 200)),     # one axis more than the other
    ((2, 1, 40, 30), (45, 12)),   # more leading dims, mixed directions
])
def test_ops_resize_matches_jax(shape, target):
    """`resize_hw` within 1e-6 of `mapping_tpu.ops.resize.resize_hw` (the
    two sum the taps in other orders); `resize_chw` is the same call."""
    from mapping_tpu.ops.resize import resize_hw as jax_resize_hw
    from mapping_tpu_torch.ops.resize import resize_chw, resize_hw

    rng = np.random.RandomState(sum(shape))
    image = rng.rand(*shape).astype(np.float32)
    if shape == (2, 64, 64):
        image[:] = 0.7
    want = np.asarray(jax_resize_hw(image, target))
    got = resize_hw(image, target).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if len(shape) == 3:
        np.testing.assert_array_equal(resize_chw(image, target).numpy(), got)


# the float planes of a mixed-size batch's targets (Pillow mode "F") -----

@pytest.mark.parametrize("src,dst", [
    ((300, 300), (256, 256)), ((256, 256), (300, 300)),
    ((320, 320), (256, 256)), ((300, 300), (64, 48)),
    ((97, 53), (200, 31)), ((1, 1), (4, 5)), ((7, 300), (300, 7)),
    ((48, 48), (48, 48)),
])
def test_float_resizes_are_exact_with_pillow(src, dst):
    """Bilinear and nearest resizes of a float32 plane equal Pillow's
    mode "F" `resize`, bit for bit."""
    from mapping_tpu_torch.utils.resize import (resize_bilinear_f32,
                                                resize_nearest_f32)

    rng = np.random.RandomState(sum(src) + 3 * sum(dst))
    plane = (rng.rand(*src) * 500).astype(np.float32)
    image = Image.fromarray(plane, "F")
    for mode, fn in ((Image.BILINEAR, resize_bilinear_f32),
                     (Image.NEAREST, resize_nearest_f32)):
        want = np.asarray(image.resize((dst[1], dst[0]), mode))
        got = fn(plane, dst)
        assert got.dtype == np.float32 and got.shape == dst
        np.testing.assert_array_equal(got, want)
