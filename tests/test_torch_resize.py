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
