"""JPEG-compressed TIFF (compression 7) in the port against the JAX
package's loader on the same bytes, exactly: `mapping_tpu.data.loader.
load_image` reads these files through Pillow's libtiff, whose JPEG codec
(libjpeg-turbo) turns YCbCr into RGB and passes RGB and grey samples
through.

- the port's writer (`tiff.encode(..., "jpeg")`) under each photometric,
  sampling, strip or tile layout, tables in JPEGTables or in every
  stream, restart markers, contradicting markers, Orientation, and a
  hypothesis sweep of sizes and shapes;
- the abbreviated streams: a strip read with the file's tables gives the
  coefficients of the same strip written whole; the colour, sampling and
  size that the TIFF gives are enforced, and bogus tables refused;
- libtiff's subsampling rules (JPEGFixupTagsSubsampling without the tag,
  JPEGPreDecode's check with it);
- `native_decode.assemble`: the parts of a batch's JPEGs and JPEG TIFFs
  go through one pixel-stage call per geometry, equal to each image's own
  decode, with the mixed-size resize on the host;
- `predict_on_dir` over JPEG-TIFF tiles against PNG tiles of the same
  decoded pixels.

The corpus files and the HTTP daemon are in tests/test_torch_tiff.py."""

import json
import warnings

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mapping_tpu.data.loader import load_image
from mapping_tpu_torch.kernels import jpeg as jpeg_pixels
from mapping_tpu_torch.utils import jpeg, native_decode, png, tiff
from tests.torch_guards import drop_tmp_path  # noqa: F401 (autouse)


def _picture(h, w, seed):
    """A gradient with noise and a bright block: smooth areas and edges."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([30 + 150 * x / max(w, 1), 50 + 120 * y / max(h, 1),
                    np.full((h, w), 100.0)], -1) + rng.randint(0, 40,
                                                               (h, w, 3))
    img[h // 3:h // 2 + 1, w // 4:w // 2 + 1] = (230, 40, 200)
    return np.clip(img, 0, 255).astype(np.uint8)


def _jax(tmp_path, data):
    """The JAX loader's RGB of the bytes, or None where it raises."""
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return load_image(str(path))
        except Exception:
            return None


def _same_as_jax(tmp_path, data):
    want = _jax(tmp_path, data)
    assert want is not None
    got = native_decode.decode_rgb_bytes(data)
    np.testing.assert_array_equal(got, want)
    return got


IMG = _picture(37, 53, 1)
KINDS = {
    "ycc22_strips": (IMG, dict(photometric=6, rows_per_strip=16)),
    "ycc22_strips_of_8": (IMG, dict(photometric=6, rows_per_strip=8)),
    "ycc22_odd_strips": (IMG, dict(photometric=6, rows_per_strip=5)),
    "ycc22_tiles": (IMG, dict(photometric=6, tile=(16, 16))),
    "ycc22_wide_tiles": (IMG, dict(photometric=6, tile=(64, 16))),
    "ycc21_tiles": (IMG, dict(photometric=6, subsampling=(2, 1),
                              tile=(32, 48))),
    "ycc12_strips": (IMG, dict(photometric=6, subsampling=(1, 2),
                               rows_per_strip=16)),
    "ycc11_strips": (IMG, dict(photometric=6, subsampling=(1, 1))),
    "ycc22_no_tables_tiles": (IMG, dict(photometric=6, tile=(32, 32),
                                        jpeg_tables=False)),
    "ycc22_restart_1": (IMG, dict(photometric=6, restart_interval=1,
                                  rows_per_strip=32)),
    "ycc22_jfif_adobe_rgb": (IMG, dict(photometric=6, jfif=True, adobe=0)),
    "ycc22_no_tag_tiles": (IMG, dict(photometric=6, subsampling=(1, 2),
                                     subsampling_tag=False, tile=(16, 32))),
    "ycc22_big_endian": (IMG, dict(photometric=6, byteorder=">",
                                   rows_per_strip=16)),
    "ycc22_bigtiff_tiles": (IMG, dict(photometric=6, bigtiff=True,
                                      tile=(32, 16))),
    "ycc22_quality_40": (IMG, dict(photometric=6, quality=40,
                                   rows_per_strip=24)),
    "rgb_tiles": (IMG, dict(photometric=2, tile=(16, 48))),
    "rgb_adobe_ycc": (IMG, dict(photometric=2, adobe=1)),
    "grey_strips": (IMG[..., 0], dict(photometric=1, rows_per_strip=8)),
    "grey_signed": (IMG[..., 0], dict(photometric=1, sample_format=2)),
    "grey_fill2": (IMG[..., 0], dict(photometric=1, fill_order=2)),
    "miniswhite_tiles": (IMG[..., 1], dict(photometric=0, tile=(16, 16))),
    "size_1x1": (IMG[:1, :1], dict(photometric=6)),
    "size_1x1_tiles": (IMG[:1, :1], dict(photometric=6, tile=(16, 16))),
    **{f"orientation{o}": (IMG, dict(photometric=6, orientation=o,
                                     tile=(16, 32))) for o in range(2, 9)},
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_jpeg_layout_reads_as_the_jax_loader(tmp_path, kind):
    samples, options = KINDS[kind]
    data = tiff.encode(samples, "jpeg", **options)
    assert isinstance(native_decode.read_bytes(data), tiff.JpegTiles)
    _same_as_jax(tmp_path, data)


@settings(max_examples=20, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       subsampling=st.sampled_from(((2, 2), (2, 1), (1, 1), (1, 2))),
       layout=st.sampled_from(("strips", "tiles")), shape=st.integers(0, 5),
       photometric=st.sampled_from((6, 6, 2, 1)),
       seed=st.integers(0, 2 ** 31 - 1))
def test_drawn_jpeg_files_read_as_the_jax_loader(tmp_path, h, w, subsampling,
                                                 layout, shape, photometric,
                                                 seed):
    img = _picture(h, w, seed % 1000)
    options = dict(photometric=photometric, subsampling=subsampling,
                   restart_interval=shape % 3)
    if layout == "tiles":
        options["tile"] = (16 * (1 + shape % 3), 16 * (1 + shape // 3))
    else:  # libtiff writes multiples of 8 v rows; any height reads
        options["rows_per_strip"] = (8 * subsampling[1] * (1 + shape % 3)
                                     if shape < 4 else shape + 1)
    _same_as_jax(tmp_path, tiff.encode(img[..., 0] if photometric == 1
                                       else img, "jpeg", **options))


def test_abbreviated_stream_reads_with_the_tables():
    """A stream without its tables, read with a tables-only stream, gives
    the coefficients of the same image written whole; without them it is
    refused (no quant table)."""
    img = _picture(20, 30, 2)
    whole = jpeg.read(jpeg.encode(img, 80, "4:2:0"))
    stream = jpeg.encode(img, 80, "4:2:0", tables=False, jfif=False)
    assert b"\xff\xdb" not in stream and b"\xff\xc4" not in stream
    part = jpeg.read(stream, tables=jpeg.tables_only(80, 3))
    assert part.geometry == whole.geometry
    np.testing.assert_array_equal(part.coef, whole.coef)
    np.testing.assert_array_equal(part.quant, whole.quant)
    with pytest.raises(ValueError, match="quant table 0 is not defined"):
        jpeg.read(stream)


def test_tiff_settings_override_and_check_the_stream():
    """The colour the TIFF gives wins over JFIF and Adobe markers; the
    components, sampling factors and size must be the TIFF's, checked at
    the frame header."""
    img = _picture(16, 24, 3)
    marked = jpeg.encode(img, 80, "4:4:4", jfif=False, adobe=0)  # RGB
    assert jpeg.read(marked).geometry.color == "rgb"
    assert jpeg.read(marked, color="ycc").geometry.color == "ycc"
    with pytest.raises(ValueError, match="3-component JPEG where the TIFF "
                                         "has 1"):
        jpeg.read(marked, color="gray")
    sub = jpeg.encode(img, 80, "4:2:0")
    assert jpeg.read(sub, sampling=(2, 2)).geometry.factors \
        == ((2, 2), (1, 1), (1, 1))
    with pytest.raises(ValueError, match="sampling factors 2x2, 1x1, 1x1 "
                                         "where the TIFF has 1x1"):
        jpeg.read(sub, sampling=(1, 1))
    with pytest.raises(ValueError, match="strip or tile of 16x24 where the "
                                         "TIFF's is 8x24"):
        jpeg.read(sub, size=(8, 24))


@pytest.mark.parametrize("tables", [
    b"\xff\xd9", jpeg.encode(np.zeros((8, 8), np.uint8)),
    jpeg.tables_only(90, 1)[:2] + b"\xff\xc0\x00\x02\xff\xd9"])
def test_bogus_jpeg_tables_are_refused(tables):
    stream = jpeg.encode(np.zeros((8, 8), np.uint8), 90, tables=False)
    with pytest.raises(ValueError, match="bogus JPEGTables"):
        jpeg.read(stream, tables=tables)


@pytest.mark.parametrize("factors, want", [
    ((0x22, 0x11, 0x11), (2, 2)), ((0x41, 0x11, 0x11), (4, 1)),
    ((0x12, 0x11, 0x11), (1, 2)), ((0x22, 0x21, 0x11), (2, 2)),
    ((0x33, 0x11, 0x11), (2, 2)), ((0x11, 0x11, 0x11), (1, 1))])
def test_subsampling_fixup_is_libtiffs(factors, want):
    """Without a YCbCrSubsampling tag libtiff takes component 0's factors
    from the first stream's frame header where the others are 1x1 and
    both are 1, 2 or 4, and keeps its default 2x2 else."""
    sof = b"\xff\xc0\x00\x11\x08\x00\x10\x00\x10\x03" + b"".join(
        bytes([k + 1, f, 0]) for k, f in enumerate(factors))
    stream = b"\xff\xd8\xff\xe0\x00\x04ab" + sof + b"\xff\xd9"
    assert tiff._fixup_sampling(stream, 3) == want
    assert tiff._fixup_sampling(b"\xff\xd8\xff\xcc\x00\x04ab" + sof, 3) \
        == (2, 2)  # a marker libtiff's walk stops at


def test_assemble_runs_one_pixel_call_per_geometry(monkeypatch):
    """A batch of two JPEG TIFFs (strips with a short last one; tiles),
    a JPEG of the tiles' geometry and a PNG: one pixel-stage call per
    geometry for the whole batch, each image equal to its own decode; a
    batch of mixed sizes is resized as the host path resizes it."""
    img = _picture(48, 40, 4)
    tile = _picture(16, 16, 5)
    items = [native_decode.read_bytes(b) for b in (
        tiff.encode(img, "jpeg", photometric=6, rows_per_strip=32),
        tiff.encode(img, "jpeg", photometric=6, tile=(16, 16),
                    orientation=6),
        jpeg.encode(tile, 90, "4:2:0"), png.encode_png(img))]
    single = [native_decode.to_rgb(it) for it in items]
    calls = []
    real = jpeg_pixels.pixels

    def counted(coef, quant, geometry):
        calls.append((geometry.height, geometry.width, coef.shape[0]))
        return real(coef, quant, geometry)

    monkeypatch.setattr(jpeg_pixels, "pixels", counted)
    batch = native_decode.assemble([items[0], items[0]], "cpu")
    assert sorted(calls) == [(16, 40, 2), (32, 40, 2)]
    for got in batch:
        np.testing.assert_array_equal(got.numpy(), single[0])
    calls.clear()
    mixed = native_decode.assemble(items, "cpu", size=(48, 40))
    # the strips' two geometries; the tiles' and the JPEG's one
    assert sorted(calls) == [(16, 16, 10), (16, 40, 1), (32, 40, 1)]
    from mapping_tpu_torch.utils.resize import resize_bilinear_u8
    for got, want in zip(mixed, single):
        if want.shape[:2] != (48, 40):
            want = resize_bilinear_u8(want, (48, 40))
        np.testing.assert_array_equal(got.numpy(), want)
    assert native_decode.image_size(items[1]) == (40, 48)


def test_predict_on_dir_over_jpeg_tiff_equals_over_png(tmp_path):
    """`predict_on_dir` on the CPU over JPEG-TIFF tiles (YCbCr 2x2, two in
    strips with a short last one, two tiled) writes the prediction.json
    it writes over PNG tiles of their decoded pixels."""
    from mapping_tpu_torch import main as cli
    from mapping_tpu_torch.models.unet_resnet import UNetResNet

    for fmt in ("tif", "png"):
        (tmp_path / fmt).mkdir()
    for i in range(4):
        options = [dict(rows_per_strip=16), dict(rows_per_strip=48),
                   dict(tile=(32, 32)), dict(tile=(48, 16))][i]
        data = tiff.encode(_picture(72, 72, 10 + i), "jpeg", photometric=6,
                           **options)
        (tmp_path / "tif" / f"t{i}.tif").write_bytes(data)
        (tmp_path / "png" / f"t{i}.png").write_bytes(png.encode_png(
            native_decode.decode_rgb_bytes(data)))
    torch.manual_seed(0)
    torch.save(UNetResNet(34).state_dict(), tmp_path / "ref.pth")
    params = {"experiment_dir": str(tmp_path / "experiment"),
              "data_dir": str(tmp_path), "meta_dir": str(tmp_path / "meta"),
              "device": "cpu", "encoder": "ResNet34",
              "model_dtype": "float32", "image_h": 64, "image_w": 64,
              "batch_size_inference": 4}
    config = tmp_path / "config.yaml"
    config.write_text("parameters:\n" + "".join(
        f"  {k}: {json.dumps(v)}\n" for k, v in params.items()))
    cli.main(["--config", str(config), "import_checkpoint", "-p",
              "unet_weighted", "--path", str(tmp_path / "ref.pth")])
    for fmt in ("tif", "png"):
        cli.main(["--config", str(config), "predict_on_dir", "-p",
                  "unet_weighted", "--dir_path", str(tmp_path / fmt),
                  "--prediction_path", str(tmp_path / f"{fmt}.json")])
    got = json.loads((tmp_path / "tif.json").read_text())
    assert got == json.loads((tmp_path / "png.json").read_text())
    assert {p["image_id"] for p in got} <= set(range(4))
