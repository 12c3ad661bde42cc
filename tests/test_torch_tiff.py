"""The port's TIFF reader (mapping_tpu_torch/utils/tiff.py over
csrc/tiff_codecs.cpp) against the JAX package's loader on the same bytes,
exactly: `mapping_tpu.data.loader.load_image`, which reads TIFF through
Pillow (its own unpackers for uncompressed files, libtiff for compressed
ones) and convert("RGB").

- the corpus `tests/fixtures/tiff_corpus` (Pillow's files and the port
  writer's), each readable file equal to the manifest's JAX digest and to
  the JAX loader here, each refused kind raising with its feature named
  and the manifest's record of whether the JAX loader reads it;
- every kind the port reads, written by the port's writer
  (`tiff.encode`) under each compression;
- a hypothesis sweep of sizes 1-67 over compression x predictor x planar
  x byte order x strips or tiles;
- the C++ LZW and PackBits decoders against the plain Python ones on
  drawn streams, valid and corrupt; a truncated file raises;
- `predict_on_dir` over TIFF tiles against the same pixels as PNG, and
  TIFF request bodies (LZW; JPEG) through the port's HTTP daemon against
  the JAX daemon's answer.

JPEG-compressed TIFF beyond the corpus: tests/test_torch_tiff_jpeg.py."""

import hashlib
import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mapping_tpu.data.loader import load_image
from mapping_tpu.infer import daemon as jax_daemon
from mapping_tpu_torch.infer.daemon import (ServingDaemon,
                                            decode_request_image)
from mapping_tpu_torch.utils import native_decode, png, tiff
from tests.test_torch_daemon import (CAT_IDS, CAT_LAYERS, HW,
                                     _assert_same_annotations, _batcher,
                                     _images, _jax_preprocess, _jax_serve,
                                     _post)
from tests.torch_guards import drop_tmp_path  # noqa: F401 (autouse)

CORPUS = Path(__file__).resolve().parent / "fixtures" / "tiff_corpus"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())
COMPRESSIONS = ("none", "lzw", "deflate", "adobe_deflate", "packbits")


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _jax(tmp_path, data, name="x.tif"):
    """The JAX loader's RGB of the bytes, or None where it raises."""
    path = tmp_path / name
    path.write_bytes(data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return load_image(str(path))
        except Exception:
            return None


def _port(data):
    try:
        return native_decode.decode_rgb_bytes(data)
    except ValueError:
        return None


def _same_as_jax(tmp_path, data):
    """The port's decode equals the JAX loader's, or both refuse."""
    want, got = _jax(tmp_path, data), _port(data)
    assert (want is None) == (got is None), (want is None, got is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_corpus_reads_as_the_jax_loader(tmp_path, name):
    entry = MANIFEST[name]
    data = (CORPUS / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]
    want = _jax(tmp_path, data)
    if "refused" in entry:
        with pytest.raises(ValueError, match=entry["refused"]):
            native_decode.read_bytes(data)
        assert (want is not None) == ("jax_reads" in entry)
        if want is not None:
            assert _digest(want) == entry["jax_reads"]
        return
    got = native_decode.decode_rgb(CORPUS / name)
    assert list(got.shape) == entry["shape"]
    assert _digest(got) == entry["decode_sha256"]
    np.testing.assert_array_equal(got, want)


def test_corpus_decodes_with_jax_and_pil_blocked():
    """The corpus through the port in a process where jax, flax and PIL
    cannot be imported: every file read to its digest (the JPEG-compressed
    ones among them), every refused kind raising with its feature named."""
    code = (
        "import sys, json, hashlib\n"
        "for m in ('jax', 'flax', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from mapping_tpu_torch.utils import native_decode, tiff\n"
        f"corpus = Path({str(CORPUS)!r})\n"
        "manifest = json.loads((corpus / 'manifest.json').read_text())\n"
        "n = jpegs = refused = 0\n"
        "for name, e in manifest.items():\n"
        "    if 'refused' in e:\n"
        "        try:\n"
        "            native_decode.decode_rgb(corpus / name)\n"
        "        except ValueError as err:\n"
        "            assert e['refused'] in str(err), (name, err)\n"
        "            refused += 1\n"
        "        continue\n"
        "    item = native_decode.read_image(corpus / name)\n"
        "    jpegs += isinstance(item, tiff.JpegTiles)\n"
        "    rgb = native_decode.to_rgb(item)\n"
        "    assert hashlib.sha256(np.ascontiguousarray(rgb).tobytes())"
        ".hexdigest() == e['decode_sha256'], name\n"
        "    n += 1\n"
        "print(n, jpegs, refused)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    n, jpegs, refused = map(int, out.stdout.split())
    assert n == sum("refused" not in e for e in MANIFEST.values())
    assert refused == sum("refused" in e for e in MANIFEST.values())
    assert jpegs == sum(name.startswith(("jpeg_", "pil_jpeg"))
                        and "refused" not in e
                        for name, e in MANIFEST.items()) > 0


def _kinds():
    """(name, samples, encode options) of every layout the port reads."""
    rng = np.random.RandomState(3)
    h, w = 19, 23
    for bits in (1, 2, 4, 8):
        v = rng.randint(0, 1 << bits, (h, w))
        for photo in (0, 1):
            yield f"grey{bits}_photometric{photo}", v, dict(
                bits=bits, photometric=photo, rows_per_strip=7)
        yield f"grey{bits}_fill2", v, dict(bits=bits, photometric=1,
                                           fill_order=2)
        yield f"palette{bits}", v, dict(
            bits=bits, photometric=3, tile=(16, 16),
            colormap=rng.randint(0, 65536, (3, 1 << bits)))
    grey16 = rng.randint(0, 700, (h, w)).astype(np.uint16)
    grey16[0, :5] = [0, 255, 256, 1000, 65535]
    yield "grey16_ii", grey16, dict(bits=16, photometric=1)
    yield "grey16_ii_miniswhite", grey16, dict(bits=16, photometric=0)
    yield "grey16_mm", grey16, dict(bits=16, photometric=1, byteorder=">")
    yield "signed8", rng.randint(0, 256, (h, w)), dict(photometric=1,
                                                       sample_format=2)
    two = rng.randint(0, 256, (h, w, 2))
    yield "grey_alpha", two, dict(photometric=1, extra_samples=(2,))
    yield "palette_x", two, dict(photometric=3, extra_samples=(0,),
                                 colormap=rng.randint(0, 65536, (3, 256)))
    yield "palette_alpha", two, dict(photometric=3, extra_samples=(2,),
                                     colormap=rng.randint(0, 65536,
                                                          (3, 256)))
    for extra in ((), (0,), (1,), (2,), (999,), (0, 0), (1, 0), (2, 0),
                  (0, 0, 0), (1, 0, 0), (2, 0, 0)):
        n = 3 + len(extra) if extra else 4
        img = rng.randint(0, 256, (h, w, n))
        img[0, :4, 3] = [0, 1, 128, 255]  # alpha 0 and small alpha
        yield f"rgb8_extra{''.join(map(str, extra))}", img, dict(
            extra_samples=extra, rows_per_strip=5)
    yield "rgb8", rng.randint(0, 256, (h, w, 3)), {}
    for extra in ((), (0,), (1,), (2,)):
        img = rng.randint(0, 65536, (h, w, 3 + len(extra) if extra else 3))
        yield f"rgb16_extra{''.join(map(str, extra))}", img.astype(
            np.uint16), dict(bits=16, extra_samples=extra, tile=(16, 32))
    rgb = rng.randint(0, 256, (h, w, 3))
    yield "rgb_planar_tiles", rgb, dict(planar=2, tile=(16, 16))
    yield "rgb_big_endian", rgb, dict(byteorder=">")
    yield "rgb_bigtiff", rgb, dict(bigtiff=True)
    yield "rgb_fill2", rgb, dict(fill_order=2)
    yield "rgb_two_pages", rgb, dict(pages=[rgb[::-1]])
    for o in range(1, 9):
        yield f"orientation{o}", rgb, dict(orientation=o)
    yield "size_1x1", rgb[:1, :1], {}


KINDS = {name: (samples, options) for name, samples, options in _kinds()}


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_layout_reads_as_the_jax_loader(tmp_path, kind, compression):
    """Each layout the port reads, written by the port's writer, decodes
    as the JAX loader decodes it (both refuse the few kinds Pillow has no
    raw unpacker for)."""
    samples, options = KINDS[kind]
    got = _same_as_jax(tmp_path, tiff.encode(samples, compression,
                                             **options))
    refused = compression == "none" and kind in (
        "grey8_fill2", "palette1", "palette2", "palette4")
    if not refused:
        assert got is not None


@pytest.mark.parametrize("compression", ("lzw", "deflate"))
@pytest.mark.parametrize("bits", (8, 16))
def test_predictor_two_reads_as_the_jax_loader(tmp_path, compression,
                                               bits):
    """Horizontal differencing wraps at 8 and 16 bits, planar or not, in
    strips and tiles; below 8 bits libtiff refuses it, and so does the
    port, naming it."""
    rng = np.random.RandomState(bits)
    img = rng.randint(0, 1 << bits, (21, 37, 3)).astype(
        np.uint16 if bits == 16 else np.uint8)
    for options in ({}, {"planar": 2}, {"tile": (16, 32)},
                    {"byteorder": ">", "rows_per_strip": 4}):
        assert _same_as_jax(tmp_path, tiff.encode(
            img, compression, bits=bits, predictor=2, **options)) is not None
    low = tiff.encode(rng.randint(0, 16, (5, 7)), compression, bits=4,
                      predictor=2)
    assert _jax(tmp_path, low) is None
    with pytest.raises(ValueError, match="predictor 2 at 4 bits"):
        tiff.decode(low)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 67), w=st.integers(1, 67),
       compression=st.sampled_from(COMPRESSIONS),
       predictor=st.sampled_from((1, 2)), planar=st.sampled_from((1, 2)),
       order=st.sampled_from("<>"), grey=st.booleans(),
       layout=st.sampled_from(("strips", "tiles")),
       rows=st.integers(1, 70), seed=st.integers(0, 2 ** 31 - 1))
def test_drawn_files_read_as_the_jax_loader(tmp_path, h, w, compression,
                                            predictor, planar, order,
                                            grey, layout, rows, seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w) if grey else (h, w, 3))
    img[h // 3:, w // 2:] = 200  # a flat block for the coders' runs
    if compression not in ("lzw", "deflate", "adobe_deflate"):
        predictor = 1
    options = dict(predictor=predictor, planar=planar, byteorder=order)
    if layout == "tiles":
        options["tile"] = (16 * (1 + rows % 3), 16 * (1 + rows % 2))
    else:
        options["rows_per_strip"] = rows
    got = _same_as_jax(tmp_path, tiff.encode(img, compression, **options))
    assert got is not None
    np.testing.assert_array_equal(got, img[..., None].repeat(3, -1)
                                  if grey else img)


def _lzw_streams():
    """Drawn LZW streams: the writer's of data with few symbols (long
    strings), many (the table passes 511, 1023 and 2047 entries, where the
    code widens one code early, and is cleared at 4094), and corrupt ones
    (a Clear, then random bits)."""
    rng = np.random.RandomState(5)
    for k in range(6):
        data = rng.randint(0, 1 << (k + 1), 1000 * (k + 1)).astype(
            np.uint8).tobytes()
        yield tiff.lzw_encode(data), len(data)
        yield tiff.lzw_encode(data)[:-(k + 2)], len(data)  # cut short
    for k in range(6):
        garbage = b"\x80\x00" + bytes(rng.randint(0, 256, 40 + 50 * k)
                                      .astype(np.uint8))
        yield garbage, 60 + 20 * k
    yield tiff.lzw_encode(b"a" * 5000)[2:], 5000  # no leading Clear
    yield b"", 1


@pytest.mark.parametrize("i", range(20))
def test_native_lzw_equals_the_plain_decoder(i):
    src, want = list(_lzw_streams())[i]
    try:
        plain = tiff.lzw_decode_plain(src, want)
    except ValueError as e:
        with pytest.raises(ValueError):
            tiff.lzw_decode(src, want)
        assert "LZW" in str(e)
        return
    np.testing.assert_array_equal(tiff.lzw_decode(src, want), plain)


@pytest.mark.parametrize("seed", range(12))
def test_native_packbits_equals_the_plain_decoder(seed):
    """Random PackBits bytes (no-op -128s, runs past the output, literals
    cut short) and the writer's streams."""
    rng = np.random.RandomState(seed)
    if seed % 2:
        data = bytes(rng.choice([0, 0, 0, 7, 255], 700).astype(np.uint8))
        src, want = tiff.packbits_encode(data), len(data)
        assert tiff.packbits_decode(src, want).tobytes() == data
    else:
        src = bytes(rng.randint(0, 256, 50 + 20 * seed).astype(np.uint8))
        want = int(rng.randint(1, 400))
    try:
        plain = tiff.packbits_decode_plain(src, want)
    except ValueError:
        with pytest.raises(ValueError):
            tiff.packbits_decode(src, want)
        return
    np.testing.assert_array_equal(tiff.packbits_decode(src, want), plain)


def test_lzw_code_widths_agree_with_libtiff(tmp_path):
    """A 300^2 RGB tile of random bytes: the writer's LZW passes every
    code width and several Clears; libtiff (through Pillow) and the port
    read it back to the pixels."""
    img = np.random.RandomState(9).randint(0, 256, (300, 300, 3))
    data = tiff.encode(img, "lzw")
    np.testing.assert_array_equal(_jax(tmp_path, data), img)
    np.testing.assert_array_equal(tiff.decode(data), img)


@pytest.mark.parametrize("name", ["pil_tiff_lzw.tif", "pil_packbits.tif",
                                  "pil_raw.tif", "lzw_pred2_strips.tif",
                                  "deflate_pred2_tiles_edges.tif",
                                  "bigtiff_deflate.tif"])
def test_truncated_files_raise(tmp_path, name):
    """Cut anywhere, a file raises a ValueError (or, where the cut spares
    all the data the JAX loader reads, decodes as it does)."""
    data = (CORPUS / name).read_bytes()
    for frac in (0.02, 0.1, 0.3, 0.5, 0.7, 0.9, 0.99):
        _same_as_jax(tmp_path, data[:int(len(data) * frac)])


def test_old_style_lzw_is_refused_by_name():
    data = bytearray(tiff.encode(np.zeros((4, 4, 3), np.uint8), "lzw"))
    data[8:10] = b"\x00\x01"  # the strip starts as an old-style stream
    with pytest.raises(ValueError, match="old-style LZW"):
        tiff.decode(bytes(data))


def test_releases_gil_names_tiff():
    assert native_decode.releases_gil("tile.tif")
    assert native_decode.releases_gil("TILE.TIFF")


def test_predict_on_dir_over_tiff_equals_over_png(tmp_path):
    """`predict_on_dir` on the CPU over TIFF tiles (LZW + predictor 2, one
    tiled, one planar PackBits) writes the prediction.json it writes over
    the same pixels as PNG files."""
    from mapping_tpu_torch import main as cli
    from mapping_tpu_torch.models.unet_resnet import UNetResNet

    rng = np.random.RandomState(4)
    base = rng.randint(0, 256, (4, 9, 9, 3)).astype(np.float32)
    tiles = torch.nn.functional.interpolate(
        torch.from_numpy(base).permute(0, 3, 1, 2), size=(72, 72),
        mode="bilinear").permute(0, 2, 3, 1).numpy().astype(np.uint8)
    for fmt in ("tif", "png"):
        (tmp_path / fmt).mkdir()
    for i, tile in enumerate(tiles):
        options = [dict(predictor=2), dict(predictor=2, tile=(32, 32)),
                   dict(predictor=2, byteorder=">"), {}][i]
        data = (tiff.encode(tile, "packbits", planar=2) if i == 3
                else tiff.encode(tile, "lzw", **options))
        (tmp_path / "tif" / f"t{i}.tif").write_bytes(data)
        (tmp_path / "png" / f"t{i}.png").write_bytes(png.encode_png(tile))
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


def test_http_tiff_body_matches_the_jax_daemon():
    """TIFF request bodies (LZW with predictor 2; JPEG, YCbCr 2x2 in
    strips) through the port's HTTP daemon: each tile equals the JAX
    daemon's decode (Pillow), and so does each answer."""
    img = _images(1, seed=29)[0]
    for body in (tiff.encode(img, "lzw", predictor=2),
                 tiff.encode(img, "jpeg", photometric=6, rows_per_strip=16,
                             quality=95)):
        _same_answer_as_the_jax_daemon(body)


def _same_answer_as_the_jax_daemon(body):
    np.testing.assert_array_equal(
        decode_request_image(body, "image/tiff", HW),
        jax_daemon.decode_request_image(body, "image/tiff", HW))
    headers = {"Content-Type": "image/tiff", "X-Image-Id": "4"}
    jax_server = jax_daemon.ServingDaemon(
        jax_daemon.Microbatcher(_jax_serve(), _jax_preprocess, 4,
                                category_ids=CAT_IDS,
                                category_layers=CAT_LAYERS,
                                max_wait_ms=30.0),
        HW, {"batch_size": 4}, port=0)
    server = ServingDaemon(_batcher(), HW, {"batch_size": 4}, device="cpu",
                           port=0)
    server.start_background()
    jax_server.start_background()
    try:
        got = _post(f"http://127.0.0.1:{server.port}/v1/predict", body,
                    headers)
        want = _post(f"http://127.0.0.1:{jax_server.port}/v1/predict", body,
                     headers)
        assert got["annotations"]
        _assert_same_annotations(got["annotations"], want["annotations"])
    finally:
        server.shutdown()
        jax_server.shutdown()
