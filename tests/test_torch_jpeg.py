"""The port's JPEG decoder (utils/jpeg.py, csrc/jpeg_entropy.cpp and the
plain pixel stage of kernels/jpeg.py) against libjpeg as the JAX package
decodes (mapping_tpu/utils/native_decode.decode_rgb over cpp/decode.cpp)
and against Pillow: the same RGB bytes, exactly, on the committed corpus
(tests/fixtures/jpeg_corpus), on drawn sizes in every supported sampling,
on truncated streams and on the port encoder's files; the refused kinds
raise naming their feature; the batch entry and the loader's batch equal
the JAX loader's.

The CUDA kernels J1 + J2 run only on the card (chip_smoke.py phase 16
holds them equal to this plain version and to the corpus digests).
"""

import hashlib
import io
import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from PIL import Image

from mapping_tpu.data.loader import SegmentationLoader as JaxLoader
from mapping_tpu.utils import native_decode as jax_decode
from mapping_tpu_torch.data.loader import SegmentationLoader
from mapping_tpu_torch.kernels import jpeg as pixels
from mapping_tpu_torch.utils import jpeg, native_decode

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "fixtures" / "jpeg_corpus"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())
DECODED = sorted(n for n, e in MANIFEST.items() if "refused" not in e)
REFUSED = sorted(n for n, e in MANIFEST.items() if "refused" in e)
PIL_SAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _port(data: bytes) -> np.ndarray:
    return native_decode.decode_rgb_bytes(data)


def _libjpeg(data: bytes, tmp_path) -> np.ndarray:
    path = tmp_path / "ref.jpg"
    path.write_bytes(data)
    return jax_decode.decode_rgb(str(path))


def _picture(h, w, seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 70, (h, w, 3)) + np.linspace(0, 180, w)[None, :,
                                                                 None]
    return img.astype(np.uint8)


@pytest.mark.parametrize("name", DECODED)
def test_corpus_decodes_as_libjpeg(name, tmp_path):
    """Each corpus file decodes to the digest of libjpeg's decode written
    in the manifest, equal to the JAX decoder's (and Pillow's where it
    reads the file)."""
    data = (CORPUS / name).read_bytes()
    entry = MANIFEST[name]
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]
    got = _port(data)
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["decode_sha256"]
    np.testing.assert_array_equal(got, _libjpeg(data, tmp_path))
    if name != "truncated.jpg":  # Pillow refuses a truncated stream
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


@pytest.mark.parametrize("name", REFUSED)
def test_refused_kinds_raise_naming_the_feature(name):
    data = (CORPUS / name).read_bytes()
    with pytest.raises(ValueError, match=MANIFEST[name]["refused"]):
        _port(data)


def _sized(data, height, width):
    """`data` with the image size in its SOF0 header replaced."""
    i = data.index(b"\xff\xc0")
    return data[:i + 5] + struct.pack(">HH", height, width) + data[i + 9:]


@pytest.mark.parametrize("height, width", [(65500, 65500), (11586, 11586),
                                           (2050, 65500)])
def test_oversized_headers_are_refused_before_the_scan(monkeypatch, height,
                                                       width):
    """A header claiming more than MAX_PIXELS pixels is refused by the
    SOF parser, before the coefficients are allocated or the Huffman
    decoder is loaded; a request body with it is a RequestError (the
    daemon's 400)."""
    from mapping_tpu_torch.infer.daemon import (RequestError,
                                                decode_request_image)

    def no_scan():
        raise AssertionError("the scan was reached")

    body = _sized(jpeg.encode(_picture(16, 16, 1), 80), height, width)
    assert height * width > jpeg.MAX_PIXELS
    monkeypatch.setattr(jpeg, "load", no_scan)
    with pytest.raises(ValueError, match="implausible image size"):
        jpeg.read_coefficients(body)
    with pytest.raises(RequestError, match="implausible image size"):
        decode_request_image(body, "image/jpeg", (16, 16),
                             native_decode.DeviceDecoder("cpu"))


@pytest.mark.parametrize("name", ["s420.jpg", "s422.jpg", "port_1x2.jpg",
                                  "gray.jpg", "size_299x301.jpg"])
def test_plain_stage_in_small_chunks_decodes_as_libjpeg(monkeypatch, name):
    """The plain pixel stage in IDCT chunks of 16 blocks and colour
    bands of a few rows (PLAIN_VALUES, which bounds its memory on a
    large image) still gives libjpeg's digest."""
    monkeypatch.setattr(pixels, "PLAIN_VALUES", 1024)
    got = _port((CORPUS / name).read_bytes())
    assert hashlib.sha256(got.tobytes()).hexdigest() \
        == MANIFEST[name]["decode_sha256"]


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "4:4:0"])
@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 67), w=st.integers(1, 67),
       quality=st.integers(20, 100), seed=st.integers(0, 2 ** 16))
def test_drawn_sizes_decode_as_libjpeg(tmp_path_factory, sampling, h, w,
                                       quality, seed):
    """Sizes 1-67 a side in every supported sampling (Pillow writes 4:4:4,
    4:2:2 and 4:2:0, the port's encoder 4:4:0): edges, replication below 3
    chroma columns, partial MCUs."""
    img = _picture(h, w, seed)
    if sampling in PIL_SAMPLING:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=quality,
                                  subsampling=PIL_SAMPLING[sampling])
        data = buf.getvalue()
    else:
        data = jpeg.encode(img, quality, sampling)
    tmp = tmp_path_factory.mktemp("drawn")
    np.testing.assert_array_equal(_port(data), _libjpeg(data, tmp))


def test_plain_idct_is_the_dct_within_one_level():
    """The plain J1 against a float64 inverse DCT of the dequantised
    coefficients (+128, clamped): within one level, libjpeg's integer
    rounding apart."""
    rng = np.random.RandomState(0)
    coef = rng.randint(-20, 21, (200, 64)).astype(np.int16)
    coef[:, 12:] = 0  # keeps |sample - 128| < 384, where the table clamps
    quant = rng.randint(1, 7, (200, 64)).astype(np.int32)
    got = pixels.idct_blocks(torch.from_numpy(coef),
                             torch.from_numpy(quant)).numpy().astype(int)
    k = np.arange(8)
    basis = np.cos((2 * k[:, None] + 1) * k[None, :] * np.pi / 16)
    scale = np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    m = basis * scale[None, :]  # m[x, u]
    f = (coef.astype(np.float64) * quant).reshape(-1, 8, 8)
    want = np.einsum("yu,nuv,xv->nyx", m, f, m) + 128
    want = np.clip(np.round(want), 0, 255)
    assert np.abs(got - want).max() <= 1


def test_range_limit_is_libjpegs_table():
    """jdmaster.c prepare_range_limit_table, built as it is, indexed by
    x & RANGE_MASK from the post-IDCT origin."""
    table = np.zeros(5 * 256 + 128, np.int64)
    base = 256
    table[base:base + 256] = np.arange(256)
    table[base + 256:base + 128 + 512] = 255
    post = base + 128
    table[post + 512:post + 512 + 384] = 0
    table[post + 1024 - 128:post + 1024] = np.arange(128)
    x = torch.arange(-3000, 3000)
    want = table[post + (x.numpy() & 1023)]
    np.testing.assert_array_equal(pixels.range_limit(x).numpy(), want)


@pytest.mark.parametrize("cut", [0.3, 0.55, 0.8, 0.97])
@pytest.mark.parametrize("restart", [0, 2])
def test_truncated_streams_decode_as_libjpeg(tmp_path, cut, restart):
    """A stream that ends early: libjpeg's zero bits for the block that
    runs out, gray for the MCUs after it, as the JAX decoder returns it."""
    data = jpeg.encode(_picture(70, 90, 1), 90, "4:2:0", restart)
    data = data[:int(len(data) * cut)]
    np.testing.assert_array_equal(_port(data), _libjpeg(data, tmp_path))


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "4:4:0",
                                      "gray"])
@pytest.mark.parametrize("restart", [0, 1, 5])
def test_encoder_files_read_equal_everywhere(tmp_path, sampling, restart):
    """The port's encoder writes files that Pillow, the JAX decoder and the
    port decode to the same pixels, close to a smooth source."""
    y, x = np.mgrid[0:41, 0:53]
    img = np.stack([2 * x + 40, 3 * y + 30, x + y + 60], -1).astype(np.uint8)
    src = img[..., 0] if sampling == "gray" else img
    data = jpeg.encode(src, 92, "4:2:0" if sampling == "gray" else sampling,
                       restart)
    got = _port(data)
    np.testing.assert_array_equal(got, _libjpeg(data, tmp_path))
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    ref = np.repeat(src[..., None], 3, -1) if sampling == "gray" else src
    assert np.abs(got.astype(int) - ref).mean() < 2


def _three_scans(img, quality):
    """The coefficients of the port encoder's 4:2:0 file, written as a
    sequential file of three non-interleaved scans (luma, Cb, Cr), which
    libjpeg writes from a scan script and Pillow never does."""
    single = jpeg.encode(img, quality, "4:2:0")
    c = jpeg.read_coefficients(single)
    g = c.geometry
    bits, vals = jpeg._huffman_arrays({})
    coef = np.ascontiguousarray(c.coef)
    scans = []
    for ci, (ch, cw) in enumerate(g.sampled):
        t = min(ci, 1)
        comp = np.array([[1, 1, g.blocks[ci][1], g.first_block[ci], t, t]],
                        np.int32)
        out = np.zeros(coef.nbytes * 2 + 1024, np.uint8)
        n = jpeg.load().jpeg_encode_scan(
            coef.ctypes.data, 1, comp.ctypes.data, bits.ctypes.data,
            vals.ctypes.data, -(-cw // 8), -(-ch // 8), 0, out.ctypes.data,
            out.size)
        assert n > 0
        scans.append(bytes([0xFF, 0xDA, 0, 8, 1, ci + 1, (t << 4) | t, 0,
                            63, 0]) + out[:n].tobytes())
    return single, single[:single.index(b"\xff\xda")] + b"".join(scans) \
        + b"\xff\xd9"


@pytest.mark.parametrize("h, w", [(37, 50), (16, 16), (9, 3)])
def test_non_interleaved_scans_decode_as_libjpeg(tmp_path, h, w):
    """A sequential file of one scan per component: the marker walk
    resumes after each scan and every component keeps its quant table;
    equal to libjpeg's decode and to the one-scan file's."""
    single, multi = _three_scans(_picture(h, w, 8), 85)
    got = _port(multi)
    np.testing.assert_array_equal(got, _libjpeg(multi, tmp_path))
    np.testing.assert_array_equal(got, _port(single))


def test_batch_equals_a_stack_of_single_decodes(tmp_path):
    """decode_rgb_batch of one size but several geometries (samplings,
    qualities, grey, a PNG) equals a stack of decode_rgb."""
    img = _picture(33, 47, 4)
    paths = []
    for i, sampling in enumerate(["4:2:0", "4:4:4", "4:4:0", "4:2:0"]):
        p = tmp_path / f"t{i}.jpg"
        p.write_bytes(jpeg.encode(img, 60 + 10 * i, sampling))
        paths.append(p)
    gray = tmp_path / "gray.jpg"
    gray.write_bytes(jpeg.encode(img[..., 2], 80))
    png_path = tmp_path / "t.png"
    Image.fromarray(img).save(png_path)
    paths += [gray, png_path]
    got = native_decode.decode_rgb_batch(paths, "cpu")
    assert got.dtype == torch.uint8 and got.shape == (6, 33, 47, 3)
    want = np.stack([native_decode.decode_rgb(p) for p in paths])
    np.testing.assert_array_equal(got.numpy(), want)
    other = tmp_path / "other.jpg"
    other.write_bytes(jpeg.encode(_picture(20, 20, 5), 80))
    with pytest.raises(ValueError, match="several sizes"):
        native_decode.decode_rgb_batch(paths + [other], "cpu")
    resized = native_decode.decode_rgb_batch(paths + [other], "cpu",
                                             size=(33, 47))
    np.testing.assert_array_equal(resized[:6].numpy(), want)


def test_the_wrappers_take_cuda_tensors_only():
    """A CPU tensor at the kernels' wrappers raises; `pixels` takes it to
    the plain version by its device alone."""
    c = jpeg.read_coefficients(jpeg.encode(_picture(16, 16, 6), 80))
    coef = torch.from_numpy(c.coef)[None]
    quant = torch.from_numpy(c.quant)[None]
    with pytest.raises(ValueError, match="CUDA"):
        pixels.idct(coef, quant, c.geometry)
    with pytest.raises(ValueError, match="CUDA"):
        pixels.color(torch.zeros((1, pixels.plane_bytes(c.geometry)),
                                 dtype=torch.uint8), c.geometry)
    before = dict(pixels.LAUNCHES)
    pixels.pixels(coef, quant, c.geometry)
    assert pixels.LAUNCHES == before


def test_geometry_record_matches_the_cuda_struct():
    """kernels/jpeg.geometry_record lays out csrc/jpeg_pixels.cu's
    JpegGeom: 6 scalars, then 10 arrays of 3."""
    src = (ROOT / "mapping_tpu_torch" / "csrc" / "jpeg_pixels.cu").read_text()
    body = src[src.index("struct JpegGeom {"):].split("};")[0]
    scalars = body.split(";")[0].split("{")[1].count(",") + 1
    arrays = body.count("[3]")
    assert (scalars, arrays) == (6, 10)
    assert pixels.GEOM_INTS == 6 + 3 * 10
    g = jpeg.read_coefficients(jpeg.encode(_picture(9, 30, 7), 80,
                                           "4:2:2")).geometry
    assert len(pixels.geometry_record(g)) == pixels.GEOM_INTS


def test_loader_batch_equals_the_jax_loaders(tmp_path):
    """The loader's batch of JPEG tiles on the CPU (the host decode on the
    threads, one pixel-stage call) equals the JAX loader's libjpeg
    batch."""
    paths = []
    for i in range(5):
        p = tmp_path / f"tile{i}.jpg"
        Image.fromarray(_picture(300, 300, 10 + i)).save(p, quality=95)
        paths.append(str(p))
    common = dict(mode="resize", size=(64, 64), batch_size_inference=5,
                  augment=False)
    want, _ = JaxLoader(**common)._assemble(paths, None, np.arange(5))
    got, targets, ready = SegmentationLoader(
        device="cpu", **common)._assemble(paths, None, np.arange(5))
    assert targets is None and ready is None
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_corpus_decodes_with_jax_pil_and_libjpeg_blocked():
    """In a process where jax, flax, PIL and the JAX package cannot be
    imported and the libjpeg/libpng library does not load, every corpus
    file decodes to its libjpeg digest and each refused kind raises a
    ValueError naming its feature."""
    code = (
        "import sys, json, hashlib\n"
        "for m in ('jax', 'flax', 'PIL', 'mapping_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from pathlib import Path\n"
        "from mapping_tpu_torch.utils import native_decode\n"
        "from mapping_tpu_torch.utils.native_lib import "
        "NativeLibraryUnavailable\n"
        "def unavailable():\n"
        "    raise NativeLibraryUnavailable('no libjpeg')\n"
        "native_decode.load = unavailable\n"
        f"corpus = Path({str(CORPUS)!r})\n"
        "manifest = json.loads((corpus / 'manifest.json').read_text())\n"
        "for name, e in manifest.items():\n"
        "    if 'refused' in e:\n"
        "        try:\n"
        "            native_decode.decode_rgb(corpus / name)\n"
        "        except ValueError as x:\n"
        "            assert e['refused'] in str(x), (name, x)\n"
        "            continue\n"
        "        raise AssertionError(name + ' decoded')\n"
        "    rgb = native_decode.decode_rgb(corpus / name)\n"
        "    d = hashlib.sha256(rgb.tobytes()).hexdigest()\n"
        "    assert d == e['decode_sha256'], name\n"
        "print(len(manifest))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == len(MANIFEST)
