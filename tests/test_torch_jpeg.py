"""The port's JPEG decoder (utils/jpeg.py, csrc/jpeg_entropy.cpp and the
plain pixel stage of kernels/jpeg.py) against the JAX package's decode
(mapping_tpu.data.loader.load_image: libjpeg over cpp/decode.cpp, Pillow
where libjpeg declines, as for CMYK) and against Pillow: the same RGB
bytes, exactly, on the committed corpus (tests/fixtures/jpeg_corpus:
baseline, progressive with its scripts and truncated cuts, arithmetic
coding, sampling ratios 3 and 4, CMYK and YCCK), on drawn sizes in every
sampling Pillow writes, baseline and progressive, on truncated streams and
on the port encoder's files; the refused kinds raise naming their feature;
the batch entry and the loader's batch equal the JAX loader's; the plain
stage's box upsampling and CMYK / YCCK colour against numpy restatements
of libjpeg's and Pillow's C.

The CUDA kernel `jpeg_pixels` runs only on the card (chip_smoke.py phase 16
holds it equal to this plain version and to the corpus digests); here its
geometry record is held against the CUDA struct, and the bounds under which
its IDCT computes in 32 bits against the plain IDCT in int32 and int64.
"""

import hashlib
import io
import json
import re
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
from mapping_tpu.data.loader import load_image
from mapping_tpu.utils import native_decode as jax_decode
from mapping_tpu_torch.data.loader import SegmentationLoader
from mapping_tpu_torch.kernels import jpeg as pixels
from mapping_tpu_torch.utils import jpeg, native_decode
from tests.torch_guards import MISSING, jax_decode_library, libjpeg_rgb

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "fixtures" / "jpeg_corpus"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())
DECODED = sorted(n for n, e in MANIFEST.items() if "refused" not in e)
REFUSED = sorted(n for n, e in MANIFEST.items() if "refused" in e)
PIL_SAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _port(data: bytes) -> np.ndarray:
    return native_decode.decode_rgb_bytes(data)


def _libjpeg(data: bytes, tmp_path) -> np.ndarray:
    """The JAX package's libjpeg decode of the bytes; an AssertionError
    naming the library where this worker has none."""
    path = tmp_path / "ref.jpg"
    path.write_bytes(data)
    return libjpeg_rgb(path)


def _jax(data: bytes, tmp_path) -> np.ndarray:
    """The JAX package's decode of a file: libjpeg, else Pillow (as for
    CMYK), with the library loaded in this worker first."""
    jax_decode_library()
    path = tmp_path / "ref.jpg"
    path.write_bytes(data)
    return load_image(str(path))


def test_a_missing_reference_fails_naming_the_library(monkeypatch,
                                                      tmp_path):
    """F9: where this worker has no JAX decode library (it lost the JAX
    package's build race and builds fail), the reference raises naming
    the library instead of returning None, which the parity tests read as
    a pixel mismatch; `_jax` too, which would fall back to Pillow."""
    monkeypatch.setattr(jax_decode, "_load", lambda: None)
    monkeypatch.setattr(jax_decode, "build", lambda force=False: False)
    data = jpeg.encode(_picture(8, 8, 0), 90, "4:2:0")
    with pytest.raises(AssertionError, match=re.escape(MISSING)):
        _libjpeg(data, tmp_path)
    with pytest.raises(AssertionError, match=re.escape(MISSING)):
        _jax(data, tmp_path)


def test_a_reference_that_declines_fails_naming_the_library(monkeypatch,
                                                             tmp_path):
    """A loaded library that returns None for a file it read before is
    loaded afresh once, then raises naming the library."""
    monkeypatch.setattr(jax_decode, "decode_rgb", lambda path: None)
    with pytest.raises(AssertionError, match=re.escape(MISSING)):
        _libjpeg(jpeg.encode(_picture(8, 8, 0), 90, "4:2:0"), tmp_path)


def _picture(h, w, seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 70, (h, w, 3)) + np.linspace(0, 180, w)[None, :,
                                                                 None]
    return img.astype(np.uint8)


#: corpus files Pillow does not read as libjpeg does: streams cut short
#: (Pillow refuses them) and corrupt ones
_CUT = ("truncated.jpg", "prog_cut_scan1.jpg", "prog_cut_scan4.jpg")


@pytest.mark.parametrize("name", DECODED)
def test_corpus_decodes_as_libjpeg(name, tmp_path):
    """Each corpus file decodes, through `read_bytes` and `read_image`, to
    the digest of the JAX package's decode written in the manifest (by
    libjpeg, or by Pillow for CMYK and YCCK), equal to that decode now
    (and to Pillow's where it reads the file)."""
    data = (CORPUS / name).read_bytes()
    entry = MANIFEST[name]
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]
    got = _port(data)
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["decode_sha256"]
    np.testing.assert_array_equal(native_decode.decode_rgb(CORPUS / name),
                                  got)
    np.testing.assert_array_equal(got, _jax(data, tmp_path))
    if name not in _CUT:
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


@pytest.mark.parametrize("name", REFUSED)
def test_refused_kinds_raise_naming_the_feature(name, tmp_path):
    """The kinds the port refuses raise a ValueError naming the feature;
    the JAX package refuses them too, except where the manifest says it
    reads the file (`jax_reads`, a gap)."""
    data = (CORPUS / name).read_bytes()
    entry = MANIFEST[name]
    with pytest.raises(ValueError, match=entry["refused"]):
        _port(data)
    if "jax_reads" in entry:
        assert hashlib.sha256(_jax(data, tmp_path).tobytes()).hexdigest() \
            == entry["jax_reads"]
    else:
        with pytest.raises(Exception):
            _jax(data, tmp_path)


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0"])
@settings(max_examples=8, deadline=None)
@given(h=st.integers(1, 67), w=st.integers(1, 67),
       quality=st.integers(20, 100), seed=st.integers(0, 2 ** 16))
def test_drawn_progressive_decode_as_libjpeg(tmp_path_factory, sampling, h,
                                             w, quality, seed):
    """Pillow's progressive files (libjpeg's default script: successive
    approximation, interleaved DC, spectral bands) at drawn sizes and
    qualities decode as the JAX package decodes them, and to the pixels
    of the baseline file of the same coefficients."""
    img = _picture(h, w, seed)
    files = {}
    for progressive in (False, True):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=quality,
                                  subsampling=PIL_SAMPLING[sampling],
                                  progressive=progressive)
        files[progressive] = buf.getvalue()
    got = _port(files[True])
    np.testing.assert_array_equal(
        got, _jax(files[True], tmp_path_factory.mktemp("prog")))
    np.testing.assert_array_equal(got, _port(files[False]))


@pytest.mark.parametrize("cut", [0.12, 0.3, 0.45, 0.6, 0.75, 0.9])
@pytest.mark.parametrize("sampling", [0, 2])
def test_truncated_progressive_decode_as_libjpeg(tmp_path, cut, sampling):
    """A progressive stream that ends early: libjpeg keeps what the scans
    brought, fills the rest with zeros and smooths the blocks whose AC
    coefficients are not all known (libjpeg-turbo 2.1's block smoothing);
    a cut inside a marker segment reads the source's fake EOI bytes. The
    port gives the JAX package's pixels, or both refuse."""
    buf = io.BytesIO()
    Image.fromarray(_picture(70, 90, 2)).save(
        buf, "JPEG", quality=85, subsampling=sampling, progressive=True)
    data = buf.getvalue()[:int(len(buf.getvalue()) * cut)]
    try:
        want = _jax(data, tmp_path)
    except Exception:
        with pytest.raises(ValueError):
            _port(data)
        return
    np.testing.assert_array_equal(_port(data), want)


_JSIMD_DECODE = (
    "import sys\n"
    "import numpy as np\n"
    "from mapping_tpu.utils import native_decode\n"
    "rgb = native_decode.decode_rgb(sys.argv[1])\n"
    "np.save(sys.argv[2], rgb)\n")


@pytest.mark.parametrize("name", ["arith_300.jpg", "arith_prog.jpg"])
def test_truncated_arithmetic_decode_as_libjpegs_c(tmp_path, name):
    """An arithmetic-coded stream that ends early: the decoder reads zeros
    past the data (jdarith.c), which decode to coefficients past 16 bits.
    The port follows libjpeg's C definitions there (its pixel stage is
    jidctint.c's); an x86-64 libjpeg-turbo runs a SIMD IDCT (SSE2 /
    AVX2) that wraps such values in 16 bits, so the JAX decoder is run
    with JSIMD_FORCENONE=1, libjpeg-turbo's switch to its C code, in a
    child process."""
    import os

    data = (CORPUS / name).read_bytes()
    for k, cut in enumerate((0.3, 0.55, 0.8)):
        part = data[:int(len(data) * cut)]
        src, dst = tmp_path / f"cut{k}.jpg", tmp_path / f"cut{k}.npy"
        src.write_bytes(part)
        out = subprocess.run(
            [sys.executable, "-c", _JSIMD_DECODE, str(src), str(dst)],
            capture_output=True, text=True, timeout=120, cwd=str(ROOT),
            env={**os.environ, "JSIMD_FORCENONE": "1"})
        assert out.returncode == 0, out.stderr
        np.testing.assert_array_equal(_port(part), np.load(dst))


def _int_upsample(plane, rh, rv, height, width):
    """jdsample.c int_upsample (and h2v1_upsample / h2v2_upsample): each
    sample repeated rh times along its row, each row rv times."""
    rows = np.repeat(np.repeat(plane, rh, axis=1), rv, axis=0)
    return rows[:height, :width]


@pytest.mark.parametrize("rh, rv, cw", [
    (3, 1, 9), (4, 1, 7), (1, 3, 5), (1, 4, 6), (2, 4, 8), (4, 2, 3),
    (3, 3, 4), (4, 4, 5), (2, 3, 7), (3, 2, 6), (2, 1, 2), (2, 2, 1),
    (2, 2, 2), (4, 3, 1)])
def test_box_upsampling_is_int_upsample(rh, rv, cw):
    """The plain stage's upsampling of every ratio libjpeg-turbo 2.1 does
    not upsample fancily (jdsample.c jinit_upsampler: h2v1 / h2v2 at most
    2 samples wide, and every ratio other than 1 or 2) is box
    replication, on a component plane's real samples."""
    assert pixels.upsampling(rh, rv, cw) == "box"
    rng = np.random.RandomState(rh * 10 + rv)
    ch = 5
    plane = rng.randint(0, 256, (ch + 3, cw + 5)).astype(np.uint8)
    height, width = ch * rv - rng.randint(rv), cw * rh - rng.randint(rh)
    y = torch.arange(height)
    got = pixels._upsample(torch.from_numpy(plane)[None], ch, cw, rh, rv, y,
                           width)[0].numpy()
    np.testing.assert_array_equal(
        got, _int_upsample(plane.astype(np.int64), rh, rv, height, width))


def test_upsampling_choice_is_jinit_upsamplers():
    """jdsample.c jinit_upsampler with fancy upsampling (the default):
    fullsize at 1 x 1, fancy h2v1 / h2v2 where the component is more than
    2 samples wide, fancy h1v2 always, and int_upsample (box) else."""
    for rh in (1, 2, 3, 4):
        for rv in (1, 2, 3, 4):
            for cw in (1, 2, 3, 40):
                if (rh, rv) == (1, 1):
                    want = "full"
                elif (rh, rv) == (1, 2):
                    want = "h1v2"
                elif (rh, rv) in ((2, 1), (2, 2)) and cw > 2:
                    want = f"h2v{rv}"
                else:
                    want = "box"
                assert pixels.upsampling(rh, rv, cw) == want


def _fix(x):
    return int(x * 65536 + 0.5)


def _ycck_to_cmyk(y, cb, cr, k):
    """jdcolor.c ycck_cmyk_convert with build_ycc_rgb_table's tables and
    the sample range limit table (a clamp to 0..255)."""
    x_cr, x_cb = cr - 128, cb - 128
    cr_r = (_fix(1.40200) * x_cr + (1 << 15)) >> 16
    cb_b = (_fix(1.77200) * x_cb + (1 << 15)) >> 16
    cr_g = -_fix(0.71414) * x_cr
    cb_g = -_fix(0.34414) * x_cb + (1 << 15)
    c = np.clip(255 - (y + cr_r), 0, 255)
    m = np.clip(255 - (y + ((cb_g + cr_g) >> 16)), 0, 255)
    yy = np.clip(255 - (y + cb_b), 0, 255)
    return c, m, yy, k


def _pillow_cmyk_rgb(c, m, y, k):
    """Pillow's reading of libjpeg's CMYK: the "CMYK;I" raw mode inverts
    every sample, then Convert.c cmyk2rgb: CLIP8(nk - MULDIV255(v, nk))
    with nk = 255 - the inverted K."""
    inv = [255 - v for v in (c, m, y, k)]
    nk = 255 - inv[3]

    def muldiv255(a, b):
        t = a * b + 128
        return ((t >> 8) + t) >> 8

    return np.stack([np.clip(nk - muldiv255(v, nk), 0, 255)
                     for v in inv[:3]], -1)


@pytest.mark.parametrize("color", ["cmyk", "ycck"])
def test_cmyk_and_ycck_colour_is_libjpeg_then_pillow(color):
    """The plain colour stage of 4-component pixels equals a numpy
    restatement of libjpeg's CMYK output (jdcolor.c) read by Pillow
    (Unpack.c "CMYK;I", Convert.c cmyk2rgb), and Pillow itself on the
    restated CMYK samples; every sample value meets every K."""
    from mapping_tpu_torch.utils.jpeg import Geometry

    rng = np.random.RandomState(7)
    h, w = 64, 64
    planes = rng.randint(0, 256, (4, h, w)).astype(np.int64)
    planes[3] = np.arange(256).reshape(16, 16).repeat(4, 0).repeat(4, 1)
    g = Geometry(h, w, ((1, 1),) * 4, color)
    got = pixels.color_plain(torch.from_numpy(
        planes.astype(np.uint8).reshape(1, -1)), g)[0].numpy()
    cmyk = _ycck_to_cmyk(*planes) if color == "ycck" else tuple(planes)
    want = _pillow_cmyk_rgb(*cmyk)
    np.testing.assert_array_equal(got, want)
    raw = np.stack(cmyk, -1).astype(np.uint8)  # libjpeg's samples
    pil = Image.frombuffer("CMYK", (w, h), raw.tobytes(), "raw", "CMYK;I", 0,
                           1).convert("RGB")
    np.testing.assert_array_equal(got, np.asarray(pil))


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
        jpeg.read(body)
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
    """The plain IDCT against a float64 inverse DCT of the dequantised
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
    c = jpeg.read(single)
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
    """A CPU tensor at the kernel's wrapper raises; `pixels` takes it to
    the plain version by its device alone, launching nothing."""
    c = jpeg.read(jpeg.encode(_picture(16, 16, 6), 80))
    coef = torch.from_numpy(c.coef)[None]
    quant = torch.from_numpy(c.quant)[None]
    with pytest.raises(ValueError, match="CUDA"):
        pixels.pixels_cuda(coef, quant, c.geometry)
    assert set(pixels.LAUNCHES) == {"jpeg_pixels"}
    before = dict(pixels.LAUNCHES)
    got = pixels.pixels(coef, quant, c.geometry)
    assert pixels.LAUNCHES == before
    assert torch.equal(got, pixels.pixels_plain(coef, quant, c.geometry))


@pytest.mark.parametrize("value", [pixels.QUANT_MAX + 1,
                                   -pixels.QUANT_MAX - 1, -2 ** 31])
def test_quant_tables_past_16_bits_are_refused(value):
    """`pixels` refuses a quant value that no DQT table holds (past
    +-65,535, where the kernel's 32-bit dequantise would not be exact) and
    takes the 16-bit extremes."""
    c = jpeg.read(jpeg.encode(_picture(16, 16, 6), 80))
    coef = torch.from_numpy(c.coef)[None]
    quant = torch.from_numpy(c.quant)[None].clone()
    quant[0, -1, 0] = value
    with pytest.raises(ValueError, match="16 bits"):
        pixels.pixels(coef, quant, c.geometry)
    quant[0, -1, 0] = pixels.QUANT_MAX
    quant[0, 0, 0] = -pixels.QUANT_MAX
    assert torch.equal(pixels.pixels(coef, quant, c.geometry),
                       pixels.pixels_plain(coef, quant, c.geometry))


def test_geometry_record_matches_the_cuda_struct():
    """kernels/jpeg.geometry_record lays out csrc/jpeg_pixels.cu's
    JpegGeom: 9 scalars, then 8 arrays of 4 (kMaxComps: CMYK and YCCK),
    with the values the kernel reads (MCUs, the largest factors, each
    component's factors, first block, real samples, ratios and fancy
    flag: h2v1 / h2v2 fancy where more than 2 samples wide, h1v2 fancy,
    else box replication)."""
    src = (ROOT / "mapping_tpu_torch" / "csrc" / "jpeg_pixels.cu").read_text()
    body = src[src.index("struct JpegGeom {"):].split("};")[0]
    scalars = body.split(";")[0].split("{")[1].count(",") + 1
    arrays = body.count("[4]")
    assert (scalars, arrays) == (9, 8)
    assert "constexpr int kMaxComps = 4;" in src
    assert pixels.GEOM_INTS == 9 + 4 * 8
    g = jpeg.read(jpeg.encode(_picture(9, 30, 7), 80, "4:2:2")).geometry
    rec = list(pixels.geometry_record(g))
    assert len(rec) == pixels.GEOM_INTS
    assert rec[:9] == [3, 9, 30, g.n_blocks, 1, 2, 2, 2, 1]
    arrays = [rec[9 + 4 * i:13 + 4 * i] for i in range(8)]
    assert arrays == [[2, 1, 1, 0], [1, 1, 1, 0], list(g.first_block) + [0],
                      [9, 9, 9, 0], [30, 15, 15, 0], [1, 2, 2, 0],
                      [1, 1, 1, 0], [0, 1, 1, 0]]
    gray = jpeg.read(jpeg.encode(_picture(5, 3, 7)[..., 0], 80)).geometry
    rec = list(pixels.geometry_record(gray))
    assert rec[:9] == [1, 5, 3, 1, 0, 1, 1, 1, 1]
    assert rec[9:13] == [1, 0, 0, 0]  # unused components are zero
    ycck = jpeg.read((CORPUS / "ycck_2x2.jpg").read_bytes()).geometry
    rec = list(pixels.geometry_record(ycck))
    assert rec[0] == 4 and rec[4] == pixels.COLORS["ycck"] == 4
    arrays = [rec[9 + 4 * i:13 + 4 * i] for i in range(8)]
    assert arrays[0] == [2, 1, 1, 2] and arrays[5] == [1, 2, 2, 1]
    assert arrays[7] == [0, 1, 1, 0]
    box = jpeg.read((CORPUS / "s411.jpg").read_bytes()).geometry
    arrays = [v for v in pixels.geometry_record(box)][9:]
    assert arrays[20:24] == [1, 4, 4, 0]  # ratio_h
    assert arrays[28:32] == [0, 0, 0, 0]  # box replication, no halo


def _pass(d, shift, dtype):
    """One plain islow pass over the columns of d (8, N) in `dtype`."""
    return torch.stack(pixels._islow_1d(
        [torch.as_tensor(d[k], dtype=dtype) for k in range(8)], shift)
    ).to(torch.int64)


def test_32_bit_first_idct_pass_is_exact_within_its_bound():
    """The kernel's 32-bit first pass (csrc/jpeg_pixels.cu kPass1Max):
    its outputs T + 2^10 = sum(w d) + 2^10 fit an int32 while every
    |d| <= (2^31 - 1 - 2^10) / 61,214 (the largest sum of |w| over the
    outputs), so the pass in int32 (modulo 2^32) equals the C
    definition's int64 on random inputs and on every output's extreme
    corner (d = sign(w) times the bound); one past the bound, the extreme
    output overflows and the two differ, which is why a column past it
    takes the 64-bit path."""
    w = pixels.islow_weights()
    gain = pixels.islow_gain()
    assert gain == 61214 == int(w.abs().sum(1).max())
    limit = (2 ** 31 - 1 - 2 ** 10) // gain
    assert pixels.PASS1_LIMIT == limit
    src = (ROOT / "mapping_tpu_torch" / "csrc" /
           "jpeg_pixels.cu").read_text()
    assert f"constexpr int kPass1Max = {limit};" in src
    rng = np.random.RandomState(11)
    d = rng.randint(-limit, limit + 1, (8, 20000))
    corners = torch.sign(w).T.numpy() * limit  # (inputs, outputs)
    d = np.concatenate([d, corners, -corners], axis=1)
    np.testing.assert_array_equal(_pass(d, 11, torch.int32).numpy(),
                                  _pass(d, 11, torch.int64).numpy())
    past = torch.sign(w).T.numpy() * (limit + 1)
    worst = int(w.abs().sum(1).argmax())
    assert _pass(past, 11, torch.int32)[worst, worst] \
        != _pass(past, 11, torch.int64)[worst, worst]


def test_32_bit_second_idct_pass_is_exact_after_the_range_limit():
    """The kernel's second pass runs in int32 (modulo 2^32) for any
    inputs: the range limit reads only the low 10 bits of (T + 2^17) >>
    18, bits that the modular sum keeps. On int32 inputs across their
    whole range, where the int32 outputs themselves are wrong, the range
    limited samples equal the int64 definition's."""
    rng = np.random.RandomState(18)
    d = rng.randint(-2 ** 31, 2 ** 31, (8, 20000))
    d[:, :8] = torch.sign(pixels.islow_weights()).T.numpy() * (2 ** 31 - 1)
    got, want = _pass(d, 18, torch.int32), _pass(d, 18, torch.int64)
    assert not torch.equal(got, want)
    assert torch.equal(pixels.range_limit(got), pixels.range_limit(want))


def test_halo_rows_are_the_passes_linear_form():
    """A halo block's one needed row is decoded as dot products with the
    pass's linear weights (csrc/jpeg_pixels.cu kIslow): those weights
    are the plain pass's, and the dot products equal the pass in int64 on
    random inputs up to the int32 workspace's range."""
    src = (ROOT / "mapping_tpu_torch" / "csrc" /
           "jpeg_pixels.cu").read_text()
    body = src[src.index("kIslow[8][8] = {"):].split("};")[0]
    got = [int(v) for v in body.split("=")[1].replace("{", " ").replace(
        "}", " ").replace(",", " ").split()]
    w = pixels.islow_weights()
    assert got == w.flatten().tolist()
    rng = np.random.RandomState(5)
    d = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (8, 5000)))
    for shift in (11, 18):
        want = _pass(d.numpy(), shift, torch.int64)
        dots = w @ d  # (outputs, N), exact in int64: |sum| < 2^47
        assert torch.equal((dots + (1 << (shift - 1))) >> shift, want)


def test_32_bit_idct_blocks_equal_the_64_bit_definition():
    """Whole blocks (dequantised, pass 1, the C int workspace, pass 2,
    range limit) in int32, as the kernel computes a block whose columns
    are within the first pass's bound, equal idct_blocks' int64: blocks
    at JPEG magnitudes and blocks whose largest coefficient times quant
    value sits on that bound."""
    rng = np.random.RandomState(3)
    coef = (rng.standard_normal((3000, 64)) * 60 /
            (1 + np.arange(64))).round().astype(np.int16)
    quant = rng.randint(1, 64, (3000, 64)).astype(np.int32)
    edge = pixels.PASS1_LIMIT
    coef[:200] = rng.choice([-1, 1], (200, 64)) * (edge // 2)
    quant[:200] = 2
    x = coef.astype(np.int64) * quant
    assert np.abs(x).max() <= edge
    cols = _pass(x.reshape(-1, 8, 8).transpose(1, 0, 2).reshape(8, -1), 11,
                 torch.int32)
    ws = cols.reshape(8, -1, 8).permute(1, 0, 2)  # (block, row, column)
    rows = ws.permute(2, 0, 1).reshape(8, -1)  # inputs along a row
    out = _pass(rows, 18, torch.int32).reshape(8, -1, 8).permute(1, 2, 0)
    want = pixels.idct_blocks(torch.from_numpy(coef), torch.from_numpy(quant))
    assert torch.equal(pixels.range_limit(out).to(torch.uint8), want)


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
    """In a process where jax, flax, PIL, pandas, joblib, sklearn and the
    JAX package cannot be imported and the libjpeg/libpng library does
    not load, every corpus file decodes to the JAX package's digest and
    each refused kind raises a ValueError naming its feature."""
    code = (
        "import sys, json, hashlib\n"
        "for m in ('jax', 'flax', 'PIL', 'pandas', 'joblib', 'sklearn',\n"
        "          'mapping_tpu'):\n"
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
