"""The port's lossless JPEG (SOF3) decoder (utils/jpeg.read over
csrc/jpeg_entropy.cpp jpeg_decode_lossless and jpeg_lossless_rgb) against
the JAX package's loader on the same bytes, exactly:
`mapping_tpu.data.loader.load_image`, which reads these files through
Pillow 12.1.0 and its libjpeg-turbo 3.1.3 (the system's libjpeg-turbo
2.1.5 declines them), and JPEG-compressed TIFF through Pillow's libtiff
4.7.1 over the same libjpeg.

- the lossless files of tests/fixtures/jpeg_corpus and
  tests/fixtures/tiff_corpus, each readable file through `read_image` and
  `assemble` equal to the manifest's JAX digest and to the JAX loader
  here, and in a process with jax, flax, PIL and the JAX package blocked;
  each refused kind raising with its cause named, and refused by the JAX
  loader too;
- hypothesis sweeps of libjpeg-turbo 3.1.3's own lossless files
  (tests/fixtures/jpeg_corpus/write_jpeg.cpp built against Pillow's
  library: predictors 1-7, point transforms 0-7, 1, 3 and 4 components,
  restarts, scan scripts, sizes from 1 x 1) and of the fixture writer's
  (tests/fixtures/jpeg_corpus/lossless.py: sampling factors up to 4,
  scans of any grouping, restart intervals, component ids);
- seeded cuts, byte flips and stray markers; the header bytes Pillow's own
  parser refuses; what follows a one-scan image (libjpeg's read_markers in
  jpeg_finish_decompress);
- lossless strips and tiles of TIFF files in each photometric, and a
  batch of them beside lossy JPEG through `assemble`;
- `predict_on_dir` over lossless tiles against the same pixels as PNG and
  against the JAX `predict_on_dir`, and a lossless request body through
  the port's HTTP daemon against the JAX daemon's answer."""

import functools
import hashlib
import json
import re
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mapping_tpu.infer import daemon as jax_daemon
from mapping_tpu_torch.infer.daemon import (ServingDaemon,
                                            decode_request_image)
from mapping_tpu_torch.kernels import jpeg as pixels
from mapping_tpu_torch.utils import jpeg, native_decode, png
from tests.fixtures.jpeg_corpus import lossless
from tests.fixtures.tiff_corpus.make_corpus import jpeg_tiff, lossless_stream
from tests.test_torch_bmp import _digest, _jax, same_as_jax
from tests.test_torch_daemon import (CAT_IDS, CAT_LAYERS, HW,
                                     _assert_same_annotations, _batcher,
                                     _images, _jax_preprocess, _jax_serve,
                                     _post)
from tests.torch_guards import drop_tmp_path  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CORPORA = {c: ROOT / "tests" / "fixtures" / c
           for c in ("jpeg_corpus", "tiff_corpus")}
MANIFESTS = {c: json.loads((p / "manifest.json").read_text())
             for c, p in CORPORA.items()}


def _lossless(name):
    return name.startswith(("lossless", "tile300_lossless", "jpeg_lossless"))


FILES = [(c, n) for c, m in MANIFESTS.items() for n in sorted(m)
         if _lossless(n)]


@functools.lru_cache(maxsize=None)
def _writer():
    """write(img, **keys) through write_jpeg.cpp built against the
    libjpeg-turbo 3.1.3 that Pillow bundles (as make_corpus.py builds
    it)."""
    from tests.fixtures.jpeg_corpus import make_corpus

    return make_corpus.writer(lossless=True)


def _same(data):
    return same_as_jax(data, ".jpg")


def _picture(h, w, c, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([40 + 120 * x / w, 60 + 100 * y / h,
                     np.full((h, w), 90.0), 30 + 50 * x / w], -1)[..., :c]
    img = np.clip(base + rng.randint(0, 40, base.shape), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if c == 1 else img


# ------------------------------------------------------------ the corpora

@pytest.mark.parametrize("corpus,name", FILES)
def test_corpus_file_reads_as_the_jax_loader(corpus, name):
    """Each lossless file of the two corpora: through `read_image` and
    `assemble` on the CPU to the manifest's JAX digest and to the JAX
    loader's pixels now; each refused kind raising naming its cause, and
    refused by the JAX loader too."""
    entry = MANIFESTS[corpus][name]
    path = CORPORA[corpus] / name
    data = path.read_bytes()
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]
    want = _jax(data, path.suffix)
    if "refused" in entry:
        with pytest.raises(ValueError, match=re.escape(entry["refused"])):
            native_decode.read_image(path)
        assert want is None and "jax_reads" not in entry
        return
    got = native_decode.decode_rgb_batch([path], "cpu")[0].numpy()
    assert list(got.shape) == entry["shape"]
    assert _digest(got) == entry["decode_sha256"]
    np.testing.assert_array_equal(got, want)


def test_corpus_covers_every_kind():
    """Predictors 1-7 and point transforms, RGB, CMYK, subsampling up to
    4, scans, restarts, DRI between scans, a DNL segment, an early EOI, bad
    codes, the 9 tiles of phase 21; TIFF strips, tiles, MinIsWhite with
    Orientation, JPEGTables, lossy strips beside lossless ones; and each
    refused kind, none of which the JAX loader reads."""
    names = {n for _, n in FILES}
    for kind in [f"lossless_gray_p{k}" for k in range(1, 8)] + [
            "lossless_rgb_p7_pt2", "lossless_rgb_rows2", "lossless_rgb_scans",
            "lossless_cmyk.", "lossless_cmyk_2x2", "lossless_s2x2",
            "lossless_h4", "lossless_v4", "lossless_ids123", "lossless_1x1",
            "lossless_gray_v2_rst", "lossless_dri_between_scans",
            "lossless_dnl", "lossless_early_eoi", "lossless_bad_code",
            "lossless_rst_resync", "jpeg_lossless_grey_strips",
            "jpeg_lossless_rgb_tiles", "jpeg_lossless_miniswhite",
            "jpeg_lossless_rgb_tables", "jpeg_lossless_between_lossy",
            "jpeg_lossless_last_strip_taller"]:
        assert any(n.startswith(kind) for n in names), kind
    assert sum(n.startswith("tile300_lossless_") for n in names) == 9
    refused = {MANIFESTS[c][n]["refused"] for c, n in FILES
               if "refused" in MANIFESTS[c][n]}
    for kind in ("YCC", "YCCK", "2-bit", "12-bit", "16-bit", "predictor 0",
                 "point transform 8", "bad lossless JPEG scan",
                 "hierarchical lossless", "arithmetic-coded lossless",
                 "restart interval", "truncated", "has no scan",
                 "bad JPEG Huffman table", "Pillow cannot identify",
                 "lossless JPEG in YCC", "16-bit JPEG-compressed TIFF"):
        assert any(kind in r for r in refused), kind
    assert not any("jax_reads" in MANIFESTS[c][n] for c, n in FILES)


def test_corpus_decodes_with_jax_pil_and_the_jax_package_blocked():
    """The lossless files of both corpora through the port in a process
    where jax, flax, PIL and the JAX package cannot be imported: every
    readable file to its digest, every refused kind raising naming its
    cause."""
    code = (
        "import sys, json, hashlib\n"
        "for m in ('jax', 'flax', 'PIL', 'mapping_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from mapping_tpu_torch.utils import native_decode\n"
        f"files = {[(str(CORPORA[c]), n) for c, n in FILES]!r}\n"
        "n = refused = 0\n"
        "for corpus, name in files:\n"
        "    e = json.loads((Path(corpus) / 'manifest.json').read_text())"
        "[name]\n"
        "    if 'refused' in e:\n"
        "        try:\n"
        "            native_decode.decode_rgb(Path(corpus) / name)\n"
        "        except ValueError as err:\n"
        "            assert e['refused'] in str(err), (name, err)\n"
        "            refused += 1\n"
        "        continue\n"
        "    rgb = native_decode.decode_rgb(Path(corpus) / name)\n"
        "    assert hashlib.sha256(np.ascontiguousarray(rgb).tobytes())"
        ".hexdigest() == e['decode_sha256'], name\n"
        "    n += 1\n"
        "print(n, refused)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n, refused = map(int, out.stdout.split())
    total = sum("refused" in MANIFESTS[c][m] for c, m in FILES)
    assert (n, refused) == (len(FILES) - total, total)


def test_read_gives_pixels_of_a_lossless_frame_coefficients_else():
    """`jpeg.read` gives a lossless frame's (H, W, 3) uint8 RGB, decoded
    wholly on the host, and a DCT frame's `Coefficients`; three
    components without a JFIF or Adobe marker are RGB in a lossless frame
    (libjpeg-turbo 3.1's rule), YCbCr in a DCT one."""
    data = (CORPORA["jpeg_corpus"] / "lossless_ids123.jpg").read_bytes()
    rgb = jpeg.read(data)
    assert (rgb.shape, rgb.dtype) == ((29, 35, 3), np.uint8)
    lossy = jpeg.read(jpeg.encode(rgb, 90))
    assert isinstance(lossy, jpeg.Coefficients)
    assert (lossy.geometry.height, lossy.geometry.width) == (29, 35)
    comps = tuple(jpeg._Component(i, 1, 1, 0, 1) for i in (1, 2, 3))
    assert jpeg._colour(comps, False, None, lossless=True) == "rgb"
    assert jpeg._colour(comps, False, None) == "ycc"
    assert jpeg._colour(comps, True, None, lossless=True) == "ycc"
    assert native_decode.releases_gil("tile.jpg")


def test_twelve_bit_lossless_tiff_is_a_gap():
    """12-bit lossless strips in a TIFF: the port refuses them naming the
    precision, while the JAX loader reads them (Pillow opens them as
    I;16); its pixels differed from process to process in the probes
    (ROADMAP queue 1), so no digest is kept."""
    img = _picture(20, 24, 1, 7)

    def stream(block):
        return lossless.encode([block[..., 0].astype(np.int64) << 4],
                               [(1, 1)], 1, precision=12)

    data = jpeg_tiff(img, stream, 1, rows=8, bits=12)
    with pytest.raises(ValueError, match="12-bit JPEG-compressed TIFF"):
        native_decode.read_bytes(data)
    assert _jax(data, ".tif") is not None


# -------------------------------------------------------- drawn files

@st.composite
def library_files(draw):
    """libjpeg-turbo 3.1.3's lossless files: 1, 3 or 4 components in
    their own colour space, 1 x 1 sampling (its compressor's only one),
    restarts every few MCU rows, scan scripts of one component a scan."""
    c = draw(st.sampled_from([1, 3, 4]))
    h, w = draw(st.integers(1, 40)), draw(st.integers(1, 40))
    keys = dict(lossless=draw(st.integers(1, 7)), pt=draw(st.integers(0, 7)))
    rows = draw(st.integers(0, 3))
    if rows:
        keys["rows"] = rows
    if c > 1 and draw(st.booleans()):
        keys["script"] = ";".join(
            f"{k}:{draw(st.integers(1, 7))}:0:0:{draw(st.integers(0, 7))}"
            for k in range(c))
    return _writer()(_picture(h, w, c, draw(st.integers(0, 999))), **keys)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=library_files())
def test_library_files_read_as_the_jax_loader(data):
    assert _same(data) is not None


@st.composite
def hand_files(draw):
    """The fixture writer's files: sampling factors 1, 2 or 4 a component
    (integral ratios), an interleaved scan or scans of any grouping,
    restart intervals (a multiple of the MCUs of a row, or not: refused by
    both), RGB or numbered component ids, with or without an Adobe
    marker."""
    c = draw(st.sampled_from([1, 3, 4]))
    factors = [(draw(st.sampled_from([1, 2, 4])),
                draw(st.sampled_from([1, 2, 4]))) for _ in range(c)]
    h, w = draw(st.integers(1, 30)), draw(st.integers(1, 30))
    hmax, vmax = max(a for a, _ in factors), max(b for _, b in factors)
    rng = np.random.RandomState(draw(st.integers(0, 999)))
    planes = [rng.randint(0, 256, (-(-h * b // vmax), -(-w * a // hmax)))
              for a, b in factors]
    order = list(range(c))
    scans = None
    if c > 1 and draw(st.booleans()):
        order = draw(st.permutations(order))
        cut = draw(st.integers(1, c))
        scans = [sorted(order[:cut])] + ([sorted(order[cut:])]
                                         if order[cut:] else [])
    width = -(-w // hmax) if scans is None and c > 1 else planes[0].shape[1]
    restart = draw(st.sampled_from([0, width, 2 * width, width + 1]))
    ids = list(b"RGB") if c == 3 and draw(st.booleans()) else None
    markers = lossless.segment(0xEE, b"Adobe\x00\x64" + bytes(5)) \
        if draw(st.booleans()) else b""
    return lossless.encode(planes, factors, draw(st.integers(1, 7)),
                           draw(st.integers(0, 7)), ids=ids, scans=scans,
                           restart=restart, markers=markers, height=h,
                           width=w)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=hand_files())
def test_hand_written_files_read_as_the_jax_loader(data):
    _same(data)


# ------------------------------------------------------- corrupt files

_BASES = ["lossless_gray_p4.jpg", "lossless_rgb_rows2.jpg",
          "lossless_rgb_scans.jpg", "lossless_cmyk_2x2.jpg",
          "lossless_gray_v2_rst.jpg", "lossless_h4.jpg"]


@pytest.mark.parametrize("kind", ["cut", "flip", "marker"])
@pytest.mark.parametrize("name", _BASES)
def test_cut_flipped_and_marked_files_read_as_the_jax_loader(name, kind):
    """Seeded cuts (Pillow's source suspends at the end of the data and
    Pillow fails the file), byte flips, and a stray marker inserted in
    the data or the header (libjpeg's zeros and predictor resets after a
    marker, its restart resync, a segment read from entropy-coded bytes
    after a one-scan image): the port reads what the JAX loader reads and
    refuses what it refuses."""
    data = (CORPORA["jpeg_corpus"] / name).read_bytes()
    rng = np.random.RandomState(len(name) * 3 + len(kind))
    read = 0
    for _ in range(15):
        case = bytearray(data)
        if kind == "cut":
            case = case[:rng.randint(2, len(data))]
        elif kind == "flip":
            for _ in range(rng.randint(1, 4)):
                case[rng.randint(len(case))] = rng.randint(256)
        else:
            at = rng.randint(2, len(case))
            case[at:at] = bytes([0xFF, rng.choice(
                [0xD0, 0xD3, 0xD9, 0xDC, 0xFE, 0xC4, 0xDD, 0xDB, 0xCC, 0xDA,
                 0xC0, 0x01, 0x00, 0xFF, 0xE1, 0xEE])])
        read += _same(bytes(case)) is not None
    assert read or kind == "cut"


def _header(data, marker, body):
    """`data` with a segment of `marker` inserted right after SOI."""
    return data[:2] + lossless.segment(marker, body) + data[2:]


_GREY = lossless.encode([np.arange(63).reshape(7, 9)], [(1, 1)], 2)
HEADERS = {
    "no marker after SOI": b"\xff\xd8\x00" + _GREY[2:],
    "fill before a marker": _GREY[:2] + b"\xff\xff" + _GREY[2:],
    "junk between markers": _GREY[:2] + b"\xff\xfe\x00\x02\x17\x17"
                            + _GREY[2:],
    "TEM": _GREY[:2] + b"\xff\xfe\x00\x02\xff\x01" + _GREY[2:],
    "JFIF of 6 bytes": _header(_GREY, 0xE0, b"JFIF\x00\x01"),
    "JFIF of 7 bytes": _header(_GREY, 0xE0, b"JFIF\x00\x01\x02"),
    "Adobe of 6 bytes": _header(_GREY, 0xEE, b"Adobe\x00"),
    "APP1 of length 0": _GREY[:2] + b"\xff\xe1\x00\x00" + _GREY[2:],
    "short ICC profile": _header(_GREY, 0xE2, b"ICC_PROFILE\x00\x01"),
    "whole ICC profile": _header(_GREY, 0xE2, b"ICC_PROFILE\x00\x01\x01ab"),
    "Photoshop block cut in its name": _header(
        _GREY, 0xED, b"Photoshop 3.0\x008BIM\x04\x04"),
    "Photoshop block cut in its size": _header(
        _GREY, 0xED, b"Photoshop 3.0\x008BIM\x04\x04\x00\x00\x00"),
    "DQT cut": _header(_GREY, 0xDB, b"\x00" + bytes(40)),
    "DQT of 16 bits": _header(_GREY, 0xDB, b"\x10" + bytes(128)),
    "DQT of precision 2": _header(_GREY, 0xDB, b"\x20" + bytes(128)),
}


@pytest.mark.parametrize("case", sorted(HEADERS))
def test_headers_read_as_pillow_parses_them(case):
    """Pillow's own header walk (JpegImagePlugin._open) runs before
    libjpeg: what it refuses, the JAX loader refuses though libjpeg would
    read it; the port follows it for bare lossless files."""
    _same(HEADERS[case])


_ONE_SCAN = _GREY[:-2]
TAILS = {
    "DQT of precision 2": b"\xff\xdb\x00\x83\x20" + bytes(128),
    "DQT short": b"\xff\xdb\x00\x20\x00" + bytes(29),
    "DQT short and cut": b"\xff\xdb\x00\x20\x00" + bytes(10),
    "DQT table 5": b"\xff\xdb\x00\x43\x05" + bytes(64),
    "DRI of length 3": b"\xff\xdd\x00\x03\x00",
    "DRI of length 3, cut": b"\xff\xdd\x00\x03",
    "DRI": b"\xff\xdd\x00\x04\x00\x05",
    "DAC odd": b"\xff\xcc\x00\x05\x00\x10\x01",
    "DAC L above U": b"\xff\xcc\x00\x04\x00\x01",
    "APP of length 0": b"\xff\xe1\x00\x00\xff\xd9",
    "APP of length 1, then SOF": b"\xff\xe1\x00\x01\xff\xc0\x00\x11",
    "COM past the end": b"\xff\xfe\xff\xff\x00",
    "SOF": b"\xff\xc0",
    "JPG": b"\xff\xc8",
    "TEM": b"\xff\x01\xff\xd9",
    "RST": b"\xff\xd3\xff\xd9",
    "SOS": b"\xff\xda\x00\x08\x01\x01\x00\x01\x00\x00",
    "SOS cut": b"\xff\xda\x00\x08\x01\x01",
    "SOS of a bad component, cut": b"\xff\xda\x00\x08\x01\x07",
    "SOS of a bad length": b"\xff\xda\x00\x09\x01",
    "DHT counts past 256, cut": b"\xff\xc4\x00\x30\x00" + bytes([255] * 16),
    "DHT class 2": b"\xff\xc4\x00\x14\x20" + bytes([1] + [0] * 15) + b"\x00",
    "DHT of 10 bytes": b"\xff\xc4\x00\x0c" + bytes(10),
    "DNL": b"\xff\xdc\x00\x04\x00\x09\xff\xd9",
    "SOI": b"\xff\xd8",
    "reserved marker": b"\xff\x02",
    "EOI, then a SOF": b"\xff\xd9\xff\xc0",
}


@pytest.mark.parametrize("case", sorted(TAILS))
def test_what_follows_a_one_scan_image_reads_as_libjpeg(case):
    """After the only scan of a one-scan image, libjpeg's read_markers
    (jpeg_finish_decompress) reads on to EOI: its errors fail the file,
    a segment cut by the end of the data only suspends it, and Pillow
    keeps the image."""
    _same(_ONE_SCAN + TAILS[case])


# ------------------------------------------------------------------ TIFF

@pytest.mark.parametrize("photometric", [0, 1, 2])
@pytest.mark.parametrize("layout", ["strips", "tiles", "orientation",
                                    "tables"])
def test_tiff_strips_and_tiles_read_as_the_jax_loader(photometric, layout):
    """Lossless strips and tiles in a TIFF (compression 7), as libtiff
    reads them: grey, MinIsWhite (inverted) and RGB; tiles clipped at the
    edges, a short last strip, Orientation, Huffman tables in JPEGTables
    with restarts in the streams."""
    img = _picture(23, 37, 3 if photometric == 2 else 1, photometric + 5)
    keys = dict(rows=8)
    stream = lossless_stream(photometric + 3, photometric)
    if layout == "tiles":
        keys = dict(tile=(16, 16))
    elif layout == "orientation":
        keys["extra"] = [(274, 3, [5 + photometric])]
    elif layout == "tables":
        tables = lossless.encode([np.zeros((1, 1), np.uint8)], [(1, 1)])
        keys["tables"] = tables[:4 + int.from_bytes(tables[4:6], "big")] \
            + b"\xff\xd9"
        stream = lossless_stream(4, restart=37 * 2, dht=False)
    data = jpeg_tiff(img, stream, photometric, **keys)
    assert same_as_jax(data, ".tif") is not None


def test_assemble_pastes_lossless_parts_beside_lossy_ones(monkeypatch):
    """A batch of a lossy JPEG, a lossless JPEG, a lossless TIFF and a TIFF
    of lossy and lossless strips: one pixel-stage call per lossy
    geometry, the lossless parts pasted as the host decoded them, each
    image equal to its own decode."""
    calls = []
    plain = pixels.pixels

    def counted(coef, quant, geometry):
        calls.append(geometry)
        return plain(coef, quant, geometry)

    img = _picture(32, 40, 3, 11)
    lossy = jpeg.encode(img, 90, "4:4:4", color="rgb", jfif=False)
    bare = lossless.encode([img[..., k] for k in range(3)], [(1, 1)] * 3, 5,
                           ids=list(b"RGB"))
    whole = jpeg_tiff(img, lossless_stream(3), 2, rows=16)
    mixed = jpeg_tiff(img[:24], [
        jpeg.encode(img[:16], 90, "4:4:4", color="rgb", jfif=False),
        lossless_stream(6)(img[16:24])], 2, rows=16)
    items = [native_decode.read_bytes(d) for d in (lossy, bare, whole, mixed)]
    monkeypatch.setattr(pixels, "pixels", counted)
    batch = native_decode.assemble(items, "cpu", size=(32, 40)).numpy()
    assert sorted((g.height, g.width) for g in calls) == [(16, 40), (32, 40)]
    for got, data in zip(batch[:3], (lossy, bare, whole)):
        np.testing.assert_array_equal(got, _jax(data, ".tif" if data[:2]
                                                == b"II" else ".jpg"))
    alone = native_decode.to_rgb(items[3])
    np.testing.assert_array_equal(alone, _jax(mixed, ".tif"))
    np.testing.assert_array_equal(
        native_decode.assemble([items[3]] * 2, "cpu").numpy(),
        np.stack([alone] * 2))


# -------------------------------------------- predict_on_dir, the daemon

def test_predict_on_dir_over_lossless_tiles_equals_png_and_jax(tmp_path):
    """`predict_on_dir -p unet_weighted` on the CPU over 8 lossless tiles
    (4 of libjpeg-turbo 3.1.3's, RGB predictors 1-4; 4 of the fixture
    writer's, one component sampled 2 x 2) writes the prediction.json it
    writes over PNG tiles of the decoded pixels, and the JAX
    `predict_on_dir` over the same files (tests/test_torch_evaluate.py's
    rule: equal but where float32 rounding may put a pixel on either side
    of the threshold)."""
    from mapping_tpu.manager import PipelineManager as JaxManager
    from mapping_tpu_torch.data.loader import infer_batch_resize
    from mapping_tpu_torch.manager import PipelineManager
    from tests.fixtures.synthetic import _make_image
    from tests.test_torch_evaluate import (PIPELINE, _centred_state_dict,
                                           assert_same_instances,
                                           served_probabilities,
                                           write_config)

    rng = np.random.RandomState(23)
    for fmt in ("jpeg", "png"):
        (tmp_path / fmt).mkdir()
    decoded = []
    for i in range(8):
        tile, _ = _make_image(rng, 96, 96, max_buildings=3)
        if i < 4:
            data = _writer()(tile, lossless=i + 1)
        else:
            planes = [tile[::2, ::2, 0]] + [tile[..., k] for k in (1, 2)]
            data = lossless.encode(planes, [(1, 1), (2, 2), (2, 2)], i,
                                   ids=list(b"RGB"))
        (tmp_path / "jpeg" / f"t{i:02d}.jpg").write_bytes(data)
        decoded.append(native_decode.decode_rgb_bytes(data))
        (tmp_path / "png" / f"t{i:02d}.png").write_bytes(
            png.encode_png(decoded[-1]))
    tiles = np.stack(decoded)
    ckpt = tmp_path / "reference.pth"
    torch.save(_centred_state_dict(infer_batch_resize(
        torch.from_numpy(tiles), (64, 64))), ckpt)
    ws = {"root": tmp_path, "data_dir": tmp_path / "data", "tiles": tiles}
    JaxManager(write_config(ws, "jax_cache", {})).import_checkpoint(
        str(ckpt), PIPELINE)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        JaxManager(write_config(ws, "jax_predict", {})).predict_on_dir(
            PIPELINE, str(tmp_path / "jpeg"), str(tmp_path / "jax.json"),
            None)
    manager = PipelineManager(write_config(ws, "port_predict", {}))
    for fmt in ("jpeg", "png"):
        manager.predict_on_dir(PIPELINE, str(tmp_path / fmt),
                               str(tmp_path / f"{fmt}.json"), None)
    got = json.loads((tmp_path / "jpeg.json").read_text())
    assert got == json.loads((tmp_path / "png.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert {p["image_id"] for p in got} <= set(range(8)) and got
    assert_same_instances(got, want, served_probabilities(ws, PIPELINE, {}),
                          range(8))


def test_http_lossless_body_matches_the_jax_daemon():
    """A lossless JPEG request body through the port's HTTP daemon: its
    tile equals the JAX daemon's decode (Pillow), and so does the
    answer."""
    img = _images(1, seed=35)[0]
    body = _writer()(img, lossless=7)
    np.testing.assert_array_equal(
        decode_request_image(body, "image/jpeg", HW),
        jax_daemon.decode_request_image(body, "image/jpeg", HW))
    headers = {"Content-Type": "image/jpeg", "X-Image-Id": "9"}
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
