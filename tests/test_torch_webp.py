"""The port's WebP reader (mapping_tpu_torch/utils/webp.py over
csrc/webp_decode.cpp) against the JAX package's loader on the same bytes,
exactly: `mapping_tpu.data.loader.load_image`, which reads WebP through
Pillow (libwebp's WebPAnimDecoder) and convert("RGB").

- the corpus `tests/fixtures/webp_corpus` (lossy with both loop filters,
  several partitions and segments, lossless with each transform and
  palettes, alpha raw and compressed with each filter, VP8X, animations,
  truncated and corrupt cuts), each readable file equal to the manifest's
  JAX digest and to the JAX loader here, through `read_bytes` and in a
  process with jax, flax and PIL blocked; each refused kind raising with
  its cause named and the manifest's record of whether the JAX loader
  reads it;
- the VP8 and VP8L constant tables of csrc/webp_decode.cpp against the
  bytes of the libwebp that Pillow ships (skipped where there is none);
- a hypothesis sweep of sizes, qualities, methods and lossless, and
  seeded cuts and byte flips of lossy, lossless and alpha streams, each
  read as the JAX loader reads it or refused where it raises;
- `predict_on_dir` over lossless and lossy WebP tiles against the same
  pixels as PNG and against the JAX `predict_on_dir`, and a WebP request
  body through the port's HTTP daemon against the JAX daemon's answer."""

import hashlib
import io
import json
import re
import struct
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from mapping_tpu.data.loader import load_image
from mapping_tpu.infer import daemon as jax_daemon
from mapping_tpu_torch.infer.daemon import (ServingDaemon,
                                            decode_request_image)
from mapping_tpu_torch.utils import native_decode, png, webp
from tests.test_torch_daemon import (CAT_IDS, CAT_LAYERS, HW,
                                     _assert_same_annotations, _batcher,
                                     _images, _jax_preprocess, _jax_serve,
                                     _post)
from tests.torch_guards import drop_tmp_path  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "fixtures" / "webp_corpus"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _jax(data):
    """The JAX loader's RGB of the bytes, or None where it raises."""
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".webp") as f:
        f.write(data)
        f.flush()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                return load_image(f.name)
            except Exception:
                return None


def _same_as_jax(data):
    """The port's decode equals the JAX loader's, or both refuse."""
    want = _jax(data)
    try:
        got = native_decode.decode_rgb_bytes(data)
    except ValueError:
        got = None
    assert (want is None) == (got is None), (want is None, got is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    return got


def _encode(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _picture(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([30 + 150 * x / max(w, 1), 50 + 120 * y / max(h, 1),
                    80 + 70 * np.sin(x / 4.0 + y / 6.0)], -1)
    img = img + rng.randint(0, 40, (h, w, 3))
    img[h // 3:h // 2 + 1, w // 4:w // 2 + 1] = rng.randint(160, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_corpus_reads_as_the_jax_loader(name):
    entry = MANIFEST[name]
    data = (CORPUS / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]
    want = _jax(data)
    if "refused" in entry:
        with pytest.raises(ValueError, match=re.escape(entry["refused"])):
            native_decode.read_bytes(data)
        assert (want is not None) == ("jax_reads" in entry)
        if want is not None:
            assert _digest(want) == entry["jax_reads"]
        return
    got = native_decode.read_bytes(data)
    assert list(got.shape) == entry["shape"]
    assert _digest(got) == entry["decode_sha256"]
    np.testing.assert_array_equal(got, want)


def test_corpus_covers_every_kind():
    """The corpus holds what the decoder must read: both lossy loop
    filters, 2, 4 and 8 partitions, segments, every lossless transform
    and palette bundling, alpha with each filter raw and compressed, VP8X
    metadata, a first animation frame smaller than its canvas, cuts."""
    names = set(MANIFEST)
    for kind in ("lossy_simple_filter", "lossy_strong_filter",
                 "lossy_partitions2", "lossy_partitions4",
                 "lossy_partitions8", "lossy_segments4", "lossy_1x1",
                 "lossy_17x33", "lossy_q95_301x299", "lossless_palette2",
                 "lossless_palette4", "lossless_palette16",
                 "lossless_palette256", "alpha_gradient_lossless",
                 "alpha_gradient_raw", "alpha_vertical_raw",
                 "alpha_horizontal_lossless", "alpha_none_raw",
                 "vp8x_icc_exif_xmp", "anim_small_first_frame",
                 "anim_two_frames", "cut_", "corrupt_"):
        assert any(n.startswith(kind) for n in names), kind
    assert sum("refused" in e for e in MANIFEST.values()) >= 15
    assert sum("refused" not in e for e in MANIFEST.values()) >= 50


def test_corpus_decodes_with_jax_and_pil_blocked():
    """The corpus through the port in a process where jax, flax and PIL
    cannot be imported: every file read to its digest, every refused kind
    raising with its cause named."""
    code = (
        "import sys, json, hashlib\n"
        "for m in ('jax', 'flax', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from mapping_tpu_torch.utils import native_decode\n"
        f"corpus = Path({str(CORPUS)!r})\n"
        "manifest = json.loads((corpus / 'manifest.json').read_text())\n"
        "n = refused = 0\n"
        "for name, e in manifest.items():\n"
        "    if 'refused' in e:\n"
        "        try:\n"
        "            native_decode.decode_rgb(corpus / name)\n"
        "        except ValueError as err:\n"
        "            assert e['refused'] in str(err), (name, err)\n"
        "            refused += 1\n"
        "        continue\n"
        "    rgb = native_decode.decode_rgb(corpus / name)\n"
        "    assert hashlib.sha256(np.ascontiguousarray(rgb).tobytes())"
        ".hexdigest() == e['decode_sha256'], name\n"
        "    n += 1\n"
        "print(n, refused)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n, refused = map(int, out.stdout.split())
    assert n == sum("refused" not in e for e in MANIFEST.values())
    assert refused == sum("refused" in e for e in MANIFEST.values())


# ------------------------------------------------------- constant tables

_TABLES = ("kDcTable", "kAcTable", "CoeffsProba0", "CoeffsUpdateProba",
           "kBModesProba", "kCodeToPlane", "kZigzag", "kBands",
           "kCodeLengthOrder")


def _table_bytes(name):
    src = (ROOT / "mapping_tpu_torch" / "csrc" / "webp_decode.cpp"
           ).read_text()
    m = re.search(r"constexpr (uint8_t|uint16_t) %s\[[^=]*= \{(.*?)\};"
                  % name, src, re.S)
    values = [int(v, 0) for v in re.findall(
        r"0x[0-9a-fA-F]+|\d+", re.sub(r"//[^\n]*", "", m.group(2)))]
    dtype = np.dtype("<u2") if m.group(1) == "uint16_t" else np.uint8
    return np.array(values, dtype).tobytes(), len(values)


def _pillow_libwebp():
    import PIL

    libs = Path(PIL.__file__).resolve().parents[1] / "pillow.libs"
    return sorted(libs.glob("libwebp-*.so*"))


@pytest.mark.parametrize("name", _TABLES)
def test_tables_are_libwebps(name):
    """Each table of the decoder (RFC 6386's quantiser, coefficient and
    4x4-mode probabilities, the VP8L distance map, zigzag, bands and the
    code-length order) occurs verbatim in the libwebp that Pillow ships,
    which the JAX loader decodes with (kAcTable as little-endian uint16):
    a wrong entry would otherwise show only on the streams that use it."""
    libs = _pillow_libwebp()
    if not libs:
        pytest.skip("no libwebp shipped with Pillow here")
    blob = libs[0].read_bytes()
    table, count = _table_bytes(name)
    assert count == {"kDcTable": 128, "kAcTable": 128, "CoeffsProba0": 1056,
                     "CoeffsUpdateProba": 1056, "kBModesProba": 900,
                     "kCodeToPlane": 120, "kZigzag": 16, "kBands": 17,
                     "kCodeLengthOrder": 19}[name]
    assert blob.find(table) >= 0, name


# ------------------------------------------------------ sweeps and cuts

@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       quality=st.integers(0, 100), method=st.integers(0, 6),
       lossless=st.booleans(), alpha=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_encoded_sweep_reads_as_the_jax_loader(h, w, quality, method,
                                               lossless, alpha, seed):
    img = _picture(h, w, seed)
    if alpha:
        img = np.dstack([img, np.random.RandomState(seed).randint(
            0, 256, (h, w)).astype(np.uint8)])
    data = _encode(img, quality=quality, method=method, lossless=lossless)
    assert _same_as_jax(data) is not None


def _with_payload_cut(data, n):
    """`data` with its last chunk's payload cut to n bytes and the chunk
    and RIFF sizes made to agree, so that the bitstream itself runs out."""
    pos, last = 12, None
    while pos + 8 <= len(data):
        size = struct.unpack_from("<I", data, pos + 4)[0]
        last = (pos, size)
        pos += 8 + size + (size & 1)
    at, size = last
    out = bytearray(data[:at + 8 + min(n, size)])
    out[at + 4:at + 8] = struct.pack("<I", min(n, size))
    out += b"\0" * (min(n, size) & 1)
    out[4:8] = struct.pack("<I", len(out) - 8)
    return bytes(out)


@pytest.mark.parametrize("kind", ["lossy", "lossless", "palette", "alpha"])
def test_cut_and_flipped_streams_read_as_the_jax_loader(kind):
    """Seeded cuts of the bitstream (sizes fixed up) and flipped bytes:
    the port reads what the JAX loader reads, byte for byte (libwebp's
    boolean decoder past the data, its SIMD inverse DCT on overflowing
    coefficients), and refuses what it refuses."""
    rng = np.random.RandomState({"lossy": 1, "lossless": 2, "palette": 3,
                                 "alpha": 4}[kind])
    img = _picture(40, 52, 5)
    if kind == "palette":
        img = img // 64 * 64
    if kind == "alpha":
        img = np.dstack([img, (img[..., 0] // 2 + 60)])
    data = _encode(img, quality=80, lossless=kind in ("lossless",
                                                      "palette"))
    start = 30 if data[12:16] == b"VP8X" else 20
    read = refused = 0
    for k in range(30):
        cut = _with_payload_cut(data, int(rng.randint(1, len(data))))
        flipped = bytearray(data)
        at = rng.randint(start, len(data) - 4)
        flipped[at:at + rng.randint(1, 5)] = bytes(
            rng.randint(0, 256, 4).astype(np.uint8))
        for case in (cut, bytes(flipped)):
            if _same_as_jax(case) is None:
                refused += 1
            else:
                read += 1
    assert read and refused


def test_read_bytes_names_webp():
    assert native_decode.releases_gil("tile.webp")
    with pytest.raises(ValueError,
                       match="not a JPEG, PNG, TIFF, WebP, BMP or GIF"):
        native_decode.read_bytes(b"RIFF\x10\x00\x00\x00WAVEfmt " + bytes(8))
    with pytest.raises(ValueError, match="first chunk is not VP8"):
        native_decode.read_bytes(b"RIFF\x10\x00\x00\x00WEBPALPH" + bytes(8))


# ------------------------------------------------ predict_on_dir, daemon

def test_predict_on_dir_over_webp_equals_png_and_jax(tmp_path):
    """`predict_on_dir -p unet_weighted` on the CPU over 8 lossless and 8
    lossy WebP tiles writes the prediction.json it writes over PNG tiles
    of the decoded pixels, and the JAX `predict_on_dir` over the same
    WebP files (the instances of tests/test_torch_evaluate.py's rule: equal
    but where float32 rounding may put a pixel on either side of the
    threshold)."""
    from mapping_tpu.manager import PipelineManager as JaxManager
    from mapping_tpu_torch.data.loader import infer_batch_resize
    from mapping_tpu_torch.manager import PipelineManager
    from tests.fixtures.synthetic import _make_image
    from tests.test_torch_evaluate import (PIPELINE, _centred_state_dict,
                                           assert_same_instances,
                                           served_probabilities,
                                           write_config)

    rng = np.random.RandomState(20)
    for fmt in ("webp", "png"):
        (tmp_path / fmt).mkdir()
    decoded = []
    for i in range(16):
        tile, _ = _make_image(rng, 96, 96, max_buildings=3)
        data = _encode(tile, lossless=True) if i < 8 else _encode(
            tile, quality=[30, 60, 75, 90][i % 4], method=i % 7)
        (tmp_path / "webp" / f"t{i:02d}.webp").write_bytes(data)
        decoded.append(native_decode.decode_rgb_bytes(data))
        (tmp_path / "png" / f"t{i:02d}.png").write_bytes(
            png.encode_png(decoded[-1]))
    tiles = np.stack(decoded)
    np.testing.assert_array_equal(tiles[0], _make_image(
        np.random.RandomState(20), 96, 96, max_buildings=3)[0])
    ckpt = tmp_path / "reference.pth"
    torch.save(_centred_state_dict(infer_batch_resize(
        torch.from_numpy(tiles), (64, 64))), ckpt)
    ws = {"root": tmp_path, "data_dir": tmp_path / "data", "tiles": tiles}
    JaxManager(write_config(ws, "jax_cache", {})).import_checkpoint(
        str(ckpt), PIPELINE)
    JaxManager(write_config(ws, "jax_predict", {})).predict_on_dir(
        PIPELINE, str(tmp_path / "webp"), str(tmp_path / "jax.json"), None)
    manager = PipelineManager(write_config(ws, "port_predict", {}))
    for fmt in ("webp", "png"):
        manager.predict_on_dir(PIPELINE, str(tmp_path / fmt),
                               str(tmp_path / f"{fmt}.json"), None)
    got = json.loads((tmp_path / "webp.json").read_text())
    assert got == json.loads((tmp_path / "png.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert {p["image_id"] for p in got} <= set(range(16)) and got
    assert_same_instances(got, want, served_probabilities(ws, PIPELINE, {}),
                          range(16))


def test_http_webp_body_matches_the_jax_daemon():
    """WebP request bodies (lossy with alpha; lossless) through the port's
    HTTP daemon: each tile equals the JAX daemon's decode (Pillow), and so
    does each answer."""
    img = _images(1, seed=31)[0]
    rgba = np.dstack([img, np.full(img.shape[:2], 200, np.uint8)])
    for body in (_encode(rgba, quality=85), _encode(img, lossless=True)):
        np.testing.assert_array_equal(
            decode_request_image(body, "image/webp", HW),
            jax_daemon.decode_request_image(body, "image/webp", HW))
        headers = {"Content-Type": "image/webp", "X-Image-Id": "5"}
        jax_server = jax_daemon.ServingDaemon(
            jax_daemon.Microbatcher(_jax_serve(), _jax_preprocess, 4,
                                    category_ids=CAT_IDS,
                                    category_layers=CAT_LAYERS,
                                    max_wait_ms=30.0),
            HW, {"batch_size": 4}, port=0)
        server = ServingDaemon(_batcher(), HW, {"batch_size": 4},
                               device="cpu", port=0)
        server.start_background()
        jax_server.start_background()
        try:
            got = _post(f"http://127.0.0.1:{server.port}/v1/predict", body,
                        headers)
            want = _post(f"http://127.0.0.1:{jax_server.port}/v1/predict",
                         body, headers)
            assert got["annotations"]
            _assert_same_annotations(got["annotations"],
                                     want["annotations"])
        finally:
            server.shutdown()
            jax_server.shutdown()
