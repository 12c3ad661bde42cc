"""The port's GIF reader (mapping_tpu_torch/utils/gif.py over
csrc/gif_decode.cpp) against the JAX package's loader on the same bytes,
exactly: `mapping_tpu.data.loader.load_image`, which reads a GIF's first
frame through Pillow's GifImagePlugin and its C LZW decoder, then
convert("RGB").

- the corpus `tests/fixtures/gif_corpus` (Pillow's files, interlaced and
  not, with transparency, comments and two frames; hand-written files with
  global, local and ramp tables, no table, offset and growing frames, code
  sizes 0 to 12, every extension, a full code table, tiny sub-blocks; and
  the kinds Pillow refuses), each readable file equal to the manifest's
  JAX digest and to the JAX loader here, through `read_bytes` and in a
  process with jax, flax and PIL blocked; each refused kind raising with
  its cause named;
- Pillow's decoder quirks, one test each;
- a hypothesis sweep of drawn files, and seeded cuts and byte flips of
  corpus files, each read as the JAX loader reads it or refused where it
  raises;
- a GIF request body through the port's HTTP daemon against the JAX
  daemon's answer. (The loader, `predict_on_dir` and `evaluate` over GIF
  tiles are in tests/test_torch_bmp.py, beside BMP and DIB.)"""

import hashlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from mapping_tpu.infer import daemon as jax_daemon
from mapping_tpu_torch.infer.daemon import (ServingDaemon,
                                            decode_request_image)
from mapping_tpu_torch.utils import gif, native_decode
from tests.fixtures.gif_corpus import make_corpus as corpus
from tests.test_torch_bmp import (_digest, _jax,
                                  decodes_with_jax_and_pil_blocked,
                                  same_as_jax)
from tests.test_torch_daemon import (CAT_IDS, CAT_LAYERS, HW,
                                     _assert_same_annotations, _batcher,
                                     _images, _jax_preprocess, _jax_serve,
                                     _post)

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "fixtures" / "gif_corpus"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())
TABLE = np.random.RandomState(3).randint(0, 256, (256, 3)).astype(np.uint8)


def _gif_jax(data):
    return _jax(data, ".gif")


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_corpus_reads_as_the_jax_loader(name):
    entry = MANIFEST[name]
    data = (CORPUS / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]
    want = _gif_jax(data)
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
    names = set(MANIFEST)
    for kind in ("pil_p", "pil_l", "pil_1", "pil_interlaced",
                 "pil_transparency", "pil_two_frames", "gif87a",
                 "global_table", "local_table", "local_ramp_under_global",
                 "global_ramp", "no_table", "index_past_table", "interlaced_h",
                 "offset_frame", "offset_frame_transparency",
                 "frame_grows_screen", "zero_width_frame_at_0",
                 "code_size_0", "code_size_1", "code_size_9", "code_size_12",
                 "table_full_no_clear", "tiny_sub_blocks", "extensions",
                 "netscape_empty_loop_block", "stray_bytes",
                 "two_frames_by_hand", "tile300_", "zeros_after_signature",
                 "early_end_code", "code_past_next", "first_code_past_clear",
                 "code_size_13", "data_cut_", "short_gce"):
        assert any(n.startswith(kind) for n in names), kind
    assert sum("refused" in e for e in MANIFEST.values()) >= 12
    assert not any("jax_reads" in e for e in MANIFEST.values())


def test_corpus_decodes_with_jax_and_pil_blocked():
    decodes_with_jax_and_pil_blocked(CORPUS, MANIFEST)


# ------------------------------------------------------ Pillow's quirks

def test_code_size_1_keeps_two_bit_codes():
    """With a minimum code size of 1 the next free entry (4) starts past
    the code mask (3), so Pillow's codes stay 2 bits wide: literals read,
    and a stream whose codes widen is cut short."""
    idx = np.array([[0, 1, 1, 0, 1]])
    literal = corpus.gif(5, 1, None, 1, TABLE[:2],
                         codes=[(2, 2)] + [(int(v), 2) for v in idx[0]])
    np.testing.assert_array_equal(same_as_jax(literal, ".gif"),
                                  TABLE[idx])
    with pytest.raises(ValueError, match="cut short"):
        gif.decode(corpus.gif(19, 1, np.arange(19) % 2, 1, TABLE[:2]))


def test_an_early_end_code_is_a_truncated_file():
    """Pillow's decoder waits for more data after an end code; the file
    has none, so the JAX loader raises 'image file is truncated'."""
    codes = corpus.lzw(np.arange(40) % 7, 4)
    data = corpus.gif(8, 5, None, 4, TABLE[:16], codes=codes[:9] + codes[-1:])
    assert same_as_jax(data, ".gif") is None
    with pytest.raises(ValueError, match="cut short"):
        gif.decode(data)


def test_outside_the_frame_reads_the_transparency_index():
    """An offset frame: pixels outside read entry 0, or the transparency
    index where a graphic control block gives one."""
    idx = np.arange(6).reshape(2, 3) + 1
    for gce, fill in ((None, 0), ([1, 0, 0, 9], 9)):
        got = same_as_jax(corpus.gif(6, 4, idx, 4, TABLE[:16],
                                     rect=(2, 1, 3, 2), gce=gce), ".gif")
        want = np.full((4, 6), fill)
        want[1:3, 2:5] = idx
        np.testing.assert_array_equal(got, TABLE[want])


def test_ramp_tables_and_width_zero_frames():
    """A local ramp table under a coloured global one reads through the
    global table; a ramp global table alone reads grey; a frame of width
    0 at x = 0 decodes over the whole image."""
    idx = (np.arange(12).reshape(3, 4) * 5) % 16
    ramp = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)
    np.testing.assert_array_equal(
        same_as_jax(corpus.gif(4, 3, idx, 4, TABLE[:16], local_table=ramp),
                    ".gif"), TABLE[idx])
    np.testing.assert_array_equal(
        same_as_jax(corpus.gif(4, 3, idx, 4, ramp), ".gif"),
        np.repeat(idx[..., None], 3, -1))
    whole = same_as_jax(corpus.gif(4, 3, None, 4, TABLE[:16],
                                   rect=(0, 1, 0, 1),
                                   codes=corpus.lzw(idx.reshape(-1), 4)),
                        ".gif")
    np.testing.assert_array_equal(whole, TABLE[idx])


# ------------------------------------------------------ sweeps and cuts

@st.composite
def files(draw):
    """A GIF of drawn screen, tables, frame, interlace, code size,
    extensions and (sometimes) corrupted codes."""
    w, h = draw(st.integers(1, 30)), draw(st.integers(1, 20))
    bits = draw(st.sampled_from((2, 3, 4, 8, 8)))
    rng = np.random.RandomState(draw(st.integers(0, 2 ** 16)))
    n = draw(st.sampled_from((2, 4, 16, 256)))
    table = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    if draw(st.integers(0, 5)) == 0:
        table = np.repeat(np.arange(n, dtype=np.uint8)[:, None], 3, 1)
    global_table = table if draw(st.booleans()) else None
    local_table = None if draw(st.booleans()) else table[::-1].copy()
    if draw(st.booleans()):
        rect = (0, 0, w, h)
    else:
        rect = (draw(st.integers(0, w)), draw(st.integers(0, h)),
                draw(st.integers(1, w + 3)), draw(st.integers(1, h + 3)))
    fw, fh = rect[2], rect[3]
    idx = rng.randint(0, min(1 << bits, 256), (fh, fw))
    if draw(st.booleans()):
        idx[:, fw // 3:] = idx[:, :1]
    gce = [draw(st.sampled_from((0, 1, 5))), 0, 0,
           draw(st.integers(0, 255))] if draw(st.booleans()) else None
    interlaced = draw(st.booleans())
    codes = None
    if draw(st.integers(0, 3)) == 0:
        codes = corpus.lzw(idx.reshape(-1), bits)
        for _ in range(draw(st.integers(1, 3))):
            k = draw(st.integers(1, len(codes) - 1))
            codes[k] = (draw(st.integers(0, (1 << codes[k][1]) - 1)),
                        codes[k][1])
    extensions = draw(st.sampled_from((
        b"", b"!\xfe\x05hello\x00", b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00"
        b"\x00", b"\x00\x2a", b"!\x01\x03abc\x00")))
    return corpus.gif(w, h, idx, bits, global_table, local_table, rect, gce,
                      interlaced, codes, extensions,
                      block=draw(st.sampled_from((255, 7, 1))))


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=files())
def test_drawn_files_read_as_the_jax_loader(data):
    same_as_jax(data, ".gif")


@pytest.mark.parametrize("name", ["pil_p.gif", "pil_interlaced.gif",
                                  "offset_frame_transparency.gif",
                                  "table_full_no_clear.gif",
                                  "pil_two_frames.gif", "extensions.gif"])
def test_cut_and_flipped_files_read_as_the_jax_loader(name):
    """Seeded cuts and flipped bytes past the signature: the port reads
    what the JAX loader reads, byte for byte, and refuses what it
    refuses."""
    data = (CORPUS / name).read_bytes()
    rng = np.random.RandomState(len(name) + 7)
    read = refused = 0
    for _ in range(25):
        cut = data[:rng.randint(6, len(data))]
        flipped = bytearray(data)
        at = rng.randint(6, len(data))
        flipped[at:at + rng.randint(1, 4)] = bytes(
            rng.randint(0, 256, 3).astype(np.uint8))
        for case in (cut, bytes(flipped)):
            if same_as_jax(case, ".gif") is None:
                refused += 1
            else:
                read += 1
    assert read and refused


def test_read_bytes_names_the_gif_refusals():
    with pytest.raises(ValueError, match="no image in the GIF"):
        native_decode.read_bytes(b"GIF89a" + bytes(64))
    with pytest.raises(ValueError, match="screen descriptor cut short"):
        native_decode.read_bytes(b"GIF87a\x01\x00")
    with pytest.raises(ValueError, match="not a GIF"):
        gif.decode(b"GIF90a" + bytes(20))


# ---------------------------------------------------------------- daemon

def test_http_gif_body_matches_the_jax_daemon():
    """A GIF request body through the port's HTTP daemon: its tile equals
    the JAX daemon's decode (Pillow), and so does its answer."""
    img = _images(1, seed=33)[0]
    body = corpus.pillow(Image.fromarray(img).quantize(128))
    np.testing.assert_array_equal(
        decode_request_image(body, "image/gif", HW),
        jax_daemon.decode_request_image(body, "image/gif", HW))
    headers = {"Content-Type": "image/gif", "X-Image-Id": "7"}
    jax_server = jax_daemon.ServingDaemon(
        jax_daemon.Microbatcher(_jax_serve(), _jax_preprocess, 4,
                                category_ids=CAT_IDS,
                                category_layers=CAT_LAYERS, max_wait_ms=30.0),
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
