"""The port's BMP and DIB reader (mapping_tpu_torch/utils/bmp.py over
csrc/bmp_decode.cpp) against the JAX package's loader on the same bytes,
exactly: `mapping_tpu.data.loader.load_image`, which reads BMP through
Pillow's BmpImagePlugin and convert("RGB").

- the corpus `tests/fixtures/bmp_corpus` (every info header size, depth,
  compression and bitfields mask set Pillow reads, top-down rows, grey
  ramps, short palettes, Pillow's RLE quirks, headerless DIB files, and
  the kinds Pillow refuses), each readable file equal to the manifest's JAX
  digest and to the JAX loader here, through `read_bytes` and in a process
  with jax, flax and PIL blocked; each refused kind raising with its cause
  named;
- a hypothesis sweep of drawn layouts, and seeded cuts and byte flips,
  each read as the JAX loader reads it or refused where it raises;
- the entry points: `read_bytes`, the loader's batch (one size and mixed
  sizes), the daemon's request decode, and `predict_on_dir` and
  `evaluate` over a directory of BMP, DIB and GIF tiles against the JAX
  package's."""

import hashlib
import json
import re
import struct
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mapping_tpu.data.loader import load_image
from mapping_tpu_torch.utils import bmp, native_decode
from tests.fixtures.bmp_corpus import make_corpus as corpus
from tests.torch_guards import drop_tmp_path  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "fixtures" / "bmp_corpus"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _jax(data, suffix=".bmp"):
    """The JAX loader's RGB of the bytes (read from a file, as it reads
    tiles), or None where it raises."""
    with tempfile.NamedTemporaryFile(suffix=suffix) as f:
        f.write(data)
        f.flush()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                return load_image(f.name)
            except Exception:
                return None


def same_as_jax(data, suffix=".bmp"):
    """The port's decode equals the JAX loader's, or both refuse; the
    port's decode (None where refused)."""
    want = _jax(data, suffix)
    try:
        got = native_decode.decode_rgb_bytes(data)
    except ValueError:
        got = None
    assert (want is None) == (got is None), (want is None, got is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    return got


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
    np.testing.assert_array_equal(native_decode.decode_rgb(CORPUS / name),
                                  got)


def test_corpus_covers_every_kind():
    """Every header size at every depth, each bitfields mask set, RLE8 and
    RLE4 with the quirks, grey and bilevel palettes, DIB files, tiles for
    the card, and refusals of each kind Pillow refuses."""
    names = set(MANIFEST)
    for size in (12, 40, 52, 56, 64, 108, 124):
        for bits in (1, 4, 8, 16, 24, 32):
            assert f"h{size}_{bits}bit.bmp" in names
    for kind in ("bitfields_bgrx", "bitfields_xbgr", "bitfields_bgxr",
                 "bitfields_abgr_v3", "bitfields_rgba_v3", "bitfields_bgra_v3",
                 "bitfields_bgar_v3", "bitfields_zero", "bitfields_bgr24",
                 "bitfields_565", "bitfields_555", "top_down_",
                 "grey_ramp_8bit", "black_white_1bit", "black_white_8bit",
                 "grey_ramp_4bit", "short_palette_", "offset_after_header",
                 "rle8_delta_quirk", "rle8_runs_clipped", "rle8_absolute_odd",
                 "rle4_absolute_odd", "rle4_delta", "dib_", "pil_",
                 "tile300_raw24_", "tile300_rle8_", "compression_4",
                 "compression_5", "depth_2", "bitfields_rgbx",
                 "palette_size_70000", "pixels_cut_short",
                 "rle8_end_of_bitmap_early", "rle8_delta_cut_short"):
        assert any(n.startswith(kind) for n in names), kind
    assert sum(n.endswith(".dib") and "refused" not in MANIFEST[n]
               for n in names) >= 4
    assert sum("refused" in e for e in MANIFEST.values()) >= 20
    assert not any("jax_reads" in e for e in MANIFEST.values())


def test_delta_escape_reads_four_bytes():
    """Pillow's delta escape reads two bytes it skips, then right and up:
    `02 05 00 02 01 00 01 07 00 00 04 09 00 01` in a 4x2 RLE8 file gives
    indices [[0, 0, 0, 0], [5, 5, 0, 0]] (the format says [[9, 9, 9, 9],
    [5, 5, 0, 7]])."""
    table = np.arange(16 * 3, dtype=np.uint8).reshape(16, 3) * 5
    data = corpus.bmp(corpus.info_header(40, 4, 2, 8, 1, colors=16),
                      corpus.palette_bytes(table),
                      bytes.fromhex("0205000201000107000004090001"))
    got = same_as_jax(data)
    np.testing.assert_array_equal(got, table[[[0, 0, 0, 0], [5, 5, 0, 0]]])


def decodes_with_jax_and_pil_blocked(corpus_dir, manifest):
    """A corpus through the port in a process where jax, flax and PIL
    cannot be imported: every file read to its digest, every refused kind
    raising with its cause named."""
    code = (
        "import sys, json, hashlib\n"
        "for m in ('jax', 'flax', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from mapping_tpu_torch.utils import native_decode\n"
        f"corpus = Path({str(corpus_dir)!r})\n"
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
    assert n == sum("refused" not in e for e in manifest.values())
    assert refused == sum("refused" in e for e in manifest.values())


def test_corpus_decodes_with_jax_and_pil_blocked():
    decodes_with_jax_and_pil_blocked(CORPUS, MANIFEST)


# ------------------------------------------------------ sweeps and cuts

@st.composite
def layouts(draw):
    """A BMP or DIB of drawn header size, depth, compression, palette,
    masks, row order, offset and size."""
    size = draw(st.sampled_from(bmp.HEADER_SIZES))
    w, h = draw(st.integers(1, 23)), draw(st.integers(1, 11))
    rng = np.random.RandomState(draw(st.integers(0, 2 ** 16)))
    if size == 12:
        bits, comp = draw(st.sampled_from((1, 4, 8, 16, 24, 32))), 0
    else:
        comp = draw(st.sampled_from((0, 0, 1, 2, 3)))
        bits = {1: 8, 2: 4}.get(comp) or draw(st.sampled_from(
            (1, 4, 8, 16, 24, 32) if comp == 0 else (16, 24, 32)))
    colors = draw(st.integers(0, 1 << bits)) if bits <= 8 else 0
    entry = 3 if size == 12 else 4
    palette = b""
    if bits <= 8:
        n = colors or 1 << bits
        kind = draw(st.sampled_from(("colour", "ramp", "short")))
        table = rng.randint(0, 256, (n, 3)).astype(np.uint8)
        if kind == "ramp":
            table = np.repeat((np.arange(n) & 255)[:, None], 3, 1).astype(
                np.uint8)
            if n == 2:
                table[1] = 255
        palette = corpus.palette_bytes(table, entry)
        if kind == "short":
            palette = palette[:draw(st.integers(0, len(palette)))]
    masks = None
    masks40 = b""
    if comp == 3:
        pool = [m for b, m in corpus.MASKS.values() if b == bits]
        masks = draw(st.sampled_from(pool + [(0xFF, 0xFF00, 0xFF0000, 0)]))
        if size == 40:
            masks40 = struct.pack("<3I", *masks[:3])
    stride = ((w * bits + 31) >> 3) & ~3
    if comp in (1, 2):
        ops = draw(st.lists(st.tuples(st.integers(0, 5), st.integers(0, 255),
                                      st.integers(0, 255)), max_size=40))
        data = bytearray()
        for op, a, b in ops:
            if op <= 2:
                data += bytes([a % (w + 3) + 1, b])
            elif op == 3:
                data += b"\0\0"
            elif op == 4:
                data += b"\0\2" + bytes([a & 3, b & 3, a % 4, b % 3])
            else:
                n = a % (w + 3) + 3
                data += bytes([0, n]) + bytes(rng.randint(
                    0, 256, n // 2 if comp == 2 else n).astype(np.uint8))
                data += b"\0" * (len(data) % 2)
        data = bytes(data)
    else:
        data = bytes(rng.randint(0, 256, stride * h).astype(np.uint8))
    data = data[:draw(st.integers(0, len(data)))] if draw(
        st.booleans()) and draw(st.booleans()) else data
    info = corpus.info_header(size, w, h, bits, comp, colors, masks,
                              draw(st.booleans()) and size > 12)
    offset = draw(st.sampled_from((None, None, 0, 14 + size)))
    return corpus.bmp(info, palette, data, masks40, offset,
                      dib=draw(st.booleans()))


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=layouts())
def test_drawn_layouts_read_as_the_jax_loader(data):
    same_as_jax(data)


@pytest.mark.parametrize("name", ["h40_24bit.bmp", "h40_8bit.bmp",
                                  "h12_4bit.bmp", "rle8_tile.bmp",
                                  "rle4_runs.bmp", "bitfields_565.bmp",
                                  "dib_rle8_absolute_odd.dib"])
def test_cut_and_flipped_files_read_as_the_jax_loader(name):
    """Seeded cuts and flipped bytes past the signature: the port reads
    what the JAX loader reads, byte for byte, and refuses what it
    refuses."""
    data = (CORPUS / name).read_bytes()
    rng = np.random.RandomState(len(name))
    read = refused = 0
    for _ in range(25):
        cut = data[:rng.randint(2, len(data))]
        flipped = bytearray(data)
        at = rng.randint(2, len(data))
        flipped[at:at + rng.randint(1, 4)] = bytes(
            rng.randint(0, 256, 3).astype(np.uint8))
        for case in (cut, bytes(flipped)):
            if same_as_jax(case, Path(name).suffix) is None:
                refused += 1
            else:
                read += 1
    assert read and refused


# ------------------------------------------------------- entry points

def test_read_bytes_names_bmp_and_gif():
    assert all(native_decode.releases_gil(p)
               for p in ("tile.bmp", "TILE.DIB", "tile.gif"))
    with pytest.raises(ValueError,
                       match="not a JPEG, PNG, TIFF, WebP, BMP or GIF"):
        native_decode.read_bytes(b"BA" + bytes(60))
    with pytest.raises(ValueError, match="header size"):
        native_decode.read_bytes(b"BM" + bytes(12) + struct.pack("<I", 20)
                                 + bytes(40))
    assert bmp.is_bmp(struct.pack("<I", 40)) and not bmp.is_bmp(
        struct.pack("<I", 41))


def encode(img, kind, interlace=False):
    """An RGB tile as `kind`: "bmp" (24-bit), "dib" (24-bit, no file
    header), "rle8" (a BMP of the tile cut to 64 levels a channel) or
    "gif" (Pillow's 96-colour quantisation, interlaced or not)."""
    from PIL import Image

    from tests.fixtures.gif_corpus import make_corpus as gif_corpus

    h, w = img.shape[:2]
    if kind in ("bmp", "dib"):
        return corpus.bmp(corpus.info_header(40, w, h, 24), b"",
                          corpus.rows(img[..., ::-1], 24), dib=kind == "dib")
    if kind == "rle8":
        quant = img // 64 * 64
        table, idx = np.unique(quant.reshape(-1, 3), axis=0,
                               return_inverse=True)
        return corpus.bmp(corpus.info_header(40, w, h, 8, 1,
                                             colors=len(table)),
                          corpus.palette_bytes(table),
                          corpus.rle8(idx.reshape(h, w).astype(np.uint8)))
    return gif_corpus.pillow(Image.fromarray(img).quantize(96),
                             interlace=interlace)


KINDS = ("bmp", "dib", "gif", "rle8")


def _tiles(root, sizes):
    """BMP, DIB, GIF and RLE8 tiles of the given sizes under root: (paths,
    the JAX loader's decode of each)."""
    paths = []
    for i, (h, w) in enumerate(sizes):
        kind = KINDS[i % 4]
        path = root / f"t{i:02d}.{'bmp' if kind == 'rle8' else kind}"
        path.write_bytes(encode(corpus.tile(h, w, 70 + i), kind,
                                bool(i % 2)))
        paths.append(str(path))
    return paths, [load_image(p) for p in paths]


@pytest.mark.parametrize("mixed", [False, True])
def test_loader_batch_equals_the_jax_loaders(tmp_path, mixed):
    """The loader's batch of BMP, DIB, RLE8 and GIF tiles on the CPU, of
    one size and of mixed sizes (resized on the host as the JAX loader
    resizes them), equals the JAX loader's batch."""
    from mapping_tpu.data.loader import SegmentationLoader as JaxLoader
    from mapping_tpu_torch.data.loader import SegmentationLoader

    sizes = [(60, 60)] * 8 if not mixed else [(60, 60), (48, 72)] * 4
    paths, _ = _tiles(tmp_path, sizes)
    common = dict(mode="resize", size=(64, 64), batch_size_inference=8,
                  augment=False)
    want, _ = JaxLoader(**common)._assemble(paths, None, np.arange(8))
    got, targets, ready = SegmentationLoader(
        device="cpu", **common)._assemble(paths, None, np.arange(8))
    assert targets is None and ready is None
    np.testing.assert_array_equal(got.numpy(), want)


def test_request_bodies_decode_as_the_jax_daemon(tmp_path):
    """BMP, DIB and GIF request bodies through the port's daemon decode
    equal the JAX daemon's (Pillow from memory), at the daemon's size and
    resized to it."""
    from mapping_tpu.infer import daemon as jax_daemon
    from mapping_tpu_torch.infer.daemon import decode_request_image

    paths, _ = _tiles(tmp_path, [(64, 64), (64, 64), (64, 64), (64, 64),
                                 (40, 52), (40, 52), (40, 52), (40, 52)])
    for path in paths:
        body = Path(path).read_bytes()
        np.testing.assert_array_equal(
            decode_request_image(body, "application/octet-stream", (64, 64)),
            jax_daemon.decode_request_image(body, "application/octet-stream",
                                            (64, 64)))


def test_predict_on_dir_and_evaluate_over_bmp_dib_and_gif_equal_jax(
        tmp_path):
    """`predict_on_dir` and `evaluate -p unet_weighted` on the CPU over a
    split whose tiles are BMP, DIB, RLE8 BMP and GIF files give what the
    JAX package gives on the same files: labels and areas exact, scores
    1e-4 relative (tests/test_torch_evaluate.py's rule, which excuses
    only pixels whose probability lies within float32 rounding of the
    threshold), and the same AP / AR."""
    from mapping_tpu.manager import PipelineManager as JaxManager
    from mapping_tpu_torch.data.loader import infer_batch_resize
    from mapping_tpu_torch.manager import PipelineManager
    from tests.fixtures.synthetic import generate
    from tests.test_torch_evaluate import (PIPELINE, _centred_state_dict,
                                           assert_same_instances,
                                           assert_same_scores,
                                           served_probabilities,
                                           write_config)
    from tests.test_torch_daemon import _jax_rle_library

    _jax_rle_library()  # the JAX package's RLE strings need its library
    data_dir = tmp_path / "data"
    generate(str(data_dir), n_train=1, n_val=8, seed=11)
    val = data_dir / "val"
    annotation = json.loads((val / "annotation.json").read_text())
    for k, entry in enumerate(sorted(annotation["images"],
                                     key=lambda e: e["file_name"])):
        old = val / "images" / entry["file_name"]
        kind = KINDS[k % 4]
        entry["file_name"] = \
            f"val_{k:05d}.{'bmp' if kind == 'rle8' else kind}"
        (val / "images" / entry["file_name"]).write_bytes(
            encode(load_image(str(old)), kind, bool(k % 3)))
        old.unlink()
    (val / "annotation.json").write_text(json.dumps(annotation))
    paths = sorted(str(p) for p in (val / "images").iterdir())
    tiles = np.stack([load_image(p) for p in paths])
    ckpt = tmp_path / "reference.pth"
    torch.save(_centred_state_dict(infer_batch_resize(
        torch.from_numpy(tiles), (64, 64))), ckpt)
    ws = {"root": tmp_path, "data_dir": data_dir, "tiles": tiles,
          "paths": paths}
    jax = JaxManager(write_config(ws, "jax_cache", {}))
    jax.prepare_metadata(True, True)
    jax.import_checkpoint(str(ckpt), PIPELINE)
    probs = served_probabilities(ws, PIPELINE, {})

    jax_scores = JaxManager(write_config(ws, "jax_eval", {})).evaluate(
        PIPELINE, False, None)
    port_scores = PipelineManager(write_config(ws, "port_eval", {})
                                  ).evaluate(PIPELINE, False, None)
    got = json.loads((tmp_path / "port_eval" / "prediction.json").read_text())
    want = json.loads((tmp_path / "jax_eval" / "prediction.json").read_text())
    excused = assert_same_instances(got, want, probs, range(1, 9))
    assert_same_scores([float(a) for a in port_scores],
                       [float(a) for a in jax_scores], excused)

    JaxManager(write_config(ws, "jax_predict", {})).predict_on_dir(
        PIPELINE, str(val / "images"), str(tmp_path / "jax.json"), None)
    PipelineManager(write_config(ws, "port_predict", {})).predict_on_dir(
        PIPELINE, str(val / "images"), str(tmp_path / "port.json"), None)
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got and {p["image_id"] for p in got} <= set(range(8))
    assert_same_instances(got, want, probs, range(8))
