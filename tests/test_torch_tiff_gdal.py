"""GeoTIFF's compressions and sample formats in the port's TIFF reader
(mapping_tpu_torch/utils/tiff.py: ZSTD through csrc/zstd_decode.cpp, LZMA
through the standard library's lzma, libtiff's floating-point predictor,
Pillow's numeric layouts) against the JAX package's loader, which reads
them through Pillow 12.1.0 and its libtiff 4.7.1 (libzstd 1.5.7,
liblzma 5.8.2):

- the ZSTD, LZMA and numeric files of tests/fixtures/tiff_corpus, each to
  the manifest's JAX digest or raising with its cause named, also in a
  process with jax, flax, PIL and the JAX package blocked; the only file
  the JAX loader reads and the port refuses is the legacy (v0.7) frame;
- every frame of tests/fixtures/zstd_frames to its content's digest, the
  frames together covering every decoder path;
- a seeded sweep of the ZSTD decoder against libzstd 1.5.7 through ctypes
  (tests/fixtures/zstd_frames/libzstd.py, driven as libtiff's ZSTDDecode
  drives it; the test's oracle only): 8 x 150 = 1,200 frames cut, with
  bits flipped, bytes replaced, stray bytes after them, random bytes from
  a point on, or read into a strip of another size;
- every numeric layout under every compression, predictors 1-3 and both
  byte orders against the JAX loader, and seeded cut, flipped and
  stray-byte TIFFs of ZSTD, LZMA and predictor 3 (9 x 20 = 180 files);
- `predict_on_dir` over two of chip_smoke.py phase 22's tiles (ZSTD RGB,
  float32 ZSTD with predictor 3) against the same pixels as PNG."""

import hashlib
import json
import lzma
import re
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mapping_tpu_torch.utils import native_decode, png, tiff
from tests.fixtures.tiff_corpus.make_corpus import elevation, scene
from tests.fixtures.zstd_frames import describe, libzstd
from tests.test_torch_bmp import _digest, same_as_jax
from tests.torch_guards import drop_tmp_path  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "fixtures" / "tiff_corpus"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())
FRAMES = ROOT / "tests" / "fixtures" / "zstd_frames"
FRAME_MANIFEST = json.loads((FRAMES / "manifest.json").read_text())
PIL_FILES = ("pil_zstd.tif", "pil_lzma.tif", "pil_float32.tif",
             "pil_int32.tif")
FILES = sorted(n for n in MANIFEST if n.startswith(
    ("gdal_", "tile300_zstd", "tile300_lzma")) or n in PIL_FILES)


# ------------------------------------------------------------ the corpus

@pytest.mark.parametrize("name", FILES)
def test_corpus_file_reads_to_its_jax_digest(name):
    """Each ZSTD, LZMA and numeric file: the port's pixels are the JAX
    loader's (the manifest's digest), or it raises naming its cause."""
    entry = MANIFEST[name]
    data = (CORPUS / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]
    if "refused" in entry:
        with pytest.raises(ValueError, match=re.escape(entry["refused"])):
            native_decode.read_bytes(data)
        return
    got = native_decode.decode_rgb_bytes(data)
    assert list(got.shape) == entry["shape"]
    assert _digest(got) == entry["decode_sha256"]


def test_corpus_covers_every_kind():
    """The four files the port refused (ZSTD, LZMA, float32, int32) are
    read; ZSTD at levels 1, 3, 19 and 22, with checksums, windows of 16
    MiB and past 2^27, raw and RLE blocks, strips (a short last one) and
    tiles, both byte orders, predictors 2 and 3; LZMA streams
    concatenated, cut, with a bad check after the strip's bytes;
    Pillow's numeric layouts and the ones it lacks; the six 300^2 tiles.
    The legacy ZSTD frame is the one file the JAX loader reads and the
    port refuses."""
    for name in PIL_FILES:
        assert "refused" not in MANIFEST[name], name
    for kind in ("zstd_level22", "zstd_window_16m", "zstd_raw_blocks",
                 "zstd_rle_blocks", "zstd_rgb_strips_short_last",
                 "zstd_rgb_tiles_pred2_mm", "zstd_float_tiles_pred3_mm",
                 "zstd_checksum_cut", "zstd_skippable_after",
                 "zstd_frame_longer", "lzma_concatenated",
                 "lzma_bad_check_after", "lzma_float_pred3_mm",
                 "float32_miniswhite", "int16_signed_mm_raw", "uint12_raw",
                 "uint32_ii_raw", "pil_zstd_float_pred3",
                 "pil_lzma_float_pred3"):
        assert f"gdal_{kind}.tif" in MANIFEST, kind
    for k in range(2):
        for kind in ("zstd_rgb", "lzma_rgb", "zstd_float"):
            assert f"tile300_{kind}_{k}.tif" in FILES
    refused = {MANIFEST[n]["refused"] for n in FILES if "refused" in
               MANIFEST[n]}
    assert refused == {
        "ZSTD window", "skippable ZSTD frame", "ZSTD data cut short",
        "ZSTD content checksum", "dictionary", "legacy", "LZMA data",
        "floating-point TIFF samples", "32-bit", "floating-point predictor",
        "predictor 2 at 12 bits"}
    gaps = [n for n in FILES if "jax_reads" in MANIFEST[n]]
    assert gaps == ["gdal_zstd_legacy_v07.tif"]


def test_corpus_decodes_with_jax_pil_and_the_jax_package_blocked():
    """The files through the port in a process where jax, flax, PIL and
    the JAX package cannot be imported: each to its digest, each refused
    kind raising naming its cause."""
    code = (
        "import sys, json, hashlib\n"
        "for m in ('jax', 'flax', 'PIL', 'mapping_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from mapping_tpu_torch.utils import native_decode\n"
        f"corpus = Path({str(CORPUS)!r})\n"
        "manifest = json.loads((corpus / 'manifest.json').read_text())\n"
        f"names = {FILES!r}\n"
        "n = refused = 0\n"
        "for name in names:\n"
        "    e = manifest[name]\n"
        "    try:\n"
        "        rgb = native_decode.decode_rgb(corpus / name)\n"
        "    except ValueError as err:\n"
        "        assert e['refused'] in str(err), (name, err)\n"
        "        refused += 1\n"
        "        continue\n"
        "    assert hashlib.sha256(np.ascontiguousarray(rgb).tobytes())"
        ".hexdigest() == e['decode_sha256'], name\n"
        "    n += 1\n"
        "print(n, refused)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    refused = sum("refused" in MANIFEST[n] for n in FILES)
    assert tuple(map(int, out.stdout.split())) == (len(FILES) - refused,
                                                  refused)


def test_no_zstd_or_xz_library_in_the_port():
    """The port decodes ZSTD itself: no module imports zstandard or loads
    libzstd, and xz goes through the standard library's lzma only."""
    for path in (ROOT / "mapping_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"zstandard|pyzstd|CDLL\([^)]*zstd", text), path
        assert not re.search(r"import (backports|lzmaffi)", text), path


# ------------------------------------------------------- the ZSTD frames

@pytest.mark.parametrize("name", sorted(FRAME_MANIFEST))
def test_frame_decodes_to_its_content(name):
    """Each frame written by libzstd 1.5.7 (one built by hand) decodes to
    its content's digest, as libzstd decodes it."""
    entry = FRAME_MANIFEST[name]
    frame = (FRAMES / name).read_bytes()
    assert hashlib.sha256(frame).hexdigest() == entry["sha256"]
    got = tiff.zstd_decode(frame, entry["content_size"]).tobytes()
    assert hashlib.sha256(got).hexdigest() == entry["content_sha256"]
    assert libzstd.tiff_decode(frame, entry["content_size"])[0] == got
    assert entry["covers"] in describe.features(frame)


def test_frames_cover_every_decoder_path():
    paths = set().union(*(set(e["paths"]) for e in FRAME_MANIFEST.values()))
    for path in ("raw_block", "rle_block", "compressed_block",
                 "literals_raw", "literals_rle", "literals_huffman_1_streams",
                 "literals_huffman_4_streams",
                 "literals_huffman_4_streams_double_symbol",
                 "literals_treeless_1_streams", "literals_treeless_4_streams",
                 "no_sequences", "checksum", "single_segment",
                 "window_descriptor", "window_over_2^20", "content_size",
                 "no_content_size", "skippable_frame"):
        assert path in paths, path
    for table in ("ll", "of", "ml"):
        for mode in describe.MODES:
            assert f"{table}_{mode}" in paths, (table, mode)


def _sweep_bases():
    """libzstd frames of pictures, text, noise and runs at levels -3 to
    22, with and without checksums and content sizes, in 1-4 blocks."""
    rng = np.random.RandomState(7)
    words = [bytes(rng.randint(97, 123, rng.randint(3, 9)).astype(np.uint8))
             for _ in range(200)]
    text = b" ".join(words[i] for i in rng.randint(0, 200, 4000))
    datas = [scene(5, 64).tobytes(), scene(6, 150).tobytes(), text,
             bytes(rng.randint(0, 256, 3000).astype(np.uint8)),
             b"\x09" * 140000 + scene(7, 48).tobytes(),
             bytes(rng.randint(0, 4, 20000).astype(np.uint8))]
    bases = []
    for data in datas:
        for level, checksum, pledged, chunk in (
                (1, False, True, None), (3, True, False, 5000),
                (19, True, True, 20000), (22, False, False, None),
                (-3, False, True, None)):
            bases.append((data, libzstd.compress(
                data, level, checksum, pledged=pledged, chunk=chunk)))
    return bases


BASES = []


@pytest.mark.parametrize("seed", range(8))
def test_zstd_sweep_equals_libzstd(seed):
    """150 mutated frames a seed: the port's decoder and libzstd 1.5.7
    (as libtiff drives it) both fail, or both give the same bytes."""
    if not BASES:
        BASES.extend(_sweep_bases())
    rng = np.random.RandomState(seed)
    for case in range(150):
        data, frame = BASES[rng.randint(len(BASES))]
        frame, occ = bytearray(frame), len(data)
        kind = case % 6
        if kind == 0:
            frame = frame[:rng.randint(1, len(frame))]
        elif kind == 1:
            for _ in range(1 + rng.randint(2)):
                at = rng.randint(len(frame))
                frame[at] ^= 1 << rng.randint(8)
        elif kind == 2:
            frame[rng.randint(len(frame))] = rng.randint(256)
        elif kind == 3:
            frame += bytes(rng.randint(0, 256, rng.randint(1, 20)).astype(
                np.uint8))
        elif kind == 4:
            at = rng.randint(6, len(frame))
            frame[at:] = bytes(rng.randint(0, 256, len(frame) - at).astype(
                np.uint8))
        else:
            occ = max(1, occ + rng.randint(-300, 300))
        want = libzstd.tiff_decode(bytes(frame), occ)[0]
        try:
            got = tiff.zstd_decode(bytes(frame), occ).tobytes()
        except ValueError:
            got = None
        assert got == want, (seed, case, kind)


# -------------------------------------------- layouts, predictors, sweeps

NUMERIC = {
    "float32": (elevation(2, 13, 17), dict(bits=32, sample_format=3),
                (0, 1)),
    "int32": (np.random.RandomState(3).randint(-300, 600, (13, 17)).astype(
        np.int32), dict(bits=32, sample_format=2), (1,)),
    "uint32": (np.random.RandomState(4).randint(0, 2 ** 32, (13, 17),
                                                dtype=np.uint64).astype(
        np.uint32), dict(bits=32), (1,)),
    "int16": (np.random.RandomState(5).randint(-300, 600, (13, 17)).astype(
        np.int16).view(np.uint16), dict(bits=16, sample_format=2), (1,)),
    "uint12": (np.random.RandomState(6).randint(0, 4096, (13, 17)).astype(
        np.uint16), dict(bits=12), (1,)),
}
NUMERIC["float32"][0].flat[:8] = [np.nan, np.inf, -np.inf, -0.6, 0.9999,
                                  254.9999, 255.5, 2 ** 31]


@pytest.mark.parametrize("compression", ["none", "lzw", "deflate", "zstd",
                                         "lzma", "packbits"])
@pytest.mark.parametrize("kind", sorted(NUMERIC))
def test_numeric_layouts_read_as_the_jax_loader(kind, compression):
    """Each numeric layout in both byte orders, MinIsBlack (and
    MinIsWhite for floats), predictors 1, 2 and 3, strips and tiles: the
    port reads it as the JAX loader does, or both refuse (libtiff's
    predictor rules, layouts Pillow lacks: big-endian 12-bit and unsigned
    32-bit)."""
    values, options, photometrics = NUMERIC[kind]
    read = 0
    for order in "<>":
        for photometric in photometrics:
            for predictor in (1, 2, 3):
                for layout in ({"rows_per_strip": 5}, {"tile": (16, 16)}):
                    data = tiff.encode(values, compression, byteorder=order,
                                       photometric=photometric,
                                       predictor=predictor, **options,
                                       **layout)
                    read += same_as_jax(data, ".tif") is not None
    assert read


@pytest.mark.parametrize("codec", ["zstd", "lzma", "predictor3"])
@pytest.mark.parametrize("kind", ["cut", "flip", "stray"])
def test_mutated_files_read_as_the_jax_loader(codec, kind):
    """20 files a case, cut anywhere, with a bit flipped or stray bytes
    after a strip's data: the port and the JAX loader read the same
    pixels, or both refuse."""
    rng = np.random.RandomState(len(codec) * 10 + len(kind))
    pixels = scene(8, 64)
    if codec == "predictor3":
        base = tiff.encode(elevation(3, 24, 40), "deflate", bits=32,
                           sample_format=3, predictor=3, rows_per_strip=6)
    elif codec == "lzma":
        base = tiff.encode(pixels, "lzma", predictor=2, rows_per_strip=10)
    else:
        base = (CORPUS / "gdal_zstd_rgb_strips_short_last.tif").read_bytes()
    for _ in range(20):
        data = bytearray(base)
        if kind == "cut":
            data = data[:rng.randint(16, len(data))]
        elif kind == "flip":
            at = rng.randint(8, len(data))
            data[at] ^= 1 << rng.randint(8)
        else:
            at = rng.randint(8, len(data))
            data[at:at] = bytes(rng.randint(0, 256, 3).astype(np.uint8))
        same_as_jax(bytes(data), ".tif")


@pytest.mark.parametrize("entry", [(2, 1), (3, 2), (4, 1), (9, 1)])
def test_predictor_entry_libtiff_cannot_read_is_ignored(entry):
    """A Predictor entry of another type or count than one SHORT (ASCII,
    two SHORTs; a LONG or SLONG is read where it fits 16 bits) is ignored
    by libtiff, which then reads the strips unpredicted, and so by the
    port; a LONG of 70,000 is out of range, so ignored too."""
    kind, count = entry
    data = bytearray(tiff.encode(elevation(4, 12, 20), "zstd", bits=32,
                                 sample_format=3, predictor=3))
    at = struct.unpack("<I", data[4:8])[0] + 2
    for k in range(struct.unpack("<H", data[at - 2:at])[0]):
        if struct.unpack("<H", data[at + 12 * k:at + 12 * k + 2])[0] == 317:
            struct.pack_into("<HII", data, at + 12 * k + 2, kind, count,
                             70000 if kind == 4 else 3)
    same_as_jax(bytes(data), ".tif")


def test_lzma_reads_libtiffs_way():
    """libtiff's LZMADecode: one xz stream, the strip's bytes; what comes
    after them (a second stream, a check that fails) does not count, a
    stream that ends before them fails."""
    data = bytes(range(256)) * 4
    stream = lzma.compress(data, lzma.FORMAT_XZ)
    assert tiff.lzma_decode(stream + stream, 1024).tobytes() == data
    bad = stream[:-13] + bytes([stream[-13] ^ 1]) + stream[-12:]
    assert tiff.lzma_decode(bad, 1024).tobytes() == data
    with pytest.raises(lzma.LZMAError):
        lzma.decompress(bad)
    for short in (stream[:len(stream) // 2], lzma.compress(data[:100])):
        with pytest.raises(ValueError, match="LZMA"):
            tiff.lzma_decode(short, 1024)


# ------------------------------------------------------ predict_on_dir

def test_predict_on_dir_over_gdal_tiles_equals_png(tmp_path):
    """`predict_on_dir` on the CPU over two of phase 22's 300^2 tiles
    (ZSTD RGB with predictor 2; float32 ZSTD with predictor 3) writes the
    prediction.json it writes over PNG tiles of their decoded pixels."""
    from mapping_tpu_torch import main as cli
    from mapping_tpu_torch.models.unet_resnet import UNetResNet

    for fmt in ("tif", "png"):
        (tmp_path / fmt).mkdir()
    for name in ("tile300_zstd_rgb_0.tif", "tile300_zstd_float_0.tif"):
        data = (CORPUS / name).read_bytes()
        (tmp_path / "tif" / name).write_bytes(data)
        (tmp_path / "png" / name.replace(".tif", ".png")).write_bytes(
            png.encode_png(native_decode.decode_rgb_bytes(data)))
    torch.manual_seed(0)
    torch.save(UNetResNet(34).state_dict(), tmp_path / "ref.pth")
    params = {"experiment_dir": str(tmp_path / "experiment"),
              "data_dir": str(tmp_path), "meta_dir": str(tmp_path / "meta"),
              "device": "cpu", "encoder": "ResNet34",
              "model_dtype": "float32", "image_h": 64, "image_w": 64,
              "batch_size_inference": 2}
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
    assert {p["image_id"] for p in got} <= {0, 1}
