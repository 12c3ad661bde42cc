"""The port's JPEG 2000 reader (mapping_tpu_torch/utils/jp2.py over
csrc/jp2_decode.cpp) against the JAX package's loader on the same bytes,
exactly: `mapping_tpu.data.loader.load_image`, which reads JP2 files and
J2K codestreams through Pillow's Jpeg2KImagePlugin (openjpeg 2.5 tile by
tile, Pillow's unpackers) and convert("RGB").

- the corpus `tests/fixtures/jp2_corpus` (Pillow's files of every mode,
  progression, tiling and layering; openjpeg's of every code-block style,
  SOP / EPH, POC, tile-parts, ROI, subsampling and precision; hand-made
  JP2 containers, palettes, PPM / PPT, a Psot of 0, the 9/7 filter over
  one-sample signals, and the kinds the port refuses), each readable file
  equal to the manifest's JAX digest and to the JAX loader here, through
  `read_bytes` and in a process with jax, flax and PIL blocked; each
  refused kind raising with its cause named;
- Pillow's integer YCbCr and CMYK conversions, Pillow's palette, and the
  float path's bytes at -O0 against the default build;
- a hypothesis sweep of Pillow-encoded files, single code-blocks of any
  bytes under every code-block style (openjpeg's tier 1 on data no encoder
  writes), and seeded cuts and byte flips, each read as the JAX loader
  reads it or refused where it raises;
- `predict_on_dir` over J2K and JP2 tiles against the same pixels as PNG
  and against the JAX `predict_on_dir`, and a J2K request body through the
  port's HTTP daemon against the JAX daemon's answer."""

import ctypes
import io
import json
import re
import subprocess
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st
from PIL import Image

from mapping_tpu.infer import daemon as jax_daemon
from mapping_tpu_torch.infer.daemon import (ServingDaemon,
                                            decode_request_image)
from mapping_tpu_torch.utils import jp2, native_decode, native_lib, png
from tests.fixtures.jp2_corpus import opj
from tests.test_torch_bmp import (_digest, _jax,
                                  decodes_with_jax_and_pil_blocked,
                                  same_as_jax)
from tests.test_torch_daemon import (CAT_IDS, CAT_LAYERS, HW,
                                     _assert_same_annotations, _batcher,
                                     _images, _jax_preprocess, _jax_serve,
                                     _post)
from tests.torch_guards import drop_tmp_path  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "fixtures" / "jp2_corpus"
MANIFEST = json.loads((CORPUS / "manifest.json").read_text())


def _encode(img, **kw):
    """Pillow's JPEG 2000 file of `img` (uint16 reads as I;16)."""
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _same(data):
    return same_as_jax(data, ".j2k" if data.startswith(jp2.J2K_SIGNATURE)
                       else ".jp2")


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_corpus_reads_as_the_jax_loader(name):
    entry = MANIFEST[name]
    data = (CORPUS / name).read_bytes()
    assert jp2.is_jp2(data) or "refused" in entry
    want = _jax(data, Path(name).suffix)
    if "refused" in entry:
        with pytest.raises(ValueError, match=re.escape(entry["refused"])):
            native_decode.read_bytes(data)
        assert (want is not None) == ("jax_reads" in entry)
        if want is not None and entry["jax_reads"] != "stale memory":
            assert _digest(want) == entry["jax_reads"]
        return
    got = native_decode.read_bytes(data)
    assert list(got.shape) == entry["shape"]
    assert _digest(got) == entry["decode_sha256"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native_decode.decode_rgb(CORPUS / name),
                                  got)


def test_corpus_covers_every_kind():
    """Each kind the reader handles has a file: modes and containers, the
    code-block styles on both wavelets, packet and tile-part layouts,
    subsampling, precisions, sizes, palettes, the 300^2 tiles, and the
    refused kinds."""
    names = set(MANIFEST)
    for kind in (
            "pil_rgb.jp2", "pil_rgb_irreversible", "pil_rgb.j2k", "pil_l",
            "pil_la", "pil_rgba", "pil_i16", "pil_layers", "pil_lrcp",
            "pil_rlcp", "pil_rpcl", "pil_pcrl", "pil_cprl", "pil_offsets",
            "pil_one_resolution", "pil_mct0", "pil_signed",
            "pil_comment_plt", "sop.", "eph.", "sop_eph", "poc.",
            "poc_cprl", "tile_parts_R", "tile_parts_L", "tile_parts_C",
            "psot0_last", "roi.", "roi_97_layers", "ppt", "ppm",
            "sub420_guessed_sycc", "sub420_srgb", "sub420_sycc",
            "sub422_97", "sub_first_component", "rgb_1bit", "rgb_4bit",
            "rgb_12bit", "rgb_16bit", "grey_10bit", "rgb_signed_12bit",
            "grey_signed_4bit", "la_mixed_precision", "size_1x1",
            "size_37x1", "size_1x41", "size_1x1_levels5", "odd_origin",
            "odd_origin_tiles", "one_sample_97_odd", "one_sample_97_even",
            "levels_5", "jp2_no_colr", "jp2_icc", "jp2_grey_colr17",
            "jp2_sycc", "jp2_cmyk", "jp2_rgba_grey_colr", "jp2_cdef_res",
            "jpx_brand", "xl_jp2c", "zero_length_jp2c", "box_before_jp2h",
            "box_after_jp2h", "ihdr_16bit_over_8bit", "ihdr_bpc255",
            "ihdr_rgba_over_rgb", "pclr_repeated", "pclr_short",
            "pclr_rgba", "pclr_pa", "tile300_reversible_",
            "tile300_irreversible_", "tile300_rpcl_", "htj2k_cap",
            "htj2k_style", "five_components", "precision_17", "cut_",
            "header_20000x20000", "eph_missing", "grey_colr_over_rgb",
            "srgb_colr_over_grey", "eycc", "ihdr_size_differs",
            "zero_length_box_before_jp2h", "subsampled_two_components",
            "stale_subsampled_read", "segment_past_tile_part",
            "tile_part_index_past_count", "cod_bad_wavelet",
            "parts_tnsot0", "parts_interleaved", "parts_tiles_reversed",
            "parts_tile_missing", "parts_psot0_first",
            "parts_bytes_after_eoc", "parts_no_eoc", "parts_junk_for_eoc"):
        assert any(n.startswith(kind) for n in names), kind
    for style in ("bypass", "reset", "termall", "vsc", "erterm", "segsym",
                  "all_styles"):
        for wave in ("53", "97"):
            assert f"style_{style}_{wave}.j2k" in names
    assert sum("refused" in e for e in MANIFEST.values()) >= 20
    assert sum("refused" not in e for e in MANIFEST.values()) >= 90
    # the refused kinds the JAX loader reads all the same: gaps
    assert {n for n, e in MANIFEST.items() if "jax_reads" in e} == {
        "htj2k_cap.j2k", "precision_17.j2k", "stale_subsampled_read.j2k"}


def test_corpus_decodes_with_jax_and_pil_blocked():
    decodes_with_jax_and_pil_blocked(CORPUS, MANIFEST)


# ------------------------------------------------- Pillow's conversions

def test_ycbcr_table_is_pillows():
    """jp2.ycbcr_to_rgb equals Pillow's YCbCr -> RGB for every Cb and Cr
    at Y on and near both ends and in the middle."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in (0, 1, 77, 128, 200, 254, 255):
        ycc = np.stack([np.full_like(cb, y), cb, cr], -1).astype(np.uint8)
        want = np.array(Image.fromarray(ycc, "YCbCr").convert("RGB"))
        np.testing.assert_array_equal(jp2.ycbcr_to_rgb(ycc), want)


def test_cmyk_is_pillows():
    rng = np.random.RandomState(0)
    cmyk = rng.randint(0, 256, (64, 64, 4)).astype(np.uint8)
    cmyk[0, :4] = [[0, 0, 0, 0], [255, 255, 255, 255], [255, 0, 0, 0],
                   [0, 0, 0, 255]]
    want = np.array(Image.fromarray(cmyk, "CMYK").convert("RGB"))
    np.testing.assert_array_equal(jp2.cmyk_to_rgb(cmyk), want)


def test_pillow_quirks():
    """A palette's repeated entry merges and shifts the later ones down;
    I;16 clips at 255; a 16-bit sample that rounds to 256 wraps to 0; a
    signed sample is offset by half its range."""
    got = _same((CORPUS / "pclr_repeated.jp2").read_bytes())
    index = (np.arange(29)[:, None] + np.arange(37)[None, :]) % 40
    entries = np.array([[(37 * i) % 256, (91 * i) % 256, (13 * i) % 256]
                        for i in range(40)])
    entries[7], entries[30] = entries[2], entries[11]
    merged = [tuple(e) for e in entries]
    distinct = list(dict.fromkeys(merged))
    table = np.zeros((256, 3), np.uint8)
    table[:len(distinct)] = distinct
    np.testing.assert_array_equal(got, table[index])
    i16 = _same((CORPUS / "pil_i16.jp2").read_bytes())
    assert i16[0, :5, 0].tolist() == [0, 100, 255, 255, 255]
    assert i16[3, 0, 0] == 255
    wrap = _same(_encode(np.full((9, 9), 65535, np.uint16)))
    assert (wrap == 255).all()
    rgb16 = opj.encode([np.full((8, 8), v) for v in (65535, 65407, 0)],
                       prec=16, levels=1)
    assert _same(rgb16)[0, 0].tolist() == [0, 255, 0]
    signed = opj.encode([np.arange(24).reshape(4, 6) - 128], prec=8,
                        sgnd=True, levels=1)
    assert _same(signed)[..., 0].reshape(-1).tolist() == list(range(24))


@pytest.mark.parametrize("name", ["odd_origin_tiles.j2k", "sub422_97.j2k",
                                  "tile_parts_L.j2k", "ppm.j2k",
                                  "la_mixed_precision.j2k",
                                  "rgb_signed_12bit.j2k"])
def test_codestream_samples_are_openjpegs(name):
    """Below Pillow's unpacking: each tile's samples as openjpeg writes
    them for Pillow (`opj_decode_tile_data`, 8, 16 or 32 bits a sample,
    the components one after another) equal the port's component planes
    over that tile, tile by tile and in openjpeg's order."""
    data = (CORPUS / name).read_bytes()
    _, tiles = opj.decode_tiles(data)
    lib = jp2.load()
    g = jp2._header(lib, data)
    planes, order = jp2._decode_planes(lib, data, g)
    assert order == [t for t, _, _ in tiles]
    for _, rect, buf in tiles:
        ours = b"".join(jp2._tile_words(p, g, c, rect).astype(
            {1: "<u1", 2: "<u2", 4: "<u4"}[jp2._csiz(c[2])]).tobytes()
            for p, c in zip(planes, g.comps))
        assert ours == buf, rect


# ------------------------------------------------ the float path's bytes

_NINE_SEVEN = [n for n, e in sorted(MANIFEST.items()) if "refused" not in e
               and ("97" in n or "irreversible" in n or "layers" in n)]


def _planes(lib, data):
    cs = data if data.startswith(jp2.J2K_SIGNATURE) else \
        data[jp2._openjpeg_jp2(data).codestream:]
    return jp2._decode_planes(lib, cs, jp2._header(lib, cs))[0]


def test_float_path_same_bytes_at_O0(tmp_path):
    """csrc/jp2_decode.cpp built at -O0 (every float operation as written,
    no vectorising) gives the component samples of the default build on
    every 9/7 file of the corpus: with -ffp-contract=off no optimisation
    level or target reorders or fuses the float path."""
    assert len(_NINE_SEVEN) >= 15
    out = tmp_path / "libjp2_O0.so"
    subprocess.run(["g++", "-O0", "-shared", "-fPIC", "-std=c++17",
                    *jp2.FLAGS, str(jp2._lib.src), "-o", str(out)],
                   check=True)
    slow = ctypes.CDLL(str(out))
    jp2._register(slow)
    fast = jp2.load()
    for name in _NINE_SEVEN:
        data = (CORPUS / name).read_bytes()
        for a, b in zip(_planes(fast, data), _planes(slow, data)):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_only_the_jpeg2000_library_gets_extra_flags():
    """jp2_decode is built with -ffp-contract=off; the other host
    libraries keep GXX_FLAGS alone, so their build hashes are unchanged."""
    from mapping_tpu_torch.utils import bmp, gif, tiff, webp
    from mapping_tpu_torch.utils import jpeg as port_jpeg

    assert "-ffp-contract=off" in jp2._lib.flags
    assert jp2._lib.flags[:len(native_lib.GXX_FLAGS)] == native_lib.GXX_FLAGS
    assert jp2._lib._target().name.startswith("libjp2_decode-")
    for lib in (bmp._lib, gif._lib, webp._lib, tiff._lib, port_jpeg._lib,
                native_decode._lib):
        assert lib.flags == native_lib.GXX_FLAGS
        import hashlib

        digest = hashlib.sha256(
            " ".join(native_lib.GXX_FLAGS + lib._link).encode())
        digest.update(lib.src.read_bytes())
        assert lib._target().name == \
            f"lib{lib.name}-{digest.hexdigest()[:16]}.so"


# ------------------------------------------------------ sweeps and cuts

@st.composite
def pillow_files(draw):
    """A file Pillow's encoder writes, of drawn mode, size, wavelet,
    resolutions, code-blocks, precincts, progression, tiles, offsets,
    layers, MCT and container."""
    mode = draw(st.sampled_from(["RGB", "RGB", "L", "LA", "RGBA", "I;16"]))
    w, h = draw(st.integers(1, 48)), draw(st.integers(1, 48))
    irreversible = draw(st.booleans())
    nres = draw(st.integers(1, 4))
    # openjpeg's 9/7 encoder asserts on one-sample signals: no tiles or
    # offsets, and every level at least 2 samples wide
    assume(min(w, h) >= (1 << (nres - 1)) * (4 if irreversible else 1))
    rng = np.random.RandomState(draw(st.integers(0, 2 ** 16)))
    y, x = np.mgrid[0:h, 0:w]
    base = 100 + 80 * np.sin(x / 4.0 + y / 5.0) + rng.randint(0, 30, (h, w))
    if mode == "I;16":
        img = (np.clip(base, 0, 255) * draw(st.sampled_from([1, 3, 257]))
               ).astype(np.uint16)
    else:
        bands = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        img = np.clip(np.stack([base + 25 * k for k in range(bands)], -1),
                      0, 255).astype(np.uint8)
        if bands == 1:
            img = img[..., 0]
    kw = dict(irreversible=irreversible, num_resolutions=nres,
              progression=draw(st.sampled_from(
                  ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"])),
              no_jp2=draw(st.booleans()))
    cb = draw(st.sampled_from([(4, 4), (8, 16), (32, 32), (64, 64)]))
    kw["codeblock_size"] = cb
    if draw(st.booleans()):
        p = draw(st.sampled_from([16, 32, 64]))
        kw["precinct_size"] = (p, p)
    if draw(st.booleans()):
        kw["quality_mode"] = "rates"
        kw["quality_layers"] = draw(st.sampled_from(
            [[30], [40, 10], [50, 20, 5]]))
    if not irreversible and draw(st.booleans()):
        kw["tile_size"] = (draw(st.integers(8, 32)), draw(st.integers(8, 32)))
        # Pillow's encoder crashes on an offset without tiles
        if draw(st.booleans()):
            kw["offset"] = (draw(st.integers(0, 9)), draw(st.integers(0, 9)))
    if mode in ("RGB", "RGBA"):
        kw["mct"] = draw(st.sampled_from([0, 1]))
    try:
        return _encode(img, **kw)
    except (OSError, ValueError):
        assume(False)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.filter_too_much])
@given(data=pillow_files())
def test_pillow_encoded_files_read_as_the_jax_loader(data):
    assert _same(data) is not None


@pytest.mark.parametrize("seed", range(4))
def test_one_code_block_of_any_bytes_reads_as_the_jax_loader(seed):
    """One code-block (no wavelet levels) whose packet header gives drawn
    zero bit-planes, passes and segments over random bytes, under each
    code-block style: openjpeg's tier 1 decodes bytes no encoder writes
    (the MQ decoder past a segment's end, raw passes, RESET, TERMALL's
    segments, VSC, SEGSYM), and the port gives the same samples."""
    rng = np.random.RandomState(seed)
    for _ in range(40):
        w, h = int(rng.randint(1, 20)), int(rng.randint(1, 20))
        style = int(rng.randint(0, 64))
        zero = int(rng.randint(0, 6))
        passes = int(rng.randint(1, min(3 * (17 - zero) - 2, 60) + 1))
        segs = []
        for n in opj.segment_passes(passes, style):
            nbytes = int(rng.randint(0, 12))
            pool = [0, 0xFF, 0x7F, 0x8F, 0x90, 0xAA] if rng.rand() < 0.3 \
                else range(256)
            segs.append((n, bytes(rng.choice(pool, nbytes).astype(
                np.uint8))))
        data = opj.one_code_block(w, h, zero, segs, cblksty=style,
                                  qmfbid=int(rng.rand() < 0.3) ^ 1)
        assert _same(data) is not None


@pytest.mark.parametrize("name", ["pil_rgb.jp2", "style_all_styles_97.j2k",
                                  "tile_parts_L.j2k", "ppm.j2k",
                                  "sub420_sycc.jp2"])
def test_cut_and_flipped_streams_read_as_the_jax_loader(name):
    """Seeded cuts, and flipped bytes past the JP2 boxes and the SIZ
    marker: the port reads what the JAX loader reads, byte for byte (the
    tier 1 and tier 2 decoders on corrupt data, openjpeg's tile-part and
    marker checks), and refuses what it refuses."""
    data = (CORPUS / name).read_bytes()
    start = data.index(b"\xff\x4f\xff\x51") + 44
    rng = np.random.RandomState(len(name))
    read = refused = 0
    for _ in range(20):
        cut = data[:rng.randint(start, len(data))]
        flipped = bytearray(data)
        at = rng.randint(start, len(data))
        flipped[at:at + rng.randint(1, 4)] = bytes(
            rng.randint(0, 256, 3).astype(np.uint8))
        for case in (cut, bytes(flipped)):
            if _same(case) is None:
                refused += 1
            else:
                read += 1
    assert read and refused


def test_read_bytes_names_jpeg2000():
    assert native_decode.releases_gil("tile.jp2")
    assert native_decode.releases_gil("tile.j2k")
    with pytest.raises(ValueError, match="nor a JPEG 2000 file"):
        native_decode.read_bytes(b"\xff\x4f\xff\x50" + bytes(40))
    with pytest.raises(ValueError, match="not a JPEG, PNG, TIFF, WebP, BMP "
                                         "or GIF image"):
        native_decode.read_bytes(b"\x00\x00\x00\x0cjP  \r\n\x87\x0b")
    with pytest.raises(ValueError, match="JPEG 2000 SIZ marker cut short"):
        native_decode.read_bytes(b"\xff\x4f\xff\x51\x00\x29" + bytes(8))
    with pytest.raises(ValueError, match="HTJ2K"):
        jp2.decode((CORPUS / "htj2k_style.j2k").read_bytes())


# ------------------------------------------------ predict_on_dir, daemon

def test_predict_on_dir_over_j2k_equals_png_and_jax(tmp_path):
    """`predict_on_dir -p unet_weighted` on the CPU over 8 reversible JP2
    and 8 irreversible J2K tiles writes the prediction.json it writes over
    PNG tiles of the decoded pixels, and the JAX `predict_on_dir` over the
    same files (the instances of tests/test_torch_evaluate.py's rule: equal
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

    rng = np.random.RandomState(22)
    for fmt in ("jp2", "png"):
        (tmp_path / fmt).mkdir()
    decoded = []
    for i in range(16):
        tile, _ = _make_image(rng, 96, 96, max_buildings=3)
        if i < 8:
            name, data = f"t{i:02d}.jp2", _encode(tile)
        else:
            name, data = f"t{i:02d}.j2k", _encode(
                tile, no_jp2=True, irreversible=True,
                quality_layers=[[20], [40], [8, 2]][i % 3],
                progression=["LRCP", "RPCL"][i % 2])
        (tmp_path / "jp2" / name).write_bytes(data)
        decoded.append(native_decode.decode_rgb_bytes(data))
        (tmp_path / "png" / f"t{i:02d}.png").write_bytes(
            png.encode_png(decoded[-1]))
    tiles = np.stack(decoded)
    np.testing.assert_array_equal(tiles[0], _make_image(
        np.random.RandomState(22), 96, 96, max_buildings=3)[0])
    ckpt = tmp_path / "reference.pth"
    torch.save(_centred_state_dict(infer_batch_resize(
        torch.from_numpy(tiles), (64, 64))), ckpt)
    ws = {"root": tmp_path, "data_dir": tmp_path / "data", "tiles": tiles}
    JaxManager(write_config(ws, "jax_cache", {})).import_checkpoint(
        str(ckpt), PIPELINE)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        JaxManager(write_config(ws, "jax_predict", {})).predict_on_dir(
            PIPELINE, str(tmp_path / "jp2"), str(tmp_path / "jax.json"),
            None)
    manager = PipelineManager(write_config(ws, "port_predict", {}))
    for fmt in ("jp2", "png"):
        manager.predict_on_dir(PIPELINE, str(tmp_path / fmt),
                               str(tmp_path / f"{fmt}.json"), None)
    got = json.loads((tmp_path / "jp2.json").read_text())
    assert got == json.loads((tmp_path / "png.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert {p["image_id"] for p in got} <= set(range(16)) and got
    assert_same_instances(got, want, served_probabilities(ws, PIPELINE, {}),
                          range(16))


def test_http_j2k_body_matches_the_jax_daemon():
    """J2K and JP2 request bodies through the port's HTTP daemon: each
    tile equals the JAX daemon's decode (Pillow), and so does each
    answer."""
    img = _images(1, seed=34)[0]
    for body in (_encode(img, no_jp2=True, irreversible=True),
                 _encode(img)):
        np.testing.assert_array_equal(
            decode_request_image(body, "image/jp2", HW),
            jax_daemon.decode_request_image(body, "image/jp2", HW))
        headers = {"Content-Type": "image/jp2", "X-Image-Id": "9"}
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
