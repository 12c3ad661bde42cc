"""Write the TIFF corpus of the port's TIFF tests and of chip_smoke.py
phase 17: files written by Pillow (through libtiff for the compressed
ones) and by the port's writer (`mapping_tpu_torch.utils.tiff.encode`:
tiles, planar data, big-endian files, BigTIFF, predictor 2, 16-bit
samples, palettes, fill order 2, JPEG strips and tiles, ...), and a
`manifest.json` with each
file's SHA-256 and
- for the files the port reads, the SHA-256 of the JAX package's RGB
  decode (`mapping_tpu.data.loader.load_image`, Pillow's convert("RGB"))
  and its shape;
- for the kinds the port refuses, the feature its ValueError names, and
  whether the JAX package reads the file all the same (`jax_reads`, with
  its decode's SHA-256: a gap of the port, or a reading of Pillow's that
  the port does not follow; see ROADMAP.md).

Run from the root of the repository, where Pillow (with libtiff) is
installed:

    python tests/fixtures/tiff_corpus/make_corpus.py
"""

import hashlib
import io
import json
import os
import struct
import sys
import warnings
from pathlib import Path

import numpy as np
from PIL import Image, features

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from mapping_tpu.data.loader import load_image  # noqa: E402
from mapping_tpu_torch.utils import jpeg, tiff  # noqa: E402


def _image(h, w, seed):
    """A tile-like picture: a gradient, mild noise and a bright block."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([40 + 120 * x / max(w, 1), 60 + 100 * y / max(h, 1),
                    np.full((h, w), 90.0)], -1) + rng.randint(0, 12,
                                                              (h, w, 3))
    img[h // 4:h // 2 + 1, w // 3:w // 2 + 1] = rng.randint(170, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil(img, mode=None, **kw):
    buf = io.BytesIO()
    im = Image.fromarray(img)
    (im.convert(mode) if mode else im).save(buf, "TIFF", **kw)
    return buf.getvalue()


def _cases():
    """(name, bytes, refused feature or None)."""
    rgb = _image(40, 50, 1)
    rng = np.random.RandomState(2)
    for c in ("raw", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate",
              "packbits"):
        yield f"pil_{c}.tif", _pil(rgb, compression=c), None
    yield "pil_grey_lzw.tif", _pil(rgb, "L", compression="tiff_lzw"), None
    yield "pil_bilevel_packbits.tif", _pil(rgb, "1", compression="packbits"), \
        None
    yield "pil_palette_lzw.tif", _pil(rgb, "P", compression="tiff_lzw"), None
    yield "pil_rgba_deflate.tif", _pil(
        np.concatenate([rgb, rng.randint(0, 256, (40, 50, 1),
                                         ).astype(np.uint8)], -1),
        compression="tiff_adobe_deflate"), None
    yield "pil_la_raw.tif", _pil(rgb, "LA"), None
    yield "pil_i16_lzw.tif", _pil(rgb, "I;16", compression="tiff_lzw"), None
    yield "pil_geotiff_tags.tif", _pil(rgb, compression="tiff_lzw", tiffinfo={
        33550: (0.5, 0.5, 0.0), 33922: (0.0, 0.0, 0.0, 500000.0, 4e6, 0.0),
        34737: "WGS 84|"}), None
    # the port's writer
    yield "lzw_pred2_strips.tif", tiff.encode(
        _image(45, 67, 3), "lzw", predictor=2, rows_per_strip=7), None
    yield "deflate_pred2_tiles_edges.tif", tiff.encode(
        _image(37, 45, 4), "deflate", predictor=2, tile=(16, 16)), None
    yield "packbits_planar_tiles.tif", tiff.encode(
        _image(33, 35, 5), "packbits", planar=2, tile=(16, 32)), None
    yield "lzw_big_endian.tif", tiff.encode(
        _image(30, 31, 6), "lzw", byteorder=">", rows_per_strip=4), None
    yield "bigtiff_deflate.tif", tiff.encode(
        _image(30, 31, 7), "adobe_deflate", bigtiff=True), None
    yield "rgb16_lzw_pred2_mm.tif", tiff.encode(
        rng.randint(0, 65536, (21, 22, 3)).astype(np.uint16), "lzw", bits=16,
        predictor=2, byteorder=">"), None
    grey16 = rng.randint(0, 700, (21, 22)).astype(np.uint16)
    yield "grey16_miniswhite.tif", tiff.encode(grey16, "none", bits=16,
                                               photometric=0), None
    yield "bilevel_odd_width.tif", tiff.encode(
        rng.randint(0, 2, (9, 13)), "packbits", bits=1, photometric=0), None
    for bits in (2, 4):
        yield f"palette{bits}_lzw.tif", tiff.encode(
            rng.randint(0, 1 << bits, (17, 19)), "lzw", bits=bits,
            photometric=3, colormap=rng.randint(0, 65536, (3, 1 << bits))), \
            None
    yield "palette8_tiles.tif", tiff.encode(
        rng.randint(0, 256, (20, 36)), "deflate", photometric=3,
        colormap=rng.randint(0, 65536, (3, 256)), tile=(16, 16)), None
    yield "grey4_fill2_lzw.tif", tiff.encode(
        rng.randint(0, 16, (11, 21)), "lzw", bits=4, photometric=1,
        fill_order=2), None
    yield "signed8_grey.tif", tiff.encode(rng.randint(0, 256, (8, 9)),
                                          "deflate", photometric=1,
                                          sample_format=2), None
    alpha = np.concatenate([_image(16, 18, 8),
                            rng.randint(0, 256, (16, 18, 1))], -1)
    alpha[0, :3, 3] = 0
    yield "rgba_associated.tif", tiff.encode(alpha, "lzw",
                                             extra_samples=(1,)), None
    yield "rgbx_unspecified.tif", tiff.encode(alpha, "packbits",
                                              extra_samples=(0,)), None
    yield "palette_alpha.tif", tiff.encode(
        rng.randint(0, 256, (10, 12, 2)), "none", photometric=3,
        extra_samples=(2,), colormap=rng.randint(0, 65536, (3, 256))), None
    yield "orientation6.tif", tiff.encode(_image(20, 30, 9), "lzw",
                                          orientation=6), None
    yield "orientation3.tif", tiff.encode(_image(20, 30, 9), "none",
                                          orientation=3), None
    yield "two_pages.tif", tiff.encode(_image(20, 24, 10), "deflate",
                                       pages=[_image(24, 20, 11)]), None
    yield "size_1x1.tif", tiff.encode(_image(1, 1, 12), "lzw"), None
    yield "pil_jpeg.tif", _pil(rgb, compression="jpeg"), None
    yield from _jpeg_cases()
    # refused kinds
    yield "pil_group4.tif", _pil(rgb, "1", compression="group4"), \
        "CCITT Group 4"
    yield "pil_group3.tif", _pil(rgb, "1", compression="group3"), \
        "CCITT Group 3"
    yield "pil_ccitt_rle.tif", _pil(rgb, "1", compression="tiff_ccitt"), \
        "CCITT RLE"
    yield "pil_lzma.tif", _pil(rgb, compression="lzma"), "LZMA"
    yield "pil_zstd.tif", _pil(rgb, compression="zstd"), "ZSTD"
    yield "pil_cmyk.tif", _pil(rgb, "CMYK"), "CMYK"
    yield "pil_lab.tif", _pil(rgb, "LAB"), "CIELab"
    yield "pil_float32.tif", _pil(rgb, "F"), "floating-point"
    yield "pil_int32.tif", _pil(rgb, "I"), "32-bit"
    yield "ycbcr_lzw.tif", tiff.encode(rgb, "lzw", photometric=6), "YCbCr"
    yield "predictor3.tif", tiff.encode(rgb, "lzw", predictor=3), \
        "floating-point predictor"
    yield "predictor2_4bit.tif", tiff.encode(
        rng.randint(0, 16, (8, 8)), "lzw", bits=4, predictor=2), \
        "predictor 2 at 4 bits"
    yield "bigtiff_big_endian.tif", tiff.encode(rgb, "none", bigtiff=True,
                                                byteorder=">"), \
        "big-endian BigTIFF"
    yield "grey16_miniswhite_mm.tif", tiff.encode(
        grey16, "none", bits=16, photometric=0, byteorder=">"), \
        "16-bit MinIsWhite"
    yield "planar_rgbx_lzw.tif", tiff.encode(alpha, "lzw", planar=2,
                                             extra_samples=(0,)), "planar"
    yield "planar_rgba_no_extra.tif", tiff.encode(alpha, "deflate",
                                                  planar=2), "planar"
    yield "planar_rgb16_raw.tif", tiff.encode(
        rng.randint(0, 65536, (8, 9, 3)).astype(np.uint16), "none", bits=16,
        planar=2), "uncompressed planar"
    huge = bytearray(tiff.encode(rgb[:1, :1], "none"))
    at = struct.unpack("<I", huge[4:8])[0] + 2
    for k in range(struct.unpack("<H", huge[at - 2:at])[0]):
        tag, kind = struct.unpack("<HH", huge[at + 12 * k:at + 12 * k + 4])
        if tag in (256, 257):  # 20000 x 20000: past 2^27 pixels
            huge[at + 12 * k + 8:at + 12 * k + 12] = struct.pack("<I", 20000)
    yield "header_20000x20000.tif", bytes(huge), "implausible image size"


def _classic(entries, blobs):
    """A little-endian classic TIFF written by hand: `blobs` first, then
    one IFD of `entries` (tag, type, values, or a function of the blobs'
    offsets giving them)."""
    out = bytearray(b"II*\x00" + bytes(4))
    offsets = []
    for blob in blobs:
        offsets.append(len(out))
        out += blob + b"\x00" * (len(blob) % 2)
    placed = []
    for tag, kind, values in sorted(entries, key=lambda e: e[0]):
        values = values(offsets) if callable(values) else values
        body = struct.pack(f"<{len(values)}{'HI'[kind == 4]}", *values)
        if len(body) > 4:
            where = len(out)
            out += body + b"\x00" * (len(body) % 2)
            body = struct.pack("<I", where)
        placed.append(struct.pack("<HHI", tag, kind, len(values))
                      + body.ljust(4, b"\x00"))
    struct.pack_into("<I", out, 4, len(out))
    out += struct.pack("<H", len(placed)) + b"".join(placed) + bytes(4)
    return bytes(out)


def _jpeg_strips(img, streams, rows, subsampling, compression=7, extra=()):
    """A hand-built YCbCr JPEG TIFF of `streams`, one strip each of
    `rows` rows (RowsPerStrip)."""
    h, w = img.shape[:2]
    return _classic([
        (256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
        (259, 3, [compression]), (262, 3, [6]), (273, 4, lambda o: o),
        (277, 3, [3]), (278, 4, [rows]),
        (279, 4, [len(s) for s in streams]), (284, 3, [1]),
        (530, 3, list(subsampling)), *extra], streams)


def _jpeg_cases():
    """JPEG-compressed TIFF (compression 7) as libtiff writes it, by the
    port's writer: YCbCr at each sampling in strips (a short last strip)
    and tiles (edge tiles clipped) of sizes that are not multiples of 16,
    tables in every stream or in JPEGTables, restart markers, markers
    that contradict the photometric, RGB, grey, MinIsWhite, Orientation;
    then hand-built files of libtiff's rules and the refused kinds."""
    img = _image(45, 67, 13)
    for (h, v), name in (((2, 2), "22"), ((2, 1), "21"), ((1, 1), "11"),
                         ((1, 2), "12")):
        yield f"jpeg_ycc{name}_strips.tif", tiff.encode(
            img, "jpeg", photometric=6, subsampling=(h, v),
            rows_per_strip=16), None
        yield f"jpeg_ycc{name}_tiles.tif", tiff.encode(
            img, "jpeg", photometric=6, subsampling=(h, v), tile=(32, 16)), \
            None
    yield "jpeg_ycc22_no_tables.tif", tiff.encode(
        img, "jpeg", photometric=6, rows_per_strip=32, jpeg_tables=False), None
    yield "jpeg_ycc22_restart.tif", tiff.encode(
        img, "jpeg", photometric=6, tile=(48, 32), restart_interval=2), None
    yield "jpeg_ycc22_adobe_rgb.tif", tiff.encode(  # Adobe says RGB
        img, "jpeg", photometric=6, rows_per_strip=16, adobe=0), None
    yield "jpeg_ycc21_no_subsampling_tag.tif", tiff.encode(
        img, "jpeg", photometric=6, subsampling=(2, 1),
        subsampling_tag=False, rows_per_strip=16), None
    yield "jpeg_ycc22_orientation6.tif", tiff.encode(
        img, "jpeg", photometric=6, tile=(32, 32), orientation=6), None
    yield "jpeg_rgb_strips.tif", tiff.encode(
        img, "jpeg", photometric=2, rows_per_strip=8), None
    yield "jpeg_rgb_jfif_adobe_ycc.tif", tiff.encode(  # markers say YCbCr
        img, "jpeg", photometric=2, tile=(32, 32), jfif=True, adobe=1), None
    yield "jpeg_rgb_fill2.tif", tiff.encode(
        img, "jpeg", photometric=2, fill_order=2), None
    yield "jpeg_grey_tiles.tif", tiff.encode(
        img[..., 1], "jpeg", photometric=1, tile=(16, 32)), None
    yield "jpeg_miniswhite.tif", tiff.encode(
        img[..., 2], "jpeg", photometric=0, rows_per_strip=24,
        orientation=3), None
    yield "pil_jpeg_ycbcr.tif", _pil(img, "YCbCr", compression="jpeg"), None
    # a last strip coded at the full strip height: libtiff keeps its top
    # rows (JPEGPreDecode)
    tall = _image(40, 48, 14)
    padded = np.concatenate([tall, _image(8, 48, 15)])
    yield "jpeg_last_strip_taller.tif", _jpeg_strips(tall, [
        jpeg.encode(padded[y:y + 16], 90, "4:2:0", jfif=False)
        for y in (0, 16, 32)], 16, (2, 2)), None
    # refused: what libtiff refuses, or reads otherwise
    yield "jpeg_subsampling_mismatch.tif", tiff.encode(
        img, "jpeg", photometric=6, subsampling=(1, 1),
        subsampling_tag=(2, 2)), "JPEG sampling factors"
    yield "jpeg_planar_rgb.tif", tiff.encode(
        img, "jpeg", photometric=2, planar=2, rows_per_strip=16), \
        "planar JPEG-compressed TIFF"
    grey = bytearray(tiff.encode(img[..., 0], "jpeg", photometric=1))
    at = struct.unpack("<I", grey[4:8])[0] + 2
    for k in range(struct.unpack("<H", grey[at - 2:at])[0]):
        if struct.unpack("<H", grey[at + 12 * k:at + 12 * k + 2])[0] == 258:
            grey[at + 12 * k + 8:at + 12 * k + 10] = struct.pack("<H", 12)
    yield "jpeg_12bit.tif", bytes(grey), "12-bit JPEG-compressed TIFF"
    # a strip coded shorter than its rows: libtiff leaves the rest of its
    # buffer, the previous strip's rows, in the image
    yield "jpeg_short_strip.tif", _jpeg_strips(tall, [
        jpeg.encode(tall[y:y + rows], 90, "4:2:0", jfif=False)
        for y, rows in ((0, 16), (16, 16), (32, 4))], 16, (2, 2)), \
        "JPEG strip or tile of 4x48"
    # old-style JPEG (compression 6): the strip and JPEGInterchangeFormat
    # (tags 513/514) both a whole baseline JFIF stream
    jif = jpeg.encode(tall, 90, "4:2:0")
    yield "old_style_jpeg.tif", _jpeg_strips(
        tall, [jif], 40, (2, 2), compression=6,
        extra=((512, 3, [1]), (513, 4, lambda o: o),
               (514, 4, [len(jif)]))), "old-style JPEG"


def _digest(rgb):
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def main():
    warnings.simplefilter("ignore")
    import PIL

    oracle = (f"Pillow {PIL.__version__} (libtiff "
              f"{features.version('libtiff')})")
    manifest = {}
    for old in HERE.glob("*.tif"):
        old.unlink()
    for name, data, refused in _cases():
        path = HERE / name
        path.write_bytes(data)
        entry = {"sha256": hashlib.sha256(data).hexdigest()}
        try:
            rgb = load_image(str(path))
        except Exception:  # the JAX package does not read it either
            rgb = None
        if refused:
            entry["refused"] = refused
            if rgb is not None:
                entry["jax_reads"] = _digest(rgb)
        else:
            entry.update(shape=list(rgb.shape), decode_sha256=_digest(rgb),
                         oracle=oracle)
        manifest[name] = entry
    with open(HERE / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(HERE / n) for n in manifest)
    print(f"{len(manifest)} files, {total} bytes")


if __name__ == "__main__":
    main()
