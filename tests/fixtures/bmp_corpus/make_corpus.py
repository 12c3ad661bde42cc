"""Write the BMP corpus of the port's BMP tests and of chip_smoke.py phase
19: files written by hand with `struct` (Pillow writes only a few BMP
kinds) and a few by Pillow, and a `manifest.json` with each file's SHA-256
and
- for the files the port reads, the SHA-256 of the JAX package's RGB
  decode (`mapping_tpu.data.loader.load_image`, Pillow's convert("RGB"))
  and its shape;
- for the files the port refuses, the cause its ValueError names, and
  whether the JAX package reads the file all the same (`jax_reads`, with
  its decode's SHA-256).

The files cover every info header size (12, 40, 52, 56, 64, 108, 124),
every depth (1, 4, 8, 16, 24, 32), raw, RLE8, RLE4 and each bitfields mask
set Pillow lists, top-down rows, grey-ramp, black-and-white and coloured
palettes, indices past a short palette, Pillow's RLE quirks (the four-byte
delta, clipped runs, odd RLE4 absolute counts, word alignment by file
position), headerless DIB files, and the kinds Pillow refuses.

Run from the root of the repository, where Pillow is installed:

    python tests/fixtures/bmp_corpus/make_corpus.py
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
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from mapping_tpu.data.loader import load_image  # noqa: E402

#: Pillow's bitfields masks by name, as (bits, masks)
MASKS = {
    "bgrx": (32, (0xFF0000, 0xFF00, 0xFF, 0)),
    "xbgr": (32, (0xFF000000, 0xFF0000, 0xFF00, 0)),
    "bgxr": (32, (0xFF000000, 0xFF00, 0xFF, 0)),
    "abgr": (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
    "rgba": (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    "bgra": (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "bgar": (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)),
    "zero": (32, (0, 0, 0, 0)),
    "bgr24": (24, (0xFF0000, 0xFF00, 0xFF, 0)),
    "565": (16, (0xF800, 0x7E0, 0x1F, 0)),
    "555": (16, (0x7C00, 0x3E0, 0x1F, 0)),
}


def tile(h, w, seed):
    """A tile-like picture: gradients, noise and a bright block."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([40 + 120 * x / max(w, 1), 60 + 100 * y / max(h, 1),
                    90 + 60 * np.sin(x / 5.0 + y / 7.0)], -1)
    img += rng.randint(0, 30, (h, w, 3))
    img[h // 4:h // 2 + 1, w // 3:w // 2 + 1] = rng.randint(170, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def building_tile(side, seed, levels=None):
    """A 300^2-style tile for chip_smoke.py phase 19's predict_on_dir: a
    smooth ground, faint noise and bright rectangles; with `levels`, each
    channel quantised to that many levels (for a palette)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:side, 0:side]
    img = np.stack([60 + 40 * x / side, 70 + 30 * y / side,
                    np.full((side, side), 55.0)], -1)
    img += rng.randint(0, 3, (side, side, 3))
    for _ in range(rng.randint(3, 9)):
        bh, bw = rng.randint(20, 70, 2)
        y0, x0 = rng.randint(5, side - 75, 2)
        img[y0:y0 + bh, x0:x0 + bw] = rng.randint(170, 255, 3)
        img[y0:y0 + 2, x0:x0 + bw] -= 40
    img = np.clip(img, 0, 255).astype(np.uint8)
    if levels:
        img = (img // (256 // levels) * (256 // levels)).astype(np.uint8)
    return img


def info_header(size, width, height, bits, compression=0, colors=0,
                masks=None, top_down=False, image_size=0):
    """A BITMAPINFOHEADER-family header of `size` bytes (12: the OS/2 core
    header); masks go into headers of 52 bytes and more."""
    if size == 12:
        return struct.pack("<IHHHH", 12, width, height, 1, bits)
    h = (2 ** 32 - height) if top_down else height
    head = struct.pack("<IIIHHIIiiII", size, width, h, 1, bits, compression,
                       image_size, 2835, 2835, colors, 0)
    if size >= 52 and masks is not None:
        head += struct.pack("<4I", *masks)[:16 if size >= 56 else 12]
    return head.ljust(size, b"\0")


def bmp(info, palette=b"", pixels=b"", masks40=b"", offset=None, dib=False):
    """A file: the file header (unless `dib`), the info header, masks after
    a 40-byte header, the palette and the pixel data; `offset` overrides
    the data offset."""
    body = info + masks40 + palette
    if dib:
        return body + pixels
    if offset is None:
        offset = 14 + len(body)
    return b"BM" + struct.pack("<IHHI", 14 + len(body) + len(pixels), 0, 0,
                               offset) + body + pixels


def rows(samples, bits, top_down=False):
    """Raw rows of (h, w) palette indices or (h, w, c) bytes, padded to 4
    bytes, bottom-up unless top_down."""
    h = samples.shape[0]
    if bits < 8:
        per = 8 // bits
        w = samples.shape[1]
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = samples
        shifts = (8 - bits * (1 + np.arange(per)))
        packed = (padded.reshape(h, -1, per) << shifts).sum(-1).astype(
            np.uint8)
    else:
        packed = samples.reshape(h, -1).astype(np.uint8)
    stride = -(-packed.shape[1] // 4) * 4
    out = np.zeros((h, stride), np.uint8)
    out[:, :packed.shape[1]] = packed
    return (out if top_down else out[::-1]).tobytes()


def palette_bytes(rgb, entry=4):
    """BGR(X) palette entries of an (n, 3) RGB table."""
    bgr = np.asarray(rgb, np.uint8)[:, ::-1]
    if entry == 4:
        bgr = np.concatenate([bgr, np.zeros((len(bgr), 1), np.uint8)], 1)
    return bgr.tobytes()


def colour_table(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 3)).astype(
        np.uint8)


def rle8(indices):
    """RLE8 as a BMP writer emits it: runs of equal indices, absolute
    stretches of 3 or more different ones (padded to a word), an end of
    line per row and an end of bitmap; rows bottom-up."""
    out = bytearray()
    for row in indices[::-1]:
        i, w = 0, len(row)
        while i < w:
            j = i
            while j < w and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= 2 or w - i < 3:
                out += bytes([j - i, row[i]])
                i = j
                continue
            j = i
            while j < w and j - i < 255 and (j + 1 >= w
                                              or row[j] != row[j + 1]):
                j += 1
            n = max(j - i, 3) if w - i >= 3 else w - i
            out += bytes([0, n]) + bytes(row[i:i + n].tolist())
            if n % 2:
                out += b"\0"
            i += n
        out += b"\0\0"
    return bytes(out) + b"\0\1"


def pixels_of(img, bits, table=None):
    """The samples of an RGB image at a depth: palette indices (nearest
    entry of `table`) up to 8 bits, else packed bytes."""
    if bits <= 8:
        d = ((img[:, :, None, :].astype(int) - table[None, None].astype(int))
             ** 2).sum(-1)
        return d.argmin(-1).astype(np.uint8)
    if bits == 24:
        return img[..., ::-1]
    if bits == 32:
        return np.concatenate([img[..., ::-1], np.full(img.shape[:2] + (1,),
                                                       77, np.uint8)], -1)
    v = ((img[..., 0].astype(np.uint16) >> 3) << 10
         | (img[..., 1].astype(np.uint16) >> 3) << 5
         | img[..., 2].astype(np.uint16) >> 3)
    return v.astype("<u2").view(np.uint8).reshape(img.shape[0], -1)


def masked(img, masks, bits):
    """Pixels of an RGB image under bitfields masks (alpha from a
    gradient)."""
    h, w, _ = img.shape
    alpha = (np.arange(w)[None, :] * 255 // max(w - 1, 1)).repeat(h, 0)
    v = np.zeros((h, w), np.uint64)
    for channel, mask in zip((img[..., 0], img[..., 1], img[..., 2], alpha),
                             masks):
        if mask:
            shift = (mask & -mask).bit_length() - 1
            top = mask >> shift
            v |= ((channel.astype(np.uint64) * top // 255) << shift)
    return v.astype({32: "<u4", 24: "<u4", 16: "<u2"}[bits]).view(
        np.uint8).reshape(h, w, -1)[..., :bits // 8].reshape(h, -1)


def _cases():
    """(name, bytes, refused cause or None)."""
    img = tile(13, 19, 1)
    table16, table256 = colour_table(16, 2), colour_table(256, 3)
    table2 = np.array([[200, 30, 40], [10, 220, 90]], np.uint8)

    # every header size x depth, bottom-up, coloured palettes
    for size in (12, 40, 52, 56, 64, 108, 124):
        for bits in (1, 4, 8, 16, 24, 32):
            table = {1: table2, 4: table16, 8: table256}.get(bits)
            entry = 3 if size == 12 else 4
            pal = palette_bytes(table, entry) if table is not None else b""
            yield (f"h{size}_{bits}bit.bmp",
                   bmp(info_header(size, 19, 13, bits), pal,
                       rows(pixels_of(img, bits, table), bits)), None)
    # top-down rows
    for bits in (4, 8, 24):
        table = {4: table16, 8: table256}.get(bits)
        pal = palette_bytes(table) if table is not None else b""
        yield (f"top_down_{bits}bit.bmp",
               bmp(info_header(40, 19, 13, bits, top_down=True), pal,
                   rows(pixels_of(img, bits, table), bits, True)), None)
    # every bitfields mask set Pillow lists
    for name, (bits, masks) in MASKS.items():
        data = rows(masked(img, masks, bits), 8)
        if masks[3] or name == "zero":
            yield (f"bitfields_{name}_v3.bmp",
                   bmp(info_header(56, 19, 13, bits, 3, masks=masks),
                       pixels=data), None)
        yield (f"bitfields_{name}.bmp",  # a 40-byte header: no alpha mask
               bmp(info_header(40, 19, 13, bits, 3),
                   masks40=struct.pack("<3I", *masks[:3]), pixels=data),
               None if bits < 32 or (bits, masks[:3] + (0,)) in MASKS.values()
               else "bitfields")
    yield ("bitfields_565_v5.bmp",
           bmp(info_header(124, 19, 13, 16, 3, masks=MASKS["565"][1]),
               pixels=rows(masked(img, MASKS["565"][1], 16), 8)), None)
    # grey ramps and black and white: Pillow's "L" and "1"
    grey = img.mean(-1).astype(np.uint8)
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    yield ("grey_ramp_8bit.bmp", bmp(info_header(40, 19, 13, 8),
                                     palette_bytes(ramp), rows(grey, 8)),
           None)
    bw = np.array([[0, 0, 0], [255, 255, 255]], np.uint8)
    yield ("black_white_1bit.bmp",
           bmp(info_header(40, 19, 13, 1, colors=2), palette_bytes(bw),
               rows((grey > 120).astype(np.uint8), 1)), None)
    yield ("black_white_8bit.bmp",  # "1" read from 8-bit data
           bmp(info_header(40, 19, 13, 8, colors=2), palette_bytes(bw),
               rows(grey, 8)), None)
    yield ("grey_ramp_4bit_3_colours.bmp",  # "L" over 4-bit rows, mapped
           bmp(info_header(40, 19, 13, 4, colors=3), palette_bytes(ramp[:3]),
               rows((grey % 3).astype(np.uint8), 4)), None)
    yield ("grey_ramp_core12.bmp",
           bmp(info_header(12, 19, 13, 8), palette_bytes(ramp, 3),
               rows(grey, 8)), None)
    # short palettes: an index past the palette reads black
    idx = (np.arange(19 * 13).reshape(13, 19) % 9).astype(np.uint8)
    yield ("short_palette_8bit.bmp",
           bmp(info_header(40, 19, 13, 8, colors=5),
               palette_bytes(table256[:5]), rows(idx, 8)), None)
    yield ("short_palette_4bit.bmp",
           bmp(info_header(40, 19, 13, 4, colors=6),
               palette_bytes(table16[:6]), rows(idx, 4)), None)
    # offsets: after the header only (moved past the palette), zero (the
    # data follows the palette), and a gap before the data
    body = rows(pixels_of(img, 8, table256), 8)
    yield ("offset_after_header.bmp",
           bmp(info_header(40, 19, 13, 8), palette_bytes(table256), body,
               offset=14 + 40), None)
    yield ("offset_zero.bmp", bmp(info_header(40, 19, 13, 8),
                                  palette_bytes(table256), body, offset=0),
           None)
    yield ("offset_gap.bmp",
           bmp(info_header(40, 19, 13, 24), b"\xAA" * 6,
               rows(pixels_of(img, 24), 24), offset=14 + 40 + 6), None)
    yield ("trailing_bytes.bmp", bmp(info_header(40, 19, 13, 24), b"",
                                     rows(pixels_of(img, 24), 24)
                                     + b"junk" * 9), None)
    # RLE8 and RLE4, with Pillow's quirks
    pal16 = palette_bytes(table16)
    yield ("rle8_delta_quirk.bmp",
           bmp(info_header(40, 4, 2, 8, 1, colors=16), pal16,
               bytes.fromhex("0205000201000107000004090001")), None)
    yield ("rle8_tile.bmp",
           bmp(info_header(40, 19, 13, 8, 1), palette_bytes(table256),
               rle8(pixels_of(img, 8, table256))), None)
    yield ("rle8_runs_clipped.bmp",  # runs past the row's end
           bmp(info_header(40, 6, 3, 8, 1, colors=16), pal16,
               bytes.fromhex("0903 0000 0405 0a06 0000 0201 0307 0000 0001")),
           None)
    yield ("rle8_absolute_odd.bmp",  # absolute runs of 3 and 5, padded
           bmp(info_header(40, 8, 2, 8, 1, colors=16), pal16,
               bytes.fromhex("0003 010203 00 0305 0000 0005 0405060708 00"
                             " 0302 0000 0001")), None)
    yield ("rle8_absolute_past_row.bmp",  # not clipped to the row
           bmp(info_header(40, 4, 3, 8, 1, colors=16), pal16,
               bytes.fromhex("0006 010203040506 0207 0000 0409 0001")), None)
    yield ("rle8_end_of_line_padding.bmp",
           bmp(info_header(40, 5, 3, 8, 1, colors=16), pal16,
               bytes.fromhex("0201 0000 0302 0000 0101 0000 0001")), None)
    yield ("rle8_top_down.bmp",
           bmp(info_header(40, 19, 13, 8, 1, top_down=True),
               palette_bytes(table256), rle8(pixels_of(img, 8, table256))),
           None)
    yield ("rle8_grey.bmp",  # a grey ramp: "L" samples
           bmp(info_header(40, 19, 13, 8, 1), palette_bytes(ramp),
               rle8(grey)), None)
    yield ("rle8_longer_than_image.bmp",  # a delta past the end
           bmp(info_header(40, 4, 2, 8, 1, colors=16), pal16,
               bytes.fromhex("0405 0000 0406 0002 0000 0505")), None)
    yield ("rle4_runs.bmp",
           bmp(info_header(40, 9, 3, 4, 2), pal16,
               bytes.fromhex("0912 0000 0534 0456 0000 09ab 0000 0001")),
           None)
    yield ("rle4_absolute_odd.bmp",  # 5 pixels read as 2 bytes
           bmp(info_header(40, 8, 2, 4, 2), pal16,
               bytes.fromhex("0005 1234 0003 0567 0000 0008 89abcdef"
                             " 0000 0001")), None)
    yield ("rle4_delta.bmp",
           bmp(info_header(40, 6, 3, 4, 2), pal16,
               bytes.fromhex("0221 0002 aaaa 0102 0377 0000 06ef 0000 0001")),
           None)
    # DIB: no file header
    yield ("dib_40_24bit.dib",
           bmp(info_header(40, 19, 13, 24), b"", rows(pixels_of(img, 24), 24),
               dib=True), None)
    yield ("dib_12_8bit.dib",
           bmp(info_header(12, 19, 13, 8), palette_bytes(table256, 3),
               rows(pixels_of(img, 8, table256), 8), dib=True), None)
    yield ("dib_124_bitfields_565.dib",
           bmp(info_header(124, 19, 13, 16, 3, masks=MASKS["565"][1]),
               pixels=rows(masked(img, MASKS["565"][1], 16), 8), dib=True),
           None)
    yield ("dib_rle8_absolute_odd.dib",  # alignment by file position
           bmp(info_header(40, 8, 2, 8, 1, colors=16), pal16,
               bytes.fromhex("0003 010203 00 0305 0000 0005 0405060708 00"
                             " 0302 0000 0001"), dib=True), None)
    # Pillow-written files
    for mode in ("RGB", "L", "P", "1"):
        im = Image.fromarray(img)
        im = {"RGB": im, "L": im.convert("L"), "1": im.convert("1"),
              "P": im.quantize(37)}[mode]
        for fmt in ("BMP", "DIB"):
            buf = io.BytesIO()
            im.save(buf, fmt)
            yield f"pil_{mode.lower()}.{fmt.lower()}", buf.getvalue(), None
    # 300^2 tiles for chip_smoke.py phase 19
    for k in range(2):
        big = building_tile(300, 40 + k)
        yield (f"tile300_raw24_{k}.bmp",
               bmp(info_header(40, 300, 300, 24), b"",
                   rows(pixels_of(big, 24), 24)), None)
        levels = building_tile(300, 50 + k, levels=6)
        table = np.unique(levels.reshape(-1, 3), axis=0)
        lut = {tuple(c): i for i, c in enumerate(table)}
        idx = np.array([[lut[tuple(c)] for c in r] for r in levels],
                       np.uint8)
        yield (f"tile300_rle8_{k}.bmp",
               bmp(info_header(40, 300, 300, 8, 1, colors=len(table)),
                   palette_bytes(table), rle8(idx)), None)

    # refused, as Pillow refuses them
    data24 = rows(pixels_of(img, 24), 24)
    for comp, cause in ((4, "JPEG compression"), (5, "PNG compression"),
                        (6, "compression (6)"), (11, "compression (11)")):
        yield (f"compression_{comp}.bmp",
               bmp(info_header(40, 19, 13, 24, comp), b"", data24), cause)
    yield ("depth_2.bmp", bmp(info_header(40, 19, 13, 2), b"", data24),
           "depth (2 bits)")
    yield ("depth_0_core12.bmp", bmp(info_header(12, 19, 13, 0), b"", data24),
           "depth (0 bits)")
    yield ("depth_64.bmp", bmp(info_header(40, 19, 13, 64), b"", data24 * 3),
           "depth (64 bits)")
    yield ("bitfields_rgbx.bmp",
           bmp(info_header(40, 19, 13, 32, 3),
               masks40=struct.pack("<3I", 0xFF, 0xFF00, 0xFF0000),
               pixels=data24 * 2), "bitfields")
    yield ("bitfields_565_reversed.bmp",
           bmp(info_header(40, 19, 13, 16, 3),
               masks40=struct.pack("<3I", 0x1F, 0x7E0, 0xF800),
               pixels=data24), "bitfields")
    yield ("bitfields_8bit.bmp",
           bmp(info_header(40, 19, 13, 8, 3), palette_bytes(table256),
               masks40=struct.pack("<3I", 0xE0, 0x1C, 0x3)), "bitfields")
    yield ("header_size_20.bmp",
           b"BM" + struct.pack("<IHHI", 60, 0, 0, 34) + struct.pack(
               "<I", 20) + bytes(40), "header size (20)")
    yield ("header_cut_short.bmp", bmp(info_header(40, 19, 13, 24))[:40],
           "info header cut short")
    yield ("palette_size_70000.bmp",
           bmp(info_header(40, 19, 13, 8, colors=70000),
               palette_bytes(table256), data24), "palette size (70000)")
    yield ("palette_300_colours.bmp",
           bmp(info_header(40, 19, 13, 8, colors=300),
               palette_bytes(colour_table(300, 4)), data24),
           "palette of 300 colours")
    yield ("pixels_cut_short.bmp",
           bmp(info_header(40, 19, 13, 24), b"", data24[:len(data24) // 2]),
           "pixel data cut short")
    yield ("rle8_end_of_bitmap_early.bmp",
           bmp(info_header(40, 4, 2, 8, 1, colors=16), pal16,
               bytes.fromhex("0401 0001")), "ends before the image is full")
    yield ("rle8_data_cut_short.bmp",
           bmp(info_header(40, 19, 13, 8, 1), palette_bytes(table256),
               rle8(pixels_of(img, 8, table256))[:60]),
           "ends before the image is full")
    yield ("rle8_delta_cut_short.bmp",
           bmp(info_header(40, 4, 2, 8, 1, colors=16), pal16,
               bytes.fromhex("0401 0002 0000 01")), "delta escape cut short")
    yield ("rle8_on_24bit.bmp",
           bmp(info_header(40, 4, 2, 24, 1), b"",
               bytes.fromhex("0401 0000 0401 0001")), "RLE data on a 24-bit")
    yield ("rle8_black_white.bmp",
           bmp(info_header(40, 4, 2, 8, 1, colors=2), palette_bytes(bw),
               bytes.fromhex("0401 0000 0401 0001")), "RLE data on a bilevel")
    yield ("zero_width.bmp", bmp(info_header(40, 0, 13, 24), b"", data24),
           "of 0x13 pixels")
    yield ("huge_header.bmp", bmp(info_header(40, 40000, 40000, 24), b"",
                                  data24), "implausible image size")
    yield ("dib_depth_2.dib", bmp(info_header(40, 19, 13, 2), b"", data24,
                                  dib=True), "depth (2 bits)")
    yield ("os2_bitmap_array.bmp", b"BA" + bmp(info_header(40, 19, 13, 24),
                                               b"", data24)[2:],
           "not a JPEG, PNG, TIFF, WebP, BMP or GIF")


def _digest(rgb):
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def main():
    warnings.simplefilter("ignore")
    import PIL

    from mapping_tpu_torch.utils import native_decode

    oracle = f"Pillow {PIL.__version__}"
    manifest = {}
    for old in list(HERE.glob("*.bmp")) + list(HERE.glob("*.dib")):
        old.unlink()
    for name, data, refused in _cases():
        path = HERE / name
        path.write_bytes(data)
        entry = {"sha256": hashlib.sha256(data).hexdigest()}
        try:
            rgb = load_image(str(path))
        except Exception:  # the JAX package does not read it either
            rgb = None
        try:
            native_decode.decode_rgb_bytes(data)
            port_refuses = None
        except ValueError as e:
            port_refuses = str(e)
        if refused is None and (port_refuses is not None or rgb is None):
            raise SystemExit(f"{name}: meant to be read, but the port says "
                             f"{port_refuses!r}, the JAX loader "
                             f"{'reads it' if rgb is not None else 'not'}")
        if refused is not None and (port_refuses is None
                                    or refused not in port_refuses):
            raise SystemExit(f"{name}: meant to be refused for {refused!r}, "
                             f"the port says {port_refuses!r}")
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
