"""Write the GIF corpus of the port's GIF tests and of chip_smoke.py phase
19: files written by Pillow (`save(..., "GIF")`) and by hand (an LZW
encoder here, for what Pillow does not write), and a `manifest.json` with
each file's SHA-256 and
- for the files the port reads, the SHA-256 of the JAX package's RGB
  decode (`mapping_tpu.data.loader.load_image`, Pillow's convert("RGB") of
  the first frame) and its shape;
- for the files the port refuses, the cause its ValueError names, and
  whether the JAX package reads the file all the same (`jax_reads`, with
  its decode's SHA-256).

The files cover GIF87a and GIF89a, global and local colour tables, grey
ramps that Pillow drops, a frame with no table, a frame smaller than the
screen and offset in it (with and without a transparency index), a frame
that grows the screen, interlaced rows, minimum code sizes 0 to 12, the
extension blocks (graphic control, comment, application, plain text),
two-frame animations, an index past a short table, a full code table with
no clear code, tiny sub-blocks, and the kinds Pillow refuses.

Run from the root of the repository, where Pillow is installed:

    python tests/fixtures/gif_corpus/make_corpus.py
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
from tests.fixtures.bmp_corpus.make_corpus import (  # noqa: E402
    building_tile, tile)


def lzw(indices, bits, clear_every=None):
    """GIF LZW codes of a sequence of indices as (code, width) pairs: a
    clear code first, the end code last; with `clear_every`, a clear code
    once the table holds that many entries, else the table fills to 4096
    entries and stays full."""
    clear = 1 << bits
    size = bits + 1
    out = [(clear, size)]
    table, nxt = {(i,): i for i in range(clear)}, clear + 2
    w = ()
    for k in indices:
        c = (int(k),)
        if w + c in table:
            w += c
            continue
        out.append((table[w], size))
        if clear_every and nxt >= clear_every:
            out.append((clear, size))
            size, nxt = bits + 1, clear + 2
            table = {(i,): i for i in range(clear)}
        elif nxt < 4096:
            table[w + c] = nxt
            if nxt == 1 << size and size < 12:
                size += 1
            nxt += 1
        w = c
    if w:
        out.append((table[w], size))
    out.append((clear + 1, size))
    return out


def pack(codes):
    """LSB-first bytes of (code, width) pairs."""
    acc = count = 0
    out = bytearray()
    for code, width in codes:
        acc |= code << count
        count += width
        while count >= 8:
            out.append(acc & 255)
            acc >>= 8
            count -= 8
    if count:
        out.append(acc)
    return bytes(out)


def sub_blocks(data, size=255):
    out = bytearray()
    for i in range(0, len(data), size):
        out += bytes([len(data[i:i + size])]) + data[i:i + size]
    return bytes(out) + b"\0"


def table_bytes(rgb):
    """A colour table padded to a power of two: (flag bits, bytes)."""
    n = len(rgb)
    bits = max(1, (n - 1).bit_length())
    return bits - 1, np.asarray(rgb, np.uint8).tobytes().ljust(3 << bits,
                                                                 b"\0")


def gif(width, height, image, bits=8, global_table=None, local_table=None,
        rect=None, gce=None, interlaced=False, codes=None, extensions=b"",
        version=b"GIF89a", block=255, trailer=b";"):
    """A GIF file by hand: screen, tables, extensions, one image."""
    out = bytearray(version + struct.pack("<HH", width, height))
    if global_table is not None:
        flag, raw = table_bytes(global_table)
        out += bytes([0x80 | flag, 0, 0]) + raw
    else:
        out += bytes(3)
    out += extensions
    if gce is not None:
        out += b"!\xf9\x04" + bytes(gce) + b"\0"
    x0, y0, w, h = rect or (0, 0, width, height)
    flags = 0x40 if interlaced else 0
    local = b""
    if local_table is not None:
        flag, local = table_bytes(local_table)
        flags |= 0x80 | flag
    out += b"," + struct.pack("<4HB", x0, y0, w, h, flags) + local
    if codes is None:
        order = np.arange(h)
        if interlaced:
            order = np.concatenate([order[0::8], order[4::8], order[2::4],
                                    order[1::2]])
        codes = lzw(np.asarray(image)[order].reshape(-1), max(bits, 1))
    out += bytes([bits]) + sub_blocks(pack(codes), block) + trailer
    return bytes(out)


def pillow(img, **kw):
    buf = io.BytesIO()
    img.save(buf, "GIF", **kw)
    return buf.getvalue()


def _cases():
    """(name, bytes, refused cause or None)."""
    rng = np.random.RandomState(1)
    table = rng.randint(0, 256, (16, 3)).astype(np.uint8)
    table256 = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    idx = rng.randint(0, 16, (13, 19)).astype(np.uint8)
    idx[4:9, 5:12] = 3  # runs for the table to grow on
    img = tile(37, 41, 2)

    # Pillow-written
    yield "pil_p.gif", pillow(Image.fromarray(img).quantize(200)), None
    yield "pil_l.gif", pillow(Image.fromarray(img).convert("L")), None
    yield "pil_1.gif", pillow(Image.fromarray(img).convert("1")), None
    yield "pil_small_palette.gif", pillow(
        Image.fromarray(img).quantize(5)), None
    yield "pil_interlaced.gif", pillow(Image.fromarray(img).quantize(64),
                                       interlace=True), None
    yield "pil_not_interlaced.gif", pillow(Image.fromarray(img).quantize(64),
                                           interlace=False), None
    yield "pil_transparency.gif", pillow(Image.fromarray(img).quantize(32),
                                         transparency=3), None
    yield "pil_comment.gif", pillow(Image.fromarray(img).quantize(32),
                                    comment=b"a tile"), None
    frames = [Image.fromarray(tile(37, 41, s)).quantize(48) for s in (3, 4)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:],
                   duration=100, loop=0)
    yield "pil_two_frames.gif", buf.getvalue(), None
    small = Image.fromarray(tile(37, 41, 5)).quantize(48)
    buf = io.BytesIO()
    small.save(buf, "GIF", save_all=True, optimize=False,
               append_images=[small.crop((0, 0, 20, 20)).resize((41, 37))],
               duration=50, disposal=2)
    yield "pil_two_frames_disposal.gif", buf.getvalue(), None

    # by hand
    yield "gif87a.gif", gif(19, 13, idx, 4, table, version=b"GIF87a"), None
    yield "global_table.gif", gif(19, 13, idx, 4, table), None
    yield "local_table.gif", gif(19, 13, idx, 4, local_table=table), None
    yield ("local_over_global.gif",
           gif(19, 13, idx, 4, table256[:16], local_table=table), None)
    yield "global_ramp.gif", gif(19, 13, idx, 4, ramp[:16]), None
    yield ("local_ramp_under_global.gif",  # the global table after all
           gif(19, 13, idx, 4, table, local_table=ramp[:16]), None)
    yield "no_table.gif", gif(19, 13, idx * 13, 8), None
    yield ("index_past_table.gif",
           gif(19, 13, idx, 4, table[:5]), None)
    yield "interlaced.gif", gif(19, 13, idx, 4, table, interlaced=True), None
    for h in (1, 2, 3, 5, 9):
        yield (f"interlaced_h{h}.gif",
               gif(7, h, idx[:h, :7], 4, table, interlaced=True), None)
    yield ("offset_frame.gif",
           gif(19, 13, idx[:5, :7], 4, table, rect=(6, 4, 7, 5)), None)
    yield ("offset_frame_transparency.gif",
           gif(19, 13, idx[:5, :7], 4, table, rect=(6, 4, 7, 5),
               gce=[1, 10, 0, 9]), None)
    yield ("offset_frame_no_table_transparency.gif",
           gif(19, 13, idx[:5, :7] * 9, 8, rect=(6, 4, 7, 5),
               gce=[5, 10, 0, 200]), None)
    yield ("frame_grows_screen.gif",
           gif(10, 6, idx[:8, :9], 4, table, rect=(4, 2, 9, 8)), None)
    yield ("zero_screen.gif", gif(0, 0, idx, 4, table, rect=(0, 0, 19, 13)),
           None)
    yield ("zero_width_frame_at_0.gif",  # Pillow decodes the whole image
           gif(7, 5, idx[:5, :7], 4, table, rect=(0, 0, 0, 5),
               codes=lzw(idx[:5, :7].reshape(-1), 4)), None)
    yield ("code_size_1.gif",  # Pillow's codes stay 2 bits wide: literals
           gif(19, 13, None, 1, table[:2],
               codes=[(2, 2)] + [(int(v), 2) for v in (idx % 2).reshape(-1)]),
           None)
    for bits in (2, 3, 5, 6, 7, 8):
        n = 1 << bits
        yield (f"code_size_{bits}.gif",
               gif(19, 13, idx.astype(int) % n, bits, table256[:n]), None)
    yield ("code_size_0.gif",
           gif(5, 2, None, 0, table[:2], codes=[(1, 1)] + [(0, 1)] * 10),
           None)
    yield ("code_size_9.gif",
           gif(19, 13, idx, 9, table256, codes=lzw(idx.reshape(-1), 9)),
           None)
    yield ("code_size_12.gif",
           gif(19, 13, idx, 12, table256, codes=lzw(idx.reshape(-1), 12)),
           None)
    big = rng.randint(0, 4, (90, 130)).astype(np.uint8)
    yield ("table_full_no_clear.gif", gif(130, 90, big, 2, table[:4]), None)
    yield ("table_cleared.gif",
           gif(130, 90, big, 2, table[:4],
               codes=lzw(big.reshape(-1), 2, clear_every=4000)), None)
    yield "tiny_sub_blocks.gif", gif(19, 13, idx, 4, table, block=3), None
    yield ("extensions.gif",
           gif(19, 13, idx, 4, table, extensions=(
               b"!\xfe" + sub_blocks(b"a comment in two blocks", 11)
               + b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
               + b"!\x01\x0c" + bytes(12) + sub_blocks(b"plain text")
               + b"!\xff\x0bXMP DataXMP" + sub_blocks(b"<x/>" * 40)
               + b"!\x42" + sub_blocks(b"unknown label"))), None)
    yield ("netscape_empty_loop_block.gif",  # Pillow reads one more block
           gif(19, 13, idx, 4, table, extensions=(
               b"!\xff\x0bNETSCAPE2.0\x00" + b"\x02ab\x00")), None)
    yield ("stray_bytes.gif",
           gif(19, 13, idx, 4, table, extensions=b"\x00\x17\x2a"), None)
    yield ("two_gce.gif",
           gif(19, 13, idx[:5, :7], 4, table, rect=(6, 4, 7, 5),
               extensions=b"!\xf9\x04\x01\x00\x00\x07\x00",
               gce=[0, 0, 0, 0]), None)
    second = (b"," + struct.pack("<4HB", 0, 0, 19, 13, 0) + b"\x04"
              + sub_blocks(pack(lzw((idx[::-1] % 16).reshape(-1), 4))))
    yield ("two_frames_by_hand.gif",
           gif(19, 13, idx, 4, table, trailer=second + b";"), None)
    yield ("no_trailer.gif", gif(19, 13, idx, 4, table, trailer=b""), None)
    # 300^2 tiles for chip_smoke.py phase 19
    for k, interlace in ((0, False), (1, True)):
        yield (f"tile300_{k}.gif",
               pillow(Image.fromarray(building_tile(300, 60 + k)).quantize(
                   64), interlace=interlace), None)

    # refused, as Pillow refuses them
    ok = gif(19, 13, idx, 4, table)
    yield "zeros_after_signature.gif", b"GIF89a" + bytes(64), "no image"
    yield "screen_cut_short.gif", ok[:9], "screen descriptor cut short"
    yield "table_cut_short.gif", ok[:13 + 40], "colour table cut short"
    yield ("trailer_before_image.gif", ok[:13 + 48] + b";" + ok[13 + 48:],
           "no image")
    yield "descriptor_cut_short.gif", ok[:13 + 48 + 6], "descriptor cut short"
    yield ("short_gce.gif",
           gif(19, 13, idx, 4, table, extensions=b"!\xf9\x02\x01\x00\x00"),
           "graphic control block")
    for cut in (0.3, 0.7, 0.95):
        yield (f"data_cut_{int(cut * 100)}.gif", ok[:int(len(ok) * cut)]
               if cut > 0.5 else ok[:13 + 48 + 11 + 6], "cut short")
    codes = lzw(idx.reshape(-1), 4)
    yield ("early_end_code.gif",
           gif(19, 13, None, 4, table, codes=codes[:40] + [codes[-1]]),
           "cut short")
    yield ("code_past_next.gif",
           gif(19, 13, None, 4, table,
               codes=codes[:10] + [(30, 5)] + codes[10:]), "broken")
    yield ("first_code_past_clear.gif",
           gif(19, 13, None, 4, table, codes=[(16, 5), (20, 5)] + codes[1:]),
           "broken")
    yield ("code_size_1_growing.gif",  # codes that widen: Pillow's do not
           gif(19, 13, idx % 2, 1, table[:2]), "cut short")
    yield ("code_size_13.gif", gif(19, 13, None, 13, table256,
                                   codes=[(1, 14)] * 40), "code size past 12")
    yield ("frame_height_0.gif",
           gif(19, 13, None, 4, table, rect=(3, 2, 5, 0), codes=codes),
           "frame of 5x0")
    yield ("huge_screen.gif", gif(65535, 65535, idx, 4, table,
                                  rect=(0, 0, 19, 13)),
           "implausible image size")


def _digest(rgb):
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def main():
    warnings.simplefilter("ignore")
    import PIL

    from mapping_tpu_torch.utils import native_decode

    oracle = f"Pillow {PIL.__version__}"
    manifest = {}
    for old in HERE.glob("*.gif"):
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
