"""Write the JPEG 2000 corpus of the port's JPEG 2000 tests and of
chip_smoke.py phase 20: files written by Pillow (`save(..., "JPEG2000")`),
by the openjpeg 2.5 Pillow ships, driven through ctypes for the options
Pillow does not expose (code-block styles, SOP / EPH, POC, tile-parts, ROI,
subsampled components, any precision; tests/fixtures/jp2_corpus/opj.py),
and by hand (JP2 containers of every colour specification and palette,
PPM / PPT packet headers moved out of the packets, a last tile-part of
Psot 0, the 9/7 filter over one-sample signals, HTJ2K markers, cut and
corrupt streams), and a `manifest.json` with each file's SHA-256 and
- for the files the port reads, the SHA-256 of the JAX package's RGB
  decode (`mapping_tpu.data.loader.load_image`, Pillow's convert("RGB"))
  and its shape;
- for the files the port refuses, the cause its ValueError names, and
  whether the JAX package reads the file all the same (`jax_reads`, with
  its decode's SHA-256).

Run from the root of the repository, where Pillow is installed:

    python tests/fixtures/jp2_corpus/make_corpus.py

Each openjpeg encode runs in a child process: the library's encoder can
corrupt its process's heap on some subsampled geometries.
"""

import hashlib
import io
import json
import os
import pickle
import struct
import sys
import warnings
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from mapping_tpu.data.loader import load_image  # noqa: E402
from tests.fixtures.jp2_corpus import opj  # noqa: E402


def picture(h, w, seed, channels=3):
    """A tile-like picture: gradients, a little noise, a bright block and
    dark lines (so every sub-band holds coefficients)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([40 + 150 * x / max(w, 1), 60 + 120 * y / max(h, 1),
                    90 + 70 * np.sin(x / 5.0 + y / 7.0),
                    128 + 100 * np.cos(x / 9.0)][:channels], -1)
    img += rng.randint(0, 12, (h, w, channels))
    img[h // 4:h // 2 + 1, w // 3:w // 2 + 1] = rng.randint(170, 255,
                                                            channels)
    img[(x + 2 * y) % 17 < 2] = 20
    return np.clip(img, 0, 255).astype(np.uint8)


def building_tile(side, seed):
    """A 300^2 tile for predict_on_dir: a smooth ground, faint noise and
    bright rectangles."""
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
    return np.clip(img, 0, 255).astype(np.uint8)


def pil(img, **kw):
    """Pillow's JPEG 2000 file of `img` (uint16 reads as I;16, two bands
    as LA)."""
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def planes(img):
    return [img[..., c].astype(np.int64) for c in range(img.shape[-1])]


def encode(*args, **kw):
    """opj.encode in a child process."""
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            out = ("ok", opj.encode(*args, **kw))
        except Exception as e:  # noqa: BLE001 (sent to the parent)
            out = ("error", str(e))
        with os.fdopen(w, "wb") as f:
            f.write(pickle.dumps(out))
        os._exit(0)
    os.close(w)
    with os.fdopen(r, "rb") as f:
        data = f.read()
    _, status = os.waitpid(pid, 0)
    if status or not data:
        raise RuntimeError(f"openjpeg's encoder died ({status})")
    kind, value = pickle.loads(data)
    if kind != "ok":
        raise RuntimeError(value)
    return value


# ------------------------------------------------------ codestream surgery

def main_markers(cs):
    """[(marker, position)] of the main header, up to the first SOT."""
    out, pos = [], 2
    while True:
        m = struct.unpack_from(">H", cs, pos)[0]
        out.append((m, pos))
        if m == 0xFF90:
            return out
        pos += 2 + struct.unpack_from(">H", cs, pos + 2)[0]


def marker_at(cs, marker):
    return next(p for m, p in main_markers(cs) if m == marker)


def patched(cs, pos, value):
    out = bytearray(cs)
    out[pos] = value
    return bytes(out)


def tile_parts(cs):
    """[(SOT position, Isot, end)] of the tile-parts, in order."""
    out, pos = [], marker_at(cs, 0xFF90)
    while cs[pos:pos + 2] == b"\xff\x90":
        isot, psot = struct.unpack_from(">HI", cs, pos + 4)
        out.append((pos, isot, pos + psot))
        pos += psot
    return out


def last_psot_zero(cs):
    pos = tile_parts(cs)[-1][0]
    out = bytearray(cs)
    out[pos + 6:pos + 10] = b"\0\0\0\0"
    return bytes(out)


def packets(body):
    """Split a tile-part body coded with SOP and EPH into [(header,
    packet data)]."""
    out, pos = [], 0
    while pos < len(body):
        assert body[pos:pos + 2] == b"\xff\x91", body[pos:pos + 8]
        eph = body.index(b"\xff\x92", pos + 6)
        nxt = body.find(b"\xff\x91", eph + 2)
        nxt = len(body) if nxt < 0 else nxt
        out.append((body[pos + 6:eph], body[eph + 2:nxt]))
        pos = nxt
    return out


def _segments(kind, data, chunk):
    """`data` in PPM (kind 0x60) or PPT (0x61) markers of `chunk` bytes,
    indexed from 0."""
    out = b""
    for k, at in enumerate(range(0, max(len(data), 1), chunk)):
        part = data[at:at + chunk]
        out += struct.pack(">HHB", 0xFF00 | kind, 3 + len(part), k) + part
    return out


def moved_headers(cs, where):
    """A codestream coded with SOP and EPH rewritten with its packet
    headers in PPT markers (`where` "ppt") or PPM markers ("ppm"), the SOP
    and EPH bits of COD cleared."""
    cod = marker_at(cs, 0xFF52)
    cs = patched(cs, cod + 4, cs[cod + 4] & ~6)
    first = marker_at(cs, 0xFF90)
    main, parts, ppm = cs[:first], [], b""
    for pos, _, end in tile_parts(cs):
        sod = cs.index(b"\xff\x93", pos)
        header = cs[pos + 12:sod]
        split = packets(cs[sod + 2:end])
        heads = b"".join(h for h, _ in split)
        body = b"".join(d for _, d in split)
        if where == "ppt":
            header += _segments(0x61, heads, chunk=37)
        else:
            ppm += struct.pack(">I", len(heads)) + heads
        psot = 12 + len(header) + 2 + len(body)
        parts.append(cs[pos:pos + 6] + struct.pack(">I", psot) +
                     cs[pos + 10:pos + 12] + header + b"\xff\x93" + body)
    if where == "ppm":
        main += _segments(0x60, ppm, chunk=61)
    return main + b"".join(parts) + b"\xff\xd9"


def with_cap(cs):
    """HTJ2K's CAP marker (Part 15) after SIZ, Rsiz bit 14 set."""
    siz = marker_at(cs, 0xFF51)
    end = siz + 2 + struct.unpack_from(">H", cs, siz + 2)[0]
    out = bytearray(cs[:end]) + b"\xff\x50\x00\x08\x00\x02\x00\x00\x00\x05" \
        + cs[end:]
    out[siz + 4] |= 0x40
    return bytes(out)


# --------------------------------------------------------- the cases

def jp2h(w, h, nc, bpc, *boxes, enumcs=16):
    head = [opj.ihdr(w, h, nc, bpc)]
    if enumcs is not None:
        head.append(opj.colr(enumcs))
    return head + list(boxes)


def _cases():
    pic = picture(29, 37, 1)
    grey = pic[..., 0]
    # --- Pillow's encoder
    yield "pil_rgb.jp2", pil(pic), None
    yield "pil_rgb_irreversible.jp2", pil(pic, irreversible=True), None
    yield "pil_rgb.j2k", pil(pic, no_jp2=True), None
    yield "pil_l.jp2", pil(grey), None
    yield "pil_la.jp2", pil(picture(23, 19, 2, 2)), None
    yield "pil_rgba.jp2", pil(picture(23, 19, 3, 4)), None
    yield "pil_rgba_irreversible.j2k", pil(picture(23, 19, 3, 4),
                                           irreversible=True,
                                           no_jp2=True), None
    i16 = (grey.astype(np.uint16) * 257 // 3)
    i16[:3, :5] = [0, 100, 255, 256, 1000]
    i16[3, 0] = 65535
    yield "pil_i16.jp2", pil(i16), None
    yield "pil_layers.jp2", pil(pic, quality_mode="rates",
                                quality_layers=[40, 10, 1],
                                irreversible=True), None
    yield "pil_layers_db.jp2", pil(pic, quality_mode="dB",
                                   quality_layers=[20, 30, 40]), None
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        yield f"pil_{prog.lower()}.j2k", pil(
            pic, no_jp2=True, progression=prog, num_resolutions=3,
            precinct_size=(16, 16), codeblock_size=(8, 8),
            tile_size=(16, 16)), None
    yield "pil_offsets.j2k", pil(pic, no_jp2=True, offset=(5, 3),
                                 tile_offset=(2, 1), tile_size=(17, 13),
                                 num_resolutions=3), None
    yield "pil_one_resolution.jp2", pil(pic, num_resolutions=1), None
    yield "pil_mct0.jp2", pil(pic, mct=0), None
    yield "pil_signed.j2k", pil(pic, signed=True, no_jp2=True), None
    yield "pil_comment_plt.jp2", pil(pic, comment="a tile", plt=True), None
    yield "pil_cinema_size.jp2", pil(picture(64, 96, 4),
                                     codeblock_size=(32, 32)), None
    # --- openjpeg through ctypes: code-block styles on both wavelets
    p = planes(pic)
    for bit, name in ((1, "bypass"), (2, "reset"), (4, "termall"),
                      (8, "vsc"), (16, "erterm"), (32, "segsym"),
                      (63, "all_styles")):
        for rev, wave in ((False, "53"), (True, "97")):
            yield f"style_{name}_{wave}.j2k", encode(
                p, mode=bit, irreversible=rev, levels=3, cblk=(16, 8),
                layers=[12, 3, 0] if bit == 63 else None), None
    yield "sop.j2k", encode(p, csty=2, levels=3, layers=[8, 0]), None
    yield "eph.j2k", encode(p, csty=4, levels=3, layers=[8, 0]), None
    yield "sop_eph.j2k", encode(p, csty=6, levels=3, layers=[8, 0]), None
    yield "poc.j2k", encode(p, levels=3, layers=[10, 0], pocs=(
        (1, 0, 0, 2, 2, 3, "LRCP"), (1, 2, 0, 2, 4, 3, "RPCL"))), None
    yield "poc_cprl.j2k", encode(p, levels=3, layers=[10, 0], pocs=(
        (1, 0, 0, 1, 4, 1, "RLCP"), (1, 0, 1, 2, 4, 3, "CPRL"))), None
    for flag in ("R", "L", "C"):
        yield f"tile_parts_{flag}.j2k", encode(
            p, tile=(16, 16), tp=flag, levels=2, layers=[10, 0],
            prog="LRCP" if flag != "C" else "CPRL"), None
    yield "psot0_last.j2k", last_psot_zero(encode(p, tile=(20, 16),
                                                  levels=2)), None
    for name, data, refused in _tile_part_layouts(p):
        yield name, data, refused
    yield "roi.j2k", encode(p, roi=(0, 6), levels=3), None
    yield "roi_97_layers.j2k", encode(p, roi=(1, 4), levels=3,
                                      irreversible=True, layers=[20, 4]), None
    sop_eph = encode(p, csty=6, levels=3, layers=[10, 0], tile=(24, 16),
                     precincts=[(8, 8)] * 4, cblk=(4, 4))
    yield "ppt.j2k", moved_headers(sop_eph, "ppt"), None
    yield "ppm.j2k", moved_headers(sop_eph, "ppm"), None
    # subsampled components
    big = picture(30, 40, 5)
    sub2 = [big[..., 0], big[::2, ::2, 1], big[::2, ::2, 2]]
    cs420 = encode([s.astype(np.int64) for s in sub2], dx=[1, 2, 2],
                   dy=[1, 2, 2], levels=2)
    yield "sub420_guessed_sycc.j2k", cs420, None
    yield "sub420_srgb.jp2", opj.jp2(cs420, jp2h(40, 30, 3, 7)), None
    yield "sub420_sycc.jp2", opj.jp2(cs420, jp2h(40, 30, 3, 7,
                                                 enumcs=18)), None
    cs422 = encode([big[..., 0], big[:, ::2, 1], big[:, ::2, 2]],
                   dx=[1, 2, 2], dy=[1, 1, 1], levels=2, irreversible=True)
    yield "sub422_97.j2k", cs422, None
    yield "sub_first_component.j2k", encode(
        [big[::2, :, 0], big[..., 1], big[..., 2]], dx=[1, 1, 1],
        dy=[2, 1, 1], levels=1), None
    # precisions and signs
    rng = np.random.RandomState(6)
    for prec in (1, 4, 12, 16):
        top = (1 << prec) - 1
        rgb = [np.clip((big[..., c].astype(np.int64) * top) // 255 +
                       rng.randint(-1, 2, (30, 40)), 0, top)
               for c in range(3)]
        yield f"rgb_{prec}bit.j2k", encode(rgb, prec=prec, levels=2), None
    g10 = (big[..., 0].astype(np.int64) * 4)
    yield "grey_10bit.j2k", encode([g10], prec=10, levels=2), None
    s12 = [(big[..., c].astype(np.int64) * 16) - 2048 for c in range(3)]
    yield "rgb_signed_12bit.j2k", encode(s12, prec=12, sgnd=True,
                                         levels=2), None
    yield "grey_signed_4bit.j2k", encode([(grey.astype(np.int64) >> 4) - 8],
                                         prec=4, sgnd=True, levels=2), None
    yield "la_mixed_precision.j2k", encode(
        [big[..., 0].astype(np.int64) * 16, big[..., 1] >> 5], prec=[12, 3],
        levels=2), None
    # sizes and offsets
    for h, w in ((1, 1), (1, 37), (41, 1), (2, 3)):
        yield f"size_{w}x{h}.j2k", encode(planes(picture(h, w, 7)),
                                          levels=int(min(h, w) > 1)), None
    yield "size_1x1_levels5.j2k", _levels_over_one_sample(), None
    yield "odd_origin.j2k", encode(planes(picture(19, 23, 8)), origin=(7, 3),
                                   levels=3), None
    yield "odd_origin_tiles.j2k", encode(planes(picture(21, 27, 9)),
                                         origin=(5, 9), tile=(11, 7),
                                         tile_origin=(1, 4), levels=2), None
    yield "one_sample_97_odd.j2k", _one_sample_97(3, (1, 0)), None
    yield "one_sample_97_even.j2k", _one_sample_97(2, (4, 0)), None
    yield "levels_5_cblk4.j2k", encode(planes(picture(48, 64, 10)), levels=5,
                                 cblk=(4, 4)), None
    # containers
    cs_rgb = encode(p, levels=3)
    cs_grey = encode([grey.astype(np.int64)], levels=3)
    cs_rgba = encode(planes(picture(29, 37, 11, 4)), levels=3, mct=1)
    yield "jp2_no_colr.jp2", opj.jp2(cs_rgb, jp2h(37, 29, 3, 7,
                                                  enumcs=None)), None
    yield "jp2_icc.jp2", opj.jp2(cs_rgb, [opj.ihdr(37, 29, 3, 7),
                                          opj.colr(icc=bytes(128))]), None
    yield "jp2_grey_colr17.jp2", opj.jp2(cs_grey, jp2h(37, 29, 1, 7,
                                                       enumcs=17)), None
    yield "jp2_sycc.jp2", opj.jp2(encode(p, levels=3, mct=0),
                                  jp2h(37, 29, 3, 7, enumcs=18)), None
    yield "jp2_cmyk.jp2", opj.jp2(cs_rgba, jp2h(37, 29, 4, 7,
                                                enumcs=12)), None
    yield "jp2_rgba_grey_colr.jp2", opj.jp2(cs_rgba, jp2h(37, 29, 4, 7,
                                                          enumcs=17)), None
    yield "jp2_rgba.jp2", opj.jp2(cs_rgba, jp2h(37, 29, 4, 7)), None
    yield "jp2_cdef_res.jp2", opj.jp2(cs_rgb, jp2h(
        37, 29, 3, 7, opj.cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)]),
        opj.box(b"res ", opj.box(b"resc", struct.pack(">HHHHBB", 1, 1, 1,
                                                      1, 0, 0))))), None
    yield "jpx_brand.jp2", opj.jp2(cs_rgb, jp2h(37, 29, 3, 7),
                                   brand=b"jpx "), None
    yield "xl_jp2c.jp2", opj.jp2(cs_rgb, jp2h(37, 29, 3, 7),
                                 jp2c_xl=True), None
    yield "zero_length_jp2c.jp2", opj.jp2(cs_rgb, jp2h(37, 29, 3, 7),
                                          jp2c_zero=True), None
    yield "box_before_jp2h.jp2", opj.jp2(cs_rgb, jp2h(37, 29, 3, 7),
                                         before=[opj.box(b"xml ", b"<a/>")]
                                         ), None
    yield "box_after_jp2h.jp2", opj.jp2(cs_rgb, jp2h(37, 29, 3, 7),
                                        after=[opj.box(b"uuid", bytes(20))]
                                        ), None
    yield "ihdr_16bit_over_8bit.jp2", opj.jp2(cs_grey, jp2h(
        37, 29, 1, 15, enumcs=17)), None
    yield "ihdr_bpc255.jp2", opj.jp2(cs_grey, jp2h(
        37, 29, 1, 255, opj.box(b"bpcc", b"\x07"), enumcs=17)), None
    yield "ihdr_rgba_over_rgb.jp2", opj.jp2(cs_rgb, jp2h(37, 29, 4, 7)), None
    # palettes: repeated entries merge in Pillow's palette
    index = ((np.arange(29)[:, None] + np.arange(37)[None, :]) % 40)
    cs_index = encode([index], levels=2)
    entries = np.array([[(37 * i) % 256, (91 * i) % 256, (13 * i) % 256]
                        for i in range(40)])
    entries[7] = entries[2]
    entries[30] = entries[11]
    yield "pclr_repeated.jp2", opj.jp2(cs_index, jp2h(
        37, 29, 1, 7, opj.pclr(entries, [7, 7, 7]),
        opj.cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)]))), None
    yield "pclr_short.jp2", opj.jp2(cs_index, jp2h(
        37, 29, 1, 7, opj.pclr(entries[:20], [7, 7, 7]))), None
    rgba_entries = np.concatenate([entries, entries[:, :1]], 1)
    yield "pclr_rgba.jp2", opj.jp2(cs_index, jp2h(
        37, 29, 1, 7, opj.pclr(rgba_entries, [7, 7, 7, 7]))), None
    yield "pclr_pa.jp2", opj.jp2(encode([index, (index * 5) % 256],
                                        levels=2), jp2h(
        37, 29, 2, 7, opj.pclr(entries, [7, 7, 7]))), None
    # the 300^2 tiles of chip_smoke.py phase 20 and the predict_on_dir test
    for k in range(3):
        t = planes(building_tile(300, k))
        yield f"tile300_reversible_{k}.jp2", opj.jp2(
            encode(t, levels=5), jp2h(300, 300, 3, 7)), None
        yield f"tile300_irreversible_{k}.jp2", opj.jp2(
            encode(t, levels=5, irreversible=True, layers=[12]),
            jp2h(300, 300, 3, 7)), None
        yield f"tile300_rpcl_{k}.j2k", encode(
            t, levels=4, tile=(128, 128), prog="RPCL",
            precincts=[(64, 64)] * 5, cblk=(32, 32)), None
    # --- refused kinds
    yield "htj2k_cap.j2k", with_cap(cs_rgb), "HTJ2K"
    cod = marker_at(cs_rgb, 0xFF52)
    yield "htj2k_style.j2k", patched(cs_rgb, cod + 12,
                                     cs_rgb[cod + 12] | 0x40), "HTJ2K"
    yield "five_components.j2k", encode(p + p[:2], levels=2), \
        "more than 4 components"
    yield "precision_17.j2k", encode([grey.astype(np.int64) * 512],
                                     prec=17, levels=2), \
        "precision above 16 bits"
    for frac in (90, 50, 20):
        yield f"cut_{frac}.j2k", cs_rgb[:len(cs_rgb) * frac // 100], "JPEG 2000"
        yield f"cut_{frac}.jp2", opj.jp2(cs_rgb, jp2h(37, 29, 3, 7))[
            :(len(cs_rgb) + 80) * frac // 100], "JPEG 2000"
    siz = marker_at(cs_grey, 0xFF51)
    huge = bytearray(cs_grey)
    huge[siz + 6:siz + 14] = struct.pack(">II", 20000, 20000)
    huge[siz + 22:siz + 30] = struct.pack(">II", 20000, 20000)
    yield "header_20000x20000.j2k", bytes(huge), "past the limit"
    yield "eph_missing.j2k", _without_eph(), "EPH"
    yield "grey_colr_over_rgb.jp2", opj.jp2(cs_rgb, jp2h(
        37, 29, 3, 7, enumcs=17)), "which Pillow does not unpack"
    yield "srgb_colr_over_grey.jp2", opj.jp2(cs_grey, jp2h(
        37, 29, 1, 7)), "which Pillow does not unpack"
    yield "eycc.jp2", opj.jp2(cs_rgb, jp2h(37, 29, 3, 7, enumcs=24)), \
        "which Pillow does not unpack"
    yield "ihdr_size_differs.jp2", opj.jp2(cs_rgb, jp2h(38, 29, 3, 7)), \
        "ihdr size"
    yield "zero_length_box_before_jp2h.jp2", opj.jp2(
        cs_rgb, jp2h(37, 29, 3, 7), before=[opj.box(b"xml ", b"<a/>",
                                                    zero=True)]), \
        "Pillow does not open it"
    yield "subsampled_two_components.j2k", encode(
        [big[..., 0], big[::2, ::2, 1]], dx=[1, 2], dy=[1, 2], levels=1), \
        "which Pillow does not unpack"
    yield "stale_subsampled_read.j2k", encode(
        [picture(29, 25, 12)[..., c].astype(np.int64)[::sy, ::sx]
         for c, (sx, sy) in enumerate(((1, 1), (3, 1), (3, 2)))],
        dx=[1, 3, 3], dy=[1, 1, 2], origin=(1, 1), levels=1), \
        "reads past its tile's data"
    # the last packet's data cut, the tile-part's Psot made to agree
    pos, _, end = tile_parts(cs_grey)[-1]
    short = bytearray(cs_grey[:end - 10] + b"\xff\xd9")
    short[pos + 6:pos + 10] = struct.pack(">I", end - 10 - pos)
    yield "segment_past_tile_part.j2k", bytes(short), \
        "segment past its tile-part"
    sot = tile_parts(cs_rgb)[0][0]
    yield "tile_part_index_past_count.j2k", patched(cs_rgb, sot + 10, 3), \
        "tile-part"
    yield "cod_bad_wavelet.j2k", patched(cs_rgb, cod + 13, 7), "wavelet"
    yield "not_after_signature.jp2", opj.SIGNATURE + bytes(30), "JP2"


def _tile_part_layouts(p):
    """Tile-parts rearranged as other encoders and cut streams arrange them,
    under openjpeg's tile-part state machine: TNsot 0 (the count unknown),
    the parts of the tiles interleaved, the tiles in reverse order, a tile
    missing, Psot 0 on the first part, bytes after EOC, and no EOC."""
    cs = encode(p, tile=(16, 16), tp="L", layers=[10, 0], levels=2)
    parts = tile_parts(cs)
    head = cs[:parts[0][0]]

    def tnsot0(data):
        out = bytearray(data)
        for pos, _, _ in tile_parts(data):
            out[pos + 11] = 0
        return bytes(out)

    by_index, by_tile = {}, {}
    for pos, tile, end in parts:
        by_index.setdefault(cs[pos + 10], []).append(cs[pos:end])
        by_tile.setdefault(tile, []).append(cs[pos:end])
    interleaved = head + b"".join(b"".join(v) for _, v in sorted(
        by_index.items())) + b"\xff\xd9"
    reversed_tiles = head + b"".join(b"".join(by_tile[t]) for t in sorted(
        by_tile, reverse=True)) + b"\xff\xd9"
    missing = head + b"".join(cs[pos:end] for pos, tile, end in parts
                              if tile != 1) + b"\xff\xd9"
    first = bytearray(cs)
    first[parts[0][0] + 6:parts[0][0] + 10] = b"\0\0\0\0"
    yield "parts_tnsot0.j2k", tnsot0(cs), None
    yield "parts_interleaved.j2k", interleaved, None
    yield "parts_interleaved_tnsot0.j2k", tnsot0(interleaved), None
    yield "parts_tiles_reversed.j2k", reversed_tiles, None
    yield "parts_tile_missing.j2k", tnsot0(missing), None
    yield "parts_psot0_first.j2k", bytes(first), None
    yield "parts_bytes_after_eoc.j2k", cs + b"\x00\x11\x22", None
    yield "parts_no_eoc.j2k", cs[:-2], "cut short"
    yield "parts_junk_for_eoc.j2k", cs[:-2] + b"\x12\x34", "cut short"


def _levels_over_one_sample():
    """A 1 x 1 image with 5 decomposition levels: openjpeg's encoder
    refuses it, so its single-level file gets a COD of 5 levels (the
    LL sample is the image)."""
    cs = encode([np.array([[77]])], levels=0)
    cod = marker_at(cs, 0xFF52)
    out = bytearray(cs)
    out[cod + 9] = 5  # decomposition levels
    # QCD: one exponent per sub-band, as many as 5 levels need (16)
    qcd = marker_at(cs, 0xFF5C)
    size = struct.unpack_from(">H", cs, qcd + 2)[0]
    style = cs[qcd + 4]
    new = struct.pack(">HB", 3 + 16, style) + bytes([cs[qcd + 5]] * 16)
    out[qcd + 2:qcd + 2 + size] = new
    data = bytes(out)
    # the packets of resolutions 1 to 5 are empty: add them after the LL's
    sod = data.index(b"\xff\x93")
    sot = tile_parts(data)[0][0]
    body = data[sod + 2:-2] + b"\x00" * 5
    head = data[:sod + 2]
    head = head[:sot + 6] + struct.pack(">I", len(head) - sot + len(body)) \
        + head[sot + 10:]
    return head + body + b"\xff\xd9"


def _one_sample_97(w, origin):
    """The 9/7 filter over one-sample signals: openjpeg's encoder asserts
    on them, so a 5/3 file of a w x 8 image at `origin` with 2 levels
    (resolution 1 one sample wide) gets its COD turned to 9/7 and its QCD
    to derived quantisation: the same code-blocks read as 9/7
    coefficients."""
    rng = np.random.RandomState(w)
    cs = encode([rng.randint(0, 256, (8, w))], origin=origin, levels=2)
    cod = marker_at(cs, 0xFF52)
    out = bytearray(cs)
    out[cod + 13] = 0
    qcd = marker_at(cs, 0xFF5C)
    size = struct.unpack_from(">H", cs, qcd + 2)[0]
    out[qcd + 2:qcd + 2 + size] = struct.pack(">HBH", 5, 0x41,
                                              (9 << 11) | 300)
    return bytes(out)


def _without_eph():
    """A codestream whose COD promises EPH markers its packets lack."""
    cs = encode([picture(16, 16, 13)[..., 0].astype(np.int64)], levels=1)
    cod = marker_at(cs, 0xFF52)
    return patched(cs, cod + 4, cs[cod + 4] | 4)


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main():
    warnings.simplefilter("ignore")
    import PIL

    from mapping_tpu_torch.utils import jp2

    oracle = (f"Pillow {PIL.__version__} "
              f"({opj.library_path().name.split('-')[0]} "
              f"{opj.library_path().name.rsplit('.so.', 1)[-1]})")
    opj.check_layout()
    manifest = {}
    for old in list(HERE.glob("*.jp2")) + list(HERE.glob("*.j2k")):
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
            got = jp2.decode(data)
            port_refuses = None
        except ValueError as e:
            port_refuses = str(e)
        if port_refuses is None and (rgb is None or not np.array_equal(
                got, rgb)):
            raise AssertionError(f"{name}: the port's decode differs")
        if refused is not None and port_refuses is None:
            raise AssertionError(f"{name}: the port reads it")
        if refused is None and port_refuses is not None:
            raise AssertionError(f"{name}: the port refuses it: "
                                 f"{port_refuses}")
        if refused is not None and refused not in port_refuses:
            raise AssertionError(f"{name}: refused as {port_refuses!r}")
        if refused:
            entry["refused"] = refused
            if rgb is not None:
                # Pillow's unpacker reads uninitialised memory past what
                # openjpeg wrote there: no digest to keep
                entry["jax_reads"] = ("stale memory" if "past its tile's"
                                      in refused else _digest(rgb))
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
