"""Write the JPEG corpus of the port's decoder tests and of chip_smoke.py
phases 16 and 21: files written by Pillow, by the port's encoder, by
libjpeg's compression API (write_jpeg.cpp: progressive scan scripts,
arithmetic coding, sampling factors 3 and 4, CMYK and YCCK; lossless
files through libjpeg-turbo 3.1.3's), and by the lossless writer of
lossless.py (subsampled lossless files, scans, markers and the refused
lossless kinds), and a `manifest.json` with each file's SHA-256 and
- for the files the JAX package reads, the SHA-256 of its RGB decode
  (`mapping_tpu.data.loader.load_image`) and the library that made it
  (`oracle`: the system's libjpeg-turbo, or Pillow where libjpeg declines
  the file, as for CMYK);
- for the kinds the port's decoder refuses, the feature its ValueError
  names, and whether the JAX package reads the file all the same
  (`jax_reads`, with its decode's SHA-256: a gap of the port).

Run from the root of the repository, where Pillow, the JAX package's
native decoder (libjpeg) and the libjpeg headers are installed. g++
builds write_jpeg.cpp into a temporary directory twice: with -ljpeg (the
system's libjpeg-turbo 2.1.5), and with -DWITH_LOSSLESS against the same
headers, linked to the libjpeg-turbo 3.1.3 that Pillow bundles
(`pillow.libs/libjpeg-*.so*`, whose `jpeg_enable_lossless` the system's
library lacks; both keep libjpeg 6.2's ABI):

    python tests/fixtures/jpeg_corpus/make_corpus.py
"""

import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))
sys.path.insert(0, str(HERE))

from mapping_tpu.data.loader import load_image  # noqa: E402
from mapping_tpu.utils import native_decode  # noqa: E402
from mapping_tpu_torch.utils import jpeg  # noqa: E402

import lossless  # noqa: E402  (tests/fixtures/jpeg_corpus/lossless.py)

#: a scan script with successive approximation in DC and AC, luma's AC
#: split into two bands
SCRIPT_SA = ("0,1,2:0:0:0:1;0:1:5:0:2;2:1:63:0:1;1:1:63:0:1;0:6:63:0:2;"
             "0:1:63:2:1;0,1,2:0:0:1:0;2:1:63:1:0;1:1:63:1:0;0:1:63:1:0")
#: DC of every component, then luma's AC only: chroma has no AC scans,
#: so libjpeg smooths its blocks
SCRIPT_NO_CHROMA_AC = "0,1,2:0:0:0:0;0:1:9:0:0;0:10:63:0:0"


def _image(h, w, seed):
    """A tile-like picture: a smooth gradient, mild noise and two bright
    rectangles, so the files stay small."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([40 + 120 * x / max(w, 1), 60 + 100 * y / max(h, 1),
                    np.full((h, w), 90.0)], -1)
    img += rng.randint(0, 12, (h, w, 3))
    for _ in range(2):
        y0, x0 = rng.randint(0, max(h, 1)), rng.randint(0, max(w, 1))
        img[y0:y0 + h // 4 + 1, x0:x0 + w // 3 + 1] = rng.randint(170, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _cases():
    tile = _image(300, 300, 1)
    yield "q30.jpg", _pil(tile, quality=30), None
    yield "q75.jpg", _pil(tile, quality=75), None
    yield "q95.jpg", _pil(tile, quality=95), None
    yield "q100.jpg", _pil(_image(64, 64, 2), quality=100), None
    yield "s444.jpg", _pil(tile, quality=90, subsampling=0), None
    yield "s422.jpg", _pil(tile, quality=90, subsampling=1), None
    yield "s420.jpg", _pil(tile, quality=90, subsampling=2), None
    yield "gray.jpg", _pil(tile[..., 1], quality=85), None
    yield "optimized.jpg", _pil(tile, quality=85, optimize=True), None
    exif = Image.Exif()
    exif[0x010F] = "mapping"
    yield "exif_icc.jpg", _pil(_image(48, 40, 3), quality=85,
                               exif=exif.tobytes(),
                               icc_profile=bytes(range(256)) * 4,
                               comment=b"a comment"), None
    for h, w in ((1, 1), (7, 9), (16, 16), (301, 299), (299, 301)):
        yield f"size_{h}x{w}.jpg", _pil(_image(h, w, h + w), quality=90), None
    yield "port_1x2.jpg", jpeg.encode(_image(45, 67, 4), 90, "4:4:0"), None
    yield "port_dri.jpg", jpeg.encode(_image(67, 45, 5), 90, "4:2:0",
                                      restart_interval=3), None
    yield "adobe_rgb.jpg", _pil(_image(40, 48, 6), quality=90,
                                keep_rgb=True), None
    full = _pil(_image(120, 100, 7), quality=90)
    yield "truncated.jpg", full[:len(full) * 3 // 5], None
    small = _image(32, 32, 8)
    yield "progressive.jpg", _pil(small, quality=80, progressive=True), None
    buf = io.BytesIO()
    Image.fromarray(small).convert("CMYK").save(buf, "JPEG", quality=80)
    yield "cmyk.jpg", buf.getvalue(), None
    base = bytearray(_pil(small, quality=80))
    sof = base.index(b"\xff\xc0")
    arith = bytearray(base)
    arith[sof + 1] = 0xC9
    # a Huffman stream under an arithmetic SOF: libjpeg decodes the
    # corrupt stream, and so does the port
    yield "arithmetic_sof9.jpg", bytes(arith), None
    twelve = bytearray(base)
    twelve[sof + 4] = 12
    yield "precision12.jpg", bytes(twelve), "12-bit"
    four = bytearray(base)
    four[sof + 11] = 0x41  # luma 4x1 against 1x1 chroma: a corrupt stream
    yield "sampling_4x1.jpg", bytes(four), None
    yield from _written(small, base, sof)


def _strip(data, marker):
    """`data` without its segments of `marker`."""
    out, i = bytearray(data[:2]), 2
    while i < len(data):
        m = data[i + 1]
        if m == 0xDA:
            return bytes(out + data[i:])
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        if m != marker:
            out += data[i:i + 2 + n]
        i += 2 + n
    return bytes(out)


def _scan_data(data):
    """(first, end) byte of each scan's entropy-coded data."""
    out, i = [], data.index(b"\xff\xda")
    while i >= 0:
        start = i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
        end = start
        while not (data[end] == 0xFF and data[end + 1] not in (0, *range(
                0xD0, 0xD8))):
            end += 1
        out.append((start, end))
        i = data.find(b"\xff\xda", end)
    return out


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def pillow_libjpeg():
    """The libjpeg-turbo 3.1.3 that Pillow bundles."""
    import PIL

    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    found = sorted(libs.glob("libjpeg-*.so*"))
    if not found:
        raise RuntimeError(f"no libjpeg in {libs}")
    return found[0]


def writer(lossless=False):
    """write(img, **keys) -> bytes through write_jpeg.cpp, built into a
    temporary directory: against the system's libjpeg, or with lossless
    against Pillow's libjpeg-turbo 3.1.3 (see the module docstring)."""
    tmp = Path(tempfile.mkdtemp())
    tool = tmp / "write_jpeg"
    if lossless:
        lib = pillow_libjpeg()
        link = ["-DWITH_LOSSLESS", str(lib), f"-Wl,-rpath,{lib.parent}"]
    else:
        link = ["-ljpeg"]
    subprocess.run(["g++", "-O2", "-o", str(tool),
                    str(HERE / "write_jpeg.cpp")] + link, check=True)

    def write(img, **kw):
        channels = 1 if img.ndim == 2 else img.shape[2]
        (tmp / "in.raw").write_bytes(np.ascontiguousarray(img).tobytes())
        kind = {1: "gray", 3: "rgb", 4: "cmyk"}.get(channels, "unknown")
        subprocess.run([str(tool), str(tmp / "in.raw"), str(tmp / "out.jpg"),
                        f"w={img.shape[1]}", f"h={img.shape[0]}", f"in={kind}",
                        f"n={channels}"] + [f"{k}={v}" for k, v in kw.items()],
                       check=True)
        return (tmp / "out.jpg").read_bytes()

    return write


def _written(small, base, sof):
    """The files libjpeg's compression API writes (write_jpeg.cpp), and
    the refused kinds made by hand."""
    write = writer()

    tile = _image(300, 300, 9)
    mid = _image(48, 56, 10)
    yield "prog_300.jpg", _pil(tile, quality=75, progressive=True), None
    yield "prog_sa_dri.jpg", write(mid, q=85, script=SCRIPT_SA, dri=2), None
    yield "prog_no_chroma_ac.jpg", write(mid, q=85, samp="2x2,1x1,1x1",
                                         script=SCRIPT_NO_CHROMA_AC), None
    full = write(_image(64, 72, 11), q=85, progressive=1)
    scans = _scan_data(full)
    for k in (1, 4):  # cut inside the Cb DC scan / a luma AC scan: smoothed
        start, end = scans[k]
        yield f"prog_cut_scan{k}.jpg", full[:(start + end) // 2], None
    yield "arith_seq.jpg", write(mid, q=85, arith=1), None
    yield "arith_seq_dri_dac.jpg", write(mid, q=85, arith=1, dri=3, dcl=1,
                                         dcu=4, ack=12), None
    prog = write(mid, q=85, arith=1, progressive=1)
    yield "arith_prog.jpg", prog, None
    yield "arith_prog_no_dac.jpg", _strip(prog, 0xCC), None
    yield "arith_300.jpg", write(tile, q=75, arith=1), None
    for name, samp in (("s411", "4x1"), ("s1x4", "1x4"), ("s4x2", "4x2"),
                       ("s3x1", "3x1")):
        yield f"{name}.jpg", write(_image(37, 61, 12), q=85,
                                   samp=f"{samp},1x1,1x1"), None
    cmyk = np.concatenate([_image(40, 44, 13), _image(40, 44, 14)[..., :1]],
                          axis=-1)
    yield "cmyk_adobe.jpg", write(cmyk, q=85, space="cmyk"), None
    yield "cmyk_plain.jpg", write(cmyk, q=85, space="cmyk", adobe=0), None
    yield "ycck_2x2.jpg", write(cmyk, q=85, space="ycck",
                                samp="2x2,1x1,1x1,2x2"), None
    # one Huffman code, category 0: every sample 2^7
    flat = (_segment(0xC3, struct.pack(">BHHB", 8, 8, 8, 1) + b"\x01\x11"
                     b"\x00")
            + _segment(0xC4, b"\x00\x01" + bytes(15) + b"\x00")
            + _segment(0xDA, b"\x01\x01\x00\x01\x00\x00"))
    yield "lossless.jpg", b"\xff\xd8" + flat + bytes(8) + b"\xff\xd9", None
    yield from _lossless()
    # the kinds that stay refused
    hier = bytearray(base)
    hier[sof + 1] = 0xC5
    yield "hierarchical.jpg", bytes(hier), "hierarchical"
    dnl = bytearray(base)
    dnl[sof + 5:sof + 7] = b"\x00\x00"  # the height comes in a DNL marker
    yield "dnl.jpg", bytes(dnl[:-2]) + _segment(0xDC, b"\x00\x20") \
        + b"\xff\xd9", "DNL"
    yield "two_components.jpg", write(_image(16, 16, 15)[..., :2], q=85), \
        "2-component"
    big = bytearray(base)
    big[sof + 11] = 0x44  # luma 4x4: 18 blocks an MCU
    yield "over10_blocks.jpg", bytes(big), "more than 10 blocks"


def tile_picture(side, seed):
    """A smooth 300^2-like RGB tile with flat blocks (roofs): little noise,
    so that its lossless file stays small."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:side, 0:side]
    img = np.stack([40 + 120 * x / side, 60 + 100 * y / side,
                    np.full((side, side), 90.0)], -1)
    img += rng.randint(0, 2, (side, side, 3))
    for _ in range(4):
        y0, x0 = rng.randint(0, side, 2)
        img[y0:y0 + side // 5, x0:x0 + side // 4] = rng.randint(120, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _planes(h, w, factors, seed):
    """Each component's samples at its own size for `lossless.encode`."""
    hmax = max(a for a, _ in factors)
    vmax = max(b for _, b in factors)
    rng = np.random.RandomState(seed)
    base = _image(h, w, seed)[..., 0].astype(np.int64)
    out = []
    for k, (a, b) in enumerate(factors):
        ph, pw = -(-h * b // vmax), -(-w * a // hmax)
        plane = base[::vmax // b, ::hmax // a][:ph, :pw] + 40 * k
        out.append(np.clip(plane + rng.randint(0, 6, plane.shape), 0,
                           255).astype(np.uint8))
    return out


def _lossless():
    """Lossless (SOF3) files: libjpeg-turbo 3.1.3's own (which writes only
    1 x 1 sampling, in the input's colour space) and hand-made ones for
    the rest; then the lossless kinds that stay refused, which the JAX
    loader refuses too."""
    write = writer(lossless=True)
    grey, rgb = _image(37, 41, 30)[..., 1], _image(37, 41, 31)
    for psv in range(1, 8):
        yield f"lossless_gray_p{psv}.jpg", write(
            grey, lossless=psv, pt=(psv - 1) % 3), None
    yield "lossless_rgb_p1.jpg", write(rgb, lossless=1), None
    yield "lossless_rgb_p7_pt2.jpg", write(rgb, lossless=7, pt=2), None
    yield "lossless_rgb_rows2.jpg", write(rgb, lossless=4, rows=2), None
    yield "lossless_rgb_scans.jpg", write(
        rgb, lossless=1, script="0:1:0:0:0;1:5:0:0:1;2:7:0:0:0"), None
    cmyk = np.concatenate([rgb, _image(37, 41, 32)[..., :1]], axis=-1)
    yield "lossless_cmyk.jpg", write(cmyk, lossless=6), None
    yield "lossless_1x1.jpg", write(rgb[:1, :1], lossless=3), None
    for k in range(9):
        yield f"tile300_lossless_{k}.jpg", write(tile_picture(300, 40 + k),
                                                 lossless=1), None

    def hand(factors, psv=1, seed=33, h=29, w=35, **kw):
        return lossless.encode(_planes(h, w, factors, seed), factors, psv,
                               height=h, width=w, **kw)

    rgb_ids = list(b"RGB")
    adobe = _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    yield "lossless_s2x2.jpg", hand([(2, 2), (1, 1), (1, 1)], 5,
                                    ids=rgb_ids), None
    yield "lossless_h4.jpg", hand([(4, 1), (1, 1), (1, 1)], 2, ids=rgb_ids,
                                  restart=9), None
    yield "lossless_v4.jpg", hand([(1, 4), (1, 1), (2, 1)], 6,
                                  markers=adobe), None
    yield "lossless_cmyk_2x2.jpg", hand([(2, 2), (1, 1), (1, 1), (2, 2)], 7,
                                        pt=1), None
    yield "lossless_ids123.jpg", hand([(1, 1)] * 3, 4), None
    yield "lossless_gray_v2_rst.jpg", hand([(2, 2)], 3, restart=35), None
    yield "lossless_dri_between_scans.jpg", hand(
        [(1, 1)] * 3, 1, ids=rgb_ids, scans=[[0], [1], [2]],
        restart=[70, 0, 35]), None
    dnl = hand([(1, 1)], 2)
    yield "lossless_dnl.jpg", dnl[:-2] + _segment(0xDC, b"\x00\x1d") \
        + b"\xff\xd9", None
    # the data stops at an EOI a third of the way in: zeros and reset
    # predictors for every MCU row after it
    data = bytearray(hand([(1, 1)] * 3, 7, ids=rgb_ids))
    start = data.index(b"\xff\xda") + 14
    cut = start + (len(data) - start) // 3
    yield "lossless_early_eoi.jpg", bytes(data[:cut]) + b"\xff\xd9", None
    # codes longer than 16 bits (all ones) in the middle: zeros
    data[cut:cut + 12] = b"\xff\x00" * 6
    yield "lossless_bad_code.jpg", bytes(data), None
    # a restart marker out of sequence: libjpeg's resync
    data = bytearray(hand([(1, 1)], 1, restart=70))
    rst = data.index(b"\xff\xd2")
    data[rst + 1] = 0xD5
    yield "lossless_rst_resync.jpg", bytes(data), None
    # refused
    jfif = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    yield "lossless_ycc.jpg", hand([(2, 2), (1, 1), (1, 1)], 1,
                                   markers=jfif), "YCC"
    yield "lossless_ycck.jpg", hand([(1, 1)] * 4, 1, markers=_segment(
        0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x02")), "YCCK"
    for bits in (2, 12, 16):
        yield f"lossless_{bits}bit.jpg", hand([(1, 1)], 1,
                                              precision=bits), f"{bits}-bit"
    yield "lossless_predictor0.jpg", hand([(1, 1)], 1,
                                          scan_params=b"\x00\x00\x00"), \
        "predictor 0"
    yield "lossless_pt8.jpg", hand([(1, 1)], 1, scan_params=b"\x01\x00\x08"), \
        "point transform 8"
    yield "lossless_se1.jpg", hand([(1, 1)], 1, scan_params=b"\x01\x01\x00"), \
        "bad lossless JPEG scan"
    for sof, name in ((0xC7, "hierarchical lossless"),
                      (0xCB, "arithmetic-coded lossless"),
                      (0xCF, "arithmetic-coded hierarchical lossless")):
        yield f"lossless_sof{sof - 0xC0}.jpg", hand([(1, 1)], 1, sof=sof), \
            name
    yield "lossless_dri_part_row.jpg", hand([(1, 1)], 1, restart=34), \
        "restart interval 34"
    whole = hand([(1, 1)] * 3, 2, ids=rgb_ids)
    yield "lossless_truncated.jpg", whole[:len(whole) * 2 // 3], "truncated"
    yield "lossless_scans_no_eoi.jpg", hand(
        [(1, 1)] * 3, 2, ids=rgb_ids, scans=[[0], [1], [2]])[:-2], \
        "truncated"
    yield "lossless_no_scan_2.jpg", hand(
        [(1, 1)] * 3, 2, ids=rgb_ids, scans=[[0], [1]]), "has no scan"
    yield "lossless_symbol17.jpg", hand(
        [(1, 1)], 1, bits=(0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0),
        values=tuple(range(18))), "bad JPEG Huffman table"
    yield "lossless_no_marker_after_soi.jpg", b"\xff\xd8\x00" \
        + hand([(1, 1)], 1)[2:], "Pillow cannot identify"


def _libraries():
    """The JAX package's decoders: the system's libjpeg-turbo, Pillow and
    the libjpeg-turbo it bundles."""
    import PIL
    from PIL import features

    conf = Path("/usr/include/x86_64-linux-gnu/jconfig.h")
    system = "libjpeg"
    if conf.exists():
        for line in conf.read_text().splitlines():
            if "LIBJPEG_TURBO_VERSION " in line:
                system = f"libjpeg-turbo {line.split()[-1]}"
    return system, (f"Pillow {PIL.__version__} (libjpeg-turbo "
                    f"{features.version('libjpeg_turbo')})")


def _digest(rgb):
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def main():
    manifest = {}
    tmp = HERE / ".decode.jpg"
    system, pillow = _libraries()
    for name, data, refused in _cases():
        (HERE / name).write_bytes(data)
        entry = {"sha256": hashlib.sha256(data).hexdigest()}
        tmp.write_bytes(data)
        try:
            rgb = load_image(str(tmp))
        except Exception:  # the JAX package does not read it either
            rgb = None
        if refused:
            entry["refused"] = refused
            if rgb is not None:
                entry["jax_reads"] = _digest(rgb)
        else:
            entry["shape"] = list(rgb.shape)
            entry["decode_sha256"] = _digest(rgb)
            native = native_decode.decode_rgb(str(tmp))
            entry["oracle"] = system if native is not None else pillow
        manifest[name] = entry
    tmp.unlink()
    with open(HERE / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(HERE / n) for n in manifest)
    print(f"{len(manifest)} files, {total} bytes")


if __name__ == "__main__":
    main()
