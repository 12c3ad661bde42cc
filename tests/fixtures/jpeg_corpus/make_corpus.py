"""Write the JPEG corpus of the port's decoder tests and of chip_smoke.py
phase 16: files written by Pillow, by the port's encoder and by libjpeg's
compression API (write_jpeg.cpp: progressive scan scripts, arithmetic
coding, sampling factors 3 and 4, CMYK and YCCK), and a `manifest.json`
with each file's SHA-256 and
- for the files the JAX package reads, the SHA-256 of its RGB decode
  (`mapping_tpu.data.loader.load_image`) and the library that made it
  (`oracle`: the system's libjpeg-turbo, or Pillow where libjpeg declines
  the file, as for CMYK);
- for the kinds the port's decoder refuses, the feature its ValueError
  names, and whether the JAX package reads the file all the same
  (`jax_reads`, with its decode's SHA-256: a gap of the port).

Run from the root of the repository, where Pillow, the JAX package's
native decoder (libjpeg) and the libjpeg headers are installed (g++
builds write_jpeg.cpp with -ljpeg into a temporary directory):

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

from mapping_tpu.data.loader import load_image  # noqa: E402
from mapping_tpu.utils import native_decode  # noqa: E402
from mapping_tpu_torch.utils import jpeg  # noqa: E402

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


def _written(small, base, sof):
    """The files libjpeg's compression API writes (write_jpeg.cpp), and
    the refused kinds made by hand."""
    tmp = Path(tempfile.mkdtemp())
    tool = tmp / "write_jpeg"
    subprocess.run(["g++", "-O2", "-o", str(tool), str(HERE / "write_jpeg.cpp"),
                    "-ljpeg"], check=True)

    def write(img, **kw):
        channels = 1 if img.ndim == 2 else img.shape[2]
        (tmp / "in.raw").write_bytes(np.ascontiguousarray(img).tobytes())
        kind = {1: "gray", 3: "rgb", 4: "cmyk"}.get(channels, "unknown")
        subprocess.run([str(tool), str(tmp / "in.raw"), str(tmp / "out.jpg"),
                        f"w={img.shape[1]}", f"h={img.shape[0]}", f"in={kind}",
                        f"n={channels}"] + [f"{k}={v}" for k, v in kw.items()],
                       check=True)
        return (tmp / "out.jpg").read_bytes()

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
    # the kinds that stay refused
    lossless = (_segment(0xC3, struct.pack(">BHHB", 8, 8, 8, 1) + b"\x01\x11"
                         b"\x00")
                + _segment(0xC4, b"\x00\x01" + bytes(15) + b"\x00")
                + _segment(0xDA, b"\x01\x01\x00\x01\x00\x00"))
    yield "lossless.jpg", b"\xff\xd8" + lossless + bytes(8) + b"\xff\xd9", \
        "lossless"
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
