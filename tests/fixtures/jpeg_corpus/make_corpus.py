"""Write the JPEG corpus of the port's decoder tests and of chip_smoke.py
phase 16: files written by Pillow and by the port's encoder, and a
`manifest.json` with each file's SHA-256 and, for the files libjpeg reads,
the SHA-256 of libjpeg's RGB decode (`mapping_tpu.utils.native_decode.
decode_rgb`, the JAX package's decoder) or, for the kinds the port's
decoder refuses, the feature its ValueError names.

Run from the root of the repository, where Pillow and the JAX package's
native decoder (libjpeg) are installed:

    python tests/fixtures/jpeg_corpus/make_corpus.py
"""

import hashlib
import io
import json
import os
import sys
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from mapping_tpu.utils import native_decode  # noqa: E402
from mapping_tpu_torch.utils import jpeg  # noqa: E402


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
    yield "progressive.jpg", _pil(small, quality=80, progressive=True), \
        "progressive"
    buf = io.BytesIO()
    Image.fromarray(small).convert("CMYK").save(buf, "JPEG", quality=80)
    yield "cmyk.jpg", buf.getvalue(), "4-component"
    base = bytearray(_pil(small, quality=80))
    sof = base.index(b"\xff\xc0")
    arith = bytearray(base)
    arith[sof + 1] = 0xC9
    yield "arithmetic_sof9.jpg", bytes(arith), "arithmetic-coded"
    twelve = bytearray(base)
    twelve[sof + 4] = 12
    yield "precision12.jpg", bytes(twelve), "12-bit"
    four = bytearray(base)
    four[sof + 11] = 0x41  # luma 4x1 against 1x1 chroma
    yield "sampling_4x1.jpg", bytes(four), "sampling factors"


def main():
    manifest = {}
    tmp = HERE / ".decode.jpg"
    for name, data, refused in _cases():
        (HERE / name).write_bytes(data)
        entry = {"sha256": hashlib.sha256(data).hexdigest()}
        if refused:
            entry["refused"] = refused
        else:
            tmp.write_bytes(data)
            rgb = native_decode.decode_rgb(str(tmp))
            entry["shape"] = list(rgb.shape)
            entry["decode_sha256"] = hashlib.sha256(
                np.ascontiguousarray(rgb).tobytes()).hexdigest()
        manifest[name] = entry
    tmp.unlink()
    with open(HERE / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(HERE / n) for n in manifest)
    print(f"{len(manifest)} files, {total} bytes")


if __name__ == "__main__":
    main()
