"""Write the PNG gamma corpus of the port's PNG tests and of chip_smoke.py
phase 17: PNG files with gAMA chunks (and the sRGB, cHRM, iCCP chunks and
chunk faults that change what libpng does with them), and a
`manifest.json` with each file's SHA-256 and the SHA-256 of the JAX
package's two reads of it:
- `rgb_sha256`: `mapping_tpu.data.loader.load_image` (libpng's simplified
  API, which converts a file gamma to sRGB, or Pillow, which ignores it,
  for alpha, tRNS and 16-bit files; `oracle` names which);
- `gray_sha256`: the mask channel of `load_target` (libpng's grey read for
  grey files, Pillow's convert("L") else), null where Pillow refuses the
  file (a chunk's bad CRC).

Run from the root of the repository, where Pillow and the JAX package's
native decoder (libpng) are installed:

    python tests/fixtures/png_gamma/make_corpus.py
"""

import hashlib
import json
import os
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
from PIL import ImageCms

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from mapping_tpu.data.loader import load_image, load_target  # noqa: E402
from mapping_tpu.utils import native_decode  # noqa: E402

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: gAMA values (gamma x 100000): common ones, extremes, and both sides of
#: the two no-correction thresholds, round(2.2 g) = 95000 and the exponent
#: round(1e15 / g / 220000) = 95000
GAMMAS = (10000, 20000, 30000, 40000, 43000, 43181, 43182, 45000, 45455,
          47700, 47847, 47848, 48000, 50000, 70000, 100000, 200000)


def chunk(kind, body, bad_crc=False):
    crc = zlib.crc32(kind + body) ^ (1 if bad_crc else 0)
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I",
                                                                   crc)


def gama(g, bad_crc=False):
    return chunk(b"gAMA", struct.pack(">I", g), bad_crc)


def png(samples, depth, colour, before=(), after_plte=(), palette=None,
        interlace=False):
    """PNG bytes of (h, w, c) samples, unfiltered rows; `before` chunks
    come before PLTE, `after_plte` between PLTE and IDAT."""
    h, w, c = samples.shape

    def pack(s):
        if depth == 16:
            return s.astype(">u2").reshape(s.shape[0], -1).view(np.uint8)
        if depth == 8:
            return s.astype(np.uint8).reshape(s.shape[0], -1)
        shifts = np.arange(depth - 1, -1, -1)
        bits = ((s[..., :1] >> shifts) & 1).astype(np.uint8)
        return np.packbits(bits.reshape(s.shape[0], -1), axis=1)

    if interlace:
        passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                  (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
        raw = b"".join(b"".join(b"\x00" + r.tobytes() for r in pack(sub))
                       for sub in (samples[y::dy, x::dx]
                                   for x, y, dx, dy in passes) if sub.size)
    else:
        raw = b"".join(b"\x00" + r.tobytes() for r in pack(samples))
    out = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                 colour, 0, 0,
                                                 int(interlace)))
    out += b"".join(before)
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    out += b"".join(after_plte)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def ramps(rng, channels):
    """4 x 256: a ramp, the ramp reversed, two random rows."""
    rows = np.stack([np.arange(256), np.arange(255, -1, -1),
                     rng.randint(0, 256, 256), rng.randint(0, 256, 256)])
    return np.repeat(rows[..., None], channels, -1) if channels == 1 else \
        np.stack([rows, np.roll(rows, 85, 1), np.roll(rows, 170, 1)], -1)


def iccp(profile, name=b"profile"):
    return chunk(b"iCCP", name + b"\x00\x00" + zlib.compress(profile))


def _cases():
    rng = np.random.RandomState(7)
    rgb = ramps(rng, 3)
    grey = ramps(rng, 1)
    for g in GAMMAS:
        yield f"rgb_g{g}.png", png(rgb, 8, 2, [gama(g)])
    for g in (20000, 100000):
        yield f"grey8_g{g}.png", png(grey, 8, 0, [gama(g)])
    for depth, g in ((1, 100000), (2, 100000), (2, 20000), (4, 200000)):
        low = rng.randint(0, 1 << depth, (5, 37, 1))
        yield f"grey{depth}_g{g}.png", png(low, depth, 0, [gama(g)])
    palette = rng.randint(0, 256, (256, 3))
    yield "palette8_g100000.png", png(grey, 8, 3, [gama(100000)],
                                      palette=palette)
    yield "palette2_g20000.png", png(rng.randint(0, 4, (6, 33, 1)), 2, 3,
                                     [gama(20000)], palette=palette[:4])
    yield "rgb_adam7_g70000.png", png(rgb[:, :61], 8, 2, [gama(70000)],
                                      interlace=True)
    mask = rng.randint(0, 256, (40, 48, 1))
    mask[:20] = rng.randint(0, 2, (20, 48, 1))  # a mask's 0 / 1 values
    yield "mask_g100000.png", png(mask, 8, 0, [gama(100000)])
    # how the chunks around gAMA change it (libpng 1.6's colour space)
    srgb = chunk(b"sRGB", b"\x00")
    profile = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")) \
        .tobytes()
    grey_profile = bytearray(profile)
    grey_profile[16:20] = b"GRAY"
    chrm = chunk(b"cHRM", struct.pack(">8I", 31270, 32900, 64000, 33000,
                                      30000, 60000, 15000, 6000))
    chunks = {
        "srgb_then_gama": [srgb, gama(100000)],
        "gama_then_srgb": [gama(100000), srgb],
        "srgb_intent7_then_gama": [chunk(b"sRGB", b"\x07"), gama(100000)],
        "srgb_bad_crc_then_gama": [chunk(b"sRGB", b"\x00", True),
                                   gama(100000)],
        "gama_twice": [gama(100000), gama(45455)],
        "gama_bad_crc": [gama(100000, True)],
        "gama_0_then_gama": [gama(0), gama(100000)],
        "gama_16": [gama(16)],
        "gama_625000001": [gama(625000001)],
        "chrm_then_gama": [chrm, gama(100000)],
        "chrm_zero_then_gama": [chunk(b"cHRM", bytes(32)), gama(100000)],
        "gama_then_chrm_zero": [gama(100000), chunk(b"cHRM", bytes(32))],
        "chrm_twice_then_gama": [chrm, chrm, gama(100000)],
        "iccp_then_gama": [iccp(profile), gama(100000)],
        "iccp_grey_profile_then_gama": [iccp(bytes(grey_profile)),
                                        gama(100000)],
        "iccp_short_then_gama": [iccp(b"x" * 200), gama(100000)],
        "iccp_truncated_then_gama": [iccp(profile[:300]), gama(100000)],
        "srgb_then_iccp_then_gama": [srgb, iccp(profile), gama(100000)],
    }
    for name, before in chunks.items():
        yield f"{name}.png", png(rgb, 8, 2, before)
    yield "grey_iccp_rgb_profile_then_gama.png", png(
        grey, 8, 0, [iccp(profile), gama(100000)])
    yield "gama_after_plte.png", png(grey, 8, 3, palette=palette,
                                     after_plte=[gama(100000)])
    # files the JAX loader hands to Pillow, which ignores the gamma
    alpha = np.concatenate([rgb, rng.randint(0, 256, (4, 256, 1))], -1)
    yield "rgba_g100000.png", png(alpha, 8, 6, [gama(100000)])
    yield "rgb16_g100000.png", png(rgb.astype(np.uint16) * 257, 16, 2,
                                   [gama(100000)])
    yield "grey_trns_g100000.png", png(grey, 8, 0, [
        gama(100000)], after_plte=[chunk(b"tRNS", b"\x00\x07")])
    yield "palette_trns_g100000.png", png(grey, 8, 3, [gama(100000)],
                                          palette=palette, after_plte=[
                                              chunk(b"tRNS", b"\x80" * 9)])


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main():
    manifest = {}
    for old in HERE.glob("*.png"):
        old.unlink()
    for name, data in _cases():
        path = HERE / name
        path.write_bytes(data)
        rgb = load_image(str(path))
        try:
            gray = _digest(load_target(str(path))[..., 0].astype(np.uint8))
        except Exception:  # Pillow refuses a chunk's bad CRC: no grey read
            gray = None
        manifest[name] = {
            "sha256": hashlib.sha256(data).hexdigest(),
            "shape": list(rgb.shape), "rgb_sha256": _digest(rgb),
            "gray_sha256": gray,
            "oracle": ("libpng" if native_decode.decode_rgb(str(path))
                       is not None else "Pillow")}
    with open(HERE / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(HERE / n) for n in manifest)
    print(f"{len(manifest)} files, {total} bytes")


if __name__ == "__main__":
    main()
