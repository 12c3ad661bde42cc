"""Write tests/fixtures/zstd_frames: ZSTD frames written by libzstd (the
copy Pillow's libtiff uses, libzstd.py), each there to cover one path of
the port's decoder (csrc/zstd_decode.cpp), and a `manifest.json` with each
frame's SHA-256, its content's size and SHA-256 (the frame decoded by
libzstd as libtiff drives it), the libzstd version, and the paths the
frame takes (describe.py), which the writer checks it covers. One frame
libzstd's compressor does not write, RLE literals, is built by hand
(`handmade`); libzstd decodes it too.

Run from the root of the repository, where Pillow is installed:

    python tests/fixtures/zstd_frames/make_frames.py
"""

import hashlib
import json
import struct
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import describe  # noqa: E402
import libzstd  # noqa: E402


def text(rng, n):
    """`n` bytes of words from a vocabulary of 300."""
    words = [bytes(rng.randint(97, 123, rng.randint(3, 9)).astype(np.uint8))
             for _ in range(300)]
    return b" ".join(words[i] for i in rng.randint(0, 300, n // 5))[:n]


def picture(h, w, seed):
    """A tile-like RGB picture's bytes: gradients, noise, a bright block."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([40 + 120 * x / w, 60 + 100 * y / h,
                    np.full((h, w), 90.0)], -1) + rng.randint(0, 12,
                                                              (h, w, 3))
    img[h // 4:h // 2, w // 3:w // 2] = rng.randint(170, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8).tobytes()


def rle_literals_frame(byte, count):
    """A single-segment frame of one compressed block: `count` (< 32)
    literals, RLE-coded, and no sequences."""
    block = bytes([1 | count << 3, byte, 0])
    return struct.pack("<IBB", 0xFD2FB528, 0x20, count) + \
        struct.pack("<I", len(block) << 3 | 0b101)[:3] + block


def frames():
    """(name, frame bytes, the path it is there for)."""
    rng = np.random.RandomState(24)
    noise = bytes(rng.randint(0, 256, 3000).astype(np.uint8))
    words = text(rng, 40000)
    yield "raw_block.zst", libzstd.compress(noise, -5), "raw_block"
    yield "rle_blocks.zst", libzstd.compress(b"\x07" * 300000, 19), \
        "rle_block"
    yield "literals_raw.zst", libzstd.compress(b"abcabcabcabd" * 3), \
        "literals_raw"
    yield "literals_rle.zst", rle_literals_frame(0x71, 20), \
        "literals_rle"
    yield "huffman_1_stream.zst", libzstd.compress(
        words[:200], 19, chunk=60), "literals_huffman_1_streams"
    yield "huffman_4_streams.zst", libzstd.compress(words[:4000], 3), \
        "literals_huffman_4_streams"
    yield "huffman_double_symbol.zst", libzstd.compress(
        words, 1, checksum=True), "literals_huffman_4_streams_double_symbol"
    yield "treeless_1_stream.zst", libzstd.compress(
        words[:6000], 1, checksum=True, pledged=False, chunk=500), \
        "literals_treeless_1_streams"
    yield "treeless_4_streams.zst", libzstd.compress(
        words, 22, chunk=500), "literals_treeless_4_streams"
    runs = np.random.RandomState(1).randint(97, 123, 3000)
    yield "sequences_rle.zst", libzstd.compress(
        b"".join(b"x" + bytes([c]) * 6 for c in runs), 19, chunk=1000), \
        "of_rle"
    yield "sequences_fse.zst", libzstd.compress(words, 22), "ll_fse"
    yield "sequences_repeat.zst", libzstd.compress(
        words, 22, pledged=False, chunk=4096), "of_repeat"
    yield "no_sequences.zst", libzstd.compress(
        bytes(rng.randint(0, 4, 400).astype(np.uint8)), 19, chunk=100), \
        "no_sequences"
    yield "checksum_level1.zst", libzstd.compress(
        picture(64, 64, 4), 1, checksum=True), "checksum"
    yield "no_content_size.zst", libzstd.compress(
        picture(64, 64, 5), 3, pledged=False, chunk=5000), \
        "no_content_size"
    yield "window_16m.zst", libzstd.compress(
        words, 3, window_log=24, pledged=False, chunk=7000), \
        "window_over_2^20"
    tile = picture(48, 64, 6)
    for level in (1, 3, 19, 22):
        yield f"tile_level{level}.zst", libzstd.compress(
            tile, level, checksum=level % 2 == 1), "compressed_block"
    yield "skippable_after.zst", libzstd.compress(noise[:500], 3) + \
        struct.pack("<II", 0x184D2A5E, 5) + b"extra", "content_size"


def main():
    manifest = {}
    for old in HERE.glob("*.zst"):
        old.unlink()
    for name, frame, path in frames():
        content = libzstd.content(frame)
        if libzstd.tiff_decode(frame, len(content))[0] != content:
            raise AssertionError(f"{name}: libtiff's reading differs")
        found = describe.features(frame)
        if path not in found:
            raise AssertionError(f"{name} does not take {path}: {found}")
        (HERE / name).write_bytes(frame)
        manifest[name] = {
            "sha256": hashlib.sha256(frame).hexdigest(),
            "content_size": len(content),
            "content_sha256": hashlib.sha256(content).hexdigest(),
            "covers": path, "paths": sorted(found),
            "oracle": f"libzstd {libzstd.version()}"}
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1,
                                                   sort_keys=True) + "\n")
    total = sum((HERE / n).stat().st_size for n in manifest)
    print(f"{len(manifest)} frames, {total} bytes")


if __name__ == "__main__":
    main()
