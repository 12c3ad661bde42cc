"""The port's standard-library PNG reader (utils/png.py), the only PNG
path on a machine without libpng, against the JAX package's readers on the
same bytes, exactly: `mapping_tpu.data.loader.load_image` (RGB: libpng
for palette files without tRNS, low-bit grey and 8-bit files, Pillow for
alpha and 16-bit ones) and `load_target`'s mask channel (grey: libpng for
grey files without tRNS, Pillow's convert("L") else). Every colour type x
bit depth x interlace, with and without tRNS, is written by a small PNG
writer here (Pillow cannot write Adam7), with all five row filters. The
port's own entry points (`native_decode.read_bytes`, `read_image`, the
loader's mask reader) are held with libpng out of the way."""

import struct
import zlib

import numpy as np
import pytest

from mapping_tpu.data.loader import load_image, load_target
from mapping_tpu_torch.data import loader as port_loader
from mapping_tpu_torch.utils import native_decode, png

#: colour type -> (samples a pixel, bit depths)
KINDS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
         4: (2, (8, 16)), 6: (4, (8, 16))}
CASES = [(colour, depth, interlace, trns)
         for colour, (_, depths) in KINDS.items() for depth in depths
         for interlace in (0, 1) for trns in (False, True)
         if not (trns and colour in (4, 6))]  # alpha types have no tRNS


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _pack(samples, depth):
    """(h, w, c) samples -> (h, stride) bytes as PNG stores them."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    shifts = np.arange(depth - 1, -1, -1)
    bits = ((samples[..., :1] >> shifts) & 1).astype(np.uint8).reshape(h, -1)
    return np.packbits(bits, axis=1)


def _left(row, bpp):
    return np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])[:len(row)]


def _filter(rows, bpp, kinds):
    """Each row with filter kinds[y % 5]: None, Sub, Up, Average, Paeth."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = kinds[y % len(kinds)]
        a = _left(row, bpp)
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - a
        elif kind == 2:
            f = row - prev
        elif kind == 3:
            f = row - ((a + prev) >> 1)
        else:
            c = _left(prev, bpp)
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            f = row - np.where((pa <= pb) & (pa <= pc), a,
                               np.where(pb <= pc, prev, c))
        out.append(bytes([kind]) + (f & 255).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def write_png(samples, depth, colour, interlace=0, palette=None, trns=None,
              kinds=(0, 1, 2, 3, 4)):
    """A PNG of (h, w, c) samples of any colour type and bit depth, plain
    or Adam7-interlaced."""
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in png.ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filter(_pack(sub, depth), bpp, kinds)
    else:
        raw = _filter(_pack(samples, depth), bpp, kinds)
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _case(colour, depth, interlace, trns, seed):
    """Drawn PNG bytes of one kind: sizes 1-37 a side (Adam7's passes
    empty where the image is small), 16-bit values past 255, palette
    indices past the palette."""
    rng = np.random.RandomState(seed)
    h, w = (int(v) for v in rng.randint(1, 38, 2))
    channels = KINDS[colour][0]
    top = (1 << depth) - 1
    palette = chunk = None
    if colour == 3:
        n = int(rng.randint(1, top + 1))
        palette = rng.randint(0, 256, (n, 3))
        samples = rng.randint(0, min(n + 2, top + 1), (h, w, 1))
        if trns:
            chunk = bytes(rng.randint(0, 256, int(rng.randint(1, n + 1)))
                          .astype(np.uint8))
    else:
        high = 600 if depth == 16 and seed % 2 else top + 1
        samples = rng.randint(0, high, (h, w, channels))
        if trns:
            chunk = struct.pack(f">{channels}H",
                                *(int(v) for v in rng.randint(0, top + 1,
                                                              channels)))
    return write_png(samples, depth, colour, interlace, palette, chunk,
                     kinds=tuple(int(k) for k in rng.permutation(5)))


@pytest.fixture
def no_libpng(monkeypatch):
    """The port's PNG path as on a machine without libpng."""
    monkeypatch.setattr(native_decode, "_png_native", lambda data: None)


@pytest.mark.parametrize("colour, depth, interlace, trns", CASES)
def test_every_png_kind_reads_as_the_jax_loader(tmp_path, no_libpng, colour,
                                                depth, interlace, trns):
    """Each kind through the stdlib reader: `read_bytes` and `read_image`
    give load_image's RGB, and the port's mask reader load_target's mask
    channel, byte for byte."""
    data = _case(colour, depth, interlace, trns, seed=colour * 100 + depth
                 + 7 * interlace + 3 * trns)
    path = tmp_path / "masks" / "tile.png"
    path.parent.mkdir()
    path.write_bytes(data)
    want = load_image(str(path))
    np.testing.assert_array_equal(native_decode.read_bytes(data), want)
    np.testing.assert_array_equal(native_decode.read_image(path), want)
    np.testing.assert_array_equal(
        port_loader.load_target(str(path))[..., 0],
        load_target(str(path))[..., 0])


@pytest.mark.parametrize("colour, depth", [(0, 1), (0, 16), (2, 16), (3, 4),
                                           (4, 16), (6, 8)])
def test_interlaced_reads_as_its_plain_file(colour, depth):
    """An Adam7 file, each pass unfiltered with its own width, gives the
    pixels of the plain file of the same samples."""
    rng = np.random.RandomState(depth + colour)
    channels = KINDS[colour][0]
    for h, w in ((1, 1), (3, 9), (8, 8), (17, 30)):
        samples = rng.randint(0, 1 << depth, (h, w, channels))
        palette = (rng.randint(0, 256, (1 << depth, 3)) if colour == 3
                   else None)
        plain = png.decode_png(write_png(samples, depth, colour, 0, palette))
        laced = png.decode_png(write_png(samples, depth, colour, 1, palette))
        np.testing.assert_array_equal(laced, plain)


def test_sixteen_bit_samples_read_as_pillow_does():
    """16-bit grey is clipped at 255 (Pillow's "I;16": 256, 1000 and
    65535 give 255); 16-bit RGB, grey+alpha and RGBA keep the high byte
    (256 gives 1, 1000 gives 3)."""
    values = np.array([0, 255, 256, 1000, 65535])
    grey = png.decode_png(write_png(values.reshape(1, -1, 1), 16, 0))
    assert grey[0, :, 0].tolist() == [0, 255, 255, 255, 255]
    rgb = png.decode_png(write_png(
        np.repeat(values.reshape(1, -1, 1), 3, -1), 16, 2))
    assert rgb[0, :, 0].tolist() == [0, 0, 1, 3, 255]


@pytest.mark.parametrize("body", [
    b"\x00\x00\x00\x01\x08\x01\x00\x00\x00",  # 8-bit palette type 1
    b"\x00\x00\x00\x01\x00\x00\x00\x01\x03\x03\x00\x00\x00",  # 3-bit grey
    b"\x00\x00\x00\x01\x00\x00\x00\x01\x10\x03\x00\x00\x00",  # 16-bit palette
    b"\x00\x00\x00\x01\x00\x00\x00\x01\x08\x00\x00\x00\x02"])  # interlace 2
def test_bad_headers_are_refused(body):
    data = (png.SIGNATURE + _chunk(b"IHDR", body)
            + _chunk(b"IDAT", zlib.compress(b"\x00\x00"))
            + _chunk(b"IEND", b""))
    with pytest.raises(ValueError):
        png.decode_png(data)
