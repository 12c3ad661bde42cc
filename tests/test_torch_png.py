"""The port's standard-library PNG reader (utils/png.py), the only PNG
path on a machine without libpng, against the JAX package's readers on the
same bytes, exactly: `mapping_tpu.data.loader.load_image` (RGB: libpng
for palette files without tRNS, low-bit grey and 8-bit files, Pillow for
alpha and 16-bit ones) and `load_target`'s mask channel (grey: libpng for
grey files without tRNS, Pillow's convert("L") else). Every colour type x
bit depth x interlace, with and without tRNS, is written by a small PNG
writer here (Pillow cannot write Adam7), with all five row filters. The
port's own entry points (`native_decode.read_bytes`, `read_image`, the
loader's mask reader) are held with libpng out of the way.

Gamma (F7): libpng converts a file gamma to sRGB in the JAX loader's reads
and Pillow does not; the port reproduces libpng's rule (utils/png.py's
docstring). The corpus `tests/fixtures/png_gamma` and drawn chunk
sequences (gAMA, sRGB, cHRM, iCCP, bad CRCs, chunks after PLTE) hold the
port's reads against the JAX loader's with libpng (as here) and without
it (as on the card's machine), RGB and mask alike. Each test first loads
the JAX package's libpng in its worker (`tests.torch_guards.py`): a
worker that lost that library's build race would otherwise compare the
port's libpng rules with Pillow's reads."""

import hashlib
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from mapping_tpu.data.loader import load_image, load_target
from mapping_tpu_torch.data import loader as port_loader
from mapping_tpu_torch.utils import native_decode, png
from tests.torch_guards import jax_decode_library

#: colour type -> (samples a pixel, bit depths)
KINDS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
         4: (2, (8, 16)), 6: (4, (8, 16))}
CASES = [(colour, depth, interlace, trns)
         for colour, (_, depths) in KINDS.items() for depth in depths
         for interlace in (0, 1) for trns in (False, True)
         if not (trns and colour in (4, 6))]  # alpha types have no tRNS


@pytest.fixture(autouse=True)
def _jax_libpng():
    """The JAX package's libpng, loaded in this worker."""
    jax_decode_library()


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


GAMMA = Path(__file__).resolve().parent / "fixtures" / "png_gamma"
GAMMA_MANIFEST = json.loads((GAMMA / "manifest.json").read_text())


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("libpng", [True, False],
                         ids=["libpng", "no_libpng"])
@pytest.mark.parametrize("name", sorted(GAMMA_MANIFEST))
def test_gamma_corpus_reads_as_the_jax_loader(monkeypatch, name, libpng):
    """F7: each file of the gamma corpus gives the JAX loader's RGB
    through `read_bytes` and `read_image`, with libpng and with it
    blocked, and the JAX `load_target`'s mask through the port's."""
    if not libpng:
        monkeypatch.setattr(native_decode, "_png_native", lambda data: None)
    entry = GAMMA_MANIFEST[name]
    path = GAMMA / name
    data = path.read_bytes()
    assert _digest(np.frombuffer(data, np.uint8)) == entry["sha256"]
    want = load_image(str(path))
    assert _digest(want) == entry["rgb_sha256"]
    np.testing.assert_array_equal(native_decode.read_bytes(data), want)
    np.testing.assert_array_equal(native_decode.read_image(path), want)
    if entry["gray_sha256"] is not None:
        mask = port_loader.load_target(str(path))[..., 0]
        np.testing.assert_array_equal(mask, load_target(str(path))[..., 0])
        assert _digest(mask.astype(np.uint8)) == entry["gray_sha256"]


def test_gamma_mask_differs_from_its_samples():
    """The grey mask with gAMA 100000: libpng's read, and so the port's
    `load_target`, is not the stored samples (the fault F7 was on every
    machine for masks)."""
    path = str(GAMMA / "mask_g100000.png")
    stored = png.decode_png((GAMMA / "mask_g100000.png").read_bytes())
    mask = port_loader.load_target(path)[..., 0]
    np.testing.assert_array_equal(mask, load_target(path)[..., 0])
    assert (mask != stored[..., 0]).any()
    assert png.gamma_table(100000)[1] == 21


@pytest.mark.parametrize("g, corrected", [
    (43181, True), (43182, False), (45455, False), (47847, False),
    (47848, True), (16, True), (625_000_000, True)])
def test_gamma_thresholds(g, corrected):
    assert (png.gamma_table(g) is not None) == corrected


def _drawn_chunk(rng, icc):
    """One gAMA, sRGB, cHRM, iCCP or tEXt chunk, valid or not, its CRC
    broken now and then."""
    k = rng.randint(9)
    if k <= 2:
        body = struct.pack(">I", int(rng.choice(
            [0, 15, 16, 20000, 43181, 43182, 45455, 47848, 100000,
             625000001, rng.randint(1, 300000)])))
        kind = b"gAMA"
    elif k <= 4:
        kind, body = b"sRGB", bytes([int(rng.choice([0, 3, 4, 7]))])
    elif k <= 6:
        values = [31270, 32900, 64000, 33000, 30000, 60000, 15000, 6000]
        if rng.rand() < .4:
            values[rng.randint(8)] = int(rng.choice([100001, 2 ** 31 + 5]))
        kind, body = b"cHRM", struct.pack(">8I", *values)
    elif k == 7:
        profile = bytearray(icc)
        r = rng.rand()
        if r < .2:
            profile[16:20] = b"GRAY"
        elif r < .35:
            profile[36:40] = b"xxxx"
        elif r < .5:
            profile = profile[:rng.randint(100, len(profile))]
        elif r < .6:
            profile = b"x" * int(rng.randint(10, 300))
        kind, body = b"iCCP", b"p\x00\x00" + zlib.compress(bytes(profile))
    else:
        kind, body = b"tEXt", b"a\x00b"
    chunk = _chunk(kind, body)
    if rng.rand() < .08:
        chunk = chunk[:-1] + bytes([chunk[-1] ^ 1])
    return chunk


@pytest.mark.parametrize("seed", range(16))
def test_drawn_gamma_chunks_read_as_libpng(tmp_path, seed):
    """Drawn chunk sequences before and after PLTE in grey (1-8 bits),
    palette and RGB files: the port's stdlib reads equal the JAX loader's
    libpng RGB and grey reads."""
    from PIL import ImageCms

    icc = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    rng = np.random.RandomState(seed)
    path = tmp_path / "x.png"
    for _ in range(25):
        colour = int(rng.choice([0, 2, 3]))
        depth = 8 if colour == 2 else int(rng.choice([1, 2, 4, 8]))
        samples = rng.randint(0, 256 if colour == 2 else 1 << depth,
                              (2, 40, 3 if colour == 2 else 1))
        raw = b"".join(b"\x00" + r.tobytes() for r in _pack(samples, depth))
        data = png.SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 40, 2, depth, colour, 0, 0, 0))
        data += b"".join(_drawn_chunk(rng, icc)
                         for _ in range(rng.randint(0, 5)))
        if colour == 3 or rng.rand() < .2:
            data += _chunk(b"PLTE", bytes(rng.randint(0, 256, 3 * (
                1 << depth if colour == 3 else 16)).astype(np.uint8)))
        data += b"".join(_drawn_chunk(rng, icc)
                         for _ in range(rng.randint(0, 3)))
        data += _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
        path.write_bytes(data)
        decoded = png.read_png(data)
        np.testing.assert_array_equal(png.to_rgb(decoded),
                                      load_image(str(path)))
        if colour == 0:
            np.testing.assert_array_equal(
                png.to_gray(decoded), load_target(str(path))[..., 0])
