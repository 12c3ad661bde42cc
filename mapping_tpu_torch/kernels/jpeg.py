"""The JPEG pixel stage: CUDA kernels (csrc/jpeg_pixels.cu) and their plain
PyTorch version.

`pixels(coef, quant, geometry)` turns a batch of quantised coefficient
blocks (`utils/jpeg.read_coefficients`, one geometry for the batch) into
(B, H, W, 3) uint8 RGB, equal bit for bit to libjpeg-turbo's default decode:
- J1 `jpeg_idct`: the coefficients times the component's quant table,
  libjpeg's `jpeg_idct_islow` (jidctint.c: CONST_BITS 13, PASS1_BITS 2,
  columns then rows, 64-bit products, a 32-bit workspace), +128 and the
  masked range-limit table (jdmaster.c `prepare_range_limit_table`) ->
  uint8 component planes padded to whole MCUs;
- J2 `jpeg_color`: libjpeg-turbo's upsampling of each plane (jdsample.c:
  `h2v1_fancy_upsample`, `h2v2_fancy_upsample` where the component is more
  than 2 samples wide, else replication; `h1v2_fancy_upsample`; a copy at
  1x1), with the row above the first and below the last real row being
  that row (jdmainct.c), then `ycc_rgb_convert` (jdcolor.c: FIX(1.40200),
  FIX(0.71414), FIX(0.34414), FIX(1.77200), SCALEBITS 16), or a copy of a
  grey or RGB stream -> RGB cropped to the image.

Neither kernel replaces a TPU kernel: the JAX package decodes on the host
with libjpeg (cpp/decode.cpp). They are the port's way to decode the JPEG
tiles of CrowdAI on a machine without libjpeg, and they move the IDCT,
upsampling and colour work off the host. The stage is bound by bytes
(`kernels/bounds.jpeg_pixels`: 128 bytes of coefficients a block in, 3
bytes a pixel out); J1 runs one thread per 8x8 block and J2 one thread per
pair of output pixels, so the planes between them make a round trip
through device memory, which fusing the two would save.

The wrapper takes CUDA tensors to the kernels and CPU tensors to the
plain version, by the tensors' device alone; it launches on the current
stream, never synchronises, allocates with torch.empty, and adds one to
`LAUNCHES[name]` at each launch.
"""

import ctypes

import torch

from mapping_tpu_torch.kernels.build import CSRC, build_shared_library

LIBRARY = "mapping_jpeg"
SOURCES = [CSRC / "jpeg_pixels.cu"]
LAUNCHES = {"jpeg_idct": 0, "jpeg_color": 0}
#: ints of the geometry record passed to the kernels (JpegGeom in
#: csrc/jpeg_pixels.cu): 6 scalars, then 10 arrays of 3
GEOM_INTS = 6 + 10 * 3
COLORS = {"gray": 0, "ycc": 1, "rgb": 2}

#: the plain version works on at most this many values at a time (an
#: IDCT chunk's coefficients, a colour band's pixels), so that its int64
#: temporaries stay some tens of MB however large the image
PLAIN_VALUES = 1 << 22

_library = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def library():
    """(ctypes library, Built): compiles csrc/jpeg_pixels.cu on first
    use."""
    global _library
    if _library is None:
        built = build_shared_library(LIBRARY, SOURCES)
        lib = ctypes.CDLL(str(built.path))
        lib.jpeg_idct.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.jpeg_color.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.jpeg_idct.restype = lib.jpeg_color.restype = ctypes.c_int
        _library = (lib, built)
    return _library


def plane_shapes(geometry):
    """(rows, columns) of each component's uint8 plane: its blocks, padded
    to whole MCUs, 8 samples a side."""
    return tuple((8 * by, 8 * bx) for by, bx in geometry.blocks)


def plane_bytes(geometry):
    return sum(r * c for r, c in plane_shapes(geometry))


def geometry_record(geometry):
    """The JpegGeom ints of csrc/jpeg_pixels.cu."""
    n = len(geometry.factors)
    shapes = plane_shapes(geometry)
    offsets, off = [], 0
    for r, c in shapes:
        offsets.append(off)
        off += r * c

    def pad(values):
        return list(values) + [0] * (3 - n)

    fancy = [int(rh == 1 or cw > 2) for (rh, _), (_, cw)
             in zip(geometry.ratios, geometry.sampled)]
    rec = [n, geometry.height, geometry.width, geometry.n_blocks, off,
           COLORS[geometry.color]]
    rec += pad(bx for _, bx in geometry.blocks)
    rec += pad(by for by, _ in geometry.blocks)
    rec += pad(geometry.first_block)
    rec += pad(offsets)
    rec += pad(c for _, c in shapes)
    rec += pad(h for h, _ in geometry.sampled)
    rec += pad(w for _, w in geometry.sampled)
    rec += pad(r for r, _ in geometry.ratios)
    rec += pad(r for _, r in geometry.ratios)
    rec += pad(fancy)
    assert len(rec) == GEOM_INTS
    return (ctypes.c_int * GEOM_INTS)(*rec)


# --- the plain version -------------------------------------------------------

def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _islow_1d(d, shift):
    """One pass of jpeg_idct_islow over 8 int64 tensors (one per input
    coefficient along the pass); the 8 outputs descaled by `shift`."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * 4433
    tmp2 = z1 + z3 * -15137
    tmp3 = z1 + z2 * 6270
    tmp0 = (d[0] + d[4]) * 8192
    tmp1 = (d[0] - d[4]) * 8192
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0, t1 = t0 + z1 + z3, t1 + z2 + z4
    t2, t3 = t2 + z2 + z3, t3 + z1 + z4
    return [_descale(v, shift) for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def range_limit(x):
    """libjpeg's post-IDCT range limit of a descaled value: the table
    index x & 1023 maps 0..127 to 128..255, 128..511 to 255, 512..895 to 0
    and 896..1023 to 0..127."""
    idx = x & 1023
    return torch.where(idx < 128, idx + 128, torch.where(
        idx < 512, 255, torch.where(idx < 896, 0, idx - 896)))


def idct_blocks(blocks, quant):
    """(..., 64) int16 coefficients and (..., 64) int32 quant values
    (broadcast) -> (..., 8, 8) uint8 samples, as jpeg_idct_islow."""
    x = (blocks.to(torch.int64) * quant.to(torch.int64)).reshape(
        *blocks.shape[:-1], 8, 8)
    cols = _islow_1d([x[..., k, :] for k in range(8)], 11)
    # the workspace is a C int
    ws = torch.stack(cols, dim=-2).to(torch.int32).to(torch.int64)
    rows = _islow_1d([ws[..., k] for k in range(8)], 18)
    return range_limit(torch.stack(rows, dim=-1)).to(torch.uint8)


def idct_plain(coef, quant, geometry):
    """The plain J1: (B, n_blocks, 64) int16 and (B, n_comp, 64) int32 ->
    (B, plane_bytes) uint8, each component's plane row-major; at most
    PLAIN_VALUES // 64 blocks at a time."""
    b = coef.shape[0]
    step = max(1, PLAIN_VALUES // 64 // max(b, 1))
    out = []
    for c, ((by, bx), first) in enumerate(zip(geometry.blocks,
                                              geometry.first_block)):
        blk = coef[:, first:first + by * bx]
        pix = torch.cat([idct_blocks(blk[:, s:s + step], quant[:, c:c + 1])
                         for s in range(0, by * bx, step)], dim=1)
        out.append(pix.reshape(b, by, bx, 8, 8).permute(0, 1, 3, 2, 4)
                   .reshape(b, -1))
    return torch.cat(out, dim=1)


def _upsample(p, ch, cw, rh, rv, y, width):
    """Rows `y` of a component plane (B, rows, cols) uint8 upsampled to
    (B, len(y), width) int64, as libjpeg-turbo's upsampler for the ratio
    (rh, rv)."""
    x = torch.arange(width, device=p.device)
    if (rh, rv) == (1, 1):
        return p[:, y, :width].long()
    fancy = rh == 1 or cw > 2
    if not fancy:  # h2v1 / h2v2 replication
        return p[:, y // rv][:, :, x // 2].long()
    if rv == 2:
        i = y // 2
        below = (y % 2).bool()
        other = torch.where(below, (i + 1).clamp(max=ch - 1),
                            (i - 1).clamp(min=0))
        near, far = p[:, i].long(), p[:, other].long()
        if rh == 1:  # h1v2: 3/4 nearer row + 1/4 further, biases 1 / 2
            bias = torch.where(below, 2, 1)[None, :, None]
            return ((3 * near + far + bias) >> 2)[:, :, :width]
        rows = 3 * near + far  # h2v2: column sums, then as h2v1 in 16ths
    else:
        rows = p[:, y].long()
    j = x // 2
    this = rows[:, :, j]
    left = rows[:, :, (j - 1).clamp(min=0)]
    right = rows[:, :, (j + 1).clamp(max=cw - 1)]
    if rv == 2:
        even = torch.where(j == 0, 4 * this + 8, 3 * this + left + 8) >> 4
        odd = torch.where(j == cw - 1, 4 * this + 7,
                          3 * this + right + 7) >> 4
    else:
        even = torch.where(j == 0, this, (3 * this + left + 1) >> 2)
        odd = torch.where(j == cw - 1, this, (3 * this + right + 2) >> 2)
    return torch.where((x % 2).bool(), odd, even)


def color_plain(planes, geometry):
    """The plain J2: (B, plane_bytes) uint8 -> (B, H, W, 3) uint8, in
    bands of at most PLAIN_VALUES output pixels."""
    b = planes.shape[0]
    h, w = geometry.height, geometry.width
    band = max(1, PLAIN_VALUES // max(b * w, 1))
    return torch.cat([_color_rows(planes, geometry, torch.arange(
        y, min(y + band, h), device=planes.device))
        for y in range(0, h, band)], dim=1)


def _color_rows(planes, geometry, y):
    """Rows `y` of the plain J2's output."""
    b = planes.shape[0]
    comps, off = [], 0
    for (rows, cols), (ch, cw), (rh, rv) in zip(
            plane_shapes(geometry), geometry.sampled, geometry.ratios):
        p = planes[:, off:off + rows * cols].reshape(b, rows, cols)
        off += rows * cols
        comps.append(_upsample(p, ch, cw, rh, rv, y, geometry.width))
    if geometry.color == "gray":
        rgb = [comps[0]] * 3
    elif geometry.color == "rgb":
        rgb = comps
    else:
        y, cb, cr = comps[0], comps[1] - 128, comps[2] - 128
        r = y + ((91881 * cr + 32768) >> 16)
        g = y + ((-22554 * cb + 32768 - 46802 * cr) >> 16)
        bl = y + ((116130 * cb + 32768) >> 16)
        rgb = [v.clamp(0, 255) for v in (r, g, bl)]
    return torch.stack(rgb, dim=-1).to(torch.uint8)


def pixels_plain(coef, quant, geometry):
    return color_plain(idct_plain(coef, quant, geometry), geometry)


# --- the kernels -------------------------------------------------------------

def _check(x, dtype, shape, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: needs a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{what}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous tensor")


def _launch(fn, name, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def idct(coef, quant, geometry):
    """J1 on CUDA tensors: (B, n_blocks, 64) int16 and (B, n_comp, 64)
    int32 -> (B, plane_bytes) uint8 planes."""
    b = coef.shape[0]
    _check(coef, torch.int16, (b, geometry.n_blocks, 64), "jpeg_idct")
    _check(quant, torch.int32, (b, len(geometry.factors), 64), "jpeg_idct")
    if quant.device != coef.device:
        raise ValueError("jpeg_idct: coefficients and quant tables on "
                         "different devices")
    if b * geometry.n_blocks >= 2 ** 31 \
            or b * plane_bytes(geometry) >= 2 ** 40:
        raise ValueError("jpeg_idct: batch too large")
    planes = torch.empty((b, plane_bytes(geometry)), dtype=torch.uint8,
                         device=coef.device)
    if b:
        rec = geometry_record(geometry)  # alive until the launch returns
        _launch(library()[0].jpeg_idct, "jpeg_idct", coef.device,
                coef.data_ptr(), quant.data_ptr(), planes.data_ptr(), b,
                ctypes.addressof(rec))
    return planes


def color(planes, geometry):
    """J2 on a CUDA tensor: (B, plane_bytes) uint8 -> (B, H, W, 3)
    uint8."""
    b = planes.shape[0]
    _check(planes, torch.uint8, (b, plane_bytes(geometry)), "jpeg_color")
    out = torch.empty((b, geometry.height, geometry.width, 3),
                      dtype=torch.uint8, device=planes.device)
    if b * geometry.height * ((geometry.width + 1) // 2) >= 2 ** 31:
        raise ValueError("jpeg_color: batch too large")
    if b:
        rec = geometry_record(geometry)  # alive until the launch returns
        _launch(library()[0].jpeg_color, "jpeg_color", planes.device,
                planes.data_ptr(), out.data_ptr(), b, ctypes.addressof(rec))
    return out


def pixels(coef, quant, geometry):
    """(B, n_blocks, 64) int16 coefficients and (B, n_comp, 64) int32
    quant tables of images of one geometry -> (B, H, W, 3) uint8 RGB on
    their device: J1 then J2 for CUDA tensors, the plain version for CPU
    tensors."""
    if coef.device.type == "cpu" and quant.device.type == "cpu":
        return pixels_plain(coef, quant, geometry)
    return color(idct(coef, quant, geometry), geometry)
