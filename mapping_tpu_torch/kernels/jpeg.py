"""The JPEG pixel stage: one CUDA kernel (csrc/jpeg_pixels.cu) and its plain
PyTorch version.

`pixels(coef, quant, geometry)` turns a batch of quantised coefficient
blocks (`utils/jpeg.read`, one geometry for the batch) into
(B, H, W, 3) uint8 RGB, equal bit for bit to libjpeg-turbo's default decode:
- the IDCT (`idct_plain`): the coefficients times the component's quant
  table, libjpeg's `jpeg_idct_islow` (jidctint.c: CONST_BITS 13,
  PASS1_BITS 2, columns then rows, 64-bit products, a 32-bit workspace),
  +128 and the masked range-limit table (jdmaster.c
  `prepare_range_limit_table`) -> uint8 component planes padded to whole
  MCUs;
- the colour stage (`color_plain`): libjpeg-turbo's upsampling of each
  plane (jdsample.c: `h2v1_fancy_upsample`, `h2v2_fancy_upsample` where
  the component is more than 2 samples wide, `h1v2_fancy_upsample`, a
  copy at 1x1, and box replication for every other integral ratio,
  `int_upsample`), with the row above the first and below the last real
  row being that row (jdmainct.c), then `ycc_rgb_convert` (jdcolor.c:
  FIX(1.40200), FIX(0.71414), FIX(0.34414), FIX(1.77200), SCALEBITS 16),
  a copy of a grey or RGB stream, or for CMYK and YCCK what Pillow makes
  of libjpeg's CMYK (the JAX package reads those files through Pillow)
  -> RGB cropped to the image.

On the card both run in one kernel, `jpeg_pixels`: a CTA decodes a band
of MCU rows of one image into component planes in shared memory and
writes the band's RGB, so the planes never reach device memory. It
replaces no TPU kernel: the JAX package decodes on the host with libjpeg
(cpp/decode.cpp). It is the port's way to decode the JPEG tiles of
CrowdAI on a machine without libjpeg, and it moves the IDCT, upsampling
and colour work off the host. Its bound counts bytes
(`kernels/bounds.jpeg_pixels`: 128 bytes of coefficients a block in, 3
bytes a pixel out); its work is integer instructions, so its IDCT runs
in 32-bit arithmetic where that is exact (`islow_gain`, `PASS1_LIMIT`)
and in 64 bits elsewhere.

The wrapper takes CUDA tensors to the kernel and CPU tensors to the
plain version, by the tensors' device alone; on both it refuses quant
values past +-QUANT_MAX. It launches on the current stream, synchronises
only to read that check's one bool back (not under CUDA-graph capture),
allocates with torch.empty, and adds one to `LAUNCHES[name]` at each
launch.
"""

import ctypes

import torch

from mapping_tpu_torch.kernels.build import CSRC, build_shared_library

LIBRARY = "mapping_jpeg"
SOURCES = [CSRC / "jpeg_pixels.cu"]
LAUNCHES = {"jpeg_pixels": 0}
#: components a geometry has at most (CMYK / YCCK)
MAX_COMPS = 4
#: ints of the geometry record passed to the kernel (JpegGeom in
#: csrc/jpeg_pixels.cu): 9 scalars, then 8 arrays of MAX_COMPS
GEOM_INTS = 9 + 8 * MAX_COMPS
COLORS = {"gray": 0, "ycc": 1, "rgb": 2, "cmyk": 3, "ycck": 4}

#: the largest |quant value| taken: a DQT entry has 8 or 16 bits, and the
#: kernel's dequantised coefficients fit an int up to here
QUANT_MAX = 65535

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
        lib.jpeg_pixels.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.jpeg_pixels.restype = ctypes.c_int
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

    def pad(values):
        return list(values) + [0] * (MAX_COMPS - n)

    fancy = [int(upsampling(rh, rv, cw) in ("h2v1", "h2v2", "h1v2"))
             for (rh, rv), (_, cw) in zip(geometry.ratios, geometry.sampled)]
    rec = [n, geometry.height, geometry.width, geometry.n_blocks,
           COLORS[geometry.color], *geometry.mcus, geometry.hmax,
           geometry.vmax]
    rec += pad(h for h, _ in geometry.factors)
    rec += pad(v for _, v in geometry.factors)
    rec += pad(geometry.first_block)
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


def _islow_1d(d, shift, pre=False):
    """One pass of jpeg_idct_islow over 8 integer tensors (one per input
    coefficient along the pass, int64 as the C definition; in int32 the
    arithmetic is modulo 2^32); the 8 outputs descaled by `shift`, or
    before the descale with `pre`."""
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
    out = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    return list(out) if pre else [_descale(v, shift) for v in out]


def islow_weights():
    """(8, 8) int64: one islow pass as the linear map it is. Output o
    before its descale is sum_i W[o, i] d_i exactly, every step of the
    pass being an integer sum or a product by a constant
    (csrc/jpeg_pixels.cu kIslow, which decodes a halo block's one row as
    these dot products)."""
    eye = torch.eye(8, dtype=torch.int64)
    return torch.stack([torch.stack(_islow_1d(list(eye[k]), 0, pre=True))
                        for k in range(8)], dim=1)


def islow_gain():
    """The largest sum of |weight| over the outputs of one islow pass:
    61,214. With every input |d| <= M, |T| <= 61,214 M."""
    return int(islow_weights().abs().sum(dim=1).max())


#: the largest input |d| for which the first pass computes in 32-bit
#: arithmetic (modulo 2^32) what the C definition's 64-bit JLONG does: it
#: keeps (T + 2^10) >> 11 as a C int, so T + 2^10 must fit an int32:
#: (2^31 - 1 - 2^10) // islow_gain() (csrc/jpeg_pixels.cu kPass1Max); a
#: column past it takes the kernel's 64-bit path. The second pass needs no
#: bound: the range limit reads bits 18..27 of its sum, which are exact
#: modulo 2^32 for any inputs
PASS1_LIMIT = (2 ** 31 - 1 - 2 ** 10) // 61214


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
    """The plain IDCT: (B, n_blocks, 64) int16 and (B, n_comp, 64) int32 ->
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


def upsampling(rh, rv, cw):
    """libjpeg-turbo 2.1's upsampler for a component (jdsample.c
    jinit_upsampler, fancy upsampling on): "full" at ratio 1 x 1, "h2v1"
    / "h2v2" (fancy, where the component is more than 2 samples wide)
    and "h1v2" (fancy), and "box" replication for every other integral
    ratio (h2v1_upsample, h2v2_upsample, int_upsample)."""
    if (rh, rv) == (1, 1):
        return "full"
    if (rh, rv) == (1, 2):
        return "h1v2"
    if (rh, rv) in ((2, 1), (2, 2)) and cw > 2:
        return "h2v1" if rv == 1 else "h2v2"
    return "box"


def _upsample(p, ch, cw, rh, rv, y, width):
    """Rows `y` of a component plane (B, rows, cols) uint8 upsampled to
    (B, len(y), width) int64, as libjpeg-turbo's upsampler for the ratio
    (rh, rv)."""
    x = torch.arange(width, device=p.device)
    method = upsampling(rh, rv, cw)
    if method == "full":
        return p[:, y, :width].long()
    if method == "box":
        return p[:, y // rv][:, :, x // rh].long()
    if rv == 2:
        i = y // 2
        below = (y % 2).bool()
        other = torch.where(below, (i + 1).clamp(max=ch - 1),
                            (i - 1).clamp(min=0))
        near, far = p[:, i].long(), p[:, other].long()
        if method == "h1v2":  # 3/4 nearer row + 1/4 further, biases 1 / 2
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


def ycc_rgb(y, cb, cr):
    """jdcolor.c ycc_rgb_convert before its clamp: (R, G, B) of int64
    samples, cb and cr centred on 0."""
    return (y + ((91881 * cr + 32768) >> 16),
            y + ((-22554 * cb + 32768 - 46802 * cr) >> 16),
            y + ((116130 * cb + 32768) >> 16))


def muldiv255(a, b):
    """Pillow's MULDIV255: a * b / 255, rounded as Pillow rounds it."""
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def color_plain(planes, geometry):
    """The plain colour stage: (B, plane_bytes) uint8 -> (B, H, W, 3)
    uint8, in bands of at most PLAIN_VALUES output pixels."""
    b = planes.shape[0]
    h, w = geometry.height, geometry.width
    band = max(1, PLAIN_VALUES // max(b * w, 1))
    return torch.cat([_color_rows(planes, geometry, torch.arange(
        y, min(y + band, h), device=planes.device))
        for y in range(0, h, band)], dim=1)


def _color_rows(planes, geometry, y):
    """Rows `y` of the plain colour stage's output."""
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
    elif geometry.color == "ycc":
        rgb = [v.clamp(0, 255) for v in ycc_rgb(comps[0], comps[1] - 128,
                                                comps[2] - 128)]
    else:
        # CMYK / YCCK as the JAX package reads them (Pillow, which asks
        # libjpeg for CMYK: jdcolor.c ycck_cmyk_convert of a YCCK stream),
        # then Pillow's "CMYK;I" raw mode (255 - v), then Convert.c
        # cmyk2rgb: R = K' - MULDIV255(C', K') with K' = 255 - inverted K,
        # the stream's K sample. The inverted C of YCCK is clamp(R).
        if geometry.color == "cmyk":
            inv = [255 - v for v in comps[:3]]
        else:
            inv = [v.clamp(0, 255) for v in ycc_rgb(
                comps[0], comps[1] - 128, comps[2] - 128)]
        k = comps[3]
        rgb = [k - muldiv255(v, k) for v in inv]
    return torch.stack(rgb, dim=-1).to(torch.uint8)


def pixels_plain(coef, quant, geometry):
    return color_plain(idct_plain(coef, quant, geometry), geometry)


# --- the kernel --------------------------------------------------------------

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


def check_quant(quant):
    """Refuses quant tables past +-QUANT_MAX, which no JPEG holds. Under
    CUDA-graph capture nothing can be read back, so the check is left to
    the calls made before the capture."""
    if quant.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    if bool(((quant > QUANT_MAX) | (quant < -QUANT_MAX)).any()):
        raise ValueError(f"jpeg_pixels: quant values past +-{QUANT_MAX}; "
                         f"a JPEG's tables have at most 16 bits")


def pixels_cuda(coef, quant, geometry):
    """The kernel on CUDA tensors: (B, n_blocks, 64) int16 coefficients
    (16-byte aligned) and (B, n_comp, 64) int32 quant tables -> (B, H, W,
    3) uint8 RGB, one launch."""
    b = coef.shape[0]
    _check(coef, torch.int16, (b, geometry.n_blocks, 64), "jpeg_pixels")
    _check(quant, torch.int32, (b, len(geometry.factors), 64),
           "jpeg_pixels")
    if quant.device != coef.device:
        raise ValueError("jpeg_pixels: coefficients and quant tables on "
                         "different devices")
    if coef.data_ptr() % 16:
        raise ValueError("jpeg_pixels: the coefficients must be 16-byte "
                         "aligned")
    if b * geometry.n_blocks >= 2 ** 31:
        raise ValueError("jpeg_pixels: batch too large")
    check_quant(quant)
    out = torch.empty((b, geometry.height, geometry.width, 3),
                      dtype=torch.uint8, device=coef.device)
    if b:
        rec = geometry_record(geometry)  # alive until the launch returns
        with torch.cuda.device(coef.device):
            stream = torch.cuda.current_stream(coef.device).cuda_stream
            err = library()[0].jpeg_pixels(
                coef.data_ptr(), quant.data_ptr(), out.data_ptr(), b,
                ctypes.addressof(rec), stream)
        if err != 0:
            raise RuntimeError(f"jpeg_pixels: CUDA launch failed with "
                               f"error {err}")
        LAUNCHES["jpeg_pixels"] += 1
    return out


def pixels(coef, quant, geometry):
    """(B, n_blocks, 64) int16 coefficients and (B, n_comp, 64) int32
    quant tables of images of one geometry -> (B, H, W, 3) uint8 RGB on
    their device: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if coef.device.type == "cpu" and quant.device.type == "cpu":
        check_quant(quant)
        return pixels_plain(coef, quant, geometry)
    return pixels_cuda(coef, quant, geometry)
