// The JPEG pixel stage on the card: one kernel, `jpeg_pixels`, that takes
// quantised coefficient blocks of 1, 3 or 4 components to RGB (dequantise
// + islow IDCT + range limit, then upsampling + colour: grey, YCbCr, RGB,
// and CMYK / YCCK as Pillow reads libjpeg's CMYK), equal bit for bit to
// libjpeg-turbo's default decode (the C definitions in jidctint.c,
// jdsample.c, jdcolor.c), to Pillow's Convert.c for CMYK, and to the plain
// PyTorch version in kernels/jpeg.py.
//
// It replaces no TPU kernel. The JAX package decodes every tile on the
// host with libjpeg (cpp/decode.cpp); the port decodes the entropy coding
// on the host (csrc/jpeg_entropy.cpp) and the pixels here, so that JPEG
// tiles decode on a machine without libjpeg and the IDCT, upsampling and
// colour work leaves the host.
//
// What bounds it: bytes, 128 of coefficients a block in and 3 a pixel out
// (kernels/bounds.jpeg_pixels), 11 MB for a serving batch of 20 300^2
// tiles at 4:2:0, 3.3 us at 3.35 TB/s. Its work is integer
// instructions and shared-memory traffic: 16 eight-point butterflies a
// block, the transposes between them and ~30 instructions a pixel of
// upsampling and colour (which of them holds it at ~4x the bound is not
// measured). So the design keeps every intermediate on chip and cuts
// instructions where the C definition allows:
// - one CTA per (image, band of MCU rows, chunk of MCU columns); the host
//   picks them (`make_plan`): a whole MCU row a CTA, taller bands where
//   the batch fills the card, chunks of MCU columns where it does not (the
//   daemon's batch of 1) or where a row's planes pass kSmemCap;
// - the band's blocks are decoded by groups of 8 threads, from a table of
//   the CTA's blocks built once: each thread copies one 16-byte row of
//   coefficients into shared memory with cp.async a few waves ahead (a
//   warp reads 512 contiguous bytes), the group dequantises and transposes
//   them through a padded workspace, runs the column pass (one column a
//   thread), then the row pass (one row a thread), and stores 8 samples of
//   the component plane with one 8-byte store;
// - a component upsampled vertically (fancy h2v2, h1v2) needs the sample
//   row just above and below the band: the CTA decodes that one row of
//   each neighbouring block itself (a halo row, as 8 dot products a pass
//   rather than a butterfly), rather than waiting on another CTA; a
//   chunked row's horizontal halo blocks are decoded whole;
// - the planes never leave shared memory: upsampling and colour read
//   them (4:2:0 with fancy chroma, CrowdAI's sampling, has a path that
//   takes two chroma samples and their 2 x 4 output pixels a thread) and
//   write RGB into a shared staging buffer laid out with the output's own
//   16-byte alignment, which leaves as 16-byte stores (bytes only at a
//   segment's unaligned head and tail);
// - one launch a batch and geometry (two before, with the planes' round
//   trip through device memory).
//
// The 32-bit IDCT. A pass of jpeg_idct_islow maps 8 inputs d to 8 outputs
// (T + 2^(n-1)) >> n, each T a sum of the inputs times integer weights
// (kIslow); the largest sum of |weight| over the 8 outputs is 61,214
// (kernels/jpeg.islow_gain). The arithmetic below is modulo 2^32
// (unsigned), and + - * commute with that reduction, so the low 32 bits
// of every sum are exact whatever the inputs. The first pass keeps
// (T + 2^10) >> 11 as a C int, which needs bits 11..42: exact when the
// true T + 2^10 fits an int, i.e. for every input |d| <= (2^31 - 1 -
// 2^10) / 61,214 = kPass1Max (35,081). The check is made per column, on
// exactly the values the pass reads (finer than per block); a column
// outside it takes the 64-bit path, as corrupt streams can. The second
// pass's output reaches the range limit only through its low 10 bits,
// bits 18..27 of T + 2^17, so it is exact in 32 bits for any inputs and
// has no bound and no 64-bit path. The dequantised inputs coef * q fit an
// int: a DQT entry has at most 16 bits, and the wrapper refuses tables
// past +-65,535 (|coef * q| <= 32,768 * 65,535 < 2^31).
// Halo blocks give one sample row each, computed as dot products with
// kIslow (64-bit in the first pass, so without a bound).

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

// The geometry of a batch, as kernels/jpeg.geometry_record lays it out.
// `color`: 0 grey, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK; `fancy`: the component
// is upsampled by h2v1, h2v2 or h1v2 fancy upsampling (else by box
// replication, which at ratio 1 x 1 is a copy).
constexpr int kMaxComps = 4;
struct JpegGeom {
  int n_comp, height, width, n_blocks, color, mcu_rows, mcu_cols, hmax, vmax;
  int h[4], v[4], first_block[4], sampled_h[4], sampled_w[4], ratio_h[4],
      ratio_v[4], fancy[4];
};

constexpr int kGeomInts = 9 + 8 * kMaxComps;
static_assert(sizeof(JpegGeom) == kGeomInts * sizeof(int),
              "JpegGeom must match kernels/jpeg.GEOM_INTS");

// how a launch cuts the images: `band_rows` MCU rows and `chunk_cols` MCU
// columns a CTA; `bands` x `chunks` CTAs an image; `smem` bytes a CTA
struct Plan {
  int band_rows, chunk_cols, bands, chunks, smem;
  // byte offsets in shared memory: quant tables (at 0), islow weights,
  // each plane, the block table, then workspace and ring / staging (one
  // region: the IDCT's are dead when staging starts)
  int plane_off[kMaxComps], plane_cols[kMaxComps], wts_off, table_off,
      work_off;
  // staging: one segment (the band) or one an output row, `seg_pitch`
  // bytes apart
  int seg_pitch;
};

constexpr int kThreads = 256;  // a thread a quant value: at least 4 x 64
constexpr int kGroups = kThreads / 8;  // 8 threads decode one block
constexpr int kWsPitch = 9;            // workspace row pitch, in ints
constexpr int kWsGroup = 72;           // workspace ints a group
constexpr int kSmemCap = 64 * 1024;    // a CTA's shared memory, at most
constexpr int kPass1Max = 35081;       // (2^31 - 1 - 2^10) / 61214
constexpr int kStages = 2;    // coefficient rows in flight a thread
constexpr int kRingStage = kThreads + kGroups;  // int4 slots a ring stage
constexpr int kMinChunk = 4;  // MCU columns a chunk cut for parallelism
// one islow pass as the linear map it is: output o before its descale is
// sum_i kIslow[o][i] d_i, exactly (every step of the pass is an integer
// sum or product by a constant; kernels/jpeg.islow_weights)
__constant__ int kIslow[8][8] = {
    {8192, 11363, 10703, 9633, 8192, 6437, 4433, 2260},
    {8192, 9633, 4433, -2259, -8192, -11362, -10704, -6436},
    {8192, 6437, -4433, -11362, -8192, 2261, 10704, 9633},
    {8192, 2260, -10703, -6436, 8192, 9633, -4433, -11363},
    {8192, -2260, -10703, 6436, 8192, -9633, -4433, 11363},
    {8192, -6437, -4433, 11362, -8192, -2261, 10704, -9633},
    {8192, -9633, 4433, 2259, -8192, 11362, -10704, 6436},
    {8192, -11363, 10703, -9633, 8192, -6437, 4433, -2260}};

// 16 bytes global -> shared without registers (cp.async), the group of
// this thread's copies so far, and a wait until at most N groups are left
__device__ __forceinline__ void copy_async(int4* to, const int4* from) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(to);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(from));
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one pass of jpeg_idct_islow over d[0..7], modulo 2^32: o[k] = the
// pass's output k before its descale, plus `round`
__device__ __forceinline__ void islow32(const int* d, unsigned* o,
                                        unsigned round) {
  unsigned z2 = d[2], z3 = d[6];
  unsigned z1 = (z2 + z3) * 4433u;
  unsigned tmp2 = z1 - z3 * 15137u;
  unsigned tmp3 = z1 + z2 * 6270u;
  unsigned d0 = d[0], d4 = d[4];
  unsigned tmp0 = ((d0 + d4) << 13) + round;
  unsigned tmp1 = ((d0 - d4) << 13) + round;
  unsigned tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  unsigned tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  unsigned t0 = d[7], t1 = d[5], t2 = d[3], t3 = d[1];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  unsigned z4 = t1 + t3;
  unsigned z5 = (z3 + z4) * 9633u;
  t0 *= 2446u;
  t1 *= 16819u;
  t2 *= 25172u;
  t3 *= 12299u;
  z1 *= 0u - 7373u;
  z2 *= 0u - 20995u;
  z3 = z5 - z3 * 16069u;
  z4 = z5 - z4 * 3196u;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  o[0] = tmp10 + t3;
  o[7] = tmp10 - t3;
  o[1] = tmp11 + t2;
  o[6] = tmp11 - t2;
  o[2] = tmp12 + t1;
  o[5] = tmp12 - t1;
  o[3] = tmp13 + t0;
  o[4] = tmp13 - t0;
}

__device__ __forceinline__ long long descale(long long x, int n) {
  return (x + (1LL << (n - 1))) >> n;
}

// the first pass in 64 bits, as jidctint.c with a 64-bit JLONG; outputs
// descaled by `shift` and cut to an int as the C workspace does
__device__ __noinline__ void islow64(const long long* d, int* o, int shift) {
  long long z2 = d[2], z3 = d[6];
  long long z1 = (z2 + z3) * 4433;
  long long tmp2 = z1 + z3 * -15137;
  long long tmp3 = z1 + z2 * 6270;
  long long tmp0 = (d[0] + d[4]) * 8192;
  long long tmp1 = (d[0] - d[4]) * 8192;
  long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  long long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  long long t0 = d[7], t1 = d[5], t2 = d[3], t3 = d[1];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  long long z4 = t1 + t3;
  long long z5 = (z3 + z4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  o[0] = (int)descale(tmp10 + t3, shift);
  o[7] = (int)descale(tmp10 - t3, shift);
  o[1] = (int)descale(tmp11 + t2, shift);
  o[6] = (int)descale(tmp11 - t2, shift);
  o[2] = (int)descale(tmp12 + t1, shift);
  o[5] = (int)descale(tmp12 - t1, shift);
  o[3] = (int)descale(tmp13 + t0, shift);
  o[4] = (int)descale(tmp13 - t0, shift);
}

// The second pass's sum T + 2^17 + 2^27, modulo 2^32, to a sample:
// jdmaster.c's range-limit table indexed by x & RANGE_MASK, x = (T +
// 2^17) >> 18, maps the low 10 bits i of x to i + 128 (i < 128), 255
// (< 512), 0 (< 896) or i - 896, which is ((i + 512) & 1023) - 384
// clamped to 0..255, and (x + 512) & 1023 is bits 18..27 of T + 2^17 +
// 2^27. Those bits are exact modulo 2^32 whatever the inputs' size, so
// the second pass needs no bound and no 64-bit path.
constexpr unsigned kPass2Round = (1u << 17) + (1u << 27);

__device__ __forceinline__ unsigned range_limit(unsigned sum) {
  return (unsigned)__vimin_s32_relu((int)((sum >> 18) & 1023) - 384, 255);
}

// jdcolor.c's clamp to 0..255
__device__ __forceinline__ uint8_t clamp255(int v) {
  return (uint8_t)__vimin_s32_relu(v, 255);
}

// a * b modulo 2^32 (exact where the product fits an int)
__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// every |d[k]| <= bound (3-input maxima and minima, Hopper's DPX)
__device__ __forceinline__ bool within(const int* d, int bound) {
  const int hi = __vimax3_s32(__vimax3_s32(d[0], d[1], d[2]),
                              __vimax3_s32(d[3], d[4], d[5]), max(d[6], d[7]));
  const int lo = __vimin3_s32(__vimin3_s32(d[0], d[1], d[2]),
                              __vimin3_s32(d[3], d[4], d[5]), min(d[6], d[7]));
  return hi <= bound && lo >= -bound;
}

// what a CTA decodes of one component: block rows [r_lo, r_lo + n / ncols)
// and columns [c_lo, c_lo + ncols) (halo included, cut to the plane),
// stored in its shared plane (`plane`, `pitch` bytes a row) from block
// (br0, bc0) on; blocks [start, start + n) of the CTA's flat list. `first`
// is the component's first block in an image, `bx` its blocks a row.
struct Comp {
  int br0, bc0, r_lo, c_lo, ncols, start, n, first, bx, plane, pitch;
  // a component upsampled vertically: the band's own block rows are
  // [own_lo, own_hi); the rows around them are halo, of which the colour
  // stage reads one sample row (the nearest)
  int vhalo, own_lo, own_hi;
};

// The shared-memory layout of a plan, on the host and on the card alike.
__host__ __device__ inline int halo_v(const JpegGeom& g, int c) {
  return g.ratio_v[c] == 2 && g.fancy[c];
}

__host__ __device__ inline int halo_h(const JpegGeom& g, int c, int chunks) {
  return g.ratio_h[c] == 2 && g.fancy[c] && chunks > 1;
}

inline int round16(int x) { return (x + 15) & ~15; }

// fills p's offsets for (band_rows, chunk_cols) and returns its bytes
inline int layout(const JpegGeom& g, Plan& p) {
  p.bands = (g.mcu_rows + p.band_rows - 1) / p.band_rows;
  p.chunks = (g.mcu_cols + p.chunk_cols - 1) / p.chunk_cols;
  p.wts_off = round16(g.n_comp * 64 * 4);
  int off = p.wts_off + 64 * 4, blocks = 0;
  for (int c = 0; c < g.n_comp; c++) {
    const int rows = 8 * (p.band_rows * g.v[c] + 2 * halo_v(g, c));
    p.plane_cols[c] = 8 * (p.chunk_cols * g.h[c] + 2 * halo_h(g, c, p.chunks));
    p.plane_off[c] = off;
    off = round16(off + rows * p.plane_cols[c]);
    blocks += rows * p.plane_cols[c] / 64;
  }
  p.table_off = off;
  off = round16(off + 4 * blocks);
  p.work_off = off;
  const int rows = 8 * g.vmax * p.band_rows;
  const int cols = 8 * g.hmax * p.chunk_cols;
  int staging;
  if (p.chunks == 1) {  // the band is one contiguous range of the output
    p.seg_pitch = round16(rows * g.width * 3 + 15);
    staging = p.seg_pitch;
  } else {  // one segment an output row
    p.seg_pitch = round16(cols * 3 + 15);
    staging = rows * p.seg_pitch;
  }
  const int work = kGroups * kWsGroup * 4 + kStages * kRingStage * 16;
  p.smem = off + (staging > work ? staging : work);
  return p.smem;
}

// one upsampled sample of component c at output (y, x), read from its
// shared plane `p` (pitch `pw`) whose first row and column are component
// row `r0` and column `c0`: jdsample.c's fullsize, h2v1 / h2v2 fancy (where
// the component is more than 2 samples wide) and h1v2 fancy upsampling,
// and box replication for every other integral ratio (h2v1_upsample,
// h2v2_upsample, int_upsample); the row above the first and below the
// last real row is that row (jdmainct.c)
__device__ __forceinline__ int sample(const uint8_t* p, int pw, int r0,
                                      int c0, const JpegGeom& g, int c,
                                      int y, int x) {
  const int rh = g.ratio_h[c], rv = g.ratio_v[c];
  if (rh == 1 && rv == 1) return p[(y - r0) * pw + x - c0];
  if (!g.fancy[c]) return p[(y / rv - r0) * pw + x / rh - c0];
  const int cw = g.sampled_w[c];
  if (rv == 1) {  // h2v1
    const uint8_t* row = p + (y - r0) * pw - c0;
    int j = x >> 1;
    int t = row[j];
    if ((x & 1) == 0) return j == 0 ? t : (3 * t + row[j - 1] + 1) >> 2;
    return j == cw - 1 ? t : (3 * t + row[j + 1] + 2) >> 2;
  }
  int i = y >> 1;
  int other = (y & 1) ? min(i + 1, g.sampled_h[c] - 1) : max(i - 1, 0);
  const uint8_t* near = p + (i - r0) * pw - c0;
  const uint8_t* far = p + (other - r0) * pw - c0;
  if (rh == 1) return (3 * near[x] + far[x] + ((y & 1) ? 2 : 1)) >> 2;
  int j = x >> 1;
  int t = 3 * near[j] + far[j];
  if ((x & 1) == 0)
    return j == 0 ? (t * 4 + 8) >> 4
                  : (3 * t + 3 * near[j - 1] + far[j - 1] + 8) >> 4;
  return j == cw - 1 ? (t * 4 + 7) >> 4
                     : (3 * t + 3 * near[j + 1] + far[j + 1] + 7) >> 4;
}

// jdcolor.c ycc_rgb_convert of one pixel (cb, cr centred on 0) into
// to[0..2]; >> of a negative int is arithmetic
__device__ __forceinline__ void ycc_to(uint8_t* to, int y, int cb, int cr) {
  to[0] = clamp255(y + ((91881 * cr + 32768) >> 16));
  to[1] = clamp255(y + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
  to[2] = clamp255(y + ((116130 * cb + 32768) >> 16));
}

// Pillow's MULDIV255 of two samples
__device__ __forceinline__ int muldiv255(int a, int b) {
  const int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

// A CMYK or YCCK pixel as the JAX package reads it (kernels/jpeg.py
// _color_rows): libjpeg's CMYK (jdcolor.c ycck_cmyk_convert of YCCK),
// inverted by Pillow's "CMYK;I" raw mode, then Convert.c cmyk2rgb:
// v - MULDIV255(v', k) with v' the inverted C, M or Y (clamp(R) of a YCCK
// pixel) and k the stream's K sample.
__device__ __forceinline__ void cmyk_to(uint8_t* to, int s0, int s1, int s2,
                                        int k, bool ycck) {
  int v[3];
  if (ycck) {
    ycc_to(to, s0, s1 - 128, s2 - 128);
    v[0] = to[0];
    v[1] = to[1];
    v[2] = to[2];
  } else {
    v[0] = 255 - s0;
    v[1] = 255 - s1;
    v[2] = 255 - s2;
  }
#pragma unroll
  for (int i = 0; i < 3; i++) to[i] = (uint8_t)(k - muldiv255(v[i], k));
}

// CTA = one band of MCU rows x one chunk of MCU columns of one image
__global__ void __launch_bounds__(kThreads, 4)
    jpeg_pixels_kernel(const int16_t* __restrict__ coef,
                       const int32_t* __restrict__ quant,
                       uint8_t* __restrict__ out, JpegGeom g, Plan p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Comp comp[kMaxComps];
  int* qs = reinterpret_cast<int*>(smem);

  const int chunk = blockIdx.x % p.chunks;
  const int band = (blockIdx.x / p.chunks) % p.bands;
  const long long img = (long long)blockIdx.x / p.chunks / p.bands;
  const int m0 = band * p.band_rows;
  const int m1 = min(m0 + p.band_rows, g.mcu_rows);
  const int x0 = chunk * p.chunk_cols;
  const int x1 = min(x0 + p.chunk_cols, g.mcu_cols);

  // the quant tables' loads first, in flight while thread 0 lays out the
  // components
  const int tid = threadIdx.x;
  const int n_q = g.n_comp * 64;
  const int q = tid < n_q ? __ldg(quant + img * n_q + tid) : 0;
  if (tid == 0) {
    int start = 0;
#pragma unroll
    for (int c = 0; c < kMaxComps; c++) {
      if (c >= g.n_comp) break;
      const int hv = halo_v(g, c), hh = halo_h(g, c, p.chunks);
      Comp d;
      d.br0 = m0 * g.v[c] - hv;
      d.bc0 = x0 * g.h[c] - hh;
      d.r_lo = max(d.br0, 0);
      const int r_hi = min(m1 * g.v[c] + hv, g.mcu_rows * g.v[c]);
      d.c_lo = max(d.bc0, 0);
      const int c_hi = min(x1 * g.h[c] + hh, g.mcu_cols * g.h[c]);
      d.ncols = c_hi - d.c_lo;
      d.start = start;
      d.n = (r_hi - d.r_lo) * d.ncols;
      d.first = g.first_block[c];
      d.bx = g.mcu_cols * g.h[c];
      d.plane = p.plane_off[c];
      d.pitch = p.plane_cols[c];
      d.vhalo = hv;
      d.own_lo = m0 * g.v[c];
      d.own_hi = m1 * g.v[c];
      start += d.n;
      comp[c] = d;
    }
  }
  __syncthreads();
  int* wts = reinterpret_cast<int*>(smem + p.wts_off);
  if (tid < 64) wts[tid] = kIslow[tid >> 3][tid & 7];
  if (tid < n_q) qs[tid] = q;
  // the CTA's blocks in order, component by component, row-major: c, block
  // row and block column packed into 2, 15 and 15 bits (the divisions
  // once a block, not once a block and thread)
  unsigned* table = reinterpret_cast<unsigned*>(smem + p.table_off);
  const int total = comp[g.n_comp - 1].start + comp[g.n_comp - 1].n;
  for (int blk = tid; blk < total; blk += kThreads) {
    int c = 0;
    while (c + 1 < g.n_comp && blk >= comp[c + 1].start) c++;
    const Comp& d = comp[c];
    const int local = blk - d.start;
    table[blk] = c | (unsigned)(d.r_lo + local / d.ncols) << 2 |
                 (unsigned)(d.c_lo + local % d.ncols) << 17;
  }
  __syncthreads();

  // --- the IDCT: 8 threads a block, into the shared planes
  const int warp = tid >> 5, lane = tid & 31;
  const int j = lane & 7;
  int* ws = reinterpret_cast<int*>(smem + p.work_off) +
            (warp * 4 + (lane >> 3)) * kWsGroup;
  const int waves = (total + kGroups - 1) / kGroups;
  // the CTA's block `blk`: its component, block row and column (from the
  // table), and its coefficients
  auto locate = [&](int blk, int& c, int& brow, int& bcol) {
    const unsigned e = table[blk];
    c = e & 3;
    brow = (e >> 2) & 0x7FFF;
    bcol = e >> 17;
    return coef + (img * g.n_blocks + comp[c].first +
                   (long long)brow * comp[c].bx + bcol) * 64;
  };
  // each thread copies its own coefficient row of the block it decodes
  // kStages - 1 waves ahead into a ring in shared memory, where the
  // group's 8 rows lie as the block (a group's slots padded by 16 bytes,
  // so that the column reads below hit distinct banks)
  int4* ring = reinterpret_cast<int4*>(smem + p.work_off +
                                       kGroups * kWsGroup * 4);
  const int slot = tid + (tid >> 3);
  auto fetch = [&](int wave) {
    const int blk = wave * kGroups + warp * 4 + (lane >> 3);
    if (wave < waves && blk < total) {
      int c, brow, bcol;
      const int16_t* src = locate(blk, c, brow, bcol);
      copy_async(ring + (wave % kStages) * kRingStage + slot,
                 reinterpret_cast<const int4*>(src) + j);
    }
    commit_async();  // a group a wave, empty or not
  };
  for (int wave = 0; wave < kStages - 1; wave++) fetch(wave);
  for (int wave = 0; wave < waves; wave++) {
    fetch(wave + kStages - 1);
    wait_async<kStages - 1>();  // this thread's row of this wave is in
    __syncwarp();               // and so are the group's other rows
    const int blk = wave * kGroups + warp * 4 + (lane >> 3);
    const bool active = blk < total;
    int c = 0, brow = 0, bcol = 0, hrow = -1;
    int d[8];
    if (active) {
      locate(blk, c, brow, bcol);
      const Comp& cd = comp[c];
      // a halo block above the band gives its last sample row, one below
      // its first: that row alone, as dot products (exact in 64 bits)
      if (cd.vhalo && (brow < cd.own_lo || brow >= cd.own_hi))
        hrow = brow < cd.own_lo ? 7 : 0;
      // column j of the block, dequantised
      const int16_t* block = reinterpret_cast<const int16_t*>(
          ring + (wave % kStages) * kRingStage + slot - j);
#pragma unroll
      for (int k = 0; k < 8; k++)
        d[k] = mul32(block[8 * k + j], qs[c * 64 + 8 * k + j]);
    }
    if (active && hrow >= 0) {  // pass 1, one output: (hrow, j)
      long long t = 0;
#pragma unroll
      for (int k = 0; k < 8; k++) t += (long long)kIslow[hrow][k] * d[k];
      ws[kWsPitch * hrow + j] = (int)descale(t, 11);
    } else if (active) {  // pass 1: column j, into workspace column j
      int o[8];
      if (within(d, kPass1Max)) {
        unsigned t[8];
        islow32(d, t, 1u << 10);
#pragma unroll
        for (int k = 0; k < 8; k++) o[k] = (int)t[k] >> 11;
      } else {
        long long d64[8];
#pragma unroll
        for (int k = 0; k < 8; k++) d64[k] = d[k];
        int o64[8];  // apart from o, which stays in registers
        islow64(d64, o64, 11);
#pragma unroll
        for (int k = 0; k < 8; k++) o[k] = o64[k];
      }
#pragma unroll
      for (int k = 0; k < 8; k++) ws[kWsPitch * k + j] = o[k];
    }
    __syncwarp();
    if (active && hrow >= 0) {  // pass 2, one output: (hrow, j)
      unsigned t = kPass2Round;
#pragma unroll
      for (int k = 0; k < 8; k++)
        t += (unsigned)wts[8 * j + k] * (unsigned)ws[kWsPitch * hrow + k];
      const Comp& dc = comp[c];
      smem[dc.plane + (8 * (brow - dc.br0) + hrow) * dc.pitch +
           8 * (bcol - dc.bc0) + j] = (uint8_t)range_limit(t);
    } else if (active) {  // pass 2: row j, range limited, into the plane
      int d[8];
      unsigned t[8];
#pragma unroll
      for (int k = 0; k < 8; k++) d[k] = ws[kWsPitch * j + k];
      islow32(d, t, kPass2Round);
      const unsigned lo = __byte_perm(
          __byte_perm(range_limit(t[0]), range_limit(t[1]), 0x40),
          __byte_perm(range_limit(t[2]), range_limit(t[3]), 0x40), 0x5410);
      const unsigned hi = __byte_perm(
          __byte_perm(range_limit(t[4]), range_limit(t[5]), 0x40),
          __byte_perm(range_limit(t[6]), range_limit(t[7]), 0x40), 0x5410);
      const Comp& dc = comp[c];
      const int row = 8 * (brow - dc.br0) + j, col = 8 * (bcol - dc.bc0);
      *reinterpret_cast<uint2*>(smem + dc.plane + row * dc.pitch + col) =
          make_uint2(lo, hi);
    }
    __syncwarp();
  }
  __syncthreads();

  // --- upsampling and colour, into the staging buffer
  const int y0 = m0 * 8 * g.vmax, y1 = min(m1 * 8 * g.vmax, g.height);
  const int xs = x0 * 8 * g.hmax, xe = min(x1 * 8 * g.hmax, g.width);
  const int cols = xe - xs, npix = (y1 - y0) * cols;
  uint8_t* stage = smem + p.work_off;
  const long long img_px = img * g.height * g.width;
  // the output byte where segment 0 starts, and its offset in a 16-byte
  // line (so that the staging buffer shares the output's alignment)
  const long long band_start = (img_px + (long long)y0 * g.width + xs) * 3;
  const uint8_t* planes[kMaxComps];
  int pw[kMaxComps], r0[kMaxComps], c0[kMaxComps];
#pragma unroll
  for (int c = 0; c < kMaxComps; c++) {  // comp[c] is unused past n_comp
    planes[c] = smem + comp[c].plane;
    pw[c] = comp[c].pitch;
    r0[c] = 8 * comp[c].br0;
    c0[c] = 8 * comp[c].bc0;
  }
  // where output pixel (y, x) goes in the staging buffer
  const int band_off = (int)(band_start & 15);
  auto at = [&](int y, int x) {
    if (p.chunks == 1) return band_off + ((y - y0) * g.width + x - xs) * 3;
    const long long row = (img_px + (long long)y * g.width + xs) * 3;
    return (y - y0) * p.seg_pitch + (int)(row & 15) + (x - xs) * 3;
  };
  if (g.color == 1 && g.ratio_h[0] == 1 && g.ratio_v[0] == 1 &&
      g.ratio_h[1] == 2 && g.ratio_v[1] == 2 && g.fancy[1] &&
      g.ratio_h[2] == 2 && g.ratio_v[2] == 2 && g.fancy[2]) {
    // 4:2:0 with fancy h2v2 chroma (CrowdAI's tiles): a thread takes two
    // neighbouring chroma samples of a row and the 2 x 4 output pixels
    // they cover, reading each chroma plane's 3 x 4 neighbourhood once
    const int rows = (y1 - y0 + 1) >> 1, cols2 = (xe - xs + 1) >> 1;
    const int pairs = (cols2 + 1) >> 1, jbase = xs >> 1;
    const int cw = g.sampled_w[1], ch = g.sampled_h[1];
    int i = (y0 >> 1) + tid / pairs, jp = tid % pairs;
    const int di = kThreads / pairs, dj = kThreads % pairs;
    for (int t = tid; t < rows * pairs; t += kThreads) {
      const int j = jbase + 2 * jp;
      const bool two = j + 1 < jbase + cols2;  // the second sample is ours
      int up[2][4], dn[2][4];  // [chroma][output column 2j + k], upsampled
#pragma unroll
      for (int c = 1; c < 3; c++) {
        const uint8_t* base = planes[c] - c0[c];
        const uint8_t* near = base + (i - r0[c]) * pw[c];
        const uint8_t* above = base + (max(i - 1, 0) - r0[c]) * pw[c];
        const uint8_t* below = base + (min(i + 1, ch - 1) - r0[c]) * pw[c];
        int* u = up[c - 1];
        int* d = dn[c - 1];
        const int n0 = 3 * near[j];
        const int u0 = n0 + above[j], d0 = n0 + below[j];
        if (j == 0) {
          u[0] = (4 * u0 + 8) >> 4;
          d[0] = (4 * d0 + 8) >> 4;
        } else {
          const int nl = 3 * near[j - 1];
          u[0] = (3 * u0 + nl + above[j - 1] + 8) >> 4;
          d[0] = (3 * d0 + nl + below[j - 1] + 8) >> 4;
        }
        if (!two) {  // j is the chunk's (or the image's) last sample
          if (j == cw - 1) {
            u[1] = (4 * u0 + 7) >> 4;
            d[1] = (4 * d0 + 7) >> 4;
          } else {
            const int nr = 3 * near[j + 1];
            u[1] = (3 * u0 + nr + above[j + 1] + 7) >> 4;
            d[1] = (3 * d0 + nr + below[j + 1] + 7) >> 4;
          }
          continue;
        }
        const int n1 = 3 * near[j + 1];
        const int u1 = n1 + above[j + 1], d1 = n1 + below[j + 1];
        u[1] = (3 * u0 + u1 + 7) >> 4;
        d[1] = (3 * d0 + d1 + 7) >> 4;
        u[2] = (3 * u1 + u0 + 8) >> 4;
        d[2] = (3 * d1 + d0 + 8) >> 4;
        if (j + 1 == cw - 1) {
          u[3] = (4 * u1 + 7) >> 4;
          d[3] = (4 * d1 + 7) >> 4;
        } else {
          const int n2 = 3 * near[j + 2];
          u[3] = (3 * u1 + n2 + above[j + 2] + 7) >> 4;
          d[3] = (3 * d1 + n2 + below[j + 2] + 7) >> 4;
        }
      }
#pragma unroll
      for (int dy2 = 0; dy2 < 2; dy2++) {
        const int y = 2 * i + dy2;
        if (y >= y1) break;
        const uint8_t* luma = planes[0] + (y - r0[0]) * pw[0] - c0[0];
        uint8_t* to = stage + at(y, 2 * j);
#pragma unroll
        for (int k = 0; k < 4; k++) {
          if (2 * j + k >= xe || (k >= 2 && !two)) break;
          const int cb = (dy2 ? dn[0][k] : up[0][k]) - 128;
          const int cr = (dy2 ? dn[1][k] : up[1][k]) - 128;
          ycc_to(to + 3 * k, luma[2 * j + k], cb, cr);
        }
      }
      jp += dj;
      i += di;
      if (jp >= pairs) {
        jp -= pairs;
        i++;
      }
    }
  } else {
    int y = y0 + tid / cols, x = xs + tid % cols;
    const int dy = kThreads / cols, dx = kThreads % cols;
    for (int t = tid; t < npix; t += kThreads) {
      const int s0 = sample(planes[0], pw[0], r0[0], c0[0], g, 0, y, x);
      uint8_t* to = stage + at(y, x);
      if (g.color == 0) {  // grey: gray_rgb_convert
        to[0] = to[1] = to[2] = (uint8_t)s0;
      } else {
        const int s1 = sample(planes[1], pw[1], r0[1], c0[1], g, 1, y, x);
        const int s2 = sample(planes[2], pw[2], r0[2], c0[2], g, 2, y, x);
        if (g.color == 2) {  // RGB stream: rgb_rgb_convert
          to[0] = (uint8_t)s0;
          to[1] = (uint8_t)s1;
          to[2] = (uint8_t)s2;
        } else if (g.color == 1) {
          ycc_to(to, s0, s1 - 128, s2 - 128);
        } else {  // CMYK, YCCK
          const int s3 = sample(planes[3], pw[3], r0[3], c0[3], g, 3, y, x);
          cmyk_to(to, s0, s1, s2, s3, g.color == 4);
        }
      }
      x += dx;
      y += dy;
      if (x >= xe) {
        x -= cols;
        y++;
      }
    }
  }
  __syncthreads();

  // --- the staging buffer to the output: 16-byte stores of whole aligned
  // lines, bytes at each segment's head and tail
  const int n_seg = p.chunks == 1 ? 1 : y1 - y0;
  const int seg_len = p.chunks == 1 ? npix * 3 : cols * 3;
  const int lines = (seg_len + 15) / 16 + 1;  // at most, a segment
  for (int t = tid; t < n_seg * lines; t += kThreads) {
    const int s = t / lines, w = t % lines;
    const long long start =
        p.chunks == 1 ? band_start
                      : (img_px + (long long)(y0 + s) * g.width + xs) * 3;
    const long long line = ((start >> 4) + w) << 4;
    const long long end = start + seg_len;
    if (line >= end) continue;
    const uint8_t* from = stage + s * p.seg_pitch + 16 * w;
    if (line >= start && line + 16 <= end) {
      *reinterpret_cast<int4*>(out + line) =
          *reinterpret_cast<const int4*>(from);
    } else {
      for (int k = 0; k < 16; k++)
        if (line + k >= start && line + k < end) out[line + k] = from[k];
    }
  }
}

JpegGeom load_geom(const int* rec) {
  JpegGeom g;
  int* dst = reinterpret_cast<int*>(&g);
  for (int i = 0; i < kGeomInts; i++) dst[i] = rec[i];
  return g;
}

// The plan of a launch. A CTA takes a whole row of MCUs unless that needs
// more than kSmemCap of shared memory: then the widest chunk of MCU
// columns that fits (with halo columns). Where the batch fills the card
// (4 CTAs an SM), bands grow to 2 or 4 MCU rows, which decode fewer halo
// blocks; where it leaves SMs idle (fewer than 2 CTAs an SM, as at the
// daemon's batch of 1), rows are cut into chunks of at least kMinChunk
// MCU columns, which spends halo blocks on parallelism.
Plan make_plan(const JpegGeom& g, int batch, int sms) {
  Plan p{};
  p.band_rows = 1;
  p.chunk_cols = g.mcu_cols;
  if (layout(g, p) > kSmemCap) {
    int lo = 1, hi = g.mcu_cols - 1;
    while (lo < hi) {
      Plan q = p;
      q.chunk_cols = (lo + hi + 1) / 2;
      if (layout(g, q) <= kSmemCap) lo = q.chunk_cols;
      else hi = q.chunk_cols - 1;
    }
    p.chunk_cols = lo;
    layout(g, p);
    return p;
  }
  const long long ctas = (long long)batch * p.bands;
  if (ctas < 2LL * sms) {
    const int want = (int)((2LL * sms + ctas - 1) / ctas);
    const int even = (g.mcu_cols + want - 1) / want;
    const int cols = even > kMinChunk ? even : kMinChunk;
    if (cols < g.mcu_cols) p.chunk_cols = cols;
  }
  for (int rows = 2; rows <= 4 && rows <= g.mcu_rows; rows *= 2) {
    Plan q = p;
    q.band_rows = rows;
    if (layout(g, q) > kSmemCap) break;
    if ((long long)batch * q.bands * q.chunks < 4LL * sms) break;
    p.band_rows = rows;
  }
  layout(g, p);
  return p;
}

// What a launch needs of its device, read and set once a device: its SM
// count, and the kernel's dynamic shared memory allowed up to kSmemCap,
// the most any plan takes (48 KB by default). Once, so that threads
// launching plans of different sizes at the same time (the daemon's
// handlers) never lower the limit under another's launch.
constexpr int kMaxDevices = 64;
struct Device {
  std::once_flag once;
  int sms = 0;
  cudaError_t err = cudaSuccess;
};
Device devices[kMaxDevices];

cudaError_t prepare(int device, int* sms) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  Device& d = devices[device];
  std::call_once(d.once, [&] {  // on a thread whose current device it is
    d.err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (d.err == cudaSuccess)
      d.err = cudaFuncSetAttribute(
          jpeg_pixels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemCap);
  });
  *sms = d.sms;
  return d.err;
}

}  // namespace

extern "C" {

// The pixel stage over `batch` images of one geometry: coef (batch,
// n_blocks, 64) int16 and quant (batch, n_comp, 64) int32 -> out (batch,
// height, width, 3) uint8, each 16-byte aligned. Returns the launch's
// cudaError_t.
int jpeg_pixels(const int16_t* coef, const int32_t* quant, uint8_t* out,
                int batch, const int* geom, void* stream) {
  if (((uintptr_t)coef | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  JpegGeom g = load_geom(geom);
  if (batch <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = prepare(device, &sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = make_plan(g, batch, sms);
  const long long grid = (long long)batch * p.bands * p.chunks;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  jpeg_pixels_kernel<<<(unsigned)grid, kThreads, p.smem,
                       (cudaStream_t)stream>>>(coef, quant, out, g, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
