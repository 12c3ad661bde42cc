// The JPEG pixel stage on the card: J1 `jpeg_idct` (dequantise + islow
// IDCT + range limit -> uint8 component planes) and J2 `jpeg_color`
// (upsampling + YCbCr -> RGB), equal bit for bit to libjpeg-turbo's
// default decode (the C definitions in jidctint.c, jdsample.c, jdcolor.c)
// and to the plain PyTorch version in kernels/jpeg.py.
//
// Neither kernel replaces a TPU kernel. The JAX package decodes every tile
// on the host with libjpeg (cpp/decode.cpp); the port decodes the entropy
// coding on the host (csrc/jpeg_entropy.cpp) and the pixels here, so that
// JPEG tiles decode on a machine without libjpeg and the IDCT, upsampling
// and colour work leaves the host.
//
// What bounds the stage on an H100 is bytes: 128 bytes of coefficients a
// block in and 3 bytes a pixel out (kernels/bounds.jpeg_pixels), about
// 11 MB for a serving batch of 20 300^2 tiles at 4:2:0, 3.3 us at
// 3.35 TB/s; the arithmetic (~1,000 integer operations a block) is far
// below the card's rate. This first design is the simple one: J1 runs
// one thread per 8x8 block (64-bit products as in jidctint.c, 8-byte
// stores of the rows), J2 one thread per pair of output pixels, reading
// the planes back through L2. The planes' round trip (2 x 2.8 MB a batch)
// and the two launches are what fusing J1 and J2 through shared memory
// would save.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The geometry of a batch, as kernels/jpeg.geometry_record lays it out.
struct JpegGeom {
  int n_comp, height, width, n_blocks, plane_bytes, color;
  int blocks_x[3], blocks_y[3], first_block[3], plane_off[3], plane_w[3];
  int sampled_h[3], sampled_w[3], ratio_h[3], ratio_v[3], fancy[3];
};

constexpr int kGeomInts = 6 + 10 * 3;
static_assert(sizeof(JpegGeom) == kGeomInts * sizeof(int),
              "JpegGeom must match kernels/jpeg.GEOM_INTS");

__device__ __forceinline__ long long descale(long long x, int n) {
  return (x + (1LL << (n - 1))) >> n;
}

// one pass of jpeg_idct_islow over d[0..7], results descaled by `shift`
// into o[0..7]
__device__ __forceinline__ void islow(const long long* d, long long* o,
                                      int shift) {
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
  o[0] = descale(tmp10 + t3, shift);
  o[7] = descale(tmp10 - t3, shift);
  o[1] = descale(tmp11 + t2, shift);
  o[6] = descale(tmp11 - t2, shift);
  o[2] = descale(tmp12 + t1, shift);
  o[5] = descale(tmp12 - t1, shift);
  o[3] = descale(tmp13 + t0, shift);
  o[4] = descale(tmp13 - t0, shift);
}

// jdmaster.c prepare_range_limit_table, indexed by x & RANGE_MASK
__device__ __forceinline__ unsigned range_limit(long long x) {
  int idx = (int)(x & 1023);
  if (idx < 128) return idx + 128;
  if (idx < 512) return 255;
  if (idx < 896) return 0;
  return idx - 896;
}

// a[c] without a dynamically indexed parameter array
__device__ __forceinline__ int pick(const int (&a)[3], int c) {
  return c == 0 ? a[0] : (c == 1 ? a[1] : a[2]);
}

// coefficient (k, col) of a block held as 8 int4 rows of 8 int16
__device__ __forceinline__ int coef_at(const int4* rows, int k, int col) {
  int4 r = rows[k];
  int w = (col >> 1) == 0 ? r.x : (col >> 1) == 1 ? r.y
        : (col >> 1) == 2 ? r.z : r.w;
  return (col & 1) ? (w >> 16) : (int)(int16_t)(w & 0xFFFF);
}

// J1: thread = one 8x8 block of one image
__global__ void jpeg_idct_kernel(const int16_t* __restrict__ coef,
                                 const int32_t* __restrict__ quant,
                                 uint8_t* __restrict__ planes, int batch,
                                 JpegGeom g) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * g.n_blocks) return;
  int img = (int)(t / g.n_blocks), blk = (int)(t % g.n_blocks);
  int c = (g.n_comp > 1 && blk >= g.first_block[1])
              ? ((g.n_comp > 2 && blk >= g.first_block[2]) ? 2 : 1)
              : 0;
  int local = blk - pick(g.first_block, c);
  int bxs = pick(g.blocks_x, c), pw = pick(g.plane_w, c);
  int by = local / bxs, bx = local % bxs;

  const int4* src = reinterpret_cast<const int4*>(coef + t * 64);
  int4 rows[8];
#pragma unroll
  for (int i = 0; i < 8; i++) rows[i] = __ldg(src + i);
  const int32_t* q = quant + ((long long)img * g.n_comp + c) * 64;
  int ws[64];  // the workspace is a C int
  // pass 1: columns, dequantised
#pragma unroll
  for (int col = 0; col < 8; col++) {
    long long d[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; k++)
      d[k] = (long long)coef_at(rows, k, col) * __ldg(q + 8 * k + col);
    islow(d, o, 11);
#pragma unroll
    for (int k = 0; k < 8; k++) ws[8 * k + col] = (int)o[k];
  }
  uint8_t* out = planes + (long long)img * g.plane_bytes +
                 pick(g.plane_off, c) + (long long)by * 8 * pw + bx * 8;
  // pass 2: rows
#pragma unroll
  for (int row = 0; row < 8; row++) {
    long long d[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; k++) d[k] = ws[8 * row + k];
    islow(d, o, 18);
    unsigned long long packed = 0;
#pragma unroll
    for (int k = 0; k < 8; k++)
      packed |= (unsigned long long)range_limit(o[k]) << (8 * k);
    *reinterpret_cast<unsigned long long*>(out + (long long)row * pw) =
        packed;
  }
}

// one upsampled sample of component c at output (y, x): jdsample.c's
// fullsize, h2v1 / h2v2 (fancy where the component is more than 2 samples
// wide, else replication) and h1v2 fancy upsampling; the row above the
// first and below the last real row is that row (jdmainct.c)
__device__ __forceinline__ int sample(const uint8_t* p, const JpegGeom& g,
                                      int c, int y, int x) {
  const int pw = g.plane_w[c];
  const int rh = g.ratio_h[c], rv = g.ratio_v[c];
  if (rh == 1 && rv == 1) return p[(long long)y * pw + x];
  const int cw = g.sampled_w[c];
  if (rv == 1) {  // h2v1
    const uint8_t* row = p + (long long)y * pw;
    int j = x >> 1;
    int t = row[j];
    if (!g.fancy[c]) return t;
    if ((x & 1) == 0) return j == 0 ? t : (3 * t + row[j - 1] + 1) >> 2;
    return j == cw - 1 ? t : (3 * t + row[j + 1] + 2) >> 2;
  }
  int i = y >> 1;
  if (rh == 2 && !g.fancy[c]) return p[(long long)i * pw + (x >> 1)];
  int other = (y & 1) ? min(i + 1, g.sampled_h[c] - 1) : max(i - 1, 0);
  const uint8_t* near = p + (long long)i * pw;
  const uint8_t* far = p + (long long)other * pw;
  if (rh == 1) return (3 * near[x] + far[x] + ((y & 1) ? 2 : 1)) >> 2;
  int j = x >> 1;
  int t = 3 * near[j] + far[j];
  if ((x & 1) == 0)
    return j == 0 ? (t * 4 + 8) >> 4
                  : (3 * t + 3 * near[j - 1] + far[j - 1] + 8) >> 4;
  return j == cw - 1 ? (t * 4 + 7) >> 4
                     : (3 * t + 3 * near[j + 1] + far[j + 1] + 7) >> 4;
}

__device__ __forceinline__ uint8_t clamp255(int v) {
  return (uint8_t)min(max(v, 0), 255);
}

// J2: thread = two horizontally adjacent output pixels of one image
__global__ void jpeg_color_kernel(const uint8_t* __restrict__ planes,
                                  uint8_t* __restrict__ out, int batch,
                                  JpegGeom g) {
  const int pairs = (g.width + 1) >> 1;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * g.height * pairs) return;
  int img = (int)(t / ((long long)g.height * pairs));
  int rem = (int)(t % ((long long)g.height * pairs));
  int y = rem / pairs, x0 = 2 * (rem % pairs);
  const uint8_t* base = planes + (long long)img * g.plane_bytes;
  uint8_t* dst = out + (((long long)img * g.height + y) * g.width + x0) * 3;
  for (int dx = 0; dx < 2 && x0 + dx < g.width; dx++) {
    int x = x0 + dx;
    int s0 = sample(base + g.plane_off[0], g, 0, y, x);
    uint8_t r, gr, b;
    if (g.color == 0) {  // grey: gray_rgb_convert
      r = gr = b = (uint8_t)s0;
    } else {
      int s1 = sample(base + g.plane_off[1], g, 1, y, x);
      int s2 = sample(base + g.plane_off[2], g, 2, y, x);
      if (g.color == 2) {  // RGB stream: rgb_rgb_convert
        r = (uint8_t)s0;
        gr = (uint8_t)s1;
        b = (uint8_t)s2;
      } else {  // ycc_rgb_convert; >> of a negative int is arithmetic
        int cb = s1 - 128, cr = s2 - 128;
        r = clamp255(s0 + ((91881 * cr + 32768) >> 16));
        gr = clamp255(s0 + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
        b = clamp255(s0 + ((116130 * cb + 32768) >> 16));
      }
    }
    dst[3 * dx] = r;
    dst[3 * dx + 1] = gr;
    dst[3 * dx + 2] = b;
  }
}

JpegGeom load_geom(const int* rec) {
  JpegGeom g;
  int* dst = reinterpret_cast<int*>(&g);
  for (int i = 0; i < kGeomInts; i++) dst[i] = rec[i];
  return g;
}

constexpr int kThreads = 128;

}  // namespace

extern "C" {

// J1 over `batch` images: coef (batch, n_blocks, 64) int16, quant
// (batch, n_comp, 64) int32 -> planes (batch, plane_bytes) uint8. Returns
// the launch's cudaError_t.
int jpeg_idct(const int16_t* coef, const int32_t* quant, uint8_t* planes,
              int batch, const int* geom, void* stream) {
  JpegGeom g = load_geom(geom);
  long long n = (long long)batch * g.n_blocks;
  if (n <= 0) return 0;
  int grid = (int)((n + kThreads - 1) / kThreads);
  jpeg_idct_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      coef, quant, planes, batch, g);
  return (int)cudaGetLastError();
}

// J2 over `batch` images: planes -> out (batch, height, width, 3) uint8.
int jpeg_color(const uint8_t* planes, uint8_t* out, int batch,
               const int* geom, void* stream) {
  JpegGeom g = load_geom(geom);
  long long n = (long long)batch * g.height * ((g.width + 1) / 2);
  if (n <= 0) return 0;
  int grid = (int)((n + kThreads - 1) / kThreads);
  jpeg_color_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      planes, out, batch, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
