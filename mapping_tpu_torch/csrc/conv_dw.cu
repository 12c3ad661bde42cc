// Filter gradient (dW) of a stride-1 SAME convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel _dw_kernel (tools/dw_probe.py:70, called through
// dw_pallas). Contract, the same as K3's:
//   x, dy: (N, H, W, C) bfloat16, NHWC (a channels_last NCHW tensor's
//          bytes), odd k, C input channels = C output channels;
//   dw[o][i][dh][dw] = sum over n, y, x of
//          x_pad[n][y + dh][x + dw][i] * dy[n][y][x][o]      (float32)
//   with x_pad zero-padded by k / 2 on each side: torch's weight layout
//   (C_out, C_in, k, k). Any H and W: there is no row-chunk or halo
//   precondition (the Pallas kernel needs its row chunk to divide H and to
//   be a multiple of 2 * (k / 2)).
//
// Why not the TPU design: the Pallas kernel walks a sequential grid and
// keeps one float32 accumulator for all k * k * C * C outputs resident in
// VMEM across it. Blocks on an H100 run in parallel and in no order, so the
// reduction axis (N * H * W) is split instead:
//   dw_partial: each tap is a GEMM, M = C_in, N = C_out, K = N * H * W, with
//     A a shifted view of x. A block owns a group of 16 x 16 output tiles
//     (tap, input-channel tile, output-channel tile), at most 8 per warp,
//     held in registers as WMMA accumulators, and a slice of the pixel
//     tiles: it walks its tiles (rows x 32 pixels of one image), stages
//     x with a k / 2 halo (zeros outside the image) and dy in shared memory,
//     and feeds bf16 m16n16k16 tensor-core products, 16 pixels deep, from
//     there. A shifted tap is a plain offset in the staged tile, so every
//     tap reads the same staged bytes: x and dy leave device memory once
//     per output group. It writes its float32 partial sums.
//   dw_reduce: one thread per output sums the slices' partials in slice
//     order and writes torch's layout. No atomics: reruns are
//     bit-identical.
//
// What bounds it: at C = 32 (the decoder's dec0 conv, 64 x 256^2, 77 GFLOP
// for 0.54 GB of x and dy) it needs ~0.16 ms of HBM traffic and ~0.08 ms of
// dense tensor-core time, so neither bound is near. This simple version
// runs at ~51 TFLOP/s on an H100 at both of the dW probe's shapes: it is
// bound by its staging (synchronous loads, no double buffering, two blocks
// per SM) and by shared-memory fragment loads through the legacy mma path.
// The staged pixel stride is padded (kPad) so that fragment loads do not
// all fall on the same banks. TMA staging and wgmma are left for later.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxFrags = 8;  // accumulator tiles per warp
constexpr int kTileW = 32;    // pixels per staged row: two 16-pixel steps
constexpr int kFrag = 16 * 16;
// Each staged pixel's channels are followed by kPad unused elements: a
// pixel stride of c + 16 bf16 (a multiple of 32 bytes, as WMMA's 256-bit
// pointer alignment needs) puts the 16 rows of a fragment load in shifted
// banks; at a stride of c alone they would all hit the same banks.
constexpr int kPad = 16;

__global__ void __launch_bounds__(kThreads, 2)
    dw_partial(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ dy,
               float* __restrict__ partial, int n, int h, int w, int c, int k,
               int rows, int frags_per_warp, int slices) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ph = k / 2;
  const int xw = kTileW + 2 * ph;  // staged x tile: (rows + 2 ph) x xw
  const int xh = rows + 2 * ph;
  const int ps = c + kPad;  // staged pixel stride
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ds = xs + (size_t)xh * xw * ps;
  const int ct = c / 16;
  const int n_frags = k * k * ct * ct;
  const int warp = threadIdx.x >> 5;
  const int first = (blockIdx.x * kWarps + warp) * frags_per_warp;

  // tile f = (tap * ct + it) * ct + ot: offsets into the staged tiles
  int a_off[kMaxFrags], b_off[kMaxFrags];
  bool valid[kMaxFrags];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxFrags];
#pragma unroll
  for (int j = 0; j < kMaxFrags; ++j) {
    const int f = first + j;
    valid[j] = j < frags_per_warp && f < n_frags;
    const int g = valid[j] ? f : 0;
    const int ot = g % ct, it = (g / ct) % ct, tap = g / (ct * ct);
    a_off[j] = ((tap / k) * xw + tap % k) * ps + it * 16;
    b_off[j] = ot * 16;
    wmma::fill_fragment(acc[j], 0.0f);
  }

  const int tiles_y = (h + rows - 1) / rows;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const long long n_tiles = (long long)n * tiles_y * tiles_x;
  const int vec_c = c / 8;  // 16-byte vectors per pixel
  const int x_vecs = xh * xw * vec_c;
  const int d_vecs = rows * kTileW * vec_c;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (long long t = blockIdx.y; t < n_tiles; t += slices) {
    const int tx = (int)(t % tiles_x);
    const int ty = (int)((t / tiles_x) % tiles_y);
    const long long b = t / ((long long)tiles_x * tiles_y);
    const int y0 = ty * rows, x0 = tx * kTileW;
    for (int v = threadIdx.x; v < x_vecs; v += kThreads) {
      const int pix = v / vec_c, cv = v % vec_c;
      const int yy = y0 - ph + pix / xw, xx = x0 - ph + pix % xw;
      uint4 val = zero;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w)
        val = reinterpret_cast<const uint4*>(
            x + ((b * h + yy) * w + xx) * c)[cv];
      reinterpret_cast<uint4*>(xs + (size_t)pix * ps)[cv] = val;
    }
    for (int v = threadIdx.x; v < d_vecs; v += kThreads) {
      const int pix = v / vec_c, cv = v % vec_c;
      const int yy = y0 + pix / kTileW, xx = x0 + pix % kTileW;
      uint4 val = zero;
      if (yy < h && xx < w)
        val = reinterpret_cast<const uint4*>(
            dy + ((b * h + yy) * w + xx) * c)[cv];
      reinterpret_cast<uint4*>(ds + (size_t)pix * ps)[cv] = val;
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      for (int c0 = 0; c0 < kTileW; c0 += 16) {
        // A (C_in x 16 pixels) is column-major with stride ps, B (16
        // pixels x C_out) row-major with stride ps: both read the staged
        // NHWC tile as is. Neighbouring tiles of a warp share (tap, it)
        // and so their A fragment.
        const __nv_bfloat16* a_base = xs + ((size_t)r * xw + c0) * ps;
        const __nv_bfloat16* b_base = ds + ((size_t)r * kTileW + c0) * ps;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fa;
#pragma unroll
        for (int j = 0; j < kMaxFrags; ++j) {
          if (valid[j]) {
            if (j == 0 || a_off[j] != a_off[j - 1])
              wmma::load_matrix_sync(fa, a_base + a_off[j], ps);
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fb;
            wmma::load_matrix_sync(fb, b_base + b_off[j], ps);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kMaxFrags; ++j) {
    if (valid[j])
      wmma::store_matrix_sync(
          partial + ((size_t)blockIdx.y * n_frags + first + j) * kFrag,
          acc[j], 16, wmma::mem_row_major);
  }
}

__global__ void dw_reduce(const float* __restrict__ partial,
                          float* __restrict__ out, int c, int k, int slices) {
  const int ct = c / 16;
  const long long total = (long long)k * k * ct * ct * kFrag;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.0f;
  for (int sl = 0; sl < slices; ++sl) s += partial[sl * total + e];
  const int f = (int)(e / kFrag), ii = (int)(e % kFrag) / 16,
            oo = (int)(e % 16);
  const int ot = f % ct, it = (f / ct) % ct, tap = f / (ct * ct);
  const int i = it * 16 + ii, o = ot * 16 + oo;
  out[((long long)o * c + i) * k * k + tap] = s;
}

}  // namespace

extern "C" {

// x, dy: (n, h, w, c) bf16, 16-byte aligned; partial: slices * k * k * c * c
// float32 scratch; out: (c, c, k, k) float32. rows, frags_per_warp and
// slices are the wrapper's plan (kernels/conv_dw.py). Returns the CUDA
// error of the launches (0 when both were accepted).
int conv_dw_bf16(const void* x, const void* dy, void* partial, void* out,
                 int n, int h, int w, int c, int k, int rows,
                 int frags_per_warp, int slices, void* stream) {
  const int ph = k / 2;
  const int ct = c / 16;
  const int n_frags = k * k * ct * ct;
  const int groups =
      (n_frags + kWarps * frags_per_warp - 1) / (kWarps * frags_per_warp);
  const size_t smem = ((size_t)(rows + 2 * ph) * (kTileW + 2 * ph) +
                       (size_t)rows * kTileW) * (c + kPad) *
                      sizeof(__nv_bfloat16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      dw_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dw_partial<<<dim3(groups, slices), kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), static_cast<float*>(partial), n,
      h, w, c, k, rows, frags_per_warp, slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n_frags * kFrag;
  dw_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), c, k,
      slices);
  return (int)cudaGetLastError();
}

}  // extern "C"
