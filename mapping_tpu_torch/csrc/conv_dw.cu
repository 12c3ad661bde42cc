// Filter gradient (dW) of a stride-1 SAME convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel _dw_kernel (tools/dw_probe.py:70, called through
// dw_pallas). Contract, the same as K3's:
//   x, dy: (N, H, W, C) bfloat16, NHWC (a channels_last NCHW tensor's
//          bytes), odd k, C input channels = C output channels, C % 16 == 0;
//   dw[o][i][dh][dw] = sum over n, y, x of
//          x_pad[n][y + dh][x + dw][i] * dy[n][y][x][o]      (float32)
//   with x_pad zero-padded by k / 2 on each side: torch's weight layout
//   (C_out, C_in, k, k). Any H and W.
//
// Why not the TPU design: the Pallas kernel walks a sequential grid and
// keeps one float32 accumulator for all k * k * C * C outputs resident in
// VMEM across it. Blocks on an H100 run in parallel and in no order. Each
// tap is a GEMM with M = C_in, N = C_out and K = N * H * W pixels: tiny M
// and N, a K of millions. So the reduction axis is split over the blocks
// (persistent split-K) and the outputs stay in registers.
//
// dw_partial, about one block per SM (plan in kernels/conv_dw.py):
//   * Rows (dh, box, dw, c_in in box) x columns c_out. For each dh the
//     k * C rows go in 64-row pieces; columns go in n-blocks of N = the
//     channel box cb (64, 32 or 16: the largest dividing C). A unit is one
//     piece and up to kDh = 3 row taps dh, held by one consumer warpgroup
//     as kDh m64nN float32 wgmma accumulators (96 registers at N = 64). An
//     output group is one n-block and a run of kConsumers units. C = 32
//     (2 units) and C = 64 (3) are one group, so x and dy leave device
//     memory once; C = 128 is 2 n-blocks x 2 runs, and the blocks of one
//     pixel run sit side by side so that the re-reads hit L2.
//   * Pixels: the N * ceil(H / bh) * ceil(W / bw) tiles of bh x bw pixels
//     are cut into `slices` contiguous runs, one per block of a group.
//   * A producer warp keeps TMA loads (cp.async.bulk.tensor, 4-D maps over
//     (C, W, H, N)) in flight into a ring of `stages` (2 to 4) shared-memory
//     stages guarded by full / empty mbarriers. A stage holds the x halo
//     tile of every channel box ((bh + k - 1) x (bw + k - 1) pixels, box
//     origin (x0 - k/2, y0 - k/2)) and the group's dy tile, each box
//     swizzled with its width (cb * 2 = 128, 64 or 32 bytes). TMA
//     zero-fills what lies outside the image, negative coordinates
//     included: that is the SAME padding and the ragged edge, with no
//     bounds checks.
//   * Consumers walk the halo tile 16 pixels a step (a row segment, or two
//     rows of an 8-wide tile). Per step the A operand (the piece's 64 rows
//     x 16 pixels of x) is read into registers with ldmatrix.trans, the
//     swizzle's XOR applied to the addresses, since a one-pixel shift of a
//     swizzled tile is no legal wgmma descriptor; the same fragment then
//     feeds kDh products whose B (16 pixels x N of dy, read by wgmma from
//     the stage, MN-major) starts dh rows up. Zero rows around the dy tile
//     make the products of rows outside it add zero, so every product is
//     issued unconditionally: a wgmma under a branch makes ptxas serialize.
//     A fragments ring through ABuf<N> register sets.
//   * Each block writes its float32 partial sums once, at the end.
// dw_reduce: one thread per output sums the slices' partials in slice order
//   and writes torch's layout. No atomics: reruns are bit-identical.
//
// What bounds it: at C = 32, 64 x 256^2 (the JAX probe's first shape) the
// work is 77 GFLOP for 0.54 GB of x and dy: 0.16 ms of HBM against 0.08 ms
// of dense bf16 tensor-core time; at C = 64, 64 x 128^2 the two bounds
// meet (0.080 and 0.078 ms). Inside the SM: each m64nNk16 product reads
// N * 32 bytes of B from shared memory for 2 * 64 * N * 16 operations,
// 64 bytes a clock at the tensor cores' peak, half of shared memory's
// bandwidth, plus A through ldmatrix (one fragment per kDh products).
// Registers bound the accumulators: a sub-partition of the SM has 16,384
// registers and hosts 4 of the block's 13 warps, so a thread has 128;
// N = 64 keeps 96 accumulators and one A set (ABuf<64> = 1).

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kConsumers = 3;  // consumer warpgroups; then one producer warp
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kAlign = 1024;  // stage regions: the 128-byte swizzle's period

constexpr int kDh = 3;  // row taps (dh) a consumer warpgroup holds
// A fragment register sets per warpgroup: with 96 accumulator registers
// at N = 64 a single set fits the 128 registers ptxas allots a thread
template <int N>
struct ABuf { static constexpr int value = 3; };
template <>
struct ABuf<64> { static constexpr int value = 1; };

// The launch's plan, computed by kernels/conv_dw.py `plan`.
struct Plan {
  int n, h, w, c, k;
  int cb;          // channels per TMA box = N of the products
  int bh, bw;      // dy tile; the x halo tile is (bh + k - 1) x (bw + k - 1)
  int stages;      // ring depth
  int tiles_x, tiles_y;
  int slices;      // pixel-tile runs (blocks per output group)
  int groups;      // output groups = n-blocks x runs of kConsumers units
  int dh_chunk;    // min(k, kDh): row taps of a unit
  int units;       // ceil(k * C / 64) pieces x ceil(k / dh_chunk) taps
                   // chunks: one unit per consumer warpgroup
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// A stage: one x region per channel box, then the group's dy region. An x
// region is the halo box and one zero row of it after (read by the
// two-row steps of an 8-wide tile). A dy region is the dy box between zero
// rows: k - 1 before it (rounded up to 1024 bytes) and k after, so that a
// product whose dy rows lie outside the tile reads zeros.
__host__ __device__ inline int x_region_bytes(const Plan& p) {
  return round_up((p.bh + p.k) * (p.bw + p.k - 1) * p.cb * 2, kAlign);
}
__host__ __device__ inline int dy_pad_bytes(const Plan& p) {
  return round_up((p.k - 1) * p.bw * p.cb * 2, kAlign);
}
__host__ __device__ inline int dy_region_bytes(const Plan& p) {
  return round_up(dy_pad_bytes(p) + (p.bh + p.k) * p.bw * p.cb * 2, kAlign);
}
__host__ __device__ inline int stage_bytes(const Plan& p) {
  return (p.c / p.cb) * x_region_bytes(p) + dy_region_bytes(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// A stage is waited for microseconds at most; a lost arrival would hang the
// card, so the wait traps (a launch error) after 2^26 polls instead. Every
// lane of the warp waits and the vote keeps the loop warp-uniform, so that
// the compiler does not treat the wgmma after it as divergent.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    if (polls == (1u << 26)) __trap();
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (__all_sync(0xffffffffu, done)) return;
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// wgmma shared-memory descriptor of a swizzled MN-major operand: rows of
// `row_bytes` (the swizzle width), groups of 8 rows `8 * row_bytes` apart.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, int row_bytes) {
  const uint64_t mode = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)1 << 16) |                           // LBO (one atom wide)
         ((uint64_t)((8 * row_bytes) >> 4) << 32) |      // SBO: 8 pixels
         (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(Pending) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, float32) += A (64 x 16 bf16, registers) * B (16 x N bf16,
// shared memory, MN-major: imm-trans-b = 1).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    dw_partial(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap dy_map,
               float* __restrict__ partial, const Plan p) {
  constexpr int kRow = N * 2;  // bytes of one staged pixel of one box
  constexpr int kABuf = ABuf<N>::value;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const int n_boxes = p.c / N;
  const int x_region = x_region_bytes(p);
  const int dy_pad = dy_pad_bytes(p);
  const int dy_box = n_boxes * x_region + dy_pad;  // offset in a stage
  const int stage = stage_bytes(p);
  const uint32_t bars = base + p.stages * stage;  // full[s], then empty[s]
  // the warp index, broadcast so that the compiler knows it is uniform
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int xw = p.bw + p.k - 1, xh = p.bh + p.k - 1;
  const int x_box = xh * xw * kRow, dy_bytes = p.bh * p.bw * kRow;

  // zero the pads, which no TMA load writes
  unsigned char* smem = smem_raw + (base - raw);
  for (int s = 0; s < p.stages; ++s) {
    unsigned char* st = smem + s * stage;
    for (int b = 0; b < n_boxes; ++b)
      for (int i = threadIdx.x * 16; i < xw * kRow; i += kThreads * 16)
        *reinterpret_cast<uint4*>(st + b * x_region + x_box + i) =
            make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x * 16; i < dy_pad; i += kThreads * 16)
      *reinterpret_cast<uint4*>(st + dy_box - dy_pad + i) =
          make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x * 16; i < p.k * p.bw * kRow; i += kThreads * 16)
      *reinterpret_cast<uint4*>(st + dy_box + dy_bytes + i) =
          make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (p.stages + s), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int group = blockIdx.x % p.groups;
  const int slice = blockIdx.x / p.groups;
  const int n_block = group % n_boxes;
  const int per_image = p.tiles_x * p.tiles_y;
  const int tiles = per_image * p.n;  // < 2^31: 16+ pixels a tile
  const int t0 = (int)((long long)tiles * slice / p.slices);
  const int t1 = (int)((long long)tiles * (slice + 1) / p.slices);

  if (warp == kConsumers * 4) {
    // producer warp: one lane issues every TMA load of the block
    const int ph = p.k / 2;
    const uint32_t tx_bytes = n_boxes * x_box + dy_bytes;
    int s = 0;
    uint32_t phase = 0;
    for (int t = t0; t < t1; ++t) {
      const int img = t / per_image, rem = t % per_image;
      const int y0 = (rem / p.tiles_x) * p.bh;
      const int x0 = (rem % p.tiles_x) * p.bw;
      const uint32_t full = bars + 8 * s;
      mbar_wait(bars + 8 * (p.stages + s), phase ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full, tx_bytes);
        const uint32_t st = base + s * stage;
        for (int b = 0; b < n_boxes; ++b)
          tma_load_4d(st + b * x_region, &x_map, full, b * N, x0 - ph,
                      y0 - ph, img);
        tma_load_4d(st + dy_box, &dy_map, full, n_block * N, x0, y0, img);
      }
      __syncwarp();
      if (++s == p.stages) {
        s = 0;
        phase ^= 1;
      }
    }
  } else {
    // A unit is one piece (64 of the k * C rows (box, dw, c_in in box) that
    // share a dh; a warp's 16 rows are one (box, dw)) and a chunk of up to
    // kDh row taps dh. One A fragment of the piece at a halo row serves
    // every dh of the unit: kDh products with B at dy rows hr - dh.
    const int wg = warp >> 2, wq = warp & 3;
    const int unit = (group / n_boxes) * kConsumers + wg;
    int s = 0;
    uint32_t phase = 0;
    if (unit >= p.units) {  // no work: keep the ring turning
      for (int t = t0; t < t1; ++t) {
        mbar_wait(bars + 8 * s, phase);
        if (lane == 0) mbar_arrive(bars + 8 * (p.stages + s));
        if (++s == p.stages) {
          s = 0;
          phase ^= 1;
        }
      }
      return;
    }
    const int dh_chunks = (p.k + p.dh_chunk - 1) / p.dh_chunk;
    const int piece = unit / dh_chunks;
    const int dh0 = (unit % dh_chunks) * p.dh_chunk;
    const int inner = p.k * p.cb;  // rows of one box
    const int rows = p.k * p.c;    // rows of one dh
    const int swz = (kRow / 16 - 1) << 4;  // the TMA swizzle's XOR mask
    // the warp's 16 rows: the box region and 16-byte chunk of the lane's
    // ldmatrix row, and the tap's column offset dw
    const int r0 = piece * 64 + wq * 16;
    const int r = r0 < rows ? r0 : 0;  // padding rows read row 0's data
    const int a_box = (r / inner) * x_region;
    const int a_chunk = ((r % p.cb) / 8 + ((lane >> 3) & 1)) * 16;
    float acc[kDh][N / 2];
#pragma unroll
    for (int d = 0; d < kDh; ++d)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[d][e] = 0.0f;
    // Step i takes 16 pixels: dy tile pixels 16 i .. 16 i + 15 shifted by
    // -dh rows for B, and for A the halo pixels over them: halo row hr =
    // the step's tile row (bw >= 16: a row segment; bw = 8: two rows), so
    // halo pixel 16 i + hr (k - 1) + the lane's offset in the step.
    const int lbw = __ffs(p.bw) - 1;
    const int lsegs = p.bw >= 16 ? lbw - 4 : 0;  // log2 steps per tile row
    const int rps = p.bw >= 16 ? 1 : 2;          // tile rows per step
    const int steps = p.bw >= 16 ? xh << lsegs : (xh + 1) / 2;
    // the lane's pixel: ldmatrix matrix (lane >> 3) holds pixels
    // 8 * (lane >> 4) .. + 7 of the step, one row per lane
    const int lane_pix = ((lane >> 4) << 3) + (lane & 7);
    const int lane_q = (lane_pix >> lbw) * xw + (lane_pix & (p.bw - 1)) +
                       (r % inner) / p.cb;
    // B descriptors: the dy box's, and per dh the offset of its rows, in the
    // descriptor's 16-byte units (the pads keep every start in the stage)
    int dh_off[kDh];
#pragma unroll
    for (int d = 0; d < kDh; ++d) dh_off[d] = (dh0 + d) * p.bw * kRow / 16;

    auto load_a = [&](uint32_t(&a)[4], uint32_t st, int i) {
      const int q = 16 * i + ((i >> lsegs) * rps) * (p.k - 1) + lane_q;
      const int lin = q * kRow + a_chunk;
      ldmatrix_x4_trans(a, st + a_box + (lin ^ ((lin >> 3) & swz)));
    };
    auto issue = [&](const uint32_t(&a)[4], uint64_t desc0, int i) {
      const uint64_t desc = desc0 + (uint64_t)(i * kRow);  // + 16 i pixels
#pragma unroll
      for (int d = 0; d < kDh; ++d) fence_acc(acc[d]);
      wgmma_fence();
#pragma unroll
      for (int d = 0; d < kDh; ++d)
        wgmma_rs<N>(acc[d], a, desc - (uint64_t)dh_off[d]);
      wgmma_commit();
    };

    // A fragments in a ring of kABuf register sets: the fragment of step
    // i + kABuf - 1 is loaded while the products of steps i - kABuf + 2 .. i
    // run, and a set is reloaded once the products that read it are done
    uint32_t a[kABuf][4];
    for (int t = t0; t < t1; ++t) {
      mbar_wait(bars + 8 * s, phase);
      const uint32_t st = base + s * stage;
      const uint64_t desc0 = b_desc(st + dy_box, kRow);
      if constexpr (kABuf == 1) {
        for (int step = 0; step < steps; ++step) {
          load_a(a[0], st, step);
          issue(a[0], desc0, step);
          wgmma_wait<0>();
        }
      } else {
#pragma unroll
        for (int i = 0; i < kABuf - 1; ++i)
          if (i < steps) load_a(a[i], st, i);
        for (int step = 0; step < steps; step += kABuf) {
#pragma unroll
          for (int i = 0; i < kABuf; ++i) {
            if (step + i < steps) {
              issue(a[i], desc0, step + i);
              wgmma_wait<kABuf - 2>();  // the products of step + i - 1 are done
              if (step + i + kABuf - 1 < steps)
                load_a(a[(i + kABuf - 1) % kABuf], st, step + i + kABuf - 1);
            }
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int d = 0; d < kDh; ++d) fence_acc(acc[d]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (p.stages + s));
      if (++s == p.stages) {
        s = 0;
        phase ^= 1;
      }
    }

    // partial[slice][tap * C + c_in][c_out]; the m64nN accumulator layout:
    // element 4 * b + e of lane l is row 16 * warp + l / 4 + 8 * (e >> 1),
    // column 8 * b + 2 * (l % 4) + (e & 1)
    float* out = partial + (size_t)slice * p.k * rows * p.c;
#pragma unroll
    for (int d = 0; d < kDh; ++d) {
      const int dh = dh0 + d;
      if (d >= p.dh_chunk || dh >= p.k) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = piece * 64 + wq * 16 + (lane >> 2) + 8 * half;
        if (row >= rows) continue;
        const int dw = (row % inner) / p.cb;
        const int ci = (row / inner) * p.cb + row % p.cb;
        float* dst = out + ((size_t)(dh * p.k + dw) * p.c + ci) * p.c;
#pragma unroll
        for (int e = 0; e < N / 8; ++e) {
          const int col = n_block * N + 8 * e + 2 * (lane & 3);
          *reinterpret_cast<float2*>(dst + col) = make_float2(
              acc[d][4 * e + 2 * half], acc[d][4 * e + 2 * half + 1]);
        }
      }
    }
  }
}

__global__ void dw_reduce(const float* __restrict__ partial,
                          float* __restrict__ out, int c, int k, int slices) {
  const long long total = (long long)k * k * c * c;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.0f;
  for (int sl = 0; sl < slices; ++sl) s += partial[sl * total + e];
  const int row = (int)(e / c), o = (int)(e % c);  // row = tap * c + c_in
  const int tap = row / c, i = row % c;
  out[((long long)o * c + i) * k * k + tap] = s;
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// 4-D map over an NHWC bf16 tensor, dims (C, W, H, N), box (cb, bw, bh, 1),
// swizzled with the box's row width; out-of-bounds elements read as zero.
bool make_map(CUtensorMap* map, const void* ptr, const Plan& p, int box_w,
              int box_h) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)p.c, (cuuint64_t)p.w,
                              (cuuint64_t)p.h, (cuuint64_t)p.n};
  const cuuint64_t strides[3] = {(cuuint64_t)p.c * 2,
                                 (cuuint64_t)p.c * 2 * p.w,
                                 (cuuint64_t)p.c * 2 * p.w * p.h};
  const cuuint32_t box[4] = {(cuuint32_t)p.cb, (cuuint32_t)box_w,
                             (cuuint32_t)box_h, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      p.cb == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : p.cb == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
cudaError_t launch_partial(const CUtensorMap& xm, const CUtensorMap& dm,
                           float* partial, const Plan& p, int smem,
                           cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      dw_partial<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dw_partial<N><<<p.groups * p.slices, kThreads, smem, s>>>(xm, dm, partial,
                                                             p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dy: (n, h, w, c) bf16, 16-byte aligned; partial: slices * k * k * c * c
// float32 scratch; out: (c, c, k, k) float32. `plan` holds the Plan fields
// in order, from kernels/conv_dw.py. Returns the CUDA error of the launches
// (0 when both were accepted; cudaErrorInvalidValue when a tensor map
// could not be encoded).
int conv_dw_bf16(const void* x, const void* dy, void* partial, void* out,
                 const int* plan, void* stream) {
  Plan p;
  int* fields = reinterpret_cast<int*>(&p);
  for (int i = 0; i < (int)(sizeof(Plan) / sizeof(int)); ++i)
    fields[i] = plan[i];
  CUtensorMap xm, dm;
  if (!make_map(&xm, x, p, p.bw + p.k - 1, p.bh + p.k - 1) ||
      !make_map(&dm, dy, p, p.bw, p.bh))
    return (int)cudaErrorInvalidValue;
  const int smem = p.stages * (stage_bytes(p) + 16) + kAlign;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  cudaError_t err =
      p.cb == 64 ? launch_partial<64>(xm, dm, part, p, smem, s)
      : p.cb == 32 ? launch_partial<32>(xm, dm, part, p, smem, s)
                   : launch_partial<16>(xm, dm, part, p, smem, s);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)p.k * p.k * p.c * p.c;
  dw_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part, static_cast<float*>(out), p.c, p.k, p.slices);
  return (int)cudaGetLastError();
}

}  // extern "C"
