// Connected-component labelling (4-connectivity) for Hopper (sm_90a).
//
// Replaces the TPU kernels of mapping_tpu/ops/ccl_pallas.py:
//   _ccl_kernel           (ccl_pallas.py:127) -> ccl_label_raw below
//   _ccl_renumber_kernel  (ccl_pallas.py:141) -> ccl_renumber below
//
// Contract (identical to mapping_tpu.ops.ccl._label_raw / _renumber):
//   ccl_label_raw: (N, H, W) uint8 mask -> int32 labels, each foreground
//     pixel holding 1 + the row-major index of its component's minimal
//     pixel, background 0.
//   ccl_renumber: those labels -> consecutive 1..K per image, numbered by
//     minimal pixel, which is scipy.ndimage.label's order.
//
// Why not the TPU design: the Pallas kernel keeps a whole image and its scan
// temporaries resident in VMEM (~6 * H * W * 4 B, 2.2 MB at 304^2) and sweeps
// row/column segmented minima until nothing changes. A Hopper block has at
// most 227 KB of shared memory, less than one int32 300^2 plane, so this is
// a union-find over global memory instead:
//   1. init_runs: one warp per row; ballots find each horizontal run's first
//      pixel and every pixel of the run points at it, so runs are stars
//      rooted at their minimal pixel.
//   2. merge_cols: one thread per vertical adjacency that starts a run
//      overlap unites the two runs. Roots link larger index under smaller
//      with atomicMin (Playne & Hawick's lock-free union), so a root is
//      always the minimal pixel of what it holds.
//   3. resolve: every pixel writes 1 + its root.
//   4. rank_roots: one block per image scans the root flags in row-major
//      order (ballot + popc per warp, carried across 1024-pixel chunks) and
//      writes each root's rank at the root.
//   5. gather_ranks: every pixel reads the rank at its root.
//
// What bounds it on an H100: memory traffic, not arithmetic. Per pixel the
// labelling reads 1 B of mask a few times and writes 4 B of parent and 4 B
// of labels; renumbering reads 4 B and writes 4 B (+4 B of rank per root),
// plus the parent-chain reads of the union-find, which hit L2 (a batch of
// 20 x 300^2 = 1.8 M pixels is ~7 MB per int32 plane, inside the 50 MB L2).
// The design keeps the chain short (runs collapse to stars before any
// union, and only run overlaps unite), and every pass but the per-image
// scan is one coalesced thread per pixel. Tiling in shared memory and a
// multi-block scan are left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

__global__ void init_runs(const uint8_t* __restrict__ mask,
                          int32_t* __restrict__ parent, long long rows, int h,
                          int w) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // row is warp-uniform: whole warps leave
  const long long off = row * w;
  const int y_base = (int)(row % h) * w;
  const unsigned lanes_below = (1u << lane) - 1u;
  int carry = 0;  // first pixel of a run that enters this chunk from the left
  for (int base = 0; base < w; base += 32) {
    const int x = base + lane;
    const bool fg = x < w && mask[off + x] != 0;
    const unsigned fg_bits = __ballot_sync(kFullMask, fg);
    const unsigned bg_below = ~fg_bits & lanes_below;
    // nearest background pixel to the left inside the chunk ends the run
    const int start = bg_below ? base + 32 - __clz(bg_below) : carry;
    if (fg) parent[off + x] = y_base + start;
    const int start_last = __shfl_sync(kFullMask, start, 31);
    carry = (fg_bits >> 31) ? start_last : base + 32;
  }
}

// Parents are read through L2 (ld.global.cg): other SMs relink roots while
// this kernel runs, and a stale L1 line could hide a new link forever.
__device__ __forceinline__ int find_root(const int32_t* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    x = p;
    p = __ldcg(parent + x);
  }
  return x;
}

__device__ void unite(int32_t* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + b, a);
    if (old == b) return;  // b was still a root and now hangs under a
    b = old;  // b was relinked meanwhile: unite a with where b went
  }
}

__global__ void merge_cols(const uint8_t* __restrict__ mask, int32_t* parent,
                           long long total, int h, int w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int hw = h * w;
  const long long img = i / hw;
  const int p = (int)(i - img * hw);
  const int y = p / w;
  const int x = p - y * w;
  if (y == 0 || !mask[i] || !mask[i - w]) return;
  // left and up-left both foreground: that pair already unites these runs
  if (x > 0 && mask[i - 1] && mask[i - w - 1]) return;
  unite(parent + img * hw, p, p - w);
}

__global__ void resolve(const uint8_t* __restrict__ mask,
                        const int32_t* __restrict__ parent,
                        int32_t* __restrict__ labels, long long total, int hw) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  if (!mask[i]) {
    labels[i] = 0;
    return;
  }
  const long long img = i / hw;
  labels[i] = find_root(parent + img * hw, (int)(i - img * hw)) + 1;
}

__global__ void rank_roots(const int32_t* __restrict__ labels,
                           int32_t* __restrict__ rank, int hw) {
  __shared__ int warp_count[kScanThreads / 32];
  const long long off = (long long)blockIdx.x * hw;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned lanes_upto = (2u << lane) - 1u;  // lane 31: all bits
  int carry = 0;
  for (int base = 0; base < hw; base += blockDim.x) {
    const int p = base + threadIdx.x;
    const bool root = p < hw && labels[off + p] == p + 1;
    const unsigned bits = __ballot_sync(kFullMask, root);
    if (lane == 0) warp_count[warp] = __popc(bits);
    __syncthreads();
    int before = 0;
    int chunk = 0;
    for (int k = 0; k < n_warps; ++k) {
      const int c = warp_count[k];
      before += k < warp ? c : 0;
      chunk += c;
    }
    if (root) rank[off + p] = carry + before + __popc(bits & lanes_upto);
    carry += chunk;
    __syncthreads();  // warp_count is rewritten by the next chunk
  }
}

__global__ void gather_ranks(const int32_t* __restrict__ labels,
                             const int32_t* __restrict__ rank,
                             int32_t* __restrict__ out, long long total,
                             int hw) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int label = labels[i];
  out[i] = label ? rank[(i / hw) * hw + label - 1] : 0;
}

int blocks_for(long long total) {
  return (int)((total + kThreads - 1) / kThreads);
}

}  // namespace

// Every entry point enqueues on `stream`, never synchronises, and returns
// cudaGetLastError() after its launches (0 when all were accepted). The
// caller guarantees n, h, w > 0, h * w < 2^31 and contiguous buffers.
extern "C" int ccl_label_raw(const void* mask, void* parent, void* labels,
                             int n, int h, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* par = static_cast<int32_t*>(parent);
  const long long rows = (long long)n * h;
  const long long total = rows * w;
  const int warps_per_block = kThreads / 32;
  init_runs<<<(int)((rows + warps_per_block - 1) / warps_per_block), kThreads,
              0, s>>>(m, par, rows, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_cols<<<blocks_for(total), kThreads, 0, s>>>(m, par, total, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  resolve<<<blocks_for(total), kThreads, 0, s>>>(
      m, par, static_cast<int32_t*>(labels), total, h * w);
  return cudaGetLastError();
}

extern "C" int ccl_renumber(const void* labels, void* rank, void* out, int n,
                            int h, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lab = static_cast<const int32_t*>(labels);
  auto* r = static_cast<int32_t*>(rank);
  const long long total = (long long)n * h * w;
  rank_roots<<<n, kScanThreads, 0, s>>>(lab, r, h * w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gather_ranks<<<blocks_for(total), kThreads, 0, s>>>(
      lab, r, static_cast<int32_t*>(out), total, h * w);
  return cudaGetLastError();
}
