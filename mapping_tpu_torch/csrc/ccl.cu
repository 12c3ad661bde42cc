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
// Renumbering (ccl_renumber) runs over a grid of (1024-pixel chunk) x image,
// 1,760 blocks for a serving batch of 20 x 300^2, so that every SM takes
// part:
//   4. count_roots: each block ballots the root flags (label == index + 1)
//      of its chunk, 32 pixels to a word, and writes the words, the roots
//      in the chunk's earlier words (a warp scan of 32 popcounts) and the
//      chunk's count. Counting and the in-chunk prefix are fused.
//   5. scan_chunks: one block per image takes the exclusive prefix of its
//      chunk counts (88 at 300^2).
//   6. gather_ranks: every pixel computes the rank of its root from those,
//      1 + chunk prefix + word prefix + popc(the root word's bits below the
//      root); writing each root's rank and gathering it are fused, so no
//      int32 rank plane is written or read.
// Steps 5 and 6 wait for every chunk of the image before them, a grid-wide
// dependency, so they stay separate launches.
//
// What bounds it on an H100: memory traffic, not arithmetic. Per pixel the
// labelling reads 1 B of mask a few times and writes 4 B of parent and 4 B
// of labels; renumbering reads the 4 B label twice and writes 4 B, plus
// 1/4 B of root bits and word prefixes, and the root lookups, which hit
// L1 / L2 (a batch of 20 x 300^2 = 1.8 M pixels is ~7 MB per int32 plane,
// inside the 50 MB L2). The labelling keeps the union-find chain short
// (runs collapse to stars before any union, and only run overlaps unite);
// every pass is coalesced. Tiling the union-find in shared memory is left
// for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kChunk = 1024;  // pixels of a renumbering chunk
constexpr int kChunkWords = kChunk / 32;

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

// Renumbering, over a grid of (chunk of kChunk pixels) x image. A root is
// a pixel whose label is its own index + 1, and its rank is 1 + the number
// of roots before it in its image. roots: one bit per pixel in 32-pixel
// words; word_before: roots in earlier words of the word's chunk;
// chunk_count / chunk_before: roots in the chunk / in earlier chunks.
__global__ void count_roots(const int32_t* __restrict__ labels,
                            uint32_t* __restrict__ roots,
                            int32_t* __restrict__ word_before,
                            int32_t* __restrict__ chunk_count, int hw,
                            int words, int chunks) {
  __shared__ int word_count[kChunkWords];
  const int img = blockIdx.y, chunk = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long off = (long long)img * hw;
  constexpr int kWordsPerWarp = kChunkWords / (kThreads / 32);
#pragma unroll
  for (int i = 0; i < kWordsPerWarp; ++i) {
    const int local = warp * kWordsPerWarp + i;
    const int word = chunk * kChunkWords + local;
    const int p = word * 32 + lane;
    const bool root = p < hw && labels[off + p] == p + 1;
    const unsigned bits = __ballot_sync(kFullMask, root);
    if (lane == 0) {
      if (word < words) roots[(long long)img * words + word] = bits;
      word_count[local] = __popc(bits);
    }
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the chunk's 32 word counts
    const int v = word_count[lane];
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= d) incl += u;
    }
    const int word = chunk * kChunkWords + lane;
    if (word < words) word_before[(long long)img * words + word] = incl - v;
    if (lane == 31) chunk_count[(long long)img * chunks + chunk] = incl;
  }
}

// One block per image: exclusive scan of its chunk counts, kScanThreads at
// a time (88 chunks of a 300^2 tile: one pass).
__global__ void scan_chunks(const int32_t* __restrict__ chunk_count,
                            int32_t* __restrict__ chunk_before, int chunks) {
  __shared__ int warp_sum[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long off = (long long)blockIdx.x * chunks;
  int carry = 0;
  for (int base = 0; base < chunks; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < chunks ? chunk_count[off + i] : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = carry, total = carry;
    for (int k = 0; k < kScanThreads / 32; ++k) {
      before += k < warp ? warp_sum[k] : 0;
      total += warp_sum[k];
    }
    if (i < chunks) chunk_before[off + i] = before + incl - v;
    carry = total;
    __syncthreads();  // warp_sum is rewritten by the next pass
  }
}

__global__ void gather_ranks(const int32_t* __restrict__ labels,
                             const uint32_t* __restrict__ roots,
                             const int32_t* __restrict__ word_before,
                             const int32_t* __restrict__ chunk_before,
                             int32_t* __restrict__ out, long long total,
                             int hw, int words, int chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int label = labels[i];
  if (!label) {
    out[i] = 0;
    return;
  }
  const long long img = i / hw;
  const int r = label - 1;  // the root, in this image
  const long long word = img * words + (r >> 5);
  out[i] = chunk_before[img * chunks + r / kChunk] + word_before[word] +
           __popc(roots[word] & ((1u << (r & 31)) - 1u)) + 1;
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

// scratch: 2 * n * words + 2 * n * chunks int32, words = ceil(h * w / 32),
// chunks = ceil(h * w / kChunk) (kernels/ccl.py `renumber_plan`).
extern "C" int ccl_renumber(const void* labels, void* scratch, void* out,
                            int n, int h, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lab = static_cast<const int32_t*>(labels);
  const int hw = h * w;
  const int words = (hw + 31) / 32, chunks = (hw + kChunk - 1) / kChunk;
  auto* roots = static_cast<uint32_t*>(scratch);
  auto* word_before = reinterpret_cast<int32_t*>(roots + (long long)n * words);
  int32_t* chunk_count = word_before + (long long)n * words;
  int32_t* chunk_before = chunk_count + (long long)n * chunks;
  count_roots<<<dim3(chunks, n), kThreads, 0, s>>>(lab, roots, word_before,
                                                   chunk_count, hw, words,
                                                   chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_chunks<<<n, kScanThreads, 0, s>>>(chunk_count, chunk_before, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)n * hw;
  gather_ranks<<<blocks_for(total), kThreads, 0, s>>>(
      lab, roots, word_before, chunk_before, static_cast<int32_t*>(out),
      total, hw, words, chunks);
  return cudaGetLastError();
}
