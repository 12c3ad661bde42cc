// Connected-component labelling (4-connectivity) for Hopper (sm_90a).
//
// Replaces the TPU kernels of mapping_tpu/ops/ccl_pallas.py:
//   _ccl_kernel           (ccl_pallas.py:127) -> ccl_label_raw below
//   _ccl_renumber_kernel  (ccl_pallas.py:141) -> ccl_renumber below, and
//                         ccl_label (ccl_label_raw with the renumbering
//                         fused into its last pass) for the main path
//
// Contract (identical to mapping_tpu.ops.ccl._label_raw / _renumber):
//   ccl_label_raw: (N, H, W) uint8 mask -> int32 labels, each foreground
//     pixel holding 1 + the row-major index of its component's minimal
//     pixel, background 0.
//   ccl_renumber: those labels -> consecutive 1..K per image, numbered by
//     minimal pixel, which is scipy.ndimage.label's order.
//   ccl_label: the mask -> ccl_renumber(ccl_label_raw(mask)).
//
// Why not the TPU design: the Pallas kernel keeps a whole image and its scan
// temporaries resident in VMEM (~6 * H * W * 4 B, 2.2 MB at 304^2) and sweeps
// row/column segmented minima until nothing changes. A Hopper block has at
// most 227 KB of shared memory, less than one int32 300^2 plane, so this is
// a block-based union-find (the family of Playne & Hawick's and Allegretti
// et al.'s GPU union-finds): each block labels one tile in shared memory,
// and only the unions across tile borders go through global memory.
//
// K1 (ccl_label_raw), three launches:
//   1. tile_label: one block per kTileH x kTileW tile of one image. The
//      mask tile comes into shared memory as 4-byte words where the row
//      allows it (a 300-pixel row is 4-byte but not 16-byte aligned), and
//      bytes where it does not. Two ballots turn each tile row into a 64-bit
//      word, so every pixel finds the first pixel of its horizontal run with
//      one __clzll and points at it: runs are stars rooted at their minimal
//      pixel. One thread per vertical run overlap (foreground above, and not
//      foreground left with foreground up-left) unites the two runs with a
//      shared-memory atomicMin on tile-local indices: roots link larger index
//      under smaller (Playne & Hawick's lock-free union), so a root is always
//      the minimal pixel of what it holds. Each warp unites the rows of its
//      own 4-row strip top down, then the strips are joined; finds halve the
//      path they walk. The trees are flattened, and each foreground pixel's
//      parent in global memory is the image index of its tile root: every
//      pixel is one hop from a root of its own tile.
//   2. merge_borders: one thread per pixel of a tile's top row and left
//      column, (kTileH + kTileW) / (kTileH * kTileW) = 4.7 % of the pixels,
//      unites the pair across the border where a run overlap along the
//      border starts, with the same union in global memory (parents read
//      through L2 while other SMs relink roots).
//   3. resolve: every pixel follows its parent (one hop to its tile root,
//      then the border links) and writes 1 + its root. It runs over the
//      renumbering's grid of (1024-pixel row-major chunk) x image, so that
//      ccl_label can fuse the root count into it (below).
// Tile of 32 x 64: a tile row is one warp's two ballots, one 64-bit word, so
// a run start needs no carry between words; 2,048 pixels for a block of 256
// threads, 10.5 KB of static shared memory, and a serving batch of
// 20 x 300^2 is 1,000 blocks, one wave on 132 SMs.
//
// K2 (ccl_renumber), over a grid of (1024-pixel chunk) x image, 1,760
// blocks for a serving batch, so that every SM takes part:
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
// ccl_label, the main path's mask -> consecutive labels, runs 1, 2, then
// resolve with count_roots fused in (a pixel is a root when its root is
// itself, which resolve knows without reading labels back), then 5 and 6:
// five launches where K1 + K2 take six, and the 7.2 MB re-read of a serving
// batch's labels by count_roots is gone.
//
// Every launch after the first of an entry point is a programmatic
// dependent launch (launch_after): its blocks are scheduled while the grid
// before drains.
//
// What bounds it on an H100: not arithmetic, and at a serving batch not the
// bytes either (~1 B of mask in and 4 B of labels out per pixel, 9 MB, and
// every intermediate plane fits in the 50 MB L2), but latency: the chains of
// dependent shared-memory loads and atomics of the tile pass's unions, the
// chains of dependent L2 loads of the border pass and the resolve, and the
// launches, each of which waits for the whole previous one. The tile pass
// keeps the union-find in shared memory, the border pass touches 4.7 % of
// the pixels, and resolve loads a thread's four pixels, their tile roots and
// the roots' parents together before it follows any longer chain.
// tools/ccl_variants.json holds the patched copies that time each pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kChunk = 1024;  // pixels of a renumbering chunk
constexpr int kChunkWords = kChunk / 32;
constexpr int kWordsPerWarp = kChunkWords / (kThreads / 32);
constexpr int kTileH = 32, kTileW = 64;   // kernels/ccl.py TILE_H, TILE_W
constexpr int kTileWords = kTileW / 4;    // 4-byte mask words of a tile row
constexpr int kBorder = kTileH + kTileW;  // border-pass threads per tile

// Every kernel that reads what the kernel before it in the stream wrote is
// started by launch_after as a programmatic dependent launch: its blocks
// are scheduled while the previous grid drains, and each waits here until
// that grid has finished and its writes are visible (a no-op otherwise).
__device__ __forceinline__ void wait_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Union-find over tile-local indices in shared memory, by 32-bit shared
// addresses. The loads are weak ld.shared in asm volatile: each is issued
// anew (shared memory has no cache between a thread and its value, so it
// sees the block's latest links), where volatile loads make the tile pass
// ~1.8x slower on sm_90 (`volatile_loads` in tools/ccl_variants.json). A
// stale parent could only delay a union, never loop: every link points to
// a smaller index, and the union's atomicMin returns the current value.
__device__ __forceinline__ int load_shared(uint32_t addr) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// The root of x, halving the path on the way: each visited node is relinked
// to its grandparent, an ancestor in the same set with a smaller index.
__device__ __forceinline__ int find_shared(uint32_t tree, int x) {
  while (true) {
    const int p = load_shared(tree + 4 * x);
    if (p == x) return x;
    const int g = load_shared(tree + 4 * p);
    if (g == p) return p;
    asm volatile("st.shared.s32 [%0], %1;" ::"r"(tree + 4 * x), "r"(g)
                 : "memory");
    x = g;
  }
}

__device__ void unite_shared(uint32_t tree, int a, int b) {
  while (true) {
    a = find_shared(tree, a);
    b = find_shared(tree, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    int old;
    asm volatile("atom.shared.min.s32 %0, [%1], %2;"
                 : "=r"(old) : "r"(tree + 4 * b), "r"(a) : "memory");
    if (old == b) return;  // b was still a root and now hangs under a
    b = old;  // b was relinked meanwhile: unite a with where b went
  }
}

// 4 mask bytes of row y from column x (0 outside the image): one 4-byte
// load where the row allows it, else bytes.
__device__ __forceinline__ uint32_t mask_word(const uint8_t* m, int y, int x,
                                              int h, int w) {
  if (y >= h || x >= w) return 0;
  const uint8_t* src = m + y * w + x;
  if (x + 4 <= w && (reinterpret_cast<uintptr_t>(src) & 3) == 0)
    return __ldg(reinterpret_cast<const uint32_t*>(src));
  uint32_t v = 0;
  for (int j = 0; j < 4 && x + j < w; ++j) v |= (uint32_t)src[j] << (8 * j);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    tile_label(const uint8_t* __restrict__ mask, int32_t* __restrict__ parent,
               int h, int w, int tiles_x, int tiles) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kStrip = kTileH / kWarps;  // rows a warp unites
  constexpr int kLoads = kTileH * kTileWords / kThreads;
  __shared__ uint32_t bytes[kTileH * kTileWords];  // the mask tile
  __shared__ unsigned long long rows[kTileH];      // foreground bits per row
  __shared__ int tree[kTileH * kTileW];            // tile-local parents
  const long long img = blockIdx.x / tiles;
  const int t = (int)(blockIdx.x - img * tiles);
  const int y0 = (t / tiles_x) * kTileH, x0 = (t % tiles_x) * kTileW;
  const long long off = img * h * w;
  const uint8_t* m = mask + off;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const auto tree_s = static_cast<uint32_t>(__cvta_generic_to_shared(tree));

  // the mask tile, every thread's loads in flight together
  uint32_t words[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    words[k] = mask_word(m, y0 + i / kTileWords, x0 + (i % kTileWords) * 4,
                         h, w);
  }
#pragma unroll
  for (int k = 0; k < kLoads; ++k) bytes[threadIdx.x + k * kThreads] = words[k];
  __syncthreads();

  // horizontal runs: every pixel points at its run's first pixel
  const auto* tile_bytes = reinterpret_cast<const uint8_t*>(bytes);
  for (int r = warp; r < kTileH; r += kWarps) {
    const unsigned lo = __ballot_sync(kFullMask, tile_bytes[r * kTileW + lane]);
    const unsigned hi =
        __ballot_sync(kFullMask, tile_bytes[r * kTileW + 32 + lane]);
    const unsigned long long row = lo | (unsigned long long)hi << 32;
    if (lane == 0) rows[r] = row;
#pragma unroll
    for (int x = lane; x < kTileW; x += 32) {
      const unsigned long long bg_left = ~row & ((1ull << x) - 1);
      const int start = bg_left ? 64 - __clzll(bg_left) : 0;
      tree[r * kTileW + x] = r * kTileW + start;
    }
  }
  __syncthreads();

  // vertical run overlaps inside the tile, one union where each starts:
  // each warp unites the rows of its strip of kStrip rows top down, then,
  // after a barrier, its strip's first row with the row above the strip
  for (int s = 1; s <= kStrip; ++s) {
    const int r = warp * kStrip + s % kStrip;
    if (s == kStrip) __syncthreads();
    if (r == 0) continue;  // the tile's top row: the border pass's
    __syncwarp();
    const unsigned long long overlap = rows[r] & rows[r - 1];
    const unsigned long long starts = overlap & ~(overlap << 1);
#pragma unroll
    for (int x = lane; x < kTileW; x += 32)
      if ((starts >> x) & 1)
        unite_shared(tree_s, r * kTileW + x, (r - 1) * kTileW + x);
  }
  __syncthreads();

  // flatten: each foreground pixel's parent is its tile root, by image index
  for (int r = warp; r < kTileH; r += kWarps) {
    const unsigned long long row = rows[r];
#pragma unroll
    for (int x = lane; x < kTileW; x += 32) {
      if (!((row >> x) & 1)) continue;
      const int root = find_shared(tree_s, r * kTileW + x);
      parent[off + (y0 + r) * w + x0 + x] =
          (y0 + root / kTileW) * w + x0 + root % kTileW;
    }
  }
}

// Parents are read through L2 (ld.global.cg): other SMs relink roots while
// this kernel runs, and a stale L1 line could hide a new link forever. The
// path is halved on the way (atomicMin to the grandparent, so a parent only
// ever decreases): big components that span many tiles leave chains of
// tile roots that the resolve would walk again.
__device__ __forceinline__ int find_root(int32_t* parent, int x) {
  while (true) {
    const int p = __ldcg(parent + x);
    if (p == x) return x;
    const int g = __ldcg(parent + p);
    if (g == p) return p;
    atomicMin(parent + x, g);
    x = g;
  }
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

// Thread k of a tile: k < kTileW is the top row's pixel x0 + k with the
// pixel above it, else the left column's pixel y0 + k - kTileW with the
// pixel left of it. A pair is skipped where the previous pair along the
// border is foreground on both sides: that pair unites the same two runs.
__global__ void merge_borders(const uint8_t* __restrict__ mask,
                              int32_t* parent, long long total, int h, int w,
                              int tiles_x, int tiles) {
  wait_previous();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long tile = i / kBorder;
  const int k = (int)(i - tile * kBorder);
  const long long img = tile / tiles;
  const int t = (int)(tile - img * tiles);
  const int y0 = (t / tiles_x) * kTileH, x0 = (t % tiles_x) * kTileW;
  const long long off = img * h * w;
  const uint8_t* m = mask + off;
  int p, step;  // the pixel inside the tile; the previous pair's offset
  int q;        // its neighbour across the border
  if (k < kTileW) {
    const int x = x0 + k;
    if (y0 == 0 || x >= w) return;
    p = y0 * w + x;
    q = p - w;
    step = k > 0 ? 1 : 0;
  } else {
    const int y = y0 + k - kTileW;
    if (x0 == 0 || y >= h) return;
    p = y * w + x0;
    q = p - 1;
    step = k > kTileW ? w : 0;
  }
  // the pair and the previous pair along the border, loaded together
  const uint8_t a = m[p], b = m[q], a0 = m[p - step], b0 = m[q - step];
  if (a && b && !(step && a0 && b0)) unite(parent + off, p, q);
}

// Over a grid of (chunk of kChunk pixels) x image, blockIdx.x = image *
// chunks + chunk. Every pixel writes 1 + its root, or 0. With kCount it
// also writes count_roots' outputs: a pixel is a root when its root is
// itself.
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    resolve(const uint8_t* __restrict__ mask,
            const int32_t* __restrict__ parent, int32_t* __restrict__ labels,
            uint32_t* __restrict__ roots, int32_t* __restrict__ word_before,
            int32_t* __restrict__ chunk_count, int hw, int words, int chunks) {
  __shared__ int word_count[kChunkWords];
  wait_previous();
  const long long img = blockIdx.x / chunks;
  const int chunk = (int)(blockIdx.x - img * chunks);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long off = img * hw;
  const int32_t* par = parent + off;  // read-only while this kernel runs
  // a thread's pixels: the mask, the tile root and its parent of each
  // loaded together before any longer chain is followed
  int p[kWordsPerWarp], hop1[kWordsPerWarp], hop2[kWordsPerWarp];
  bool fg[kWordsPerWarp];
#pragma unroll
  for (int i = 0; i < kWordsPerWarp; ++i) {
    p[i] = (chunk * kChunkWords + warp * kWordsPerWarp + i) * 32 + lane;
    const int in = min(p[i], hw - 1);
    const uint8_t v = mask[off + in];
    fg[i] = (p[i] < hw) & (v != 0);
    hop1[i] = __ldg(par + in);
  }
#pragma unroll
  for (int i = 0; i < kWordsPerWarp; ++i)
    hop2[i] = __ldg(par + (fg[i] ? hop1[i] : min(p[i], hw - 1)));
#pragma unroll
  for (int i = 0; i < kWordsPerWarp; ++i) {
    const int local = warp * kWordsPerWarp + i;
    const int word = chunk * kChunkWords + local;
    int x = fg[i] ? hop1[i] : 0, q = fg[i] ? hop2[i] : 0;
    while (q != x) {  // the border links
      x = q;
      q = __ldg(par + x);
    }
    if (p[i] < hw) labels[off + p[i]] = fg[i] ? x + 1 : 0;
    const bool root = fg[i] && x == p[i];
    if constexpr (kCount) {
      const unsigned bits = __ballot_sync(kFullMask, root);
      if (lane == 0) {
        if (word < words) roots[img * words + word] = bits;
        word_count[local] = __popc(bits);
      }
    }
  }
  if constexpr (kCount) {
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
      if (word < words) word_before[img * words + word] = incl - v;
      if (lane == 31) chunk_count[img * chunks + chunk] = incl;
    }
  }
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
  wait_previous();
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
  wait_previous();
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

template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), long long grid,
                         int block, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(block);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// The renumbering scratch (kernels/ccl.py `renumber_plan`): root words and
// in-chunk prefixes per word, counts and prefixes per chunk.
struct Scratch {
  uint32_t* roots;
  int32_t* word_before;
  int32_t* chunk_count;
  int32_t* chunk_before;
  int words, chunks;
};

Scratch scratch_of(void* scratch, int n, int hw) {
  Scratch s;
  s.words = (hw + 31) / 32;
  s.chunks = (hw + kChunk - 1) / kChunk;
  s.roots = static_cast<uint32_t*>(scratch);
  s.word_before = reinterpret_cast<int32_t*>(s.roots + (long long)n * s.words);
  s.chunk_count = s.word_before + (long long)n * s.words;
  s.chunk_before = s.chunk_count + (long long)n * s.chunks;
  return s;
}

// Steps 1 and 2: parent holds every foreground pixel's link after them.
cudaError_t label_tiles(const uint8_t* m, int32_t* par, int n, int h, int w,
                        cudaStream_t s) {
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles = tiles_x * ((h + kTileH - 1) / kTileH);
  const long long blocks = (long long)n * tiles;
  tile_label<<<(unsigned)blocks, kThreads, 0, s>>>(m, par, h, w, tiles_x,
                                                   tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long border = blocks * kBorder;
  return launch_after(merge_borders, blocks_for(border), kThreads, s, m, par,
                      border, h, w, tiles_x, tiles);
}

// Steps 5 and 6: ranks from the root bits and counts.
cudaError_t rank_roots(const int32_t* lab, const Scratch& sc, int32_t* out,
                       int n, int hw, cudaStream_t s) {
  const cudaError_t err = launch_after(scan_chunks, n, kScanThreads, s,
                                       sc.chunk_count, sc.chunk_before,
                                       sc.chunks);
  if (err != cudaSuccess) return err;
  const long long total = (long long)n * hw;
  return launch_after(gather_ranks, blocks_for(total), kThreads, s, lab,
                      sc.roots, sc.word_before, sc.chunk_before, out, total,
                      hw, sc.words, sc.chunks);
}

}  // namespace

// Every entry point enqueues on `stream`, never synchronises, and returns
// cudaGetLastError() after its launches (0 when all were accepted). The
// caller guarantees n, h, w > 0, h * w < 2^31 and contiguous buffers.
// parent: n * h * w int32 of scratch.
extern "C" int ccl_label_raw(const void* mask, void* parent, void* labels,
                             int n, int h, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* par = static_cast<int32_t*>(parent);
  cudaError_t err = label_tiles(m, par, n, h, w, s);
  if (err != cudaSuccess) return err;
  const int hw = h * w, chunks = (hw + kChunk - 1) / kChunk;
  return launch_after(resolve<false>, (long long)n * chunks, kThreads, s, m,
                      par, static_cast<int32_t*>(labels), nullptr, nullptr,
                      nullptr, hw, 0, chunks);
}

// scratch: 2 * n * words + 2 * n * chunks int32, words = ceil(h * w / 32),
// chunks = ceil(h * w / kChunk) (kernels/ccl.py `renumber_plan`).
extern "C" int ccl_renumber(const void* labels, void* scratch, void* out,
                            int n, int h, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lab = static_cast<const int32_t*>(labels);
  const int hw = h * w;
  const Scratch sc = scratch_of(scratch, n, hw);
  count_roots<<<dim3(sc.chunks, n), kThreads, 0, s>>>(
      lab, sc.roots, sc.word_before, sc.chunk_count, hw, sc.words, sc.chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return rank_roots(lab, sc, static_cast<int32_t*>(out), n, hw, s);
}

// work: 2 * n * h * w int32 (parents, then raw labels) followed by
// ccl_renumber's scratch (kernels/ccl.py `label_plan`).
extern "C" int ccl_label(const void* mask, void* work, void* out, int n, int h,
                         int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint8_t*>(mask);
  const int hw = h * w;
  auto* par = static_cast<int32_t*>(work);
  int32_t* raw = par + (long long)n * hw;
  const Scratch sc = scratch_of(raw + (long long)n * hw, n, hw);
  cudaError_t err = label_tiles(m, par, n, h, w, s);
  if (err != cudaSuccess) return err;
  err = launch_after(resolve<true>, (long long)n * sc.chunks, kThreads, s, m,
                     par, raw, sc.roots, sc.word_before, sc.chunk_count, hw,
                     sc.words, sc.chunks);
  if (err != cudaSuccess) return err;
  return rank_roots(raw, sc, static_cast<int32_t*>(out), n, hw, s);
}

// Blocks of tile_label that one SM holds at once (what its registers and
// shared memory allow), or -1 if the query fails.
extern "C" int ccl_tile_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, tile_label, kThreads, 0);
  return err == cudaSuccess ? blocks : -1;
}
