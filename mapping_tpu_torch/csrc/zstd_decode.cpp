// ZSTD frames (RFC 8878) on the host, for TIFF compression 50000
// (mapping_tpu_torch/utils/tiff.py).
//
// The JAX package reads a ZSTD-compressed TIFF through Pillow, whose libtiff
// 4.7.1 hands each strip or tile to libzstd 1.5.7 (tif_zstd.c ZSTDDecode:
// ZSTD_decompressStream in a loop while it returns non-zero, input is left
// and the output is not full; fewer bytes than the strip is an error). This
// file is a decoder of its own that follows that pair on every input,
// corrupt ones included, so that a strip reads here exactly when it reads
// there, to the same bytes:
// - one frame a strip: the loop stops at the end of the first frame, so
//   bytes after it are ignored, and a skippable frame first ends the strip
//   with no data (an error); legacy (v0.5-v0.7) frames, which Pillow's build
//   decodes, are refused by name;
// - the frame header: the reserved bit, window logs past 31, a dictionary
//   ID (libtiff loads no dictionary), and a window past 2^27 + 1 bytes
//   (ZSTD_WINDOWLOG_LIMIT_DEFAULT) are errors; the last only in streaming
//   mode, which libzstd skips for a frame of known content size that fits
//   the strip and lies whole in it (ZSTD_decompressStream's single-pass
//   shortcut, whose rules differ: no Block_Maximum_Size check on raw and
//   RLE blocks, the content size checked even after an empty last block, a
//   compressed block of size 0 an error);
// - in streaming mode, libzstd's output buffer of window + 2 blocks + 64
//   bytes (an offset may reach back into the previous fill of it, and no
//   further), the units it decodes after the strip is full (an error there
//   fails the strip, a missing checksum does not), raw blocks in pieces;
// - raw, RLE and compressed blocks; literals raw, RLE, Huffman-compressed
//   and treeless with 1 or 4 streams, decoded as libzstd's HUF decoders do
//   on an x86-64 host with BMI2: the single- or double-symbol table by
//   HUF_selectDecoder, and for 4 streams of 8 bytes or more with an 11-bit
//   table the fast loops, which read past a stream's start into the bytes
//   before it and do not check that a stream ends where its bits do;
// - sequences with predefined, RLE, FSE-compressed and repeat tables
//   (FSE_readNCount's reads at the end of its input included), the three
//   repeat offsets, the exact end of the bit stream;
// - the content checksum (XXH64), verified.
// The bit reader is libzstd's BIT_DStream_t, field for field, so that bits
// read past the end of a stream are the ones libzstd reads.
//
// zstd_tiff_decode returns 0 or a negative code (ZstdError). No call holds a
// Python object, so ctypes releases the GIL for the whole call.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

typedef uint8_t u8;
typedef uint16_t u16;
typedef uint32_t u32;
typedef uint64_t u64;

enum ZstdError {
  kOk = 0,
  kCorrupt = -1,    // libzstd reports an error
  kShort = -2,      // the strip or tile is not filled
  kWindow = -3,     // a window libzstd will not allocate
  kDictionary = -4, // a frame that needs a dictionary
  kLegacy = -5,     // a v0.5-v0.7 frame
  kChecksum = -6,   // the content checksum does not match
  kMagic = -7,      // not a ZSTD frame
  kSkippable = -8,  // a skippable frame where the data should be
};

constexpr u32 kMagicNumber = 0xFD2FB528u;
constexpr size_t kBlockMax = 128 * 1024;
constexpr u64 kWindowLimit = (1ull << 27) + 1;  // ZSTD_MAXWINDOWSIZE_DEFAULT
constexpr size_t kLitExtra = 1 << 16;           // ZSTD_LITBUFFEREXTRASIZE
constexpr size_t kWild = 32;                    // WILDCOPY_OVERLENGTH
constexpr u64 kUnknown = ~0ull;

inline u64 rd64(const u8* p) {
  u64 v = 0;
  for (int k = 7; k >= 0; --k) v = (v << 8) | p[k];
  return v;
}
inline u32 rd32(const u8* p) {
  return (u32)p[0] | (u32)p[1] << 8 | (u32)p[2] << 16 | (u32)p[3] << 24;
}
inline u32 rd16(const u8* p) { return (u32)p[0] | (u32)p[1] << 8; }
inline u32 rd24(const u8* p) { return rd16(p) | (u32)p[2] << 16; }
inline u32 highbit(u32 v) { return 31 - __builtin_clz(v); }

// ------------------------------------------------------------ XXH64

constexpr u64 P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
              P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
              P5 = 2870177450012600261ull;
inline u64 rotl(u64 x, int r) { return (x << r) | (x >> (64 - r)); }
inline u64 round64(u64 acc, u64 v) { return rotl(acc + v * P2, 31) * P1; }
inline u64 merge64(u64 acc, u64 v) { return (acc ^ round64(0, v)) * P1 + P4; }

u64 xxh64(const u8* p, size_t n) {
  const u8* end = p + n;
  u64 h;
  if (n >= 32) {
    u64 v1 = P1 + P2, v2 = P2, v3 = 0, v4 = -P1;
    for (; p + 32 <= end; p += 32) {
      v1 = round64(v1, rd64(p));
      v2 = round64(v2, rd64(p + 8));
      v3 = round64(v3, rd64(p + 16));
      v4 = round64(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge64(merge64(merge64(merge64(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += (u64)n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ round64(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (u64)rd32(p) * P1, 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (u64)*p * P5, 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------ BIT_DStream_t

enum { kUnfinished, kEndOfBuffer, kCompleted, kOverflow };

struct BitD {
  u64 c = 0;  // bitContainer
  u32 bc = 0; // bitsConsumed
  const u8* ptr = nullptr;
  const u8* start = nullptr;
  const u8* limit = nullptr;
  bool over = false;  // ptr moved to libzstd's static zeros
};

// BIT_initDStream: false where libzstd fails (no byte, no end mark)
bool bit_init(BitD& d, const u8* src, size_t n) {
  d = BitD();
  if (n < 1) return false;
  d.start = src;
  d.limit = src + 8;
  u8 last = src[n - 1];
  d.bc = last ? 8 - highbit(last) : 0;
  if (n >= 8) {
    d.ptr = src + n - 8;
    d.c = rd64(d.ptr);
  } else {
    d.ptr = src;
    for (size_t k = 0; k < n; ++k) d.c |= (u64)src[k] << (8 * k);
    d.bc += (u32)(8 - n) * 8;
  }
  return last != 0;
}

inline size_t look(const BitD& d, u32 nb) {  // BIT_lookBits
  u32 start = (64u - d.bc - nb) & 63;
  return nb ? (size_t)((d.c >> start) & ((1ull << nb) - 1)) : 0;
}
inline size_t look_fast(const BitD& d, u32 nb) {  // BIT_lookBitsFast
  return (size_t)((d.c << (d.bc & 63)) >> ((64 - nb) & 63));
}
inline size_t read_bits(BitD& d, u32 nb) {
  size_t v = look(d, nb);
  d.bc += nb;
  return v;
}
inline size_t read_fast(BitD& d, u32 nb) {
  size_t v = look_fast(d, nb);
  d.bc += nb;
  return v;
}

int reload(BitD& d) {  // BIT_reloadDStream
  if (d.over || d.bc > 64) {
    d.over = true;
    return kOverflow;
  }
  if (d.ptr >= d.limit) {
    d.ptr -= d.bc >> 3;
    d.bc &= 7;
    d.c = rd64(d.ptr);
    return kUnfinished;
  }
  if (d.ptr == d.start) return d.bc < 64 ? kEndOfBuffer : kCompleted;
  u32 nb = d.bc >> 3;
  int r = kUnfinished;
  if (d.ptr - nb < d.start) {
    nb = (u32)(d.ptr - d.start);
    r = kEndOfBuffer;
  }
  d.ptr -= nb;
  d.bc -= nb * 8;
  d.c = rd64(d.ptr);
  return r;
}

int reload_fast(BitD& d) {  // BIT_reloadDStreamFast
  if (d.ptr < d.limit) return kOverflow;
  d.ptr -= d.bc >> 3;
  d.bc &= 7;
  d.c = rd64(d.ptr);
  return kUnfinished;
}

inline bool at_end(const BitD& d) {  // BIT_endOfDStream
  return !d.over && d.ptr == d.start && d.bc == 64;
}

// ------------------------------------------------------------ FSE

struct FseEntry {
  u16 next = 0;
  u8 nb = 0;
  u8 sym = 0;
};

// FSE_readNCount: the header's bytes, or -1
long read_ncount(short* norm, unsigned* max_sv, unsigned* table_log,
                 const u8* hb, size_t hb_size) {
  if (hb_size < 8) {
    u8 buf[8] = {0};
    memcpy(buf, hb, hb_size);
    long r = read_ncount(norm, max_sv, table_log, buf, 8);
    if (r < 0 || (size_t)r > hb_size) return -1;
    return r;
  }
  const u8* const istart = hb;
  const u8* const iend = hb + hb_size;
  const u8* ip = istart;
  unsigned charnum = 0;
  const unsigned max_sv1 = *max_sv + 1;
  int previous0 = 0;
  memset(norm, 0, max_sv1 * sizeof(short));
  u32 bits = rd32(ip);
  int nb = (bits & 0xF) + 5;
  if (nb > 15) return -1;
  bits >>= 4;
  int count_bits = 4;
  *table_log = nb;
  int remaining = (1 << nb) + 1;
  int threshold = 1 << nb;
  nb++;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (count_bits >> 3) <= iend - 4) {
      ip += count_bits >> 3;
      count_bits &= 7;
    } else {
      count_bits -= (int)(8 * (iend - 4 - ip));
      count_bits &= 31;
      ip = iend - 4;
    }
  };
  for (;;) {
    if (previous0) {
      int repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          count_bits -= (int)(8 * (iend - 7 - ip));
          count_bits &= 31;
          ip = iend - 4;
        }
        bits = rd32(ip) >> count_bits;
        repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      }
      charnum += 3 * repeats;
      bits >>= 2 * repeats;
      count_bits += 2 * repeats;
      charnum += bits & 3;
      count_bits += 2;
      if (charnum >= max_sv1) break;
      advance();
      bits = rd32(ip) >> count_bits;
    }
    {
      const int max = (2 * threshold - 1) - remaining;
      int count;
      if ((bits & (threshold - 1)) < (u32)max) {
        count = bits & (threshold - 1);
        count_bits += nb - 1;
      } else {
        count = bits & (2 * threshold - 1);
        if (count >= threshold) count -= max;
        count_bits += nb;
      }
      count--;
      if (count >= 0)
        remaining -= count;
      else
        remaining += count;
      norm[charnum++] = (short)count;
      previous0 = !count;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nb = highbit(remaining) + 1;
        threshold = 1 << (nb - 1);
      }
      if (charnum >= max_sv1) break;
      advance();
      bits = rd32(ip) >> count_bits;
    }
  }
  if (remaining != 1) return -1;
  if (charnum > max_sv1) return -1;
  if (count_bits > 32) return -1;
  *max_sv = charnum - 1;
  ip += (count_bits + 7) >> 3;
  return ip - istart;
}

// FSE decoding table of `norm` (FSE_buildDTable_internal,
// ZSTD_buildFSETable); false where the spread does not come back to 0
bool fse_build(std::vector<FseEntry>& t, const short* norm, unsigned max_sv,
               unsigned table_log, bool* fast) {
  const u32 size = 1u << table_log;
  t.assign(size, FseEntry());
  u32 high = size - 1;
  u16 next[256];
  const short large = (short)(1 << (table_log - 1));
  *fast = true;
  for (unsigned s = 0; s <= max_sv; ++s) {
    if (norm[s] == -1) {
      t[high--].sym = (u8)s;
      next[s] = 1;
    } else {
      if (norm[s] >= large) *fast = false;
      next[s] = (u16)norm[s];
    }
  }
  const u32 step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  u32 pos = 0;
  for (unsigned s = 0; s <= max_sv; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      t[pos].sym = (u8)s;
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  if (pos != 0) return false;
  for (u32 u = 0; u < size; ++u) {
    u32 ns = next[t[u].sym]++;
    u8 nb = (u8)(table_log - highbit(ns));
    t[u].nb = nb;
    t[u].next = (u16)((ns << nb) - size);
  }
  return true;
}

// FSE_decompress_wksp with maxLog 6: the Huffman weights, or -1
long fse_weights(u8* dst, size_t cap, const u8* src, size_t n) {
  short norm[256];
  unsigned max_sv = 255, table_log;
  long h = read_ncount(norm, &max_sv, &table_log, src, n);
  if (h < 0 || table_log > 6) return -1;
  std::vector<FseEntry> t;
  bool fast;
  if (!fse_build(t, norm, max_sv, table_log, &fast)) return -1;
  BitD d;
  if (!bit_init(d, src + h, n - h)) return -1;
  u32 s1 = (u32)read_bits(d, table_log);
  reload(d);
  u32 s2 = (u32)read_bits(d, table_log);
  reload(d);
  if (reload(d) == kOverflow) return -1;
  u8* op = dst;
  u8* const omax = dst + cap;
  u8* const olimit = omax - 3;
  auto get = [&](u32& st) {
    const FseEntry e = t[st];
    st = e.next + (u32)(fast ? read_fast(d, e.nb) : read_bits(d, e.nb));
    return e.sym;
  };
  for (; (reload(d) == kUnfinished) & (op < olimit); op += 4) {
    op[0] = get(s1);
    op[1] = get(s2);
    op[2] = get(s1);
    op[3] = get(s2);
  }
  for (;;) {
    if (op > omax - 2) return -1;
    *op++ = get(s1);
    if (reload(d) == kOverflow) {
      *op++ = get(s2);
      break;
    }
    if (op > omax - 2) return -1;
    *op++ = get(s2);
    if (reload(d) == kOverflow) {
      *op++ = get(s1);
      break;
    }
  }
  return op - dst;
}

// --------------------------------------------------------- Huffman

struct Huf {
  bool x2 = false;
  u32 log = 0;            // the table's dtLog
  std::vector<u8> sym;    // single-symbol entries
  std::vector<u8> nb;
  std::vector<u16> seq;   // double-symbol entries
  std::vector<u8> nb2;
  std::vector<u8> len2;
};

// HUF_readStats: the header's bytes, or -1
long huf_stats(u8* w, u32* nsym, u32* table_log, const u8* src, size_t n) {
  if (!n) return -1;
  size_t isize = src[0], osize;
  if (isize >= 128) {
    osize = isize - 127;
    isize = (osize + 1) / 2;
    if (isize + 1 > n || osize >= 256) return -1;
    for (size_t k = 0; k < osize; k += 2) {
      w[k] = src[1 + k / 2] >> 4;
      w[k + 1] = src[1 + k / 2] & 15;
    }
  } else {
    if (isize + 1 > n) return -1;
    long r = fse_weights(w, 255, src + 1, isize);
    if (r < 0) return -1;
    osize = (size_t)r;
  }
  u32 rank[13] = {0};
  u32 total = 0;
  for (size_t k = 0; k < osize; ++k) {
    if (w[k] > 12) return -1;
    rank[w[k]]++;
    total += (1u << w[k]) >> 1;
  }
  if (!total) return -1;
  u32 tl = highbit(total) + 1;
  if (tl > 12) return -1;
  u32 rest = (1u << tl) - total;
  if ((1u << highbit(rest)) != rest) return -1;
  u32 last = highbit(rest) + 1;
  w[osize] = (u8)last;
  rank[last]++;
  if (rank[1] < 2 || (rank[1] & 1)) return -1;
  *nsym = (u32)osize + 1;
  *table_log = tl;
  return (long)isize + 1;
}

// the canonical single-symbol table at `log` bits of weights scaled up by
// `scale`, in HUF's order (weight, then symbol)
void huf_fill(std::vector<u8>& sym, std::vector<u8>& nb, const u8* w,
              u32 nsym, u32 log, u32 scale) {
  sym.assign(1u << log, 0);
  nb.assign(1u << log, 0);
  u32 pos = 0;
  for (u32 wt = 1; wt <= log; ++wt)
    for (u32 s = 0; s < nsym; ++s) {
      if (!w[s] || w[s] + scale != wt) continue;
      u32 span = 1u << (wt - 1);
      for (u32 k = 0; k < span; ++k) {
        sym[pos + k] = (u8)s;
        nb[pos + k] = (u8)(log + 1 - wt);
      }
      pos += span;
    }
}

// HUF_readDTableX1 / X2: the header's bytes, or -1
long huf_read_table(Huf& h, bool x2, const u8* src, size_t n) {
  u8 w[260];
  u32 nsym, tl;
  long r = huf_stats(w, &nsym, &tl, src, n);
  if (r < 0) return -1;
  h.x2 = x2;
  if (!x2) {  // HUF_rescaleStats to the fast table log, 11
    h.log = tl < 11 ? 11 : tl;
    huf_fill(h.sym, h.nb, w, nsym, h.log, h.log - tl);
    return r;
  }
  h.log = tl <= 11 ? 11 : 12;
  std::vector<u8> sym, nb;
  huf_fill(sym, nb, w, nsym, h.log, h.log - tl);
  const u32 size = 1u << h.log, mask = size - 1;
  h.seq.assign(size, 0);
  h.nb2.assign(size, 0);
  h.len2.assign(size, 0);
  for (u32 i = 0; i < size; ++i) {
    u32 n1 = nb[i];
    u32 j = (i << n1) & mask;
    if (nb[j] <= h.log - n1) {
      h.seq[i] = (u16)(sym[i] | sym[j] << 8);
      h.nb2[i] = (u8)(n1 + nb[j]);
      h.len2[i] = 2;
    } else {
      h.seq[i] = sym[i];
      h.nb2[i] = (u8)n1;
      h.len2[i] = 1;
    }
  }
  return r;
}

inline u8 sym_x1(BitD& d, const Huf& h, u32 log) {
  size_t v = look_fast(d, log);
  d.bc += h.nb[v];
  return h.sym[v];
}
inline void sym_x2(u8*& p, BitD& d, const Huf& h, u32 log) {
  size_t v = look_fast(d, log);
  p[0] = (u8)h.seq[v];
  p[1] = (u8)(h.seq[v] >> 8);
  d.bc += h.nb2[v];
  p += h.len2[v];
}

void stream_x1(u8* p, BitD& d, u8* end, const Huf& h, u32 log) {
  if (end - p > 3) {
    while ((reload(d) == kUnfinished) & (end - p > 3))
      for (int k = 0; k < 4; ++k) *p++ = sym_x1(d, h, log);
  } else {
    reload(d);
  }
  while (p < end) *p++ = sym_x1(d, h, log);
}

void stream_x2(u8* p, BitD& d, u8* end, const Huf& h, u32 log) {
  if (end - p >= 8) {
    if (log <= 11) {
      while ((reload(d) == kUnfinished) & (end - p > 9))
        for (int k = 0; k < 5; ++k) sym_x2(p, d, h, log);
    } else {
      while ((reload(d) == kUnfinished) & (end - p > 7))
        for (int k = 0; k < 4; ++k) sym_x2(p, d, h, log);
    }
  } else {
    reload(d);
  }
  if (end - p >= 2) {
    while ((reload(d) == kUnfinished) & (end - p >= 2)) sym_x2(p, d, h, log);
    while (end - p >= 2) sym_x2(p, d, h, log);
  }
  if (p < end) {  // HUF_decodeLastSymbolX2
    size_t v = look_fast(d, log);
    *p = (u8)h.seq[v];
    if (h.len2[v] == 1) {
      d.bc += h.nb2[v];
    } else if (d.bc < 64) {
      d.bc += h.nb2[v];
      if (d.bc > 64) d.bc = 64;
    }
  }
}

void stream_any(u8* p, BitD& d, u8* end, const Huf& h, u32 log) {
  if (h.x2)
    stream_x2(p, d, end, h, log);
  else
    stream_x1(p, d, end, h, log);
}

bool huf_1x(u8* dst, size_t n_out, const u8* src, size_t n, const Huf& h) {
  BitD d;
  if (!bit_init(d, src, n)) return false;
  stream_any(dst, d, dst + n_out, h, h.log);
  return at_end(d);
}

bool huf_4x_generic(u8* dst, size_t n_out, const u8* src, size_t n,
                    const Huf& h) {
  if (n < 10 || n_out < 6) return false;
  size_t l1 = rd16(src), l2 = rd16(src + 2), l3 = rd16(src + 4);
  size_t l4 = n - (l1 + l2 + l3 + 6);
  if (l4 > n) return false;
  size_t seg = (n_out + 3) / 4;
  u8* const oend = dst + n_out;
  if (3 * seg > n_out) return false;  // opStart4 > oend
  u8* starts[5] = {dst, dst + seg, dst + 2 * seg, dst + 3 * seg, oend};
  u8* op[4] = {starts[0], starts[1], starts[2], starts[3]};
  const u8* s = src + 6;
  size_t lens[4] = {l1, l2, l3, l4};
  BitD d[4];
  for (int k = 0; k < 4; ++k) {
    if (!bit_init(d[k], s, lens[k])) return false;
    s += lens[k];
  }
  if (!h.x2) {
    if (oend - op[3] >= 8) {
      u32 signal = 1;
      while (signal & (op[3] < oend - 3)) {
        for (int k = 0; k < 4; ++k)
          for (int j = 0; j < 4; ++j) *op[k]++ = sym_x1(d[k], h, h.log);
        for (int k = 0; k < 4; ++k)
          signal &= reload_fast(d[k]) == kUnfinished;
      }
    }
  } else {
    if (oend - op[3] >= 8) {
      u32 signal = 1;
      while (signal & (op[3] < oend - 7)) {
        for (int k = 0; k < 4; ++k)
          for (int j = 0; j < 4; ++j) sym_x2(op[k], d[k], h, h.log);
        u32 next = 1;
        for (int k = 0; k < 4; ++k)
          next &= reload_fast(d[k]) == kUnfinished;
        signal = next;
      }
    }
  }
  for (int k = 0; k < 3; ++k)
    if (op[k] > starts[k + 1]) return false;
  for (int k = 0; k < 4; ++k) stream_any(op[k], d[k], starts[k + 1], h, h.log);
  bool end = true;
  for (int k = 0; k < 4; ++k) end &= at_end(d[k]);
  return end;
}

// HUF_decompress4X{1,2}_usingDTable_internal_fast with the C loop: 1 done,
// 0 not taken (the generic decoder runs), -1 an error
int huf_4x_fast(u8* dst, size_t n_out, const u8* src, size_t n,
                const Huf& h) {
  if (n_out == 0) return 0;
  if (n < 10) return -1;
  if (h.log != 11) return 0;
  size_t l1 = rd16(src), l2 = rd16(src + 2), l3 = rd16(src + 4);
  size_t l4 = n - (l1 + l2 + l3 + 6);
  if (l1 < 8 || l2 < 8 || l3 < 8 || l4 < 8) return 0;
  if (l4 > n) return -1;
  const u8* const ilowest = src;
  const u8* iend[4] = {src + 6, src + 6 + l1, src + 6 + l1 + l2,
                       src + 6 + l1 + l2 + l3};
  const u8* ip[4] = {iend[1] - 8, iend[2] - 8, iend[3] - 8, src + n - 8};
  size_t seg = (n_out + 3) / 4;
  u8* const oend = dst + n_out;
  if (3 * seg >= n_out) return 0;
  u8* op[4] = {dst, dst + seg, dst + 2 * seg, dst + 3 * seg};
  u64 bits[4];
  for (int k = 0; k < 4; ++k) {  // HUF_initFastDStream
    u8 last = ip[k][7];
    u32 consumed = last ? 8 - highbit(last) : 0;
    bits[k] = (rd64(ip[k]) | 1) << consumed;
  }
  auto refill = [&](int k) {
    int ctz = __builtin_ctzll(bits[k]);
    ip[k] -= ctz >> 3;
    bits[k] = (rd64(ip[k]) | 1) << (ctz & 7);
  };
  if (!h.x2) {
    for (;;) {
      size_t oiters = (size_t)(oend - op[3]) / 5;
      size_t iiters = (size_t)(ip[0] - ilowest) / 7;
      u8* olimit = op[3] + std::min(oiters, iiters) * 5;
      if (op[3] == olimit) break;
      bool crossed = false;
      for (int k = 1; k < 4; ++k) crossed |= ip[k] < ip[k - 1];
      if (crossed) break;
      do {
        for (int j = 0; j < 5; ++j)
          for (int k = 0; k < 4; ++k) {
            int idx = (int)(bits[k] >> 53);
            bits[k] <<= h.nb[idx] & 0x3F;
            op[k][j] = h.sym[idx];
          }
        for (int k = 0; k < 4; ++k) {
          op[k] += 5;
          refill(k);
        }
      } while (op[3] < olimit);
    }
  } else {
    u8* ends[4] = {op[1], op[2], op[3], oend};
    auto dec = [&](int k) {
      int idx = (int)(bits[k] >> 53);
      op[k][0] = (u8)h.seq[idx];
      op[k][1] = (u8)(h.seq[idx] >> 8);
      bits[k] <<= h.nb2[idx] & 0x3F;
      op[k] += h.len2[idx];
    };
    for (;;) {
      size_t iters = (size_t)(ip[0] - ilowest) / 7;
      for (int k = 0; k < 4; ++k)
        iters = std::min(iters, (size_t)(ends[k] - op[k]) / 10);
      u8* olimit = op[3] + iters * 5;
      if (op[3] == olimit) break;
      bool crossed = false;
      for (int k = 1; k < 4; ++k) crossed |= ip[k] < ip[k - 1];
      if (crossed) break;
      do {
        for (int j = 0; j < 5; ++j)
          for (int k = 0; k < 3; ++k) dec(k);
        dec(3);
        for (int k = 0; k < 4; ++k) {
          dec(3);
          refill(k);
        }
      } while (op[3] < olimit);
    }
  }
  u8* seg_end = dst;
  for (int k = 0; k < 4; ++k) {
    if (seg <= (size_t)(oend - seg_end))
      seg_end += seg;
    else
      seg_end = oend;
    if (op[k] > seg_end) return -1;
    if ((intptr_t)ip[k] < (intptr_t)iend[k] - 8) return -1;
    BitD b;  // HUF_initRemainingDStream
    b.c = rd64(ip[k]);
    b.bc = (u32)__builtin_ctzll(bits[k]);
    b.start = ilowest;
    b.limit = ilowest + 8;
    b.ptr = ip[k];
    stream_any(op[k], b, seg_end, h, 11);
  }
  return 1;
}

bool huf_4x(u8* dst, size_t n_out, const u8* src, size_t n, const Huf& h) {
  int r = huf_4x_fast(dst, n_out, src, n, h);
  if (r) return r > 0;
  return huf_4x_generic(dst, n_out, src, n, h);
}

// HUF_selectDecoder: the double-symbol decoder?
bool select_x2(size_t n_out, size_t n_in) {
  static const u32 table[16][2][2] = {
      {{0, 0}, {1, 1}},         {{0, 0}, {1, 1}},
      {{150, 216}, {381, 119}}, {{170, 205}, {514, 112}},
      {{177, 199}, {539, 110}}, {{197, 194}, {644, 107}},
      {{221, 192}, {735, 107}}, {{256, 189}, {881, 106}},
      {{359, 188}, {1167, 109}}, {{582, 187}, {1570, 114}},
      {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
      {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}},
      {{1377, 185}, {1731, 202}}, {{1412, 185}, {1695, 202}}};
  u32 q = n_in >= n_out ? 15 : (u32)(n_in * 16 / n_out);
  u32 d256 = (u32)(n_out >> 8);
  u32 t0 = table[q][0][0] + table[q][0][1] * d256;
  u32 t1 = table[q][1][0] + table[q][1][1] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// ------------------------------------------------------- sequences

struct SeqEntry {
  u32 base = 0;
  u8 bits = 0;  // nbAdditionalBits
  u8 nb = 0;
  u16 next = 0;
};
struct SeqTable {
  u32 log = 0;
  std::vector<SeqEntry> t;
};

const u32 kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,   8,   9,    10,   11,
                         12, 13, 14, 15, 16, 18, 20, 22,  24,  28,   32,   40,
                         48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
                         32768, 65536};
const u8 kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  1,  1,
                        1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const u32 kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14,  15,  16,
                         17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28,  29,  30,
                         31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59,  67,  83,
                         99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const u8 kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                        2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const short kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                              2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const short kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const short kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                              1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

enum Kind { kLL, kOF, kML };

void seq_entry(SeqEntry& e, int kind, u32 s) {
  if (kind == kLL) {
    e.base = kLLBase[s];
    e.bits = kLLBits[s];
  } else if (kind == kML) {
    e.base = kMLBase[s];
    e.bits = kMLBits[s];
  } else {  // OF_base: (1 << s) - 3 past code 1
    e.base = s < 2 ? s : (1u << s) - 3;
    e.bits = (u8)s;
  }
}

void seq_from_norm(SeqTable& out, int kind, const short* norm, unsigned max_sv,
                   unsigned log) {
  std::vector<FseEntry> t;
  bool fast;
  fse_build(t, norm, max_sv, log, &fast);
  out.log = log;
  out.t.assign(t.size(), SeqEntry());
  for (size_t u = 0; u < t.size(); ++u) {
    seq_entry(out.t[u], kind, t[u].sym);
    out.t[u].nb = t[u].nb;
    out.t[u].next = t[u].next;
  }
}

struct Defaults {
  SeqTable ll, of, ml;
  Defaults() {
    seq_from_norm(ll, kLL, kLLDefault, 35, 6);
    seq_from_norm(of, kOF, kOFDefault, 28, 5);
    seq_from_norm(ml, kML, kMLDefault, 52, 6);
  }
};

const Defaults& defaults() {
  static const Defaults d;
  return d;
}

// ZSTD_buildSeqTable: the bytes read, or -1
long build_seq_table(SeqTable& cur, int kind, int mode, const u8* src,
                     size_t n, bool repeat_ok) {
  static const unsigned kMax[3] = {35, 31, 52}, kMaxLog[3] = {9, 8, 9};
  const Defaults& d = defaults();
  switch (mode) {
    case 1: {  // RLE
      if (!n || src[0] > kMax[kind]) return -1;
      cur.log = 0;
      cur.t.assign(1, SeqEntry());
      seq_entry(cur.t[0], kind, src[0]);
      return 1;
    }
    case 0:  // predefined
      cur = kind == kLL ? d.ll : kind == kOF ? d.of : d.ml;
      return 0;
    case 3:  // repeat
      return repeat_ok ? 0 : -1;
    default: {
      short norm[64];
      unsigned max_sv = kMax[kind], log;
      long h = read_ncount(norm, &max_sv, &log, src, n);
      if (h < 0 || log > kMaxLog[kind]) return -1;
      seq_from_norm(cur, kind, norm, max_sv, log);
      return h;
    }
  }
}

// --------------------------------------------------------- frames

struct Frame {
  u64 window = 0;
  u64 content = kUnknown;  // frame content size
  bool checksum = false;
  u32 dict = 0;
  size_t header = 0;   // bytes
  size_t block_max = 0;
  // entropy, reset at the frame's start
  bool lit_entropy = false, fse_entropy = false;
  Huf huf;
  SeqTable ll, of, ml;
  u64 rep[3] = {1, 4, 8};
  // the content so far, and the position an offset may reach back to
  std::vector<u8> out;
  size_t virt = 0;
};

// ZSTD_getFrameHeader for a frame with the standard magic: kOk, kShort or
// an error
int frame_header(Frame& f, const u8* src, size_t n) {
  if (n < 5) return kShort;
  static const size_t did[4] = {0, 1, 2, 4}, fcs[4] = {0, 2, 4, 8};
  const u8 fhd = src[4];
  const u32 single = (fhd >> 5) & 1, fcs_id = fhd >> 6;
  f.header = 5 + !single + did[fhd & 3] + fcs[fcs_id] + (single && !fcs_id);
  if (n < f.header) return kShort;
  if (fhd & 8) return kCorrupt;
  size_t pos = 5;
  u64 window = 0;
  if (!single) {
    u32 wl = (src[pos] >> 3) + 10;
    if (wl > 31) return kWindow;
    window = 1ull << wl;
    window += (window >> 3) * (src[pos] & 7);
    pos++;
  }
  switch (fhd & 3) {
    case 1: f.dict = src[pos]; pos += 1; break;
    case 2: f.dict = rd16(src + pos); pos += 2; break;
    case 3: f.dict = rd32(src + pos); pos += 4; break;
    default: break;
  }
  switch (fcs_id) {
    case 0: if (single) f.content = src[pos]; break;
    case 1: f.content = rd16(src + pos) + 256; break;
    case 2: f.content = rd32(src + pos); break;
    default: f.content = (u64)rd32(src + pos) | (u64)rd32(src + pos + 4) << 32;
  }
  if (single) window = f.content;
  f.window = window;
  f.block_max = (size_t)std::min<u64>(window, kBlockMax);
  f.checksum = (fhd >> 2) & 1;
  return kOk;
}

// ZSTD_findFrameCompressedSize: the frame's bytes, or 0 where it is not
// whole in `n` bytes or a block type is reserved
size_t frame_size(const Frame& f, const u8* src, size_t n) {
  size_t pos = f.header;
  for (;;) {
    if (n - pos < 3) return 0;
    u32 bh = rd24(src + pos);
    u32 type = (bh >> 1) & 3;
    if (type == 3) return 0;
    size_t size = type == 1 ? 1 : bh >> 3;
    if (3 + size > n - pos) return 0;
    pos += 3 + size;
    if (bh & 1) break;
  }
  if (f.checksum) {
    if (n - pos < 4) return 0;
    pos += 4;
  }
  return pos;
}

// where the literals of a compressed block lie (ZSTD_allocateLiteralsBuffer)
enum LitPlace { kNotInDst, kInDst, kSplit };

// ZSTD_decompressBlock_internal: appends the block's bytes to f.out;
// `cap` is the room libzstd gives the block. Returns kOk or kCorrupt.
int compressed_block(Frame& f, const u8* src, size_t n, size_t cap,
                     bool streaming) {
  const size_t bsm = f.block_max;
  if (n > bsm) return kCorrupt;
  const size_t ews = std::min(bsm, cap);  // expectedWriteSize
  // literals (ZSTD_decodeLiteralsBlock)
  if (n < 2) return kCorrupt;
  std::vector<u8> lits;
  size_t lit_size, used;
  LitPlace place;
  auto locate = [&](size_t size) {
    if (!streaming && cap > bsm + kWild + size + kWild) return kInDst;
    return size <= kLitExtra ? kNotInDst : kSplit;
  };
  const u32 type = src[0] & 3, lhl = (src[0] >> 2) & 3;
  if (type == 3 || type == 2) {  // treeless, compressed
    if (type == 3 && !f.lit_entropy) return kCorrupt;
    if (n < 5) return kCorrupt;
    const u32 lhc = rd32(src);
    size_t lh, csize;
    bool single = false;
    if (lhl < 2) {
      single = !lhl;
      lh = 3;
      lit_size = (lhc >> 4) & 0x3FF;
      csize = (lhc >> 14) & 0x3FF;
    } else if (lhl == 2) {
      lh = 4;
      lit_size = (lhc >> 4) & 0x3FFF;
      csize = lhc >> 18;
    } else {
      lh = 5;
      lit_size = (lhc >> 4) & 0x3FFFF;
      csize = (lhc >> 22) + ((size_t)src[4] << 10);
    }
    if (lit_size > bsm) return kCorrupt;
    if (!single && lit_size < 6) return kCorrupt;
    if (csize + lh > n) return kCorrupt;
    if (ews < lit_size) return kCorrupt;
    place = locate(lit_size);
    lits.assign(lit_size + 64, 0);
    const u8* cs = src + lh;
    bool ok;
    if (type == 3) {
      ok = single ? huf_1x(lits.data(), lit_size, cs, csize, f.huf)
                  : huf_4x(lits.data(), lit_size, cs, csize, f.huf);
    } else if (single) {  // HUF_decompress1X1_DCtx_wksp
      long h = huf_read_table(f.huf, false, cs, csize);
      ok = h >= 0 && (size_t)h < csize &&
           huf_1x(lits.data(), lit_size, cs + h, csize - h, f.huf);
    } else {  // HUF_decompress4X_hufOnly_wksp
      if (lit_size == 0 || csize == 0) return kCorrupt;
      long h = huf_read_table(f.huf, select_x2(lit_size, csize), cs, csize);
      ok = h >= 0 && (size_t)h < csize &&
           huf_4x(lits.data(), lit_size, cs + h, csize - h, f.huf);
    }
    if (!ok) return kCorrupt;
    f.lit_entropy = true;
    used = csize + lh;
  } else {  // raw or RLE
    size_t lh;
    if (lhl == 1) {
      lh = 2;
      if (type == 1 && n < 3) return kCorrupt;
      lit_size = rd16(src) >> 4;
    } else if (lhl == 3) {
      lh = 3;
      if (n < (type == 1 ? 4u : 3u)) return kCorrupt;
      lit_size = rd24(src) >> 4;
    } else {
      lh = 1;
      lit_size = src[0] >> 3;
    }
    if (lit_size > bsm) return kCorrupt;
    if (ews < lit_size) return kCorrupt;
    place = locate(lit_size);
    if (type == 0) {
      if (lh + lit_size + kWild <= n) place = kNotInDst;
      if (lit_size + lh > n) return kCorrupt;
      lits.assign(src + lh, src + lh + lit_size);
      used = lh + lit_size;
    } else {
      lits.assign(lit_size, src[lh]);
      used = lh + 1;
    }
  }
  // the room the sequences may fill (oend)
  size_t limit = place == kInDst ? bsm + kWild : place == kSplit ? ews : cap;
  limit = std::min(limit, cap);
  // sequences (ZSTD_decodeSeqHeaders)
  const u8* ip = src + used;
  const u8* const iend = src + n;
  if (ip >= iend) return kCorrupt;  // MIN_SEQUENCES_SIZE
  int nseq = *ip++;
  if (nseq > 0x7F) {
    if (nseq == 0xFF) {
      if (ip + 2 > iend) return kCorrupt;
      nseq = (int)rd16(ip) + 0x7F00;
      ip += 2;
    } else {
      if (ip >= iend) return kCorrupt;
      nseq = ((nseq - 0x80) << 8) + *ip++;
    }
  }
  std::vector<u8>& out = f.out;
  const size_t base = out.size();
  size_t lit_pos = 0;
  if (nseq == 0) {
    if (ip != iend) return kCorrupt;
  } else {
    if (ip + 1 > iend) return kCorrupt;
    if (*ip & 3) return kCorrupt;
    const int modes[3] = {*ip >> 6, (*ip >> 2) & 3, (*ip >> 4) & 3};
    ip++;
    SeqTable* tables[3] = {&f.ll, &f.ml, &f.of};
    const int kinds[3] = {kLL, kML, kOF};
    for (int order : {0, 2, 1}) {  // LL, OF, ML
      long r = build_seq_table(*tables[order], kinds[order], modes[order], ip,
                               iend - ip, f.fse_entropy);
      if (r < 0) return kCorrupt;
      ip += r;
    }
    if (cap == 0) return kCorrupt;
    f.fse_entropy = true;
    u64 rep[3] = {f.rep[0], f.rep[1], f.rep[2]};
    BitD d;
    if (!bit_init(d, ip, iend - ip)) return kCorrupt;
    u32 sll = (u32)read_bits(d, f.ll.log);
    reload(d);
    u32 sof = (u32)read_bits(d, f.of.log);
    reload(d);
    u32 sml = (u32)read_bits(d, f.ml.log);
    reload(d);
    for (int k = nseq; k > 0; --k) {
      const SeqEntry ll = f.ll.t[sll], ml = f.ml.t[sml], of = f.of.t[sof];
      u64 ml_len = ml.base, ll_len = ll.base, offset;
      const u32 total = ll.bits + ml.bits + of.bits;
      if (of.bits > 1) {
        offset = of.base + read_fast(d, of.bits);
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        const u32 ll0 = ll.base == 0;
        if (of.bits == 0) {
          offset = rep[ll0];
          rep[1] = rep[!ll0];
          rep[0] = offset;
        } else {
          offset = of.base + ll0 + read_fast(d, 1);
          u64 temp = offset == 3 ? rep[0] - 1 : rep[offset];
          temp -= !temp;
          if (offset != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset = temp;
        }
      }
      if (ml.bits) ml_len += read_fast(d, ml.bits);
      if (total >= 31) reload(d);
      if (ll.bits) ll_len += read_fast(d, ll.bits);
      if (k > 1) {
        sll = ll.next + (u32)read_bits(d, ll.nb);
        sml = ml.next + (u32)read_bits(d, ml.nb);
        sof = of.next + (u32)read_bits(d, of.nb);
        reload(d);
      }
      // ZSTD_execSequence
      const size_t done = out.size() - base;
      if (ll_len + ml_len > limit - done) return kCorrupt;
      if (ll_len > lit_size - lit_pos) return kCorrupt;
      out.insert(out.end(), lits.begin() + lit_pos,
                 lits.begin() + lit_pos + ll_len);
      lit_pos += ll_len;
      if (offset > out.size() - f.virt) return kCorrupt;
      size_t from = out.size() - offset;
      for (u64 j = 0; j < ml_len; ++j) out.push_back(out[from + j]);
    }
    if (!at_end(d)) return kCorrupt;
    f.rep[0] = rep[0];
    f.rep[1] = rep[1];
    f.rep[2] = rep[2];
  }
  const size_t last = lit_size - lit_pos;
  if (last > limit - (out.size() - base)) return kCorrupt;
  out.insert(out.end(), lits.begin() + lit_pos, lits.begin() + lit_size);
  return kOk;
}

// ZSTD_decompressFrame over a whole frame of known content size that fits
// the `occ` bytes wanted
int single_pass(Frame& f, const u8* src, size_t occ) {
  size_t pos = f.header;
  for (;;) {
    u32 bh = rd24(src + pos);
    pos += 3;
    const u32 type = (bh >> 1) & 3;
    const size_t size = bh >> 3, cap = occ - f.out.size();
    if (type == 0) {
      if (size > cap) return kCorrupt;
      f.out.insert(f.out.end(), src + pos, src + pos + size);
      pos += size;
    } else if (type == 1) {
      if (size > cap) return kCorrupt;
      f.out.insert(f.out.end(), size, src[pos]);
      pos += 1;
    } else {
      int r = compressed_block(f, src + pos, size, cap, false);
      if (r) return r;
      pos += size;
    }
    if (bh & 1) break;
  }
  if (f.out.size() != f.content) return kCorrupt;
  if (f.checksum &&
      (u32)xxh64(f.out.data(), f.out.size()) != rd32(src + pos))
    return kChecksum;
  return kOk;
}

// ZSTD_decompressStream in buffered mode, called as libtiff calls it: the
// frame's units in turn until the frame ends, the input ends, an error, or
// a unit's bytes no longer fit the `occ` wanted. Returns kOk when the
// output is full.
int stream_frame(Frame& f, const u8* src, size_t n, size_t occ) {
  u64 window = std::max<u64>(f.window, 1024);
  if (window > kWindowLimit) return kWindow;
  const u64 bsm = f.block_max;
  const u64 block = std::min<u64>(std::min<u64>(window, kBlockMax), bsm);
  const u64 ring = std::min<u64>(f.content, window + 2 * block + 2 * kWild);
  size_t pos = f.header, seg = 0, seg_start = 0;
  enum { kHeader, kBody, kCheck } stage = kHeader;
  u32 type = 0;
  bool last = false, done = false;
  size_t expected = 0, rle_size = 0;
  for (;;) {
    if (stage == kHeader) {
      if (n - pos < 3) break;
      const u32 bh = rd24(src + pos);
      type = (bh >> 1) & 3;
      last = bh & 1;
      if (type == 3) return kCorrupt;
      rle_size = bh >> 3;
      expected = type == 1 ? 1 : bh >> 3;
      if (expected > bsm) return kCorrupt;
      pos += 3;
      if (expected) {
        stage = kBody;
      } else if (last) {
        if (!f.checksum) break;  // the frame's end
        stage = kCheck;
      }
      continue;
    }
    if (stage == kCheck) {
      if (n - pos < 4) break;
      if ((u32)xxh64(f.out.data(), f.out.size()) != rd32(src + pos))
        return kChecksum;
      break;
    }
    const size_t cap = (size_t)(ring - seg), before = f.out.size();
    if (type == 0) {  // a raw block, in the pieces the input holds
      const size_t chunk = std::min(n - pos, expected);
      if (chunk == 0) break;
      if (chunk > cap) return kCorrupt;
      f.out.insert(f.out.end(), src + pos, src + pos + chunk);
      pos += chunk;
      expected -= chunk;
    } else {
      if (n - pos < expected) break;  // loaded, waiting for more input
      if (type == 1) {
        if (rle_size > cap) return kCorrupt;
        f.out.insert(f.out.end(), rle_size, src[pos]);
      } else {
        int r = compressed_block(f, src + pos, expected, cap, true);
        if (r) return r;
      }
      pos += expected;
      expected = 0;
    }
    const size_t produced = f.out.size() - before;
    if (produced > bsm) return kCorrupt;
    if (expected == 0) {
      if (last) {
        if (f.content != kUnknown && f.out.size() != f.content)
          return kCorrupt;
        stage = kCheck;
        done = !f.checksum;
      } else {
        stage = kHeader;
      }
    }
    if (produced) {
      if (before >= occ || f.out.size() > occ) break;  // the flush stops
      seg += produced;
      if (ring < f.content && seg + bsm > ring) {  // back to the start
        f.virt = seg_start;
        seg_start = f.out.size();
        seg = 0;
      }
    }
    if (done) break;  // the frame's end
  }
  return f.out.size() >= occ ? kOk : kShort;
}

}  // namespace

extern "C" {

// `occ` bytes of the ZSTD data `src` of a TIFF strip or tile into `out`, as
// libtiff's ZSTDDecode reads them with libzstd: 0, or a ZstdError.
int zstd_tiff_decode(const u8* src, long n, u8* out, long occ) {
  if (n < 0 || occ <= 0) return kShort;
  const size_t size = (size_t)n, want = (size_t)occ;
  if (size < 5) {  // the magic's first bytes are checked, then more wanted
    u8 head[4] = {0x28, 0xB5, 0x2F, 0xFD};
    memcpy(head, src, std::min<size_t>(size, 4));
    if (rd32(head) == kMagicNumber) return kShort;
    u8 skip[4] = {0x50, 0x2A, 0x4D, 0x18};
    memcpy(skip, src, std::min<size_t>(size, 4));
    return (rd32(skip) & 0xFFFFFFF0u) == 0x184D2A50u ? kShort : kMagic;
  }
  const u32 magic = rd32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) return kSkippable;
  if (magic >= 0xFD2FB525u && magic <= 0xFD2FB527u) return kLegacy;
  if (magic != kMagicNumber) return kMagic;
  Frame f;
  int r = frame_header(f, src, size);
  if (r) return r;
  f.out.reserve(want + kBlockMax + 64);
  if (f.content != kUnknown && want >= f.content &&
      frame_size(f, src, size)) {
    if (f.dict) return kDictionary;
    r = single_pass(f, src, want);
    if (r) return r;
    if (f.out.size() < want) return kShort;  // the frame ends early
  } else {
    if (f.dict) return kDictionary;
    r = stream_frame(f, src, size, want);
    if (r) return r;
  }
  memcpy(out, f.out.data(), want);
  return kOk;
}

}  // extern "C"
