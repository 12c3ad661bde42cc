// TIFF strip and tile decoders on the host: LZW (compression 5) and
// PackBits (compression 32773), for mapping_tpu_torch/utils/tiff.py.
//
// The JAX package reads TIFF tiles through Pillow, which hands compressed
// strips and tiles to libtiff (tif_lzw.c, tif_packbits.c). These follow
// libtiff 4.7's decoders on every input, corrupt ones included:
// - LZW, new style: MSB-first codes of 9 to 12 bits, Clear 256, EOI 257,
//   the first free entry 258, the code width growing one code early (after
//   entry 2^n - 2 is added); the decode stops once `want` bytes are out
//   (the rest of a string that overruns them is dropped), at EOI, or where
//   fewer bits than a code's width are left (read as EOI); a code past the
//   next free entry, a code above 255 right after Clear, or a table past
//   its 5,120 entries is an error; fewer than `want` bytes is an error.
// - PackBits: a count byte n, then n + 1 literal bytes (0 <= n <= 127) or
//   one byte repeated 1 - n times (-127 <= n <= -1); -128 is skipped; a run
//   past `want` is cut; missing bytes end the decode; fewer than `want`
//   bytes is an error.
// Each returns 0 or a negative error code. No call holds a Python object,
// so ctypes releases the GIL for the whole call.

#include <cstdint>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kMaxBits = 12;
constexpr int kTable = (1 << kMaxBits) + 1024;  // libtiff's CSIZE

struct Entry {
  int32_t prev;    // the entry this one extends, -1 for a single byte
  uint8_t last;    // its last byte
  uint8_t first;   // its first byte
  int32_t length;  // its length in bytes, 0 where not filled
};

}  // namespace

extern "C" {

int tiff_lzw_decode(const uint8_t* src, long n, uint8_t* out, long want) {
  std::vector<Entry> table(kTable);
  for (int c = 0; c < 256; ++c) table[c] = {-1, (uint8_t)c, (uint8_t)c, 1};
  long pos = 0, done = 0;
  uint32_t data = 0;
  int bits = 0, width = 9, next = kFirst, prev = -1;
  auto read = [&](int& code) {
    // libtiff's GetNextCode: EOI where fewer bits than a code are left
    while (bits < width) {
      if (pos >= n) return false;
      data = (data << 8) | src[pos++];
      bits += 8;
    }
    code = (int)((data >> (bits - width)) & ((1u << width) - 1));
    bits -= width;
    return true;
  };
  // writes entry `e`'s string, cut at `want`
  auto emit = [&](int e) {
    long len = table[e].length;
    long keep = len < want - done ? len : want - done;
    for (long k = len - 1; k >= 0; --k, e = table[e].prev)
      if (k < keep) out[done + k] = table[e].last;
    done += keep;
  };
  while (done < want) {
    int code;
    if (!read(code) || code == kEoi) break;
    if (code == kClear) {
      do {
        next = kFirst;
        width = 9;
        if (!read(code)) code = kEoi;
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return -1;  // "Corrupted LZW table"
      out[done++] = (uint8_t)code;
      prev = code;
      continue;
    }
    if (prev < 0) return -1;  // a stream that does not begin with Clear
    if (code > next) return -2;  // past the next free entry
    if (next >= kTable) return -3;
    Entry& add = table[next];
    add.prev = prev;
    add.first = table[prev].first;
    add.length = table[prev].length + 1;
    add.last = code < next ? table[code].first : add.first;
    if (++next > (1 << width) - 2 && width < kMaxBits) ++width;
    emit(code);
    prev = code;
  }
  return done == want ? 0 : -4;
}

int tiff_packbits_decode(const uint8_t* src, long n, uint8_t* out,
                         long want) {
  long pos = 0, done = 0;
  while (pos < n && done < want) {
    int count = (int8_t)src[pos++];
    if (count == -128) continue;
    if (count < 0) {
      long run = 1 - count;
      if (run > want - done) run = want - done;
      if (pos >= n) break;
      uint8_t b = src[pos++];
      for (long k = 0; k < run; ++k) out[done++] = b;
    } else {
      long run = count + 1;
      if (run > want - done) run = want - done;
      if (n - pos < run) break;
      for (long k = 0; k < run; ++k) out[done++] = src[pos++];
    }
  }
  return done == want ? 0 : -4;
}

}  // extern "C"
