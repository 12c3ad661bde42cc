// WebP bitstream decoders on the host, for mapping_tpu_torch/utils/webp.py:
// lossless VP8L, lossy VP8 (key frames) to RGB, and the ALPH chunk's alpha
// plane. The JAX package reads WebP through Pillow, which decodes every
// file with libwebp's WebPAnimDecoder (RGBA, not premultiplied, fancy
// upsampling). These follow libwebp 1.6's decoders byte for byte:
//
// - VP8L: the LSB-first bit reader (past the data it reads zeros and marks
//   the end of stream once more than max(64, 8 x size) bits are consumed;
//   any such overrun fails the image), prefix codes (simple codes and
//   code-length codes in the order 17, 18, 0, 1, ...; an all-zero, an
//   incomplete or an over-subscribed code fails, a code with one used
//   symbol reads with zero bits), meta prefix codes (groups in the red
//   and green bytes of the entropy image), LZ77 with the 120-entry
//   distance map and the colour cache (hash 0x1e35a7bd), and the four
//   inverse transforms in reverse order of reading: predictor (14 modes,
//   14 and 15 read as mode 0; the top-right of the last column is the
//   first pixel of the current row), cross-colour, subtract-green and
//   colour indexing (1, 2, 4 or 8 bits a pixel; entries past the palette
//   are 0). A transform type read twice, cache bits outside 1..11 or a
//   copy outside the image fails.
// - VP8: the boolean decoder of libwebp (bit_reader_inl_utils.h: past the
//   data it shifts in one zero byte and flags end of file; a flagged
//   partition fails the image after the macroblock or the mode row that
//   read it), segment, filter, quantiser and probability headers
//   (dequantiser: y2 dc x 2, y2 ac x 155 / 100 at least 8, uv dc index
//   capped at 117), 1 to 8 token partitions (the last runs to the end of
//   the chunk's padded payload), intra modes (4x4 modes through
//   kBModesProba), tokens, the inverse WHT and DCT (20091, 35468), intra
//   prediction on unfiltered pixels (127 above the frame, 129 left of it;
//   the 4x4 blocks of the right column take the macroblock's above-right
//   pixels, the frame's right edge repeating the pixel above), the simple
//   and the normal loop filter over the whole frame in macroblock order
//   (levels per segment and per mode, no filtering where the frame's
//   level is 0, inner edges skipped on macroblocks with no coefficient
//   that are not 4x4-predicted), the crop to the frame size, then
//   dsp/upsampling.c's fancy upsampler (two rounding stages: diag_12 and
//   diag_03, then averaged with the near sample; first and last column
//   (3 near + far + 2) >> 2; the top row mirrors its chroma row, as does
//   an even height's last row) into dsp/yuv.h's 14-bit VP8YUVToR/G/B.
// - ALPH: header byte (method 0 raw or 1 lossless, filter 0-3,
//   preprocessing 0-1, reserved bits 0), a raw plane at least w x h bytes
//   or a headerless VP8L stream whose green is the alpha (its overrun on
//   the last symbol is let pass where libwebp's 8-bit path decodes it:
//   colour indexing the only transform, no colour cache and one-symbol
//   red, blue and alpha codes), then unfiltering (horizontal, vertical,
//   gradient with its clip to 0..255).
//
// Each entry point returns 0 or a negative error code (kept in step with
// utils/webp.py _ERRORS). No call holds a Python object, so ctypes
// releases the GIL for the whole call.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum {
  kOk = 0,
  kTruncated = -1,      // the data ran out
  kBadCode = -2,        // an invalid prefix code or code-length code
  kBadTransform = -3,   // a VP8L transform read twice
  kBadCacheBits = -4,   // colour cache bits outside 1..11
  kBadCopy = -5,        // an LZ77 copy outside the image
  kBadAlphaHeader = -6, // ALPH header byte
  kBadPartitions = -7,  // VP8 partition sizes
  kNoMemory = -8,
};

// ======================================================================
// VP8L
// ======================================================================

class LBits {
 public:
  LBits(const uint8_t* buf, size_t len)
      : buf_(buf), len_(len),
        limit_(std::max<uint64_t>(64, 8 * (uint64_t)len)) {}

  // the next n <= 25 bits, LSB first, zeros past the data
  uint32_t peek(int n) const {
    uint64_t byte = pos_ >> 3;
    uint64_t v = 0;
    if (byte + 8 <= len_) {  // one little-endian load
      for (int i = 0; i < 8; ++i) v |= (uint64_t)buf_[byte + i] << (8 * i);
    } else {
      for (int i = 0; byte + i < len_; ++i)
        v |= (uint64_t)buf_[byte + i] << (8 * i);
    }
    return (uint32_t)(v >> (pos_ & 7)) & ((1u << n) - 1);
  }
  void skip(int n) {
    pos_ += n;
    if (pos_ > limit_) eos_ = true;
  }
  uint32_t bits(int n) {  // libwebp's VP8LReadBits: 0 once at the end
    if (eos_) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
  bool eos() const { return eos_; }

 private:
  const uint8_t* buf_;
  size_t len_;
  uint64_t limit_;
  uint64_t pos_ = 0;
  bool eos_ = false;
};

constexpr int kMaxCodeLength = 15;
constexpr int kFastBits = 8;

struct Code {
  int single = -1;  // the symbol of a code with one used symbol (0 bits)
  int count[kMaxCodeLength + 1] = {0};
  // per length: the first canonical code and its index in `sorted`
  int first_code[kMaxCodeLength + 1] = {0};
  int first_index[kMaxCodeLength + 1] = {0};
  std::vector<uint16_t> sorted;  // symbols by (length, symbol)
  uint16_t fast[1 << kFastBits] = {0};  // symbol | length << 12, 0: longer
  int zero_bits() const { return single >= 0; }
};

// libwebp's BuildHuffmanTable rules; false for an invalid code
bool build_code(Code& c, const int* lengths, int n) {
  int count[kMaxCodeLength + 1] = {0};
  int used = 0, last = -1;
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return false;
    ++count[lengths[s]];
    if (lengths[s]) {
      ++used;
      last = s;
    }
  }
  if (used == 0) return false;
  c = Code();
  if (used == 1) {
    c.single = last;
    return true;
  }
  int open = 1;
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    open = open * 2 - count[len];
    if (open < 0) return false;
  }
  if (open != 0) return false;
  int offset[kMaxCodeLength + 2] = {0};
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    c.count[len] = count[len];
    offset[len + 1] = offset[len] + count[len];
  }
  c.sorted.assign(used, 0);
  {
    int next[kMaxCodeLength + 2];
    std::memcpy(next, offset, sizeof(next));
    for (int s = 0; s < n; ++s)
      if (lengths[s]) c.sorted[next[lengths[s]]++] = (uint16_t)s;
  }
  // canonical codes, read MSB of the code first: fill the fast table
  int code = 0, k = 0;
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    c.first_code[len] = code;
    c.first_index[len] = k;
    for (int i = 0; i < count[len]; ++i, ++code, ++k) {
      if (len > kFastBits) continue;
      int rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
      for (int fill = rev; fill < (1 << kFastBits); fill += 1 << len)
        c.fast[fill] = (uint16_t)(c.sorted[k] | (len << 12));
    }
    code <<= 1;
  }
  return true;
}

int read_symbol(const Code& c, LBits& br) {
  if (c.single >= 0) return c.single;
  const uint32_t bits = br.peek(kMaxCodeLength);
  const uint16_t f = c.fast[bits & ((1 << kFastBits) - 1)];
  if (f >> 12) {
    br.skip(f >> 12);
    return f & 0xfff;
  }
  // no code of kFastBits bits or fewer starts so: walk the longer ones
  int code = 0;
  for (int len = 1; len <= kFastBits; ++len) code = code << 1 | ((bits >> (len - 1)) & 1);
  for (int len = kFastBits + 1; len <= kMaxCodeLength; ++len) {
    code = code << 1 | ((bits >> (len - 1)) & 1);
    const int offset = code - c.first_code[len];
    if (offset < c.count[len]) {
      br.skip(len);
      return c.sorted[c.first_index[len] + offset];
    }
  }
  return 0;  // not reached for a complete code
}

constexpr int kNumLiteral = 256;
constexpr int kNumLength = 24;
constexpr int kNumDistance = 40;
constexpr int kCodeLengthCodes = 19;
constexpr uint8_t kCodeLengthOrder[kCodeLengthCodes] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

// the distance map: (dy << 4) | (8 - dx) for the 120 short codes
constexpr uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a,
    0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a,
    0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03,
    0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c,
    0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b,
    0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
    0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41,
    0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f,
    0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

int prefix_value(int symbol, LBits& br) {  // GetCopyDistance / Length
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + (int)br.bits(extra) + 1;
}

int plane_to_distance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int d = kCodeToPlane[plane_code - 1];
  const int dist = (d >> 4) * xsize + (8 - (d & 0xf));
  return dist >= 1 ? dist : 1;
}

struct Group {
  Code codes[5];  // green + length + cache, red, blue, alpha, distance
};

struct Transform {
  int type;
  int bits = 0;
  int xsize;
  std::vector<uint32_t> data;
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1,
                                          uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = (int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) -
                  (int)((c2 >> s) & 0xff);
    out |= clip255((uint32_t)v) << s;
  }
  return out;
}
inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1,
                                          uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (int)((ave >> s) & 0xff), b = (int)((c2 >> s) & 0xff);
    out |= clip255((uint32_t)(a + (a - b) / 2)) << s;
  }
  return out;
}
inline int sub3(int a, int b, int c) {
  return std::abs(b - c) - std::abs(a - c);
}
inline uint32_t select_pixel(uint32_t a, uint32_t b, uint32_t c) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8)
    pa_minus_pb += sub3((a >> s) & 0xff, (b >> s) & 0xff, (c >> s) & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}

uint32_t predict(int mode, const uint32_t* px, int i, int width) {
  const uint32_t L = px[i - 1], T = px[i - width], TL = px[i - width - 1],
                 TR = px[i - width + 1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pixel(T, L, TL);
    case 12: return clamped_add_subtract_full(L, T, TL);
    case 13: return clamped_add_subtract_half(L, T, TL);
    default: return 0xff000000u;
  }
}

inline int color_delta(int8_t pred, int8_t color) {
  return ((int)pred * color) >> 5;
}

class LosslessDecoder {
 public:
  LosslessDecoder(const uint8_t* src, size_t n) : br_(src, n) {}

  // the VP8L header (signature, size, alpha bit, version): 0 or an error
  int header(int* w, int* h) {
    if (br_.bits(8) != 0x2f) return kBadCode;
    *w = (int)br_.bits(14) + 1;
    *h = (int)br_.bits(14) + 1;
    br_.bits(1);
    if (br_.bits(3) != 0) return kBadCode;
    return br_.eos() ? kTruncated : kOk;
  }

  // the level-0 image of w x h pixels as ARGB; `alpha` lets the stream
  // overrun on its last symbol where libwebp's 8-bit alpha path would
  int image(int w, int h, uint32_t* out, bool alpha) {
    alpha_ = alpha;
    std::vector<uint32_t> px;
    int rc = stream(w, h, true, px);
    if (rc) return rc;
    std::memcpy(out, px.data(), sizeof(uint32_t) * (size_t)w * h);
    return kOk;
  }

 private:
  LBits br_;
  std::vector<Transform> transforms_;
  unsigned seen_ = 0;
  bool alpha_ = false;

  int code_lengths(const int* cl_lengths, int num_symbols, int* lengths) {
    Code cl;
    if (!build_code(cl, cl_lengths, kCodeLengthCodes)) return kBadCode;
    int max_symbol = num_symbols;
    if (br_.bits(1)) {
      const int nbits = 2 + 2 * (int)br_.bits(3);
      max_symbol = 2 + (int)br_.bits(nbits);
      if (max_symbol > num_symbols) return kBadCode;
    }
    int prev = 8;
    for (int symbol = 0; symbol < num_symbols;) {
      if (max_symbol-- == 0) break;
      const int len = read_symbol(cl, br_);
      if (len < 16) {
        lengths[symbol++] = len;
        if (len) prev = len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int slot = len - 16;
        const int repeat = (int)br_.bits(kExtra[slot]) + kOffset[slot];
        if (symbol + repeat > num_symbols) return kBadCode;
        const int v = len == 16 ? prev : 0;
        for (int r = 0; r < repeat; ++r) lengths[symbol++] = v;
      }
    }
    return kOk;
  }

  int read_code(int alphabet, Code& out) {
    std::vector<int> lengths(alphabet, 0);
    if (br_.bits(1)) {  // simple code
      const int num = (int)br_.bits(1) + 1;
      const int first_bits = br_.bits(1) ? 8 : 1;
      int s = (int)br_.bits(first_bits);
      if (s < alphabet) lengths[s] = 1;
      if (num == 2) {
        s = (int)br_.bits(8);
        if (s < alphabet) lengths[s] = 1;
      }
    } else {
      int cl[kCodeLengthCodes] = {0};
      const int num = (int)br_.bits(4) + 4;
      for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = (int)br_.bits(3);
      const int rc = code_lengths(cl, alphabet, lengths.data());
      if (rc) return rc;
    }
    if (br_.eos()) return kTruncated;
    return build_code(out, lengths.data(), alphabet) ? kOk : kBadCode;
  }

  int transform(int* xsize, int ysize) {
    Transform t;
    t.type = (int)br_.bits(2);
    if (seen_ & (1u << t.type)) return kBadTransform;
    seen_ |= 1u << t.type;
    t.xsize = *xsize;
    if (t.type == 0 || t.type == 1) {  // predictor, cross-colour
      t.bits = (int)br_.bits(3) + 2;
      const int rc = stream(subsample(t.xsize, t.bits),
                            subsample(ysize, t.bits), false, t.data);
      if (rc) return rc;
    } else if (t.type == 3) {  // colour indexing
      const int colors = (int)br_.bits(8) + 1;
      t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> palette;
      const int rc = stream(colors, 1, false, palette);
      if (rc) return rc;
      const int final_colors = 1 << (8 >> t.bits);
      t.data.assign(final_colors, 0);
      t.data[0] = palette[0];
      for (int i = 1; i < colors; ++i)
        t.data[i] = add_pixels(palette[i], t.data[i - 1]);
    }
    transforms_.push_back(std::move(t));
    return kOk;
  }

  int stream(int xsize, int ysize, bool level0, std::vector<uint32_t>& out) {
    if (level0)
      while (br_.bits(1)) {
        const int rc = transform(&xsize, ysize);
        if (rc) return rc;
      }
    int cache_bits = 0;
    if (br_.bits(1)) {
      cache_bits = (int)br_.bits(4);
      if (cache_bits < 1 || cache_bits > 11) return kBadCacheBits;
    }
    int meta_bits = 0, meta_xsize = 0, num_groups = 1;
    std::vector<uint32_t> meta;
    if (level0 && br_.bits(1)) {
      meta_bits = (int)br_.bits(3) + 2;
      meta_xsize = subsample(xsize, meta_bits);
      const int rc = stream(meta_xsize, subsample(ysize, meta_bits), false,
                            meta);
      if (rc) return rc;
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        num_groups = std::max(num_groups, (int)m + 1);
      }
    }
    if (br_.eos()) return kTruncated;
    // groups the entropy image uses are kept; the others are read and
    // checked only (libwebp's mapping)
    std::vector<int> slot(num_groups, meta.empty() ? 0 : -1);
    int used = meta.empty() ? 1 : 0;
    for (uint32_t m : meta)
      if (slot[m] < 0) slot[m] = used++;
    std::vector<Group> groups(used);
    Group scratch;
    const int alphabets[5] = {kNumLiteral + kNumLength +
                                  (cache_bits ? 1 << cache_bits : 0),
                              kNumLiteral, kNumLiteral, kNumLiteral,
                              kNumDistance};
    for (int g = 0; g < num_groups; ++g) {
      Group& dst = slot[g] >= 0 ? groups[slot[g]] : scratch;
      for (int j = 0; j < 5; ++j) {
        const int rc = read_code(alphabets[j], dst.codes[j]);
        if (rc) return rc;
      }
    }
    for (uint32_t& m : meta) m = slot[m];
    out.assign((size_t)xsize * ysize, 0);
    bool lenient = false;
    if (level0 && alpha_ && cache_bits == 0 && transforms_.size() == 1 &&
        transforms_[0].type == 3) {
      lenient = true;
      for (const Group& g : groups)
        lenient = lenient && g.codes[1].zero_bits() &&
                  g.codes[2].zero_bits() && g.codes[3].zero_bits();
    }
    int rc = data(out.data(), xsize, ysize, groups, meta, meta_bits,
                  meta_xsize, cache_bits, lenient);
    if (rc) return rc;
    if (level0) inverse_transforms(out, ysize);
    return kOk;
  }

  int data(uint32_t* px, int width, int height, const std::vector<Group>& groups,
           const std::vector<uint32_t>& meta, int meta_bits, int meta_xsize,
           int cache_bits, bool lenient) {
    const size_t total = (size_t)width * height;
    std::vector<uint32_t> cache(cache_bits ? 1u << cache_bits : 0);
    const int cache_shift = 32 - cache_bits;
    size_t pos = 0, cached = 0;
    int col = 0, row = 0;
    auto insert = [&](size_t upto) {
      for (; cached < upto; ++cached)
        cache[(px[cached] * 0x1e35a7bdu) >> cache_shift] = px[cached];
    };
    while (pos < total) {
      const Group& g = meta.empty()
          ? groups[0]
          : groups[meta[(size_t)(row >> meta_bits) * meta_xsize +
                        (col >> meta_bits)]];
      const int code = read_symbol(g.codes[0], br_);
      if (br_.eos() && !lenient) return kTruncated;
      if (code < kNumLiteral) {
        const uint32_t red = read_symbol(g.codes[1], br_);
        const uint32_t blue = read_symbol(g.codes[2], br_);
        const uint32_t alpha = read_symbol(g.codes[3], br_);
        if (br_.eos() && !lenient) return kTruncated;
        px[pos++] = (alpha << 24) | (red << 16) | ((uint32_t)code << 8) | blue;
        if (++col >= width) {
          col = 0;
          ++row;
        }
      } else if (code < kNumLiteral + kNumLength) {
        const int length = prefix_value(code - kNumLiteral, br_);
        const int dist_symbol = read_symbol(g.codes[4], br_);
        const int dist =
            plane_to_distance(width, prefix_value(dist_symbol, br_));
        if (br_.eos() && !lenient) return kTruncated;
        if (pos < (size_t)dist || total - pos < (size_t)length)
          return kBadCopy;
        for (int i = 0; i < length; ++i) px[pos + i] = px[pos + i - dist];
        pos += length;
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
      } else if (code < kNumLiteral + kNumLength + (int)cache.size()) {
        insert(pos);
        px[pos++] = cache[code - kNumLiteral - kNumLength];
        if (++col >= width) {
          col = 0;
          ++row;
        }
      } else {
        return kBadCode;
      }
      if (br_.eos()) {  // lenient: only past the last symbol
        if (pos < total) return kTruncated;
        break;
      }
      if (!cache.empty()) insert(pos);
    }
    return br_.eos() && !lenient ? kTruncated : kOk;
  }

  void inverse_transforms(std::vector<uint32_t>& px, int height) {
    for (int k = (int)transforms_.size() - 1; k >= 0; --k) {
      const Transform& t = transforms_[k];
      const int width = t.xsize;
      if (t.type == 0) {  // predictor
        const int tiles = subsample(width, t.bits);
        uint32_t* p = px.data();
        p[0] = add_pixels(p[0], 0xff000000u);
        for (int x = 1; x < width; ++x) p[x] = add_pixels(p[x], p[x - 1]);
        for (int y = 1; y < height; ++y) {
          const uint32_t* modes = &t.data[(size_t)(y >> t.bits) * tiles];
          const size_t row = (size_t)y * width;
          p[row] = add_pixels(p[row], p[row - width]);
          for (int x = 1; x < width; ++x) {
            const int mode = (modes[x >> t.bits] >> 8) & 0xf;
            p[row + x] = add_pixels(p[row + x],
                                    predict(mode, p, (int)(row + x), width));
          }
        }
      } else if (t.type == 1) {  // cross-colour
        const int tiles = subsample(width, t.bits);
        for (int y = 0; y < height; ++y) {
          const uint32_t* codes = &t.data[(size_t)(y >> t.bits) * tiles];
          for (int x = 0; x < width; ++x) {
            const uint32_t c = codes[x >> t.bits];
            const int8_t g2r = (int8_t)(c & 0xff), g2b = (int8_t)(c >> 8),
                         r2b = (int8_t)(c >> 16);
            uint32_t& a = px[(size_t)y * width + x];
            const int8_t green = (int8_t)(a >> 8);
            int red = (a >> 16) & 0xff, blue = a & 0xff;
            red = (red + color_delta(g2r, green)) & 0xff;
            blue += color_delta(g2b, green);
            blue = (blue + color_delta(r2b, (int8_t)red)) & 0xff;
            a = (a & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
          }
        }
      } else if (t.type == 2) {  // subtract green
        for (uint32_t& a : px) {
          const uint32_t g = (a >> 8) & 0xff;
          const uint32_t rb = ((a & 0x00ff00ffu) + ((g << 16) | g)) &
                              0x00ff00ffu;
          a = (a & 0xff00ff00u) | rb;
        }
      } else {  // colour indexing
        const int packed = subsample(width, t.bits);
        const int per_byte_bits = 8 >> t.bits;
        const uint32_t mask = (1u << per_byte_bits) - 1;
        std::vector<uint32_t> out((size_t)width * height);
        for (int y = 0; y < height; ++y) {
          const uint32_t* src = &px[(size_t)y * packed];
          uint32_t* dst = &out[(size_t)y * width];
          uint32_t bits = 0;
          for (int x = 0; x < width; ++x) {
            if ((x & ((1 << t.bits) - 1)) == 0) bits = (*src++ >> 8) & 0xff;
            dst[x] = t.data[bits & mask];
            bits >>= per_byte_bits;
          }
        }
        px.swap(out);
      }
    }
  }
};

// ======================================================================
// VP8
// ======================================================================

class BoolReader {
 public:
  void init(const uint8_t* buf, size_t n) {
    buf_ = buf;
    end_ = buf + n;
    range_ = 255 - 1;
    value_ = 0;
    bits_ = -8;
    eof_ = false;
    load();
  }
  int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * (uint32_t)prob) >> 8;
    const uint32_t value = (uint32_t)(value_ >> pos);
    const int bit = value > split;
    if (bit) {
      range -= split;
      value_ -= (uint64_t)(split + 1) << pos;
    } else {
      range = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return bit;
  }
  int value(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value(n);
    return value(1) ? -v : v;
  }
  int with_sign(int v) {  // VP8GetSigned
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = range_ >> 1;
    const uint32_t value = (uint32_t)(value_ >> pos);
    const int32_t mask = (int32_t)(split - value) >> 31;
    bits_ -= 1;
    range_ += (uint32_t)mask;
    range_ |= 1;
    value_ -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  bool eof() const { return eof_; }

 private:
  // VP8LoadNewBytes: 56 bits at once while 8 bytes remain, then
  // VP8LoadFinalBytes one byte at a time (end of file is flagged at the
  // same bit either way: the first load with no byte left)
  void load() {
    if (end_ - buf_ >= 8) {
      uint64_t in = 0;
      for (int i = 0; i < 7; ++i) in = (in << 8) | buf_[i];
      buf_ += 7;
      value_ = (value_ << 56) | in;
      bits_ += 56;
    } else if (buf_ < end_) {
      bits_ += 8;
      value_ = (uint64_t)(*buf_++) | (value_ << 8);
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  int bits_ = 0;
  uint32_t range_ = 0;
  bool eof_ = false;
};

// RFC 6386 section 14.1 (dc_qlookup, ac_qlookup)
constexpr uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,
    16,  17,  17,  18,  19,  20,  20,  21,  21,  22,  22,  23,  23,
    24,  25,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,
    36,  37,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  46,
    47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  59,
    60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,
    73,  74,  75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,
    85,  86,  87,  88,  89,  91,  93,  95,  96,  98,  100, 101, 102,
    104, 106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130,
    132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};

constexpr uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,
    17,  18,  19,  20,  21,  22,  23,  24,  25,  26,  27,  28,  29,
    30,  31,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  42,
    43,  44,  45,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,
    56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,  78,
    80,  82,  84,  86,  88,  90,  92,  94,  96,  98,  100, 102, 104,
    106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137,
    140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177,
    181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229,
    234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

// RFC 6386 section 13.5 (default_coeff_probs)
constexpr uint8_t CoeffsProba0[4][8][3][11] = {
  { { { 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128 } },
    { { 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128 },
      { 189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128 },
      { 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128 } },
    { { 1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128 },
      { 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128 },
      { 78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128 } },
    { { 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128 },
      { 184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128 },
      { 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128 } },
    { { 1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128 },
      { 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128 },
      { 37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128 } },
    { { 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128 },
      { 207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128 },
      { 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128 } },
    { { 1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128 },
      { 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128 },
      { 80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128 } },
    { { 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128 } } },
  { { { 198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62 },
      { 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1 },
      { 68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128 } },
    { { 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128 },
      { 184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128 },
      { 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128 } },
    { { 1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128 },
      { 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128 },
      { 23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128 } },
    { { 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128 },
      { 109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128 },
      { 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128 } },
    { { 1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128 },
      { 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128 },
      { 22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128 } },
    { { 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128 },
      { 124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128 },
      { 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128 } },
    { { 1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128 },
      { 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128 },
      { 45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128 } },
    { { 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128 },
      { 203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128 },
      { 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128 } } },
  { { { 253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128 },
      { 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128 },
      { 73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128 } },
    { { 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128 },
      { 239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128 },
      { 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128 } },
    { { 1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128 },
      { 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128 },
      { 69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128 } },
    { { 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128 },
      { 223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128 },
      { 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128 } },
    { { 1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128 },
      { 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128 },
      { 149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128 } },
    { { 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128 } },
    { { 1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128 },
      { 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128 },
      { 55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128 } },
    { { 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128 } } },
  { { { 202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255 },
      { 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128 },
      { 61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128 } },
    { { 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128 },
      { 166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128 },
      { 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128 } },
    { { 1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128 },
      { 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128 },
      { 24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128 } },
    { { 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128 },
      { 149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128 },
      { 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128 } },
    { { 1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128 },
      { 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128 },
      { 20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128 } },
    { { 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128 },
      { 168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128 },
      { 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128 } },
    { { 1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128 },
      { 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128 },
      { 42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128 } },
    { { 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128 } } } };

// RFC 6386 section 13.4 (coeff_update_probs)
constexpr uint8_t CoeffsUpdateProba[4][8][3][11] = {
  { { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255 },
      { 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255 },
      { 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } } },
  { { { 217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255 },
      { 234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255 } },
    { { 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } } },
  { { { 186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255 },
      { 251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255 } },
    { { 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255 } },
    { { 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } } },
  { { { 248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255 },
      { 248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255 } },
    { { 255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } } } };

// RFC 6386 section 11.5 (kf_bmode_probs), both indices in libwebp's mode
// order (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU) for [above][left]
constexpr uint8_t kBModesProba[10][10][9] = {
  { { 231, 120, 48, 89, 115, 113, 120, 152, 112 },
    { 152, 179, 64, 126, 170, 118, 46, 70, 95 },
    { 175, 69, 143, 80, 85, 82, 72, 155, 103 },
    { 56, 58, 10, 171, 218, 189, 17, 13, 152 },
    { 114, 26, 17, 163, 44, 195, 21, 10, 173 },
    { 121, 24, 80, 195, 26, 62, 44, 64, 85 },
    { 144, 71, 10, 38, 171, 213, 144, 34, 26 },
    { 170, 46, 55, 19, 136, 160, 33, 206, 71 },
    { 63, 20, 8, 114, 114, 208, 12, 9, 226 },
    { 81, 40, 11, 96, 182, 84, 29, 16, 36 } },
  { { 134, 183, 89, 137, 98, 101, 106, 165, 148 },
    { 72, 187, 100, 130, 157, 111, 32, 75, 80 },
    { 66, 102, 167, 99, 74, 62, 40, 234, 128 },
    { 41, 53, 9, 178, 241, 141, 26, 8, 107 },
    { 74, 43, 26, 146, 73, 166, 49, 23, 157 },
    { 65, 38, 105, 160, 51, 52, 31, 115, 128 },
    { 104, 79, 12, 27, 217, 255, 87, 17, 7 },
    { 87, 68, 71, 44, 114, 51, 15, 186, 23 },
    { 47, 41, 14, 110, 182, 183, 21, 17, 194 },
    { 66, 45, 25, 102, 197, 189, 23, 18, 22 } },
  { { 88, 88, 147, 150, 42, 46, 45, 196, 205 },
    { 43, 97, 183, 117, 85, 38, 35, 179, 61 },
    { 39, 53, 200, 87, 26, 21, 43, 232, 171 },
    { 56, 34, 51, 104, 114, 102, 29, 93, 77 },
    { 39, 28, 85, 171, 58, 165, 90, 98, 64 },
    { 34, 22, 116, 206, 23, 34, 43, 166, 73 },
    { 107, 54, 32, 26, 51, 1, 81, 43, 31 },
    { 68, 25, 106, 22, 64, 171, 36, 225, 114 },
    { 34, 19, 21, 102, 132, 188, 16, 76, 124 },
    { 62, 18, 78, 95, 85, 57, 50, 48, 51 } },
  { { 193, 101, 35, 159, 215, 111, 89, 46, 111 },
    { 60, 148, 31, 172, 219, 228, 21, 18, 111 },
    { 112, 113, 77, 85, 179, 255, 38, 120, 114 },
    { 40, 42, 1, 196, 245, 209, 10, 25, 109 },
    { 88, 43, 29, 140, 166, 213, 37, 43, 154 },
    { 61, 63, 30, 155, 67, 45, 68, 1, 209 },
    { 100, 80, 8, 43, 154, 1, 51, 26, 71 },
    { 142, 78, 78, 16, 255, 128, 34, 197, 171 },
    { 41, 40, 5, 102, 211, 183, 4, 1, 221 },
    { 51, 50, 17, 168, 209, 192, 23, 25, 82 } },
  { { 138, 31, 36, 171, 27, 166, 38, 44, 229 },
    { 67, 87, 58, 169, 82, 115, 26, 59, 179 },
    { 63, 59, 90, 180, 59, 166, 93, 73, 154 },
    { 40, 40, 21, 116, 143, 209, 34, 39, 175 },
    { 47, 15, 16, 183, 34, 223, 49, 45, 183 },
    { 46, 17, 33, 183, 6, 98, 15, 32, 183 },
    { 57, 46, 22, 24, 128, 1, 54, 17, 37 },
    { 65, 32, 73, 115, 28, 128, 23, 128, 205 },
    { 40, 3, 9, 115, 51, 192, 18, 6, 223 },
    { 87, 37, 9, 115, 59, 77, 64, 21, 47 } },
  { { 104, 55, 44, 218, 9, 54, 53, 130, 226 },
    { 64, 90, 70, 205, 40, 41, 23, 26, 57 },
    { 54, 57, 112, 184, 5, 41, 38, 166, 213 },
    { 30, 34, 26, 133, 152, 116, 10, 32, 134 },
    { 39, 19, 53, 221, 26, 114, 32, 73, 255 },
    { 31, 9, 65, 234, 2, 15, 1, 118, 73 },
    { 75, 32, 12, 51, 192, 255, 160, 43, 51 },
    { 88, 31, 35, 67, 102, 85, 55, 186, 85 },
    { 56, 21, 23, 111, 59, 205, 45, 37, 192 },
    { 55, 38, 70, 124, 73, 102, 1, 34, 98 } },
  { { 125, 98, 42, 88, 104, 85, 117, 175, 82 },
    { 95, 84, 53, 89, 128, 100, 113, 101, 45 },
    { 75, 79, 123, 47, 51, 128, 81, 171, 1 },
    { 57, 17, 5, 71, 102, 57, 53, 41, 49 },
    { 38, 33, 13, 121, 57, 73, 26, 1, 85 },
    { 41, 10, 67, 138, 77, 110, 90, 47, 114 },
    { 115, 21, 2, 10, 102, 255, 166, 23, 6 },
    { 101, 29, 16, 10, 85, 128, 101, 196, 26 },
    { 57, 18, 10, 102, 102, 213, 34, 20, 43 },
    { 117, 20, 15, 36, 163, 128, 68, 1, 26 } },
  { { 102, 61, 71, 37, 34, 53, 31, 243, 192 },
    { 69, 60, 71, 38, 73, 119, 28, 222, 37 },
    { 68, 45, 128, 34, 1, 47, 11, 245, 171 },
    { 62, 17, 19, 70, 146, 85, 55, 62, 70 },
    { 37, 43, 37, 154, 100, 163, 85, 160, 1 },
    { 63, 9, 92, 136, 28, 64, 32, 201, 85 },
    { 75, 15, 9, 9, 64, 255, 184, 119, 16 },
    { 86, 6, 28, 5, 64, 255, 25, 248, 1 },
    { 56, 8, 17, 132, 137, 255, 55, 116, 128 },
    { 58, 15, 20, 82, 135, 57, 26, 121, 40 } },
  { { 164, 50, 31, 137, 154, 133, 25, 35, 218 },
    { 51, 103, 44, 131, 131, 123, 31, 6, 158 },
    { 86, 40, 64, 135, 148, 224, 45, 183, 128 },
    { 22, 26, 17, 131, 240, 154, 14, 1, 209 },
    { 45, 16, 21, 91, 64, 222, 7, 1, 197 },
    { 56, 21, 39, 155, 60, 138, 23, 102, 213 },
    { 83, 12, 13, 54, 192, 255, 68, 47, 28 },
    { 85, 26, 85, 85, 128, 128, 32, 146, 171 },
    { 18, 11, 7, 63, 144, 171, 4, 4, 246 },
    { 35, 27, 10, 146, 174, 171, 12, 26, 128 } },
  { { 190, 80, 35, 99, 180, 80, 126, 54, 45 },
    { 85, 126, 47, 87, 176, 51, 41, 20, 32 },
    { 101, 75, 128, 139, 118, 146, 116, 128, 85 },
    { 56, 41, 15, 176, 236, 85, 37, 9, 62 },
    { 71, 30, 17, 119, 118, 255, 17, 18, 138 },
    { 101, 38, 60, 138, 55, 70, 43, 26, 142 },
    { 146, 36, 19, 30, 171, 255, 97, 27, 20 },
    { 138, 45, 61, 62, 219, 1, 81, 188, 64 },
    { 32, 41, 20, 117, 151, 142, 20, 21, 163 },
    { 112, 19, 12, 61, 195, 128, 48, 4, 24 } } };

constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                                6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kZigzag[16] = {0, 1,  4,  8,  5, 2,  3,  6,
                                 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177,
                             153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's intra modes: the 16x16 and chroma ones share the first four
enum {
  B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
  DC_NOTOP, DC_NOLEFT, DC_NOTOPLEFT  // DC at the frame's edges
};

constexpr int BPS = 32;  // the work buffer's stride, as libwebp's yuv_b_
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }
#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x)
      dst[x] = clip8(top[x] + dst[-1] - top[-1]);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

void predict16(uint8_t* dst, int mode) {
  int dc = 0;
  switch (mode) {
    case B_DC:
      dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, dc >> 5, 16);
      break;
    case DC_NOTOP:
      dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> 4, 16);
      break;
    case DC_NOLEFT:
      dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[j - BPS];
      fill(dst, dc >> 4, 16);
      break;
    case DC_NOTOPLEFT: fill(dst, 0x80, 16); break;
    case B_TM: true_motion(dst, 16); break;
    case B_VE:
      for (int j = 0; j < 16; ++j) std::memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case B_HE:
      for (int j = 0; j < 16; ++j)
        std::memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
  }
}

void predict8(uint8_t* dst, int mode) {
  int dc = 0;
  switch (mode) {
    case B_DC:
      dc = 8;
      for (int j = 0; j < 8; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, dc >> 4, 8);
      break;
    case DC_NOTOP:
      dc = 4;
      for (int j = 0; j < 8; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> 3, 8);
      break;
    case DC_NOLEFT:
      dc = 4;
      for (int j = 0; j < 8; ++j) dc += dst[j - BPS];
      fill(dst, dc >> 3, 8);
      break;
    case DC_NOTOPLEFT: fill(dst, 0x80, 8); break;
    case B_TM: true_motion(dst, 8); break;
    case B_VE:
      for (int j = 0; j < 8; ++j) std::memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case B_HE:
      for (int j = 0; j < 8; ++j)
        std::memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
  }
}

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS], X = top[-1];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {(uint8_t)avg3(X, A, B), (uint8_t)avg3(A, B, C),
                            (uint8_t)avg3(B, C, D), (uint8_t)avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = L;
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
  }
}
#undef DST

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// TransformOne_C (and, on their inputs, TransformAC3_C and TransformDC_C):
// the inverse DCT in int, added to `dst` with a clip to 0..255
void transform(const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

// Transform_SSE2, which libwebp runs on x86-64 for a block with more than
// three coefficients (and for every chroma block of a plane with one):
// the same arithmetic in 16-bit lanes that wrap, _mm_mulhi_epi16 with the
// constants 20091 and 35468 - 65536, and a saturating pack. It differs
// from the int version only where a lane overflows (corrupt streams).
inline int16_t wrap16(int v) { return (int16_t)(uint16_t)(unsigned)v; }
inline int mulhi(int16_t a, int k) { return ((int)a * k) >> 16; }

void transform_simd(const int16_t* in, uint8_t* dst) {
  int16_t C[16];
  for (int i = 0; i < 4; ++i) {
    const int16_t i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
    const int a = i0 + i2, b = i0 - i2;
    const int c = mulhi(i1, -30068) - mulhi(i3, 20091) + i1 - i3;
    const int d = mulhi(i1, 20091) + mulhi(i3, -30068) + i1 + i3;
    C[4 * i + 0] = wrap16(a + d);
    C[4 * i + 1] = wrap16(b + c);
    C[4 * i + 2] = wrap16(b - c);
    C[4 * i + 3] = wrap16(a - d);
  }
  for (int j = 0; j < 4; ++j, dst += BPS) {
    const int16_t t0 = C[j], t1 = C[4 + j], t2 = C[8 + j], t3 = C[12 + j];
    const int dc = t0 + 4;
    const int a = dc + t2, b = dc - t2;
    const int c = mulhi(t1, -30068) - mulhi(t3, 20091) + t1 - t3;
    const int d = mulhi(t1, 20091) + mulhi(t3, -30068) + t1 + t3;
    const int out[4] = {wrap16(a + d) >> 3, wrap16(b + c) >> 3,
                        wrap16(b - c) >> 3, wrap16(a - d) >> 3};
    for (int x = 0; x < 4; ++x) dst[x] = clip8(wrap16(dst[x] + out[x]));
  }
}

// libwebp's DoTransform on a block's NzCodeBits code
void do_transform(int code, const int16_t* in, uint8_t* dst) {
  if (code == 3) transform_simd(in, dst);
  else if (code) transform(in, dst);
}

void inverse_wht(const int16_t* in, int16_t* out) {  // to each block's DC
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// ---------------------------------------------------------- loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
            a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_t, bool edge) {
  const int t2 = 2 * thresh + 1;
  for (; size > 0; --size, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) filter2(p, hstride);
    else if (edge) filter6(p, hstride);
    else filter4(p, hstride);
  }
}

struct FilterInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

// ------------------------------------------------------------ upsampler

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return (v & ~16383) == 0 ? (uint8_t)(v >> 6) : v < 0 ? 0 : 255;
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                     mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// one output row: `nu`/`nv` the near chroma row, `fu`/`fv` the far one
void upsample_row(const uint8_t* y, const uint8_t* nu, const uint8_t* nv,
                  const uint8_t* fu, const uint8_t* fv, uint8_t* out,
                  int len) {
  const uint8_t* near_[2] = {nu, nv};
  const uint8_t* far_[2] = {fu, fv};
  int px[2][2];  // [pixel 2x - 1, 2x][u, v]
  int c[2];
  for (int k = 0; k < 2; ++k)
    c[k] = (3 * near_[k][0] + far_[k][0] + 2) >> 2;
  yuv_to_rgb(y[0], c[0], c[1], out);
  const int last_pair = (len - 1) >> 1;
  for (int x = 1; x <= last_pair; ++x) {
    for (int k = 0; k < 2; ++k) {
      const int tl = near_[k][x - 1], t = near_[k][x];
      const int l = far_[k][x - 1], cur = far_[k][x];
      const int avg = tl + t + l + cur + 8;
      const int diag_12 = (avg + 2 * (t + l)) >> 3;
      const int diag_03 = (avg + 2 * (tl + cur)) >> 3;
      px[0][k] = (diag_12 + tl) >> 1;
      px[1][k] = (diag_03 + t) >> 1;
    }
    yuv_to_rgb(y[2 * x - 1], px[0][0], px[0][1], out + 3 * (2 * x - 1));
    yuv_to_rgb(y[2 * x], px[1][0], px[1][1], out + 3 * (2 * x));
  }
  if (!(len & 1)) {
    for (int k = 0; k < 2; ++k)
      c[k] = (3 * near_[k][last_pair] + far_[k][last_pair] + 2) >> 2;
    yuv_to_rgb(y[len - 1], c[0], c[1], out + 3 * (len - 1));
  }
}

// ------------------------------------------------------------- decoder

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t is_i4x4, uvmode, segment, skip;
  uint8_t code[24];  // libwebp's NzCodeBits per block: 0 to 3
};

class LossyDecoder {
 public:
  int decode(const uint8_t* buf, size_t size, int width, int height,
             uint8_t* rgb) {
    // frame tag and key-frame header (checked by utils/webp.py)
    const uint32_t tag = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const size_t part0 = tag >> 5;
    buf += 10;
    size -= 10;
    mb_w_ = (width + 15) >> 4;
    mb_h_ = (height + 15) >> 4;
    if (part0 > size) return kTruncated;
    br_.init(buf, part0);
    buf += part0;
    size -= part0;
    br_.bit(0x80);  // colour space
    br_.bit(0x80);  // clamping type (libwebp always clamps)
    segment_header();
    filter_header();
    if (br_.eof()) return kTruncated;
    const int rc = partitions(buf, size);
    if (rc) return rc;
    quant();
    br_.bit(0x80);  // refresh entropy probs: ignored on a key frame
    proba();
    precompute_filter_strengths();

    const int yw = mb_w_ * 16, uvw = mb_w_ * 8;
    ys_.assign((size_t)yw * mb_h_ * 16, 0);
    us_.assign((size_t)uvw * mb_h_ * 8, 0);
    vs_.assign((size_t)uvw * mb_h_ * 8, 0);
    finfo_.assign((size_t)mb_w_ * mb_h_, FilterInfo());
    intra_t_.assign(4 * mb_w_, B_DC);
    nz_top_.assign((size_t)mb_w_ * 9, 0);
    top_y_.assign((size_t)mb_w_ * 16, 0);
    top_u_.assign((size_t)mb_w_ * 8, 0);
    top_v_.assign((size_t)mb_w_ * 8, 0);
    std::vector<MBData> row(mb_w_);
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x)
        intra_mode(row[mb_x], mb_x, intra_l);
      if (br_.eof()) return kTruncated;
      BoolReader& tokens = parts_[mb_y & (num_parts_ - 1)];
      uint8_t nz_left[9] = {0};
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        MBData& mb = row[mb_x];
        uint8_t* nz_top = &nz_top_[(size_t)mb_x * 9];
        bool skip = use_skip_proba_ ? mb.skip : false;
        if (!skip) {
          skip = residuals(mb, tokens, nz_top, nz_left);
        } else {
          std::memset(nz_top, 0, 8);
          std::memset(nz_left, 0, 8);
          if (!mb.is_i4x4) nz_top[8] = nz_left[8] = 0;
          std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
          std::memset(mb.code, 0, sizeof(mb.code));
        }
        if (filter_type_ > 0) {
          FilterInfo f = fstrengths_[mb.segment][mb.is_i4x4];
          f.inner |= !skip;
          finfo_[(size_t)mb_y * mb_w_ + mb_x] = f;
        }
        if (tokens.eof()) return kTruncated;
      }
      reconstruct_row(row, mb_y);
    }
    if (filter_type_ > 0)
      for (int mb_y = 0; mb_y < mb_h_; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x) loop_filter(mb_x, mb_y);
    // crop and upsample
    const int uv_h = (height + 1) / 2;
    for (int r = 0; r < height; ++r) {
      // the row's nearer chroma row and the other one (EmitFancyRGB)
      const int near_row = r / 2;
      const int far_row = r == 0 ? 0
                          : r & 1 ? std::min(near_row + 1, uv_h - 1)
                                  : near_row - 1;
      upsample_row(&ys_[(size_t)r * yw], &us_[(size_t)near_row * uvw],
                   &vs_[(size_t)near_row * uvw], &us_[(size_t)far_row * uvw],
                   &vs_[(size_t)far_row * uvw], rgb + (size_t)r * width * 3,
                   width);
    }
    return kOk;
  }

 private:
  BoolReader br_;
  BoolReader parts_[8];
  int num_parts_ = 1;
  int mb_w_ = 0, mb_h_ = 0;
  // segment header
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  uint8_t segment_proba_[3] = {255, 255, 255};
  // filter header
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
  Quant dqm_[4];
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  FilterInfo fstrengths_[4][2];
  std::vector<uint8_t> ys_, us_, vs_, intra_t_, nz_top_, top_y_, top_u_,
      top_v_;
  std::vector<FilterInfo> finfo_;
  uint8_t yuv_b_[YUV_SIZE];

  void segment_header() {
    use_segment_ = br_.bit(0x80);
    if (use_segment_) {
      update_map_ = br_.bit(0x80);
      if (br_.bit(0x80)) {  // update data
        absolute_delta_ = br_.bit(0x80);
        for (int s = 0; s < 4; ++s)
          quantizer_[s] = br_.bit(0x80) ? br_.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength_[s] = br_.bit(0x80) ? br_.signed_value(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s)
          segment_proba_[s] = br_.bit(0x80) ? br_.value(8) : 255;
    } else {
      update_map_ = false;
    }
  }

  void filter_header() {
    simple_ = br_.bit(0x80);
    level_ = br_.value(6);
    sharpness_ = br_.value(3);
    use_lf_delta_ = br_.bit(0x80);
    if (use_lf_delta_ && br_.bit(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br_.bit(0x80)) ref_lf_delta_[i] = br_.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br_.bit(0x80)) mode_lf_delta_[i] = br_.signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
  }

  int partitions(const uint8_t* buf, size_t size) {
    num_parts_ = 1 << br_.value(2);
    const size_t last = num_parts_ - 1;
    if (size < 3 * last) return kBadPartitions;
    const uint8_t* sz = buf;
    const uint8_t* part = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts_[p].init(part, psize);
      part += psize;
      left -= psize;
    }
    parts_[last].init(part, left);
    return part < buf + size ? kOk : kTruncated;
  }

  void quant() {
    const int base_q0 = br_.value(7);
    int dq[5];
    for (int& d : dq) d = br_.bit(0x80) ? br_.signed_value(4) : 0;
    const int dqy1_dc = dq[0], dqy2_dc = dq[1], dqy2_ac = dq[2],
              dquv_dc = dq[3], dquv_ac = dq[4];
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i] + (absolute_delta_ ? 0 : base_q0);
      } else if (i > 0) {
        dqm_[i] = dqm_[0];
        continue;
      } else {
        q = base_q0;
      }
      Quant& m = dqm_[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void proba() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = br_.bit(CoeffsUpdateProba[t][b][c][p])
                                     ? br_.value(8)
                                     : CoeffsProba0[t][b][c][p];
    use_skip_proba_ = br_.bit(0x80);
    if (use_skip_proba_) skip_p_ = br_.value(8);
  }

  void precompute_filter_strengths() {
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (use_segment_) {
        base = filter_strength_[s];
        if (!absolute_delta_) base += level_;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = fstrengths_[s][i4x4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = (uint8_t)ilevel;
          info.limit = (uint8_t)(2 * level + ilevel);
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = (uint8_t)i4x4;
      }
    }
  }

  void intra_mode(MBData& mb, int mb_x, uint8_t* left) {
    uint8_t* top = &intra_t_[4 * mb_x];
    if (update_map_) {
      mb.segment = !br_.bit(segment_proba_[0])
                       ? br_.bit(segment_proba_[1])
                       : br_.bit(segment_proba_[2]) + 2;
    } else {
      mb.segment = 0;
    }
    if (use_skip_proba_) mb.skip = br_.bit(skip_p_);
    mb.is_i4x4 = !br_.bit(145);
    if (!mb.is_i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? B_TM : B_HE)
                                     : (br_.bit(163) ? B_VE : B_DC);
      mb.imodes[0] = (uint8_t)ymode;
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = mb.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          if (!br_.bit(prob[0])) ymode = B_DC;
          else if (!br_.bit(prob[1])) ymode = B_TM;
          else if (!br_.bit(prob[2])) ymode = B_VE;
          else if (!br_.bit(prob[3]))
            ymode = !br_.bit(prob[4]) ? B_HE
                    : !br_.bit(prob[5]) ? B_RD : B_VR;
          else
            ymode = !br_.bit(prob[6]) ? B_LD
                    : !br_.bit(prob[7]) ? B_VL
                    : !br_.bit(prob[8]) ? B_HD : B_HU;
          top[x] = (uint8_t)ymode;
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = (uint8_t)ymode;
      }
    }
    mb.uvmode = !br_.bit(142) ? B_DC
                : !br_.bit(114) ? B_VE
                : br_.bit(183) ? B_TM : B_HE;
  }

  // GetCoeffs: the index past the last coefficient read, the coefficients
  // dequantised into `out` (int16, as libwebp stores them)
  int coeffs(BoolReader& br, int type, int ctx, const int* dq, int n,
             int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;
      while (!br.bit(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      const int band = kBands[n + 1];
      if (!br.bit(p[2])) {
        v = 1;
        p = proba_[type][band][1];
      } else {
        v = large_value(br, p);
        p = proba_[type][band][2];
      }
      out[kZigzag[n]] = (int16_t)(br.with_sign(v) * dq[n > 0]);
    }
    return 16;
  }

  static int large_value(BoolReader& br, const uint8_t* p) {
    int v;
    if (!br.bit(p[3])) {
      v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
    } else if (!br.bit(p[6])) {
      if (!br.bit(p[7])) {
        v = 5 + br.bit(159);
      } else {
        v = 7 + 2 * br.bit(165);
        v += br.bit(145);
      }
    } else {
      const int bit1 = br.bit(p[8]);
      const int bit0 = br.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
        v += v + br.bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // nz contexts: [0..3] luma columns or rows, [4, 5] u, [6, 7] v, [8] dc
  // NzCodeBits: 3 past three coefficients, 2 past one, else a non-zero DC
  static int nz_code(int nz, const int16_t* block) {
    return nz > 3 ? 3 : nz > 1 ? 2 : block[0] != 0;
  }

  bool residuals(MBData& mb, BoolReader& br, uint8_t* top, uint8_t* left) {
    const Quant& q = dqm_[mb.segment];
    int16_t* dst = mb.coeffs;
    std::memset(dst, 0, sizeof(mb.coeffs));
    bool any = false;
    int first, type;
    if (!mb.is_i4x4) {
      int16_t dc[16] = {0};
      const int nz = coeffs(br, 1, top[8] + left[8], q.y2, 0, dc);
      top[8] = left[8] = nz > 0;
      if (nz > 1) {
        inverse_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = (int16_t)dc0;
      }
      first = 1;
      type = 0;
    } else {
      first = 0;
      type = 3;
    }
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) {
        int16_t* block = dst + (y * 4 + x) * 16;
        const int nz = coeffs(br, type, top[x] + left[y], q.y1, first, block);
        top[x] = left[y] = nz > first;
        mb.code[y * 4 + x] = (uint8_t)nz_code(nz, block);
        any = any || mb.code[y * 4 + x];
      }
    for (int ch = 0; ch < 2; ++ch)
      for (int y = 0; y < 2; ++y)
        for (int x = 0; x < 2; ++x) {
          const int b = 16 + ch * 4 + y * 2 + x;
          int16_t* block = dst + b * 16;
          const int nz = coeffs(br, 2, top[4 + ch * 2 + x] +
                                           left[4 + ch * 2 + y],
                                q.uv, 0, block);
          top[4 + ch * 2 + x] = left[4 + ch * 2 + y] = nz > 0;
          mb.code[b] = (uint8_t)nz_code(nz, block);
          any = any || mb.code[b];
        }
    return !any;
  }

  void reconstruct_row(std::vector<MBData>& row, int mb_y) {
    uint8_t* const y_dst = yuv_b_ + Y_OFF;
    uint8_t* const u_dst = yuv_b_ + U_OFF;
    uint8_t* const v_dst = yuv_b_ + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    const int yw = mb_w_ * 16, uvw = mb_w_ * 8;
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      const MBData& mb = row[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j)
          std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      uint8_t* top_y = &top_y_[(size_t)mb_x * 16];
      uint8_t* top_u = &top_u_[(size_t)mb_x * 8];
      uint8_t* top_v = &top_v_[(size_t)mb_x * 8];
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, top_y, 16);
        std::memcpy(u_dst - BPS, top_u, 8);
        std::memcpy(v_dst - BPS, top_v, 8);
      }
      if (mb.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w_ - 1) std::memset(top_right, top_y[15], 4);
          else std::memcpy(top_right, top_y + 16, 4);
        }
        for (int r = 1; r <= 3; ++r)
          std::memcpy(top_right + r * 4 * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, mb.imodes[n]);
          do_transform(mb.code[n], mb.coeffs + n * 16, dst);
        }
      } else {
        predict16(y_dst, check_mode(mb_x, mb_y, mb.imodes[0]));
        for (int n = 0; n < 16; ++n)
          do_transform(mb.code[n], mb.coeffs + n * 16,
                       y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      const int uvmode = check_mode(mb_x, mb_y, mb.uvmode);
      predict8(u_dst, uvmode);
      predict8(v_dst, uvmode);
      uv_transform(mb, 16, u_dst);
      uv_transform(mb, 20, v_dst);
      if (mb_y < mb_h_ - 1) {
        std::memcpy(top_y, y_dst + 15 * BPS, 16);
        std::memcpy(top_u, u_dst + 7 * BPS, 8);
        std::memcpy(top_v, v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(&ys_[(size_t)(mb_y * 16 + j) * yw + mb_x * 16],
                    y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&us_[(size_t)(mb_y * 8 + j) * uvw + mb_x * 8],
                    u_dst + j * BPS, 8);
        std::memcpy(&vs_[(size_t)(mb_y * 8 + j) * uvw + mb_x * 8],
                    v_dst + j * BPS, 8);
      }
    }
  }

  // DoUVTransform: the SIMD transform on all four blocks where one has an
  // AC coefficient (code 2 or 3), else the DC of each block that has one
  static void uv_transform(const MBData& mb, int first, uint8_t* dst) {
    bool ac = false, any = false;
    for (int b = 0; b < 4; ++b) {
      ac = ac || mb.code[first + b] >= 2;
      any = any || mb.code[first + b];
    }
    if (!any) return;
    for (int b = 0; b < 4; ++b) {
      const int16_t* in = mb.coeffs + (first + b) * 16;
      uint8_t* at = dst + (b & 1) * 4 + (b >> 1) * 4 * BPS;
      if (ac) transform_simd(in, at);
      else if (in[0]) transform(in, at);
    }
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode != B_DC) return mode;
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : B_DC;
  }

  void loop_filter(int mb_x, int mb_y) {
    const FilterInfo& f = finfo_[(size_t)mb_y * mb_w_ + mb_x];
    const int limit = f.limit;
    if (limit == 0) return;
    const int ys = mb_w_ * 16, uvs = mb_w_ * 8;
    uint8_t* y = &ys_[(size_t)mb_y * 16 * ys + mb_x * 16];
    if (filter_type_ == 1) {
      if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k)
          simple_filter(y + 4 * k * ys, ys, 1, limit);
      return;
    }
    uint8_t* u = &us_[(size_t)mb_y * 8 * uvs + mb_x * 8];
    uint8_t* v = &vs_[(size_t)mb_y * 8 * uvs + mb_x * 8];
    const int il = f.ilevel, hv = f.hev_thresh;
    if (mb_x > 0) {
      filter_loop(y, 1, ys, 16, limit + 4, il, hv, true);
      filter_loop(u, 1, uvs, 8, limit + 4, il, hv, true);
      filter_loop(v, 1, uvs, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k)
        filter_loop(y + 4 * k, 1, ys, 16, limit, il, hv, false);
      filter_loop(u + 4, 1, uvs, 8, limit, il, hv, false);
      filter_loop(v + 4, 1, uvs, 8, limit, il, hv, false);
    }
    if (mb_y > 0) {
      filter_loop(y, ys, 1, 16, limit + 4, il, hv, true);
      filter_loop(u, uvs, 1, 8, limit + 4, il, hv, true);
      filter_loop(v, uvs, 1, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k)
        filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
      filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
      filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
    }
  }
};

void unfilter(int filter, uint8_t* a, int w, int h) {
  for (int y = 0; y < h; ++y) {
    uint8_t* row = a + (size_t)y * w;
    const uint8_t* prev = y ? row - w : nullptr;
    if (filter == 1 || (prev == nullptr && filter != 0)) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = row[x] = (uint8_t)(pred + row[x]);
    } else if (filter == 2) {
      for (int x = 0; x < w; ++x) row[x] = (uint8_t)(prev[x] + row[x]);
    } else if (filter == 3) {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < w; ++x) {
        top = prev[x];
        const int g = left + top - top_left;
        const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
        left = (uint8_t)(row[x] + pred);
        top_left = top;
        row[x] = left;
      }
    }
  }
}

}  // namespace

extern "C" {

// a VP8L bitstream (header included) of w x h pixels into `argb`
int webp_vp8l_decode(const uint8_t* src, long n, uint32_t* argb, int w,
                     int h) {
  LosslessDecoder dec(src, n);
  int sw = 0, sh = 0;
  int rc = dec.header(&sw, &sh);
  if (rc) return rc;
  if (sw != w || sh != h) return kBadCode;
  return dec.image(w, h, argb, false);
}

// a VP8 key frame (from its frame tag; header checked by the caller) of
// w x h pixels into `rgb` (h, w, 3)
int webp_vp8_decode(const uint8_t* src, long n, uint8_t* rgb, int w, int h) {
  LossyDecoder* dec = new (std::nothrow) LossyDecoder();
  if (dec == nullptr) return kNoMemory;
  const int rc = dec->decode(src, (size_t)n, w, h, rgb);
  delete dec;
  return rc;
}

// an ALPH chunk's payload into the w x h alpha plane
int webp_alpha_decode(const uint8_t* src, long n, uint8_t* alpha, int w,
                      int h) {
  if (n <= 1) return kTruncated;
  const int method = src[0] & 3, filter = (src[0] >> 2) & 3,
            pre = (src[0] >> 4) & 3, reserved = src[0] >> 6;
  if (method > 1 || pre > 1 || reserved != 0) return kBadAlphaHeader;
  const size_t size = (size_t)w * h;
  if (method == 0) {
    if ((size_t)(n - 1) < size) return kTruncated;
    std::memcpy(alpha, src + 1, size);
  } else {
    std::vector<uint32_t> argb(size);
    LosslessDecoder dec(src + 1, n - 1);
    const int rc = dec.image(w, h, argb.data(), true);
    if (rc) return rc;
    for (size_t i = 0; i < size; ++i) alpha[i] = (argb[i] >> 8) & 0xff;
  }
  unfilter(filter, alpha, w, h);
  return kOk;
}

}  // extern "C"
