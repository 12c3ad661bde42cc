// JPEG entropy coding on the host: the decode of one scan into int16
// coefficient blocks (sequential Huffman, progressive Huffman, arithmetic
// coding), libjpeg-turbo 2.1's block smoothing of a progressive image's
// missing coefficients, the whole decode of a lossless (SOF3) image as
// libjpeg-turbo 3.1 does it (its scans into sample planes, then its
// upsampling and colour: jpeg_decode_lossless, jpeg_lossless_rgb), and the
// Huffman encode of one scan for the port's fixture encoder
// (mapping_tpu_torch/utils/jpeg.py).
//
// The port decodes JPEG in two parts: this file turns the entropy-coded
// bytes into quantised DCT coefficients on the host, and the pixel stage
// (dequantise, IDCT, upsampling, colour) runs on the card
// (csrc/jpeg_pixels.cu) or, for CPU tensors, as plain PyTorch
// (kernels/jpeg.py). Neither replaces a TPU kernel: the JAX package
// decodes every tile on the host with libjpeg (cpp/decode.cpp).
//
// The decode follows libjpeg-turbo 2.1's jdhuff.c, jdphuff.c, jdarith.c,
// jdmarker.c and jdcoefct.c bit for bit, corrupt streams included:
// - the Huffman bit reader stops at a marker (0xFF followed by a byte
//   other than 0x00 after any 0xFF fill bytes) and the end of the data
//   counts as one; bits asked for past it are zeros
//   (`jpeg_fill_bit_buffer`);
// - once a block consumed such bits, the MCUs after it are left alone
//   until a restart marker with data behind it (`decode_mcu`; a
//   progressive DC refinement reads its zero bits on);
// - a code longer than 16 bits decodes as symbol 0 after 17 bits
//   (`jpeg_huff_decode`); a run past coefficient 63 writes coefficient
//   63 (`jpeg_natural_order`'s extra entries);
// - at each restart interval the remaining bits are dropped, the marker
//   is found (`next_marker`), matched or resynchronised as
//   `jpeg_resync_to_restart` does, and the DC predictors (and a
//   progressive scan's end-of-band run, an arithmetic scan's statistics)
//   reset;
// - the arithmetic decoder reads zeros from a marker on, and stops
//   decoding a scan's blocks after a magnitude or spectral overflow until
//   the next restart.
// The caller zeroes the coefficient buffer; blocks are written in
// natural (row-major) order. No call holds a Python object, so ctypes
// releases the GIL for the whole call.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag index -> natural index, with libjpeg's 16 guard entries of 63
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jdhuff.c jpeg_make_d_derived_tbl: maxcode / valoffset per code length,
// and an 8-bit look-ahead (length << 8 | symbol, 0 for longer codes). A
// DC table's symbols must not pass `max_symbol` (15, or 16 in a lossless
// frame); -1 checks none (an AC table).
struct DecTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[256];
};

int make_dec_table(const uint8_t* bits, const uint8_t* vals, int max_symbol,
                   DecTable* t) {
  uint8_t size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int n = bits[l];
    if (p + n > 256) return -1;
    while (n--) size[p++] = (uint8_t)l;
  }
  size[p] = 0;
  int count = p;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) return -1;  // over-subscribed
    c <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l]) {
      t->valoffset[l] = p - (int32_t)code[p];
      p += bits[l];
      t->maxcode[l] = (int32_t)code[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  memcpy(t->vals, vals, 256);
  memset(t->look, 0, sizeof(t->look));
  p = 0;
  for (int l = 1; l <= 8; l++) {
    for (int i = 0; i < bits[l]; i++, p++) {
      int base = (int)(code[p] << (8 - l));
      for (int j = 0; j < (1 << (8 - l)); j++)
        t->look[base + j] = (uint16_t)((l << 8) | vals[p]);
    }
  }
  if (max_symbol >= 0) {
    for (int i = 0; i < count; i++)
      if (vals[i] > max_symbol) return -1;
  }
  return 0;
}

// jdmarker.c next_marker: skip to the next marker (the end of the data
// counts as EOI, the source manager's fake one); false where it was the
// end of the data
template <class Source>
bool skip_to_marker(Source& r) {
  for (;;) {
    uint8_t c;
    do {
      if (r.pos >= r.len) {
        r.marker = 0xD9;
        return false;
      }
      c = r.d[r.pos++];
    } while (c != 0xFF);
    do {
      if (r.pos >= r.len) {
        r.marker = 0xD9;
        return false;
      }
      c = r.d[r.pos++];
    } while (c == 0xFF);
    if (c != 0) {
      r.marker = c;
      return true;
    }
  }
}

struct Reader {
  const uint8_t* d;
  long len;
  long pos;        // next byte to load
  uint64_t buf;    // bits, most significant first
  int bits;        // valid bits in buf
  int marker;      // the marker the loader stopped at, 0 for none
  bool short_data; // a block consumed bits past the data (insufficient_data)
  int warnings;

  // load bytes until 57 bits are buffered or a marker is reached
  void fill() {
    while (bits <= 56 && marker == 0) {
      if (pos >= len) {  // the source manager's fake EOI
        marker = 0xD9;
        break;
      }
      uint8_t c = d[pos++];
      if (c == 0xFF) {
        uint8_t n;
        do {
          if (pos >= len) {
            marker = 0xD9;
            return;
          }
          n = d[pos++];
        } while (n == 0xFF);
        if (n != 0) {
          marker = n;
          return;
        }
      }
      buf |= (uint64_t)c << (56 - bits);
      bits += 8;
    }
  }

  // `n` (1..16) bits, zeros past the data
  uint32_t get(int n) {
    if (bits < n) {
      fill();
      if (bits < n) {
        if (!short_data) warnings++;
        short_data = true;
        bits = n;  // the buffer's low bits are zero
      }
    }
    uint32_t v = (uint32_t)(buf >> (64 - n));
    buf <<= n;
    bits -= n;
    return v;
  }

  // one Huffman symbol: the same as Figure F.16 read one bit at a time
  // with zeros past the data, from 16 bits peeked at once
  int decode(const DecTable& t) {
    if (bits < 16) fill();
    uint16_t e = t.look[buf >> 56];
    int l;
    int32_t code;
    if (e) {
      l = e >> 8;
    } else {
      uint32_t peek = (uint32_t)(buf >> 48);  // zeros past the data
      for (l = 9; l <= 16; l++) {
        code = (int32_t)(peek >> (16 - l));
        if (code <= t.maxcode[l]) break;
      }
    }
    if (l > 16) {  // garbage: libjpeg reads a 17th bit and returns 0
      get(16);
      get(1);
      warnings++;
      return 0;
    }
    if (bits < l) {  // the code ran past the data
      if (!short_data) warnings++;
      short_data = true;
      bits = l;
    }
    code = (int32_t)(buf >> (64 - l));
    buf <<= l;
    bits -= l;
    if (e) return e & 0xFF;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  void next_marker() { skip_to_marker(*this); }
};

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? (int)v + (int)((~0u << s) + 1) : (int)v;
}

// jdmarker.c read_restart_marker + jpeg_resync_to_restart, on a source
// with `marker`, `warnings` and `next_marker()`
template <class Source>
void read_restart_marker(Source& r, int* next_rst) {
  if (r.marker == 0) r.next_marker();
  int want = *next_rst;
  if (r.marker == 0xD0 + want) {
    r.marker = 0;
  } else {
    r.warnings++;
    for (;;) {
      int m = r.marker;
      int action;
      if (m < 0xC0) {
        action = 2;
      } else if (m < 0xD0 || m > 0xD7) {
        action = 3;
      } else if (m == 0xD0 + ((want + 1) & 7) ||
                 m == 0xD0 + ((want + 2) & 7)) {
        action = 3;
      } else if (m == 0xD0 + ((want - 1) & 7) ||
                 m == 0xD0 + ((want - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        r.marker = 0;
        break;
      }
      if (action == 3) break;
      r.marker = 0;
      r.next_marker();
    }
  }
  *next_rst = (want + 1) & 7;
}

// jdhuff.c / jdphuff.c process_restart: the bits left are dropped, and
// the out-of-data flag clears unless the reader stopped at a marker
void restart(Reader& r, int* next_rst) {
  r.buf = 0;
  r.bits = 0;
  read_restart_marker(r, next_rst);
  if (r.marker == 0) r.short_data = false;
}

// --- arithmetic decoding (jdarith.c) ---------------------------------------

// Table D.2 of ITU-T T.81 as jaricom.c packs it: Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5
// estimate of T.851 (the sign of an AC coefficient, refinement bits).
#define V(qe, lps, mps, sw) \
  (((int64_t)(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const int64_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1), V(0x2586, 14, 2, 0), V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0), V(0x03d8, 20, 5, 0), V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0), V(0x006f, 28, 8, 0), V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0), V(0x000d, 35, 11, 0), V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0), V(0x0001, 12, 13, 0), V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0), V(0x2cf2, 38, 17, 0), V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0), V(0x1182, 42, 20, 0), V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0), V(0x072f, 46, 23, 0), V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0), V(0x0303, 51, 26, 0), V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0), V(0x0144, 56, 29, 0), V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0), V(0x008a, 60, 32, 0), V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0), V(0x003b, 32, 35, 0), V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1), V(0x484c, 64, 38, 0), V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0), V(0x261f, 68, 41, 0), V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0), V(0x1518, 72, 44, 0), V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0), V(0x0bfb, 75, 47, 0), V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0), V(0x0706, 79, 50, 0), V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0), V(0x040f, 50, 53, 0), V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0), V(0x025c, 53, 56, 0), V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0), V(0x0160, 56, 59, 0), V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0), V(0x00cb, 59, 62, 0), V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0), V(0x5b12, 65, 65, 1), V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0), V(0x37d8, 82, 68, 0), V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0), V(0x2379, 86, 71, 0), V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0), V(0x174e, 72, 74, 0), V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0), V(0x0f6b, 74, 77, 0), V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0), V(0x0a40, 77, 48, 0), V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0), V(0x438e, 89, 83, 0), V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0), V(0x2eae, 92, 86, 0), V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0), V(0x5570, 88, 89, 1), V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0), V(0x3e22, 97, 92, 0), V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0), V(0x2e17, 93, 86, 0), V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0), V(0x47e5, 102, 98, 0), V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0), V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0),
};
#undef V

constexpr int kArithTables = 16;
constexpr int kDcBins = 64, kAcBins = 256;

// the decoder's registers and its byte source: the source stops at a
// marker, and from then on (or past the data, the source manager's fake
// EOI) the decoder reads zeros
struct ArithReader {
  const uint8_t* d;
  long len;
  long pos;
  int marker;
  int warnings;
  int64_t c, a;
  int ct;  // -16: two bytes to load; -1: a decoding error, do nothing

  void next_marker() { skip_to_marker(*this); }

  int byte() {
    if (marker) return 0;
    if (pos >= len) {
      marker = 0xD9;
      warnings++;
      return 0;
    }
    int v = d[pos++];
    if (v != 0xFF) return v;
    do {
      if (pos >= len) {
        marker = 0xD9;
        warnings++;
        return 0;
      }
      v = d[pos++];
    } while (v == 0xFF);
    if (v == 0) return 0xFF;
    marker = v;
    return 0;
  }

  // arith_decode: one binary decision with statistics bin *st
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // two initial bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const uint8_t nl = qe & 0xFF;
    qe >>= 8;
    const uint8_t nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// Figures F.21-F.24 after the sign: the magnitude category from bins
// `st` on (the first decision at `first`), then the magnitude's bits 14
// bins further; returns |v| - 1, or -1 on a magnitude overflow
int arith_magnitude(ArithReader& r, uint8_t* st, uint8_t* big, bool ac) {
  int m = r.decode(st);
  if (m) {
    if (ac) {
      if (!r.decode(st)) goto bits;
      m <<= 1;
    }
    st = big;
    while (r.decode(st)) {
      if ((m <<= 1) == 0x8000) {
        r.warnings++;
        return -1;
      }
      st++;
    }
  }
bits:
  int v = m;
  st += 14;
  while (m >>= 1)
    if (r.decode(st)) v |= m;
  return v;
}

// --- block smoothing (jdcoefct.c decompress_smooth_data) -------------------

// The first 9 AC coefficients in zigzag order, at their natural positions.
constexpr int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
constexpr int kSavedCoefs = 10;

// An AC estimate: (Q00 * num) over the coefficient's quant value, rounded
// as libjpeg rounds it, and held below 2^Al where Al bits are still to
// come.
inline int smooth_pred(int64_t num, int64_t q, int al) {
  int pred;
  if (num >= 0) {
    pred = (int)(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = (int)(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return pred;
}

// --- lossless decoding (libjpeg-turbo 3.1's jdlhuff.c, jddiffct.c, ---------
// --- jdlossls.c) ----------------------------------------------------------

// jdhuff.c's bit reader as jdlhuff.c drives it: bits right-aligned in
// `buf`, refilled to MIN_GET_BITS (57) at a time. At a marker the bits
// asked for past it are zeros and the out-of-data flag is set. The end of
// the data is a marker (a fake EOI, as libtiff's source manager gives
// it) where `fake_eoi` holds, and otherwise a suspension that never
// resumes: Pillow's source has no more bytes to give, and Pillow fails
// the file as truncated.
struct LosslessReader {
  static constexpr int kMinGetBits = 57;
  const uint8_t* d;
  long len;
  long pos;
  uint64_t buf;
  int bits;
  int marker;
  bool insufficient;
  bool suspended;
  bool fake_eoi;
  int warnings;

  // the end of the data suspends unless it reads as an EOI
  void next_marker() {
    if (!skip_to_marker(*this) && !fake_eoi) suspended = true;
  }

  // jpeg_fill_bit_buffer; false on a suspension
  bool fill(int nbits) {
    if (marker == 0) {
      while (bits < kMinGetBits) {
        if (pos >= len) {
          if (!fake_eoi) return !(suspended = true);
          marker = 0xD9;
          goto no_more_bytes;
        }
        int c = d[pos++];
        if (c == 0xFF) {
          do {
            if (pos >= len) {
              if (!fake_eoi) return !(suspended = true);
              marker = 0xD9;
              goto no_more_bytes;
            }
            c = d[pos++];
          } while (c == 0xFF);
          if (c != 0) {
            marker = c;
            goto no_more_bytes;
          }
          c = 0xFF;
        }
        buf = (buf << 8) | (uint64_t)c;
        bits += 8;
      }
      return true;
    }
  no_more_bytes:
    if (nbits > bits) {
      if (!insufficient) {
        warnings++;
        insufficient = true;
      }
      buf <<= kMinGetBits - bits;
      bits = kMinGetBits;
    }
    return true;
  }

  uint32_t get(int n) {  // GET_BITS, after CHECK_BIT_BUFFER
    bits -= n;
    return (uint32_t)(buf >> bits) & ((1u << n) - 1);
  }

  // HUFF_DECODE and jpeg_huff_decode; -1 on a suspension
  int decode(const DecTable& t) {
    int nb;
    if (bits < 8) {
      if (!fill(0)) return -1;
      if (bits < 8) {
        nb = 1;
        goto slow;
      }
    }
    {
      const uint16_t e = t.look[(buf >> (bits - 8)) & 0xFF];
      if (e) {
        bits -= e >> 8;
        return e & 0xFF;
      }
      nb = 9;
    }
  slow:
    if (bits < nb && !fill(nb)) return -1;
    int32_t code = (int32_t)get(nb);
    int l = nb;
    while (code > t.maxcode[l]) {
      code <<= 1;
      if (bits < 1 && !fill(1)) return -1;
      code |= (int32_t)get(1);
      l++;
    }
    if (l > 16) {  // JWRN_HUFF_BAD_CODE: a zero
      warnings++;
      return 0;
    }
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

// One scan component of a lossless scan.
struct LosslessComp {
  int h, v;         // its samples an MCU (1 x 1 in a non-interleaved scan)
  int frame_v;      // the SOF's v factor: the sample rows of an iMCU row
  int width;        // real samples a row (width_in_blocks)
  int height;       // real rows (height_in_blocks)
  long first;       // its plane's first sample in `planes`
  int table;        // its DC table
  int index;        // its component index in the frame
};

constexpr int kLosslessFields = 8;

}  // namespace

extern "C" {

// Decode one lossless scan (SOF3, 8-bit samples) into the image's sample
// planes: jdlhuff.c's difference decode (categories 0-16; 16 reads no
// bits and means 32768), jddiffct.c's loop (an iMCU row's MCU rows, then
// each component's rows undifferenced; a restart every
// restart_interval / mcus_x MCU rows resets the predictors, and so does
// every MCU row decoded after the data ran out, its differences zero) and
// jdlossls.c's undifferencing modulo 2^16: a component's first row after
// a reset from 2^(7 - pt) and then its left neighbour, every later row's
// first sample from the one above, the rest by predictor `psv` (1-7);
// then the sample << pt, kept to 8 bits. `comps` holds kLosslessFields
// ints a scan component (LosslessComp); `bits` / `vals` the 4 DC tables
// (17 / 256 bytes each); an interleaved scan has mcus_x MCUs of h x v
// samples a component per MCU row, a non-interleaved one mcus_x samples.
// `fake_eoi`: the end of the data reads as an EOI marker; else it is a
// suspension. On return `state` holds [where the marker search resumes,
// the marker the reader stopped at (0: none), warnings]. Returns 0, -1
// for a bad Huffman table, -2 for bad arguments, -4 for a suspension.
int jpeg_decode_lossless(const uint8_t* data, long len, int n_comps,
                         const int* comps, const uint8_t* bits,
                         const uint8_t* vals, int mcus_x, int imcu_rows,
                         int restart_interval, int psv, int pt, int fake_eoi,
                         uint8_t* planes, long* state) {
  if (n_comps < 1 || n_comps > 4 || mcus_x < 1 || imcu_rows < 1 ||
      psv < 1 || psv > 7 || pt < 0 || pt > 7)
    return -2;
  LosslessComp sc[4];
  DecTable tables[4];
  bool built[4] = {false, false, false, false};
  const bool interleaved = n_comps > 1;
  for (int i = 0; i < n_comps; i++) {
    const int* c = comps + i * kLosslessFields;
    sc[i] = {c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]};
    if (sc[i].table < 0 || sc[i].table > 3 || sc[i].frame_v < 1 ||
        sc[i].width < 1 || sc[i].height < 1)
      return -2;
    if (!built[sc[i].table]) {
      if (make_dec_table(bits + 17 * sc[i].table, vals + 256 * sc[i].table,
                         16, &tables[sc[i].table]) != 0)
        return -1;
      built[sc[i].table] = true;
    }
  }
  // a component's MCU-row differences (mcus_x * h a row, v rows) and its
  // last undifferenced row
  std::vector<int32_t> diff[4], prev[4];
  for (int i = 0; i < n_comps; i++) {
    const int rows = interleaved ? sc[i].v : sc[i].frame_v;
    diff[i].resize((size_t)mcus_x * sc[i].h * rows);
    prev[i].resize((size_t)sc[i].width);
  }
  LosslessReader r = {data, len, 0, 0, 0, 0, false, false, fake_eoi != 0, 0};
  bool first_row[4] = {true, true, true, true};
  const int initial = 1 << (7 - pt);
  const int per_restart = restart_interval / mcus_x;
  int rows_to_go = per_restart, next_rst = 0;
  int rc = 0;
  for (int imcu = 0; imcu < imcu_rows && rc == 0; imcu++) {
    const bool last = imcu == imcu_rows - 1;
    // start_iMCU_row: an interleaved scan has one MCU row an iMCU row, a
    // non-interleaved one the component's v rows (what is left, last)
    int mcu_rows = 1;
    if (!interleaved) {
      const int left = sc[0].height - imcu * sc[0].frame_v;
      mcu_rows = last ? left : sc[0].frame_v;
    }
    for (int y = 0; y < mcu_rows; y++) {
      if (restart_interval && rows_to_go == 0) {  // process_restart
        r.buf = 0;
        r.bits = 0;
        read_restart_marker(r, &next_rst);
        if (r.suspended) {
          rc = -4;
          break;
        }
        if (r.marker == 0) r.insufficient = false;
        for (bool& f : first_row) f = true;
        rows_to_go = per_restart;
      }
      if (r.insufficient) {  // decode_mcus: zeros, the predictors reset
        for (int i = 0; i < n_comps; i++) {
          const int h = interleaved ? sc[i].h : 1;
          const int rows = interleaved ? sc[i].v : 1;
          const int row0 = interleaved ? 0 : y;
          memset(diff[i].data() + (size_t)row0 * mcus_x * h, 0,
                 sizeof(int32_t) * (size_t)mcus_x * h * rows);
        }
        for (bool& f : first_row) f = true;
      } else {
        for (int mx = 0; mx < mcus_x && rc == 0; mx++) {
          for (int i = 0; i < n_comps && rc == 0; i++) {
            const LosslessComp& c = sc[i];
            const int h = interleaved ? c.h : 1, v = interleaved ? c.v : 1;
            const int row0 = interleaved ? 0 : y;
            for (int yy = 0; yy < v && rc == 0; yy++) {
              int32_t* out = diff[i].data() +
                             (size_t)(row0 + yy) * mcus_x * h +
                             (size_t)mx * h;
              for (int xx = 0; xx < h; xx++) {
                int s = r.decode(tables[c.table]);
                if (s < 0) {
                  rc = -4;
                  break;
                }
                if (s == 16) {
                  s = 32768;
                } else if (s) {
                  if (r.bits < s && !r.fill(s)) {
                    rc = -4;
                    break;
                  }
                  s = extend(r.get(s), s);
                }
                out[xx] = s;
              }
            }
          }
        }
      }
      if (restart_interval) rows_to_go--;
    }
    if (rc) break;
    // undifference and scale each component's rows of the iMCU row
    for (int i = 0; i < n_comps; i++) {
      const LosslessComp& c = sc[i];
      const int h = interleaved ? c.h : 1;
      const int v = c.frame_v;
      const int rows = last ? c.height - imcu * v : v;
      const int w = c.width;
      for (int row = 0; row < rows; row++) {
        const int32_t* in = diff[i].data() + (size_t)row * mcus_x * h;
        int32_t* up = prev[i].data();
        uint8_t* out = planes + c.first + ((size_t)imcu * v + row) * w;
        int ra;
        if (first_row[c.index]) {  // jpeg_undifference_first_row
          ra = (in[0] + initial) & 0xFFFF;
          up[0] = ra;
          for (int x = 1; x < w; x++) up[x] = ra = (in[x] + ra) & 0xFFFF;
          first_row[c.index] = false;
        } else {
          int rb = up[0], rc_ = 0;
          ra = (in[0] + rb) & 0xFFFF;
          up[0] = ra;
          for (int x = 1; x < w; x++) {
            rc_ = rb;
            rb = up[x];
            int64_t p;
            switch (psv) {
              case 1: p = ra; break;
              case 2: p = rb; break;
              case 3: p = rc_; break;
              case 4: p = (int64_t)ra + rb - rc_; break;
              case 5: p = ra + (((int64_t)rb - rc_) >> 1); break;
              case 6: p = rb + (((int64_t)ra - rc_) >> 1); break;
              default: p = ((int64_t)ra + rb) >> 1; break;
            }
            up[x] = ra = (int)((in[x] + (int)p) & 0xFFFF);
          }
        }
        for (int x = 0; x < w; x++) out[x] = (uint8_t)(up[x] << pt);
      }
    }
  }
  state[0] = r.pos;
  state[1] = r.marker;
  state[2] = r.warnings;
  return rc;
}

// A lossless image's sample planes to (height, width, 3) RGB as Pillow
// reads it from libjpeg-turbo 3.1 in lossless mode, which converts no
// colour space (YCbCr and YCCK fail there, and the caller refuses them):
// box replication of every plane (jdsample.c takes no fancy upsampler
// where the scaled DCT size is 1), then `color` 0 grey (replicated), 2
// RGB (a copy) or 3 CMYK (read by Pillow as "CMYK;I" and turned to RGB by
// Convert.c cmyk2rgb). `info` holds 4 ints a component: its plane's first
// sample, samples a row, and the horizontal and vertical ratios.
void jpeg_lossless_rgb(const uint8_t* planes, int n_comps, const int* info,
                       int color, int height, int width, uint8_t* out) {
  const int n = color == 0 ? 1 : n_comps;
  for (int y = 0; y < height; y++) {
    const uint8_t* row[4];
    for (int ci = 0; ci < n; ci++) {
      const int* c = info + 4 * ci;
      row[ci] = planes + c[0] + (long)(y / c[3]) * c[1];
    }
    uint8_t* o = out + (long)y * width * 3;
    for (int x = 0; x < width; x++, o += 3) {
      int v[4];
      for (int ci = 0; ci < n; ci++) v[ci] = row[ci][x / info[4 * ci + 2]];
      if (color == 0) {
        o[0] = o[1] = o[2] = (uint8_t)v[0];
      } else if (color == 2) {
        for (int i = 0; i < 3; i++) o[i] = (uint8_t)v[i];
      } else {  // cmyk2rgb of the inverted samples: K - MULDIV255(C', K)
        for (int i = 0; i < 3; i++) {
          const int t = (255 - v[i]) * v[3] + 128;
          o[i] = (uint8_t)(v[3] - (((t >> 8) + t) >> 8));
        }
      }
    }
  }
}

}  // extern "C"

namespace {

// Huffman encoding table: code and length per symbol (jcparam.c
// jpeg_make_c_derived_tbl)
struct EncTable {
  uint32_t code[256];
  uint8_t size[256];
};

int make_enc_table(const uint8_t* bits, const uint8_t* vals, EncTable* t) {
  uint8_t size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int n = bits[l];
    if (p + n > 256) return -1;
    while (n--) size[p++] = (uint8_t)l;
  }
  size[p] = 0;
  int count = p;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) return -1;
    c <<= 1;
    si++;
  }
  memset(t->size, 0, sizeof(t->size));
  for (int i = 0; i < count; i++) {
    t->code[vals[i]] = code[i];
    t->size[vals[i]] = size[i];
  }
  return 0;
}

struct Writer {
  uint8_t* out;
  long cap;
  long n;
  uint64_t acc;
  int bits;
  bool overflow;

  void byte(uint8_t b) {
    if (n < cap) out[n] = b;
    else overflow = true;
    n++;
  }
  void put(uint32_t v, int s) {
    if (s == 0) return;
    acc = (acc << s) | (v & ((1u << s) - 1));
    bits += s;
    while (bits >= 8) {
      uint8_t b = (uint8_t)(acc >> (bits - 8));
      byte(b);
      if (b == 0xFF) byte(0);
      bits -= 8;
    }
  }
  void flush() {  // pad with 1-bits to a byte
    if (bits > 0) put(0x7F, 8 - bits);
    acc = 0;
    bits = 0;
  }
};

// one scan component: h, v, blocks per plane row, the plane's first block
// within the image, the DC and AC table numbers
struct ScanComp {
  int h, v, blocks_x, first, dc, ac;
};

constexpr int kCompFields = 6;

}  // namespace

extern "C" {

// Decode one scan. `data` runs from the first entropy-coded byte to the
// end of the file. `comps` holds kCompFields ints per scan component;
// `bits` / `vals` 8 tables (DC 0-3, then AC 0-3) of 17 / 256 bytes, the
// tables a scan uses being defined. An interleaved scan (n_comps > 1)
// has mcus_x * mcus_y MCUs of h * v blocks per component; a
// non-interleaved one mcus_x * mcus_y single blocks. `coef` is the
// image's zeroed int16 buffer, 64 coefficients a block. On return
// `state` holds [the offset where the marker search resumes, the marker
// the reader stopped at (0: none), the count of corrupt-data warnings].
// Returns 0, or -1 for a bad Huffman table, -2 for bad arguments.
int jpeg_decode_scan(const uint8_t* data, long len, int n_comps,
                     const int* comps, const uint8_t* bits,
                     const uint8_t* vals, int mcus_x, int mcus_y,
                     int restart_interval, int16_t* coef, long* state) {
  if (n_comps < 1 || n_comps > 4 || mcus_x < 1 || mcus_y < 1) return -2;
  ScanComp sc[4];
  DecTable tables[8];
  bool built[8] = {false};
  for (int i = 0; i < n_comps; i++) {
    const int* c = comps + i * kCompFields;
    sc[i] = {c[0], c[1], c[2], c[3], c[4], c[5]};
    if (sc[i].dc < 0 || sc[i].dc > 3 || sc[i].ac < 0 || sc[i].ac > 3)
      return -2;
    int ids[2] = {sc[i].dc, 4 + sc[i].ac};
    for (int id : ids) {
      if (!built[id]) {
        if (make_dec_table(bits + 17 * id, vals + 256 * id, id < 4 ? 15 : -1,
                           &tables[id]) != 0)
          return -1;
        built[id] = true;
      }
    }
  }
  Reader r = {data, len, 0, 0, 0, 0, false, 0};
  int last_dc[4] = {0, 0, 0, 0};
  int to_go = restart_interval;
  int next_rst = 0;
  const bool interleaved = n_comps > 1;
  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval) {
        if (to_go == 0) {
          restart(r, &next_rst);
          for (int i = 0; i < 4; i++) last_dc[i] = 0;
          to_go = restart_interval;
        }
      }
      if (!r.short_data) {
        for (int i = 0; i < n_comps; i++) {
          const ScanComp& c = sc[i];
          const DecTable& dct = tables[c.dc];
          const DecTable& act = tables[4 + c.ac];
          int bh = interleaved ? c.h : 1, bv = interleaved ? c.v : 1;
          for (int yy = 0; yy < bv; yy++) {
            for (int xx = 0; xx < bh; xx++) {
              long row = (long)my * bv + yy, col = (long)mx * bh + xx;
              int16_t* blk = coef + 64 * (c.first + row * c.blocks_x + col);
              int s = r.decode(dct);
              int diff = 0;
              if (s) diff = extend(r.get(s), s);
              last_dc[i] = (int)((uint32_t)last_dc[i] + (uint32_t)diff);
              blk[0] = (int16_t)last_dc[i];
              for (int k = 1; k < 64; k++) {
                int rs = r.decode(act);
                int run = rs >> 4, size = rs & 15;
                if (size) {
                  k += run;
                  blk[kNatural[k]] = (int16_t)extend(r.get(size), size);
                } else {
                  if (run != 15) break;
                  k += 15;
                }
              }
            }
          }
        }
      }
      if (restart_interval) to_go--;
    }
  }
  state[0] = r.pos;
  state[1] = r.marker;
  state[2] = r.warnings;
  return 0;
}

// Decode one scan of a progressive Huffman-coded image (jdphuff.c) into
// the image's coefficients: `scan` holds Ss, Se, Ah, Al and the MCU rows
// an iMCU row has (a non-interleaved scan's component's v factor, else
// 1); `comps`, `bits`, `vals`, the MCU counts, `coef` and `state` are as
// jpeg_decode_scan's, and state[3] is set to the last iMCU row whose
// decoding started with data left (libjpeg's last_good_iMCU_row; -1 when
// none did). The caller checks the progression. Returns 0, -1 for a bad
// Huffman table, -2 for bad arguments, -3 for a DC value past an int
// (JERR_BAD_DCT_COEF).
int jpeg_decode_progressive(const uint8_t* data, long len, int n_comps,
                            const int* comps, const uint8_t* bits,
                            const uint8_t* vals, int mcus_x, int mcus_y,
                            int restart_interval, const int* scan,
                            int16_t* coef, long* state) {
  const int ss = scan[0], se = scan[1], ah = scan[2], al = scan[3];
  const int imcu = scan[4];
  if (n_comps < 1 || n_comps > 4 || mcus_x < 1 || mcus_y < 1 || imcu < 1 ||
      se > 63 || ss > se || (ss > 0 && n_comps != 1) || al > 13)
    return -2;
  ScanComp sc[4];
  DecTable tables[8];
  for (int i = 0; i < n_comps; i++) {
    const int* c = comps + i * kCompFields;
    sc[i] = {c[0], c[1], c[2], c[3], c[4], c[5]};
    // DC first scans need the DC tables, AC scans the AC table; the other
    // table numbers are not read
    if (ss == 0 && ah) continue;
    const int t = ss == 0 ? sc[i].dc : sc[i].ac;
    if (t < 0 || t > 3) return -2;
    const int id = ss == 0 ? t : 4 + t;
    if (make_dec_table(bits + 17 * id, vals + 256 * id, id < 4 ? 15 : -1,
                       &tables[id]))
      return -1;
  }
  Reader r = {data, len, 0, 0, 0, 0, false, 0};
  int last_dc[4] = {0, 0, 0, 0};
  unsigned eobrun = 0;
  int to_go = restart_interval, next_rst = 0;
  long last_good = -1;
  const bool interleaved = n_comps > 1;
  const int p1 = 1 << al, m1 = -(1 << al);
  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (!r.short_data) last_good = my / imcu;
      if (restart_interval && to_go == 0) {
        restart(r, &next_rst);
        for (int i = 0; i < 4; i++) last_dc[i] = 0;
        eobrun = 0;
        to_go = restart_interval;
      }
      if (ss == 0) {  // DC: every block of the MCU
        if (ah == 0 && r.short_data) goto next;
        for (int i = 0; i < n_comps; i++) {
          const ScanComp& c = sc[i];
          int bh = interleaved ? c.h : 1, bv = interleaved ? c.v : 1;
          for (int yy = 0; yy < bv; yy++) {
            for (int xx = 0; xx < bh; xx++) {
              long row = (long)my * bv + yy, col = (long)mx * bh + xx;
              int16_t* blk = coef + 64 * (c.first + row * c.blocks_x + col);
              if (ah) {  // refinement: the next bit of the DC value
                if (r.get(1)) blk[0] = (int16_t)(blk[0] | p1);
                continue;
              }
              int s = r.decode(tables[c.dc]);
              int diff = s ? extend(r.get(s), s) : 0;
              if ((last_dc[i] >= 0 && diff > INT32_MAX - last_dc[i]) ||
                  (last_dc[i] < 0 && diff < INT32_MIN - last_dc[i]))
                return -3;
              last_dc[i] += diff;
              blk[0] = (int16_t)((uint32_t)last_dc[i] << al);
            }
          }
        }
      } else if (!r.short_data) {  // AC: one block
        const ScanComp& c = sc[0];
        const DecTable& act = tables[4 + c.ac];
        int16_t* blk = coef + 64 * (c.first + (long)my * c.blocks_x + mx);
        if (ah == 0) {  // first: runs of zeros, values, end-of-band runs
          if (eobrun > 0) {
            eobrun--;
          } else {
            for (int k = ss; k <= se; k++) {
              int rs = r.decode(act);
              int run = rs >> 4, s = rs & 15;
              if (s) {
                k += run;
                blk[kNatural[k]] =
                    (int16_t)((uint32_t)extend(r.get(s), s) << al);
              } else if (run == 15) {
                k += 15;
              } else {
                eobrun = 1u << run;
                if (run) eobrun += r.get(run);
                eobrun--;
                break;
              }
            }
          }
        } else {  // refinement: correction bits, newly nonzero values
          int k = ss;
          if (eobrun == 0) {
            for (; k <= se; k++) {
              int rs = r.decode(act);
              int run = rs >> 4, s = rs & 15;
              if (s) {
                if (s != 1) r.warnings++;
                s = r.get(1) ? p1 : m1;
              } else if (run != 15) {
                eobrun = 1u << run;
                if (run) eobrun += r.get(run);
                break;
              }
              do {
                int16_t* t = blk + kNatural[k];
                if (*t != 0) {
                  if (r.get(1) && (*t & p1) == 0)
                    *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
                } else if (--run < 0) {
                  break;
                }
                k++;
              } while (k <= se);
              if (s) blk[kNatural[k]] = (int16_t)s;
            }
          }
          if (eobrun > 0) {
            for (; k <= se; k++) {
              int16_t* t = blk + kNatural[k];
              if (*t != 0 && r.get(1) && (*t & p1) == 0)
                *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
            }
            eobrun--;
          }
        }
      }
    next:
      if (restart_interval) to_go--;
    }
  }
  state[0] = r.pos;
  state[1] = r.marker;
  state[2] = r.warnings;
  state[3] = last_good;
  return 0;
}

// Decode one arithmetic-coded scan (jdarith.c), sequential or
// progressive: `scan` holds progressive (0 / 1), Ss, Se, Ah, Al and the
// MCU rows of an iMCU row; `conditioning` 48 bytes, the DC L and U values
// and the AC Kx value of each of the 16 tables (DAC, else 0, 1 and 5).
// `comps` as jpeg_decode_scan's, their DC and AC fields the arithmetic
// table numbers (0-15). Fills `state` as jpeg_decode_progressive does
// (the decoder never runs out of data: it reads zeros). Returns 0 or -2
// for bad arguments.
int jpeg_decode_arith(const uint8_t* data, long len, int n_comps,
                      const int* comps, const uint8_t* conditioning,
                      int mcus_x, int mcus_y, int restart_interval,
                      const int* scan, int16_t* coef, long* state) {
  const bool progressive = scan[0] != 0;
  const int ss = scan[1], se = scan[2], ah = scan[3], al = scan[4];
  const int imcu = scan[5];
  if (n_comps < 1 || n_comps > 4 || mcus_x < 1 || mcus_y < 1 || imcu < 1)
    return -2;
  // a sequential scan's Ss, Se, Ah and Al are not read (libjpeg warns)
  if (progressive &&
      (se > 63 || ss > se || (ss > 0 && n_comps != 1) || al > 13))
    return -2;
  const uint8_t* dc_l = conditioning;
  const uint8_t* dc_u = conditioning + kArithTables;
  const uint8_t* ac_k = conditioning + 2 * kArithTables;
  ScanComp sc[4];
  for (int i = 0; i < n_comps; i++) {
    const int* c = comps + i * kCompFields;
    sc[i] = {c[0], c[1], c[2], c[3], c[4], c[5]};
    if (sc[i].dc < 0 || sc[i].dc >= kArithTables || sc[i].ac < 0 ||
        sc[i].ac >= kArithTables)
      return -2;
  }
  const bool dc_scan = !progressive || (ss == 0 && ah == 0);
  const bool ac_scan = !progressive || ss > 0;
  uint8_t dc_stats[kArithTables][kDcBins], ac_stats[kArithTables][kAcBins];
  uint8_t fixed_bin = 113;
  int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
  auto reset_stats = [&] {
    for (int i = 0; i < n_comps; i++) {
      if (dc_scan) {
        memset(dc_stats[sc[i].dc], 0, kDcBins);
        last_dc[i] = 0;
        dc_context[i] = 0;
      }
      if (ac_scan) memset(ac_stats[sc[i].ac], 0, kAcBins);
    }
  };
  reset_stats();
  ArithReader r = {data, len, 0, 0, 0, 0, 0, -16};
  int to_go = restart_interval, next_rst = 0;
  const bool interleaved = n_comps > 1;
  const int p1 = 1 << al, m1 = -(1 << al);
  // Figure F.19 and F.21-F.24: one DC difference of scan component i,
  // added to its prediction; false on a magnitude overflow
  auto dc_value = [&](int i) {
    const int tbl = sc[i].dc;
    uint8_t* st = dc_stats[tbl] + dc_context[i];
    if (r.decode(st) == 0) {
      dc_context[i] = 0;
      return true;
    }
    const int sign = r.decode(st + 1);
    st += 2 + sign;
    int m = arith_magnitude(r, st, dc_stats[tbl] + 20, false);
    if (m < 0) return false;
    // F.1.4.4.1.2: the conditioning category of the next difference
    const int mag = m == 0 ? 0 : 1 << (31 - __builtin_clz((unsigned)m));
    if (mag < (int)((1L << dc_l[tbl]) >> 1))
      dc_context[i] = 0;
    else if (mag > (int)((1L << dc_u[tbl]) >> 1))
      dc_context[i] = 12 + sign * 4;
    else
      dc_context[i] = 4 + sign * 4;
    int v = m + 1;
    if (sign) v = -v;
    last_dc[i] = (last_dc[i] + v) & 0xFFFF;
    return true;
  };
  // Figure F.20: the AC coefficients ss..se of one block, scaled by `al`;
  // false on an overflow
  auto ac_first = [&](int16_t* blk, int tbl, int from, int to, int shift) {
    for (int k = from; k <= to; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (r.decode(st)) break;  // end of block
      while (r.decode(st + 1) == 0) {
        st += 3;
        k++;
        if (k > to) {
          r.warnings++;
          return false;
        }
      }
      const int sign = r.decode(&fixed_bin);
      st += 2;
      int m = arith_magnitude(r, st,
                              ac_stats[tbl] + (k <= ac_k[tbl] ? 189 : 217),
                              true);
      if (m < 0) return false;
      int v = m + 1;
      if (sign) v = -v;
      blk[kNatural[k]] = (int16_t)((unsigned)v << shift);
    }
    return true;
  };
  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval) {
        if (to_go == 0) {  // process_restart
          read_restart_marker(r, &next_rst);
          reset_stats();
          r.c = 0;
          r.a = 0;
          r.ct = -16;
          to_go = restart_interval;
        }
        to_go--;
      }
      if (progressive && ss == 0 && ah) {  // DC refinement: a bit a block
        for (int i = 0; i < n_comps; i++) {
          const ScanComp& c = sc[i];
          int bh = interleaved ? c.h : 1, bv = interleaved ? c.v : 1;
          for (int yy = 0; yy < bv; yy++)
            for (int xx = 0; xx < bh; xx++) {
              long row = (long)my * bv + yy, col = (long)mx * bh + xx;
              int16_t* blk = coef + 64 * (c.first + row * c.blocks_x + col);
              if (r.decode(&fixed_bin)) blk[0] = (int16_t)(blk[0] | p1);
            }
        }
        continue;
      }
      if (r.ct == -1) continue;  // after an error, nothing more is decoded
      if (!progressive || ss == 0) {
        for (int i = 0; i < n_comps; i++) {
          const ScanComp& c = sc[i];
          int bh = interleaved ? c.h : 1, bv = interleaved ? c.v : 1;
          for (int yy = 0; yy < bv; yy++) {
            for (int xx = 0; xx < bh; xx++) {
              long row = (long)my * bv + yy, col = (long)mx * bh + xx;
              int16_t* blk = coef + 64 * (c.first + row * c.blocks_x + col);
              if (!dc_value(i)) {
                r.ct = -1;
                goto next;
              }
              blk[0] = (int16_t)((uint32_t)last_dc[i] << (progressive ? al
                                                                      : 0));
              if (!progressive && !ac_first(blk, c.ac, 1, 63, 0)) {
                r.ct = -1;
                goto next;
              }
            }
          }
        }
      } else if (ah == 0) {
        const ScanComp& c = sc[0];
        int16_t* blk = coef + 64 * (c.first + (long)my * c.blocks_x + mx);
        if (!ac_first(blk, c.ac, ss, se, al)) r.ct = -1;
      } else {  // AC refinement
        const ScanComp& c = sc[0];
        int16_t* blk = coef + 64 * (c.first + (long)my * c.blocks_x + mx);
        int kex = se;  // the previous stage's end of block
        for (; kex > 0; kex--)
          if (blk[kNatural[kex]]) break;
        for (int k = ss; k <= se; k++) {
          uint8_t* st = ac_stats[c.ac] + 3 * (k - 1);
          if (k > kex && r.decode(st)) break;  // end of block
          for (;;) {
            int16_t* t = blk + kNatural[k];
            if (*t) {  // a coefficient already nonzero: a correction bit
              if (r.decode(st + 2))
                *t = (int16_t)(*t < 0 ? *t + m1 : *t + p1);
              break;
            }
            if (r.decode(st + 1)) {  // newly nonzero
              *t = (int16_t)(r.decode(&fixed_bin) ? m1 : p1);
              break;
            }
            st += 3;
            k++;
            if (k > se) {
              r.warnings++;
              r.ct = -1;
              goto next;
            }
          }
        }
      }
    next:;
    }
  }
  state[0] = r.pos;
  state[1] = r.marker;
  state[2] = r.warnings;
  state[3] = mcus_y > 0 ? (mcus_y - 1) / imcu : -1;
  return 0;
}

// libjpeg-turbo 2.1's block smoothing of a progressive image whose AC
// coefficients are not all known to full precision (jdcoefct.c
// decompress_smooth_data, applied where smoothing_ok holds, which the
// caller decides): the first 9 AC coefficients of each block that are
// still zero are estimated from the DC values of the 5 x 5 blocks around
// it, and where no AC data came at all the DC value too. `coef` is read,
// `out` (a copy of it) written, over each component's real blocks.
// `comp_info` holds 5 ints a component: first block, blocks a padded row,
// real blocks a row and real block rows, its v factor; `quant` its quant
// values (64 a component, natural order), `bits` and `prev_bits` its
// coef_bits latched for coefficients 0-9 now and before the last scan.
// Rows of iMCUs past `last_good` use `prev_bits`.
void jpeg_smooth(const int16_t* coef, int16_t* out, int n_comp,
                 const int* comp_info, int imcu_rows, const int* quant,
                 const int* bits, const int* prev_bits, long last_good) {
  const int last_row = imcu_rows - 1;
  for (int ci = 0; ci < n_comp; ci++) {
    const int* info = comp_info + 5 * ci;
    const int first = info[0], pitch = info[1], wb = info[2], hb = info[3];
    const int v = info[4];
    const int* q = quant + 64 * ci;
    auto dc = [&](long row, long col) {
      return (int)coef[64 * (first + row * pitch + col)];
    };
    for (int r = 0; r < imcu_rows; r++) {
      int block_rows = v;
      if (r == last_row) {
        block_rows = hb % v;
        if (block_rows == 0) block_rows = v;
      }
      const int* cb = (r > last_good ? prev_bits : bits) + kSavedCoefs * ci;
      bool change_dc = true;
      for (int k = 1; k < kSavedCoefs; k++) change_dc &= cb[k] == -1;
      const int64_t q00 = q[0];
      for (int br = 0; br < block_rows; br++) {
        const long row = (long)r * v + br;
        const long prev = (br > 0 || r > 0) ? row - 1 : row;
        const long prev2 = (br > 1 || r > 1) ? row - 2 : prev;
        const long next = (br < block_rows - 1 || r < last_row) ? row + 1 : row;
        const long next2 =
            (br < block_rows - 2 || r + 1 < last_row) ? row + 2 : next;
        const long rows[5] = {prev2, prev, row, next, next2};
        // the 5 x 5 DC values, row-major (DC01..DC25), in sliding registers
        int d[5][5];
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 5; j++) d[i][j] = dc(rows[i], 0);
        const int last_col = wb - 1;
        for (int bn = 0; bn < wb; bn++) {
          if (bn == 0 && bn < last_col)
            for (int i = 0; i < 5; i++) d[i][3] = dc(rows[i], bn + 1);
          if (bn + 1 < last_col)
            for (int i = 0; i < 5; i++) d[i][4] = dc(rows[i], bn + 2);
          int16_t* ws = out + 64 * (first + row * pitch + bn);
#define DC(n) ((int64_t)d[((n) - 1) / 5][((n) - 1) % 5])
          int64_t num;
          int al;
          if ((al = cb[1]) != 0 && ws[1] == 0) {
            num = q00 * (change_dc
                ? (-DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7) -
                   13 * DC(9) + 3 * DC(10) - 3 * DC(11) + 38 * DC(12) -
                   38 * DC(14) + 3 * DC(15) - 3 * DC(16) + 13 * DC(17) -
                   13 * DC(19) + 3 * DC(20) - DC(21) - DC(22) + DC(24) +
                   DC(25))
                : (-7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15)));
            ws[1] = (int16_t)smooth_pred(num, q[1], al);
          }
          if ((al = cb[2]) != 0 && ws[8] == 0) {
            num = q00 * (change_dc
                ? (-DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) -
                   DC(6) + 13 * DC(7) + 38 * DC(8) + 13 * DC(9) - DC(10) +
                   DC(16) - 13 * DC(17) - 38 * DC(18) - 13 * DC(19) +
                   DC(20) + DC(21) + 3 * DC(22) + 3 * DC(23) + 3 * DC(24) +
                   DC(25))
                : (-7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23)));
            ws[8] = (int16_t)smooth_pred(num, q[8], al);
          }
          if ((al = cb[3]) != 0 && ws[16] == 0) {
            num = q00 * (change_dc
                ? (DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) -
                   14 * DC(13) - 5 * DC(14) + 2 * DC(17) + 7 * DC(18) +
                   2 * DC(19) + DC(23))
                : (-DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) - DC(23)));
            ws[16] = (int16_t)smooth_pred(num, q[16], al);
          }
          if ((al = cb[4]) != 0 && ws[9] == 0) {
            num = q00 * (change_dc
                ? (-DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) +
                   9 * DC(19) + DC(21) - DC(25))
                : (DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) -
                   DC(20) + DC(22) - DC(24) + DC(4) - DC(6) + 10 * DC(7) -
                   10 * DC(9)));
            ws[9] = (int16_t)smooth_pred(num, q[9], al);
          }
          if ((al = cb[5]) != 0 && ws[2] == 0) {
            num = q00 * (change_dc
                ? (2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12) -
                   14 * DC(13) + 7 * DC(14) + DC(15) + 2 * DC(17) -
                   5 * DC(18) + 2 * DC(19))
                : (-DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) -
                   DC(15)));
            ws[2] = (int16_t)smooth_pred(num, q[2], al);
          }
          if (change_dc) {
            if ((al = cb[6]) != 0 && ws[3] == 0) {
              num = q00 * (DC(7) - DC(9) + 2 * DC(12) - 2 * DC(14) + DC(17) -
                           DC(19));
              ws[3] = (int16_t)smooth_pred(num, q[3], al);
            }
            if ((al = cb[7]) != 0 && ws[10] == 0) {
              num = q00 * (DC(7) - 3 * DC(8) + DC(9) - DC(17) + 3 * DC(18) -
                           DC(19));
              ws[10] = (int16_t)smooth_pred(num, q[10], al);
            }
            if ((al = cb[8]) != 0 && ws[17] == 0) {
              num = q00 * (DC(7) - DC(9) - 3 * DC(12) + 3 * DC(14) + DC(17) -
                           DC(19));
              ws[17] = (int16_t)smooth_pred(num, q[17], al);
            }
            if ((al = cb[9]) != 0 && ws[24] == 0) {
              num = q00 * (DC(7) + 2 * DC(8) + DC(9) - DC(17) - 2 * DC(18) -
                           DC(19));
              ws[24] = (int16_t)smooth_pred(num, q[24], al);
            }
            num = q00 * (-2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) -
                         2 * DC(5) - 6 * DC(6) + 6 * DC(7) + 42 * DC(8) +
                         6 * DC(9) - 6 * DC(10) - 8 * DC(11) + 42 * DC(12) +
                         152 * DC(13) + 42 * DC(14) - 8 * DC(15) -
                         6 * DC(16) + 6 * DC(17) + 42 * DC(18) + 6 * DC(19) -
                         6 * DC(20) - 2 * DC(21) - 6 * DC(22) - 8 * DC(23) -
                         6 * DC(24) - 2 * DC(25));
            ws[0] = (int16_t)smooth_pred(num, q00, 0);
          }
#undef DC
          for (int i = 0; i < 5; i++)
            for (int j = 0; j < 4; j++) d[i][j] = d[i][j + 1];
        }
      }
    }
  }
}

// Encode one scan of quantised coefficients (natural order) with the
// given Huffman tables (the same layout as jpeg_decode_scan's), restart
// markers every `restart_interval` MCUs, into `out`. Returns the bytes
// written, -1 for a bad table, or -(bytes needed) - 2 when `cap` is too
// small.
long jpeg_encode_scan(const int16_t* coef, int n_comps, const int* comps,
                      const uint8_t* bits, const uint8_t* vals, int mcus_x,
                      int mcus_y, int restart_interval, uint8_t* out,
                      long cap) {
  if (n_comps < 1 || n_comps > 4) return -1;
  ScanComp sc[4];
  EncTable tables[8];
  for (int id = 0; id < 8; id++) {
    if (make_enc_table(bits + 17 * id, vals + 256 * id, &tables[id]) != 0)
      return -1;
  }
  for (int i = 0; i < n_comps; i++) {
    const int* c = comps + i * kCompFields;
    sc[i] = {c[0], c[1], c[2], c[3], c[4], c[5]};
  }
  Writer w = {out, cap, 0, 0, 0, false};
  int last_dc[4] = {0, 0, 0, 0};
  int to_go = restart_interval, rst = 0;
  const bool interleaved = n_comps > 1;
  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval) {
        if (to_go == 0) {
          w.flush();
          w.byte(0xFF);
          w.byte((uint8_t)(0xD0 + rst));
          rst = (rst + 1) & 7;
          for (int i = 0; i < 4; i++) last_dc[i] = 0;
          to_go = restart_interval;
        }
        to_go--;
      }
      for (int i = 0; i < n_comps; i++) {
        const ScanComp& c = sc[i];
        const EncTable& dct = tables[c.dc];
        const EncTable& act = tables[4 + c.ac];
        int bh = interleaved ? c.h : 1, bv = interleaved ? c.v : 1;
        for (int yy = 0; yy < bv; yy++) {
          for (int xx = 0; xx < bh; xx++) {
            long row = (long)my * bv + yy, col = (long)mx * bh + xx;
            const int16_t* blk =
                coef + 64 * (c.first + row * c.blocks_x + col);
            int diff = blk[0] - last_dc[i];
            last_dc[i] = blk[0];
            int a = diff < 0 ? -diff : diff, nb = 0;
            while (a) {
              nb++;
              a >>= 1;
            }
            w.put(dct.code[nb], dct.size[nb]);
            w.put((uint32_t)(diff < 0 ? diff - 1 : diff), nb);
            int run = 0;
            for (int k = 1; k < 64; k++) {
              int v = blk[kNatural[k]];
              if (v == 0) {
                run++;
                continue;
              }
              while (run > 15) {
                w.put(act.code[0xF0], act.size[0xF0]);
                run -= 16;
              }
              int m = v < 0 ? -v : v;
              nb = 0;
              while (m) {
                nb++;
                m >>= 1;
              }
              int sym = (run << 4) | nb;
              w.put(act.code[sym], act.size[sym]);
              w.put((uint32_t)(v < 0 ? v - 1 : v), nb);
              run = 0;
            }
            if (run > 0) w.put(act.code[0], act.size[0]);
          }
        }
      }
    }
  }
  w.flush();
  if (w.overflow) return -w.n - 2;
  return w.n;
}

}  // extern "C"
