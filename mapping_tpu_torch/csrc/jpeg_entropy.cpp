// Baseline JPEG entropy coding on the host: the Huffman decode of one scan
// into int16 coefficient blocks, and the Huffman encode of one scan for
// the port's fixture encoder (mapping_tpu_torch/utils/jpeg.py).
//
// The port decodes JPEG in two parts: this file turns the entropy-coded
// bytes into quantised DCT coefficients on the host, and the pixel stage
// (dequantise, IDCT, upsampling, colour) runs on the card
// (csrc/jpeg_pixels.cu) or, for CPU tensors, as plain PyTorch
// (kernels/jpeg.py). Neither replaces a TPU kernel: the JAX package
// decodes every tile on the host with libjpeg (cpp/decode.cpp).
//
// The decode follows libjpeg-turbo's jdhuff.c / jdmarker.c bit for bit,
// corrupt streams included:
// - the bit reader stops at a marker (0xFF followed by a byte other than
//   0x00 after any 0xFF fill bytes) and the end of the data counts as
//   one; bits asked for past it are zeros (`jpeg_fill_bit_buffer`);
// - once a block consumed such bits, the MCUs after it are left at zero
//   until a restart marker with data behind it (`decode_mcu`);
// - a code longer than 16 bits decodes as symbol 0 after 17 bits
//   (`jpeg_huff_decode`); a run past coefficient 63 writes coefficient
//   63 (`jpeg_natural_order`'s extra entries);
// - at each restart interval the remaining bits are dropped, the marker
//   is found (`next_marker`), matched or resynchronised as
//   `jpeg_resync_to_restart` does, and the DC predictors reset.
// The caller zeroes the coefficient buffer; blocks are written in
// natural (row-major) order. Both calls hold no Python object, so ctypes
// releases the GIL for the whole call.

#include <cstdint>
#include <cstring>

namespace {

// zigzag index -> natural index, with libjpeg's 16 guard entries of 63
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jdhuff.c jpeg_make_d_derived_tbl: maxcode / valoffset per code length,
// and an 8-bit look-ahead (length << 8 | symbol, 0 for longer codes).
struct DecTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[256];
};

int make_dec_table(const uint8_t* bits, const uint8_t* vals, bool is_dc,
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
  if (is_dc) {
    for (int i = 0; i < count; i++)
      if (vals[i] > 15) return -1;
  }
  return 0;
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

  // jdmarker.c next_marker: skip to the next marker
  void next_marker() {
    for (;;) {
      uint8_t c;
      do {
        if (pos >= len) {
          marker = 0xD9;
          return;
        }
        c = d[pos++];
      } while (c != 0xFF);
      do {
        if (pos >= len) {
          marker = 0xD9;
          return;
        }
        c = d[pos++];
      } while (c == 0xFF);
      if (c != 0) {
        marker = c;
        return;
      }
    }
  }
};

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? (int)v + (int)((~0u << s) + 1) : (int)v;
}

// process_restart + read_restart_marker + jpeg_resync_to_restart
void restart(Reader& r, int* next_rst) {
  r.buf = 0;
  r.bits = 0;
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
  if (r.marker == 0) r.short_data = false;
}

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
        if (make_dec_table(bits + 17 * id, vals + 256 * id, id < 4,
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
