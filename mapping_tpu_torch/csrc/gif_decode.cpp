// GIF image data (LZW) on the host, for mapping_tpu_torch/utils/gif.py.
// The JAX package reads GIF through Pillow; this follows Pillow 12.1's C
// decoder (GifDecode.c) and the way ImageFile.load feeds it, probed
// against it:
//
// - codes LSB first, from data sub-blocks; a sub-block is decoded only
//   once it is whole, and a size byte of 0 is read as an empty sub-block
//   (the terminator does not end the data);
// - the code size starts at the minimum code size + 1 (0 to 12 accepted)
//   and grows when the next free entry equals the code mask before it is
//   taken, up to 12 bits; entries stop at 4096 (no deferred clear);
// - the first code after a clear (or at the start) is used as it is and
//   must not exceed the clear code; a later code must not exceed the next
//   free entry (equal to it: the previous string and its first byte); a
//   string longer than the 4096-byte buffer fails;
// - samples fill the frame's rectangle row by row, a string running on
//   into the next row; interlaced frames take rows 0, 8, ..., then 4, 8k
//   + 4, then 2, 4k + 2, then the odd rows; the decode ends with the last
//   row, whatever follows;
// - the end code pauses the decoder until Pillow reads more of the file:
//   ImageFile.load hands it the data in 65,536-byte reads, so after an
//   end code it resumes with the next read, and where the file has no
//   more the image is truncated.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kTable = 4096, kBuffer = 4096, kBits = 12, kRead = 65536;

enum Status : int { kFilled = 0, kTruncated = -1, kBroken = -2 };

struct Lzw {
  // the frame's rectangle in the image
  uint8_t* image;
  long stride;
  int xoff, yoff, xsize, ysize;
  int x = 0, y = 0, step = 1, interlace = 0;
  // the code stream
  int bits, clear, end, next = 0, codesize = 0, codemask = 0;
  int state = 1;  // 1 reset the table, 2 after a clear, 3 running
  uint32_t bitbuffer = 0;
  int bitcount = 0, blocksize = 0;
  int lastcode = 0;
  uint8_t lastdata = 0;
  uint8_t data[kTable];
  uint16_t link[kTable];
  uint8_t buffer[kBuffer];
  int bufferindex = kBuffer;

  // the next row, or false once the frame is full
  bool newline() {
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (interlace) {
        case 1: y = 4; interlace = 2; break;
        case 2: step = 4; y = 2; interlace = 3; break;
        case 3: step = 2; y = 1; interlace = 0; break;
        default: return false;
      }
    }
    return true;
  }

  // one sample; false once the frame is full
  bool put(uint8_t v) {
    image[(long)(y + yoff) * stride + xoff + x] = v;
    return ++x < xsize || newline();
  }

  // GifDecode.c's decode call on `bytes` bytes: the bytes consumed (>= 0),
  // or kFilled / kBroken once it ends
  long decode(const uint8_t* buf, long bytes, int* status) {
    const uint8_t* ptr = buf;
    for (;;) {
      if (state == 1) {
        next = clear + 2;
        codesize = bits + 1;
        codemask = (1 << codesize) - 1;
        bufferindex = kBuffer;
        state = 2;
      }
      const uint8_t* p;
      int n;
      if (bufferindex < kBuffer) {  // the rest of a string
        n = kBuffer - bufferindex;
        p = buffer + bufferindex;
        bufferindex = kBuffer;
      } else {
        while (bitcount < codesize) {
          if (blocksize > 0) {
            bitbuffer |= (uint32_t)*ptr++ << bitcount;
            --bytes;
            --blocksize;
            bitcount += 8;
          } else {  // a sub-block, once it is whole
            if (bytes < 1 || bytes < *ptr + 1) return ptr - buf;
            blocksize = *ptr++;
            --bytes;
          }
        }
        int c = bitbuffer & codemask;
        bitbuffer >>= codesize;
        bitcount -= codesize;
        if (c == clear) {
          if (state != 2) state = 1;
          continue;
        }
        if (c == end) return ptr - buf;
        n = 1;
        p = &lastdata;
        if (state == 2) {
          if (c > clear) {
            *status = kBroken;
            return -1;
          }
          lastdata = (uint8_t)c;
          lastcode = c;
          state = 3;
        } else {
          const int thiscode = c;
          if (c > next) {
            *status = kBroken;
            return -1;
          }
          if (c == next) {
            if (bufferindex <= 0) {
              *status = kBroken;
              return -1;
            }
            buffer[--bufferindex] = lastdata;
            c = lastcode;
          }
          while (c >= clear) {
            if (bufferindex <= 0 || c >= kTable) {
              *status = kBroken;
              return -1;
            }
            buffer[--bufferindex] = data[c];
            c = link[c];
          }
          lastdata = (uint8_t)c;
          if (next < kTable) {
            data[next] = (uint8_t)c;
            link[next] = (uint16_t)lastcode;
            if (next == codemask && codesize < kBits) {
              ++codesize;
              codemask = (1 << codesize) - 1;
            }
            ++next;
          }
          lastcode = thiscode;
        }
      }
      for (int i = 0; i < n; ++i) {
        if (!put(p[i])) {
          *status = kFilled;
          return -1;
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// Decodes the LZW data of `file` (n bytes) that starts at `pos` (the first
// sub-block's size byte) into the rectangle (xoff, yoff, xsize, ysize) of
// `image`, a row-major uint8 image `stride` samples wide that already holds
// the canvas Pillow starts from. Returns 0 once the rectangle is full, -1
// for a truncated file, -2 for a broken stream, -3 for a code size past
// 12.
int gif_lzw_decode(const uint8_t* file, long n, long pos, int bits,
                   int interlaced, uint8_t* image, long stride, int xoff,
                   int yoff, int xsize, int ysize) {
  if (bits < 0 || bits > kBits) return -3;
  Lzw lzw{image, stride, xoff, yoff, xsize, ysize};
  lzw.bits = bits;
  lzw.clear = 1 << bits;
  lzw.end = lzw.clear + 1;
  if (interlaced) {
    lzw.interlace = 1;
    lzw.step = 8;
  }
  // ImageFile.load: reads of kRead bytes, each appended to what the
  // decoder left, until it ends or the file does
  long start = pos, stop = pos;
  for (;;) {
    if (stop >= n) return kTruncated;
    stop = stop + kRead < n ? stop + kRead : n;
    int status = kBroken;
    const long used = lzw.decode(file + start, stop - start, &status);
    if (used < 0) return status;
    start += used;
  }
}

}  // extern "C"
