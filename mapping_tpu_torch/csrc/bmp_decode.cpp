// Run-length BMP data (RLE8 and RLE4) on the host, for
// mapping_tpu_torch/utils/bmp.py. The JAX package reads BMP through
// Pillow, whose BmpRleDecoder (BmpImagePlugin.py) is written in Python;
// this follows it operation for operation, its quirks included:
//
// - an encoded run that passes the end of the row is clipped to the row;
//   an RLE4 run alternates the byte's high and low nibble;
// - 00 00 (end of line) pads the output with zeros to a whole row,
//   00 01 (end of bitmap) stops;
// - 00 02 (delta) consumes four bytes: two that are skipped, then the
//   right and up counts; it appends right + up x width zeros. Fewer than
//   two bytes after the escape stop the decode; two or three fail it (the
//   Python unpacking of a short read);
// - absolute mode copies n bytes (RLE8) or n / 2 bytes of two nibbles each
//   (RLE4, so an odd count loses its last pixel), without clipping to the
//   row; a short read stops the decode; then the position in the FILE is
//   aligned to an even byte;
// - the decode stops once the output holds width x height samples, or
//   where the data ends.
//
// The output is the flat sample string Pillow builds (it may run past
// width x height); utils/bmp.py lays it out in rows and refuses it where it
// is shorter than the image, as Pillow does ("not enough image data").

#include <cstdint>
#include <cstring>

extern "C" {

// Decodes the RLE data of `file` (n bytes) from `pos`, for an image
// `width` wide holding `total` samples, into `out` (capacity `cap`).
// Returns the number of samples written, -1 for a delta cut short, -2 if
// `out` is too small.
long bmp_rle_decode(const uint8_t* file, long n, long pos, long width,
                    long total, int rle4, uint8_t* out, long cap) {
  long len = 0, x = 0;
  auto grow = [&](long k) { return len + k <= cap; };
  while (len < total) {
    if (pos + 2 > n) break;  // a pair cut short
    const int count = file[pos], byte = file[pos + 1];
    pos += 2;
    if (count) {  // encoded run
      long run = count;
      if (x + run > width) run = width - x > 0 ? width - x : 0;
      if (!grow(run)) return -2;
      if (rle4) {
        const uint8_t hi = byte >> 4, lo = byte & 0x0F;
        for (long i = 0; i < run; ++i) out[len++] = (i & 1) ? lo : hi;
      } else {
        std::memset(out + len, byte, run);
        len += run;
      }
      x += run;
    } else if (byte == 0) {  // end of line
      const long pad = (width - len % width) % width;
      if (!grow(pad)) return -2;
      std::memset(out + len, 0, pad);
      len += pad;
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: two bytes skipped, then right, up
      if (pos + 2 > n) break;
      pos += 2;
      if (pos + 2 > n) return -1;
      const long right = file[pos], up = file[pos + 1];
      pos += 2;
      const long add = right + up * width;
      if (!grow(add)) return -2;
      std::memset(out + len, 0, add);
      len += add;
      x = len % width;
    } else {  // absolute mode
      const long want = rle4 ? byte / 2 : byte;
      const long got = pos + want <= n ? want : (n - pos > 0 ? n - pos : 0);
      if (!grow(rle4 ? 2 * got : got)) return -2;
      for (long i = 0; i < got; ++i) {
        const uint8_t b = file[pos + i];
        if (rle4) {
          out[len++] = b >> 4;
          out[len++] = b & 0x0F;
        } else {
          out[len++] = b;
        }
      }
      pos += got;
      if (got < want) break;
      x += byte;
      if (pos % 2) ++pos;  // word alignment by the file position
    }
  }
  return len;
}

}  // extern "C"
