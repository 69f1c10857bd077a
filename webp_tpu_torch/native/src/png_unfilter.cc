// PNG row unfiltering (PNG spec, section 9: filter method 0) for the
// port's PNG reader (utils/png.py).
//
// Sub, Average and Paeth each depend on the byte just reconstructed to
// their left, so a row is a sequential walk; this loop does in
// milliseconds what a Python loop over a 1536x1024 RGB image does in
// seconds. Plain C interface, loaded by ctypes.
#include <stdint.h>
#include <stdlib.h>

static inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// src: `rows` scanlines of 1 + rowbytes bytes, each its filter type then
// its filtered bytes; dst: rows x rowbytes reconstructed bytes. bpp is the
// byte distance to the corresponding byte of the pixel to the left
// (bytes per complete pixel, at least 1). The row above the first row is
// zeros. Returns 0, or 1 + the index of the first row whose filter type
// is not 0-4 (dst is then incomplete).
extern "C" long png_unfilter(const uint8_t* src, uint8_t* dst, long rows,
                             long rowbytes, long bpp) {
  for (long y = 0; y < rows; ++y) {
    const uint8_t* in = src + y * (rowbytes + 1);
    const int type = in[0];
    ++in;
    uint8_t* out = dst + y * rowbytes;
    const uint8_t* up = y > 0 ? out - rowbytes : nullptr;
    switch (type) {
      case 0:
        for (long i = 0; i < rowbytes; ++i) out[i] = in[i];
        break;
      case 1:
        for (long i = 0; i < rowbytes; ++i)
          out[i] = (uint8_t)(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (long i = 0; i < rowbytes; ++i)
          out[i] = (uint8_t)(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (long i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          out[i] = (uint8_t)(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}
