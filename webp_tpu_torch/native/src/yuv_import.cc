// Native RGB -> YUV420 import (the host side of the encode pipeline).
//
// Exact parity with the reference's numpy rgb_to_yuv420 without dithering
// (lossy/encode.go:671-838 importImage + dsp/yuv.go gamma accumulation):
// per-pixel integer luma; chroma from gamma-corrected 2x2 accumulation
// with the interpolated LinearToGamma lookup. Planes are padded to
// macroblock multiples by border replication.
//
// numpy's lookup-table indexing holds the GIL for this; the importer is
// called through ctypes, which releases the GIL, so a thread pool converts
// a whole batch in parallel.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kYFix = 16;
constexpr int kYHalf = 1 << (kYFix - 1);
constexpr int kGammaFix = 12;
constexpr int kGammaScale = (1 << kGammaFix) - 1;
constexpr int kGammaTabFix = 7;
constexpr int kGammaTabScale = 1 << kGammaTabFix;
constexpr int kGammaTabSize = 1 << (kGammaFix - kGammaTabFix);

struct GammaTables {
  int32_t to_linear[256];
  int32_t to_gamma[kGammaTabSize + 2];
  GammaTables() {
    for (int v = 0; v < 256; ++v)
      to_linear[v] =
          (int32_t)(std::pow(v / 255.0, 0.80) * kGammaScale + 0.5);
    const double scale = (double)kGammaTabScale / kGammaScale;
    for (int v = 0; v <= kGammaTabSize; ++v)
      to_gamma[v] =
          (int32_t)(std::pow(scale * v, 1.0 / 0.80) * 255.0 + 0.5);
    to_gamma[kGammaTabSize + 1] = 255;
  }
};
const GammaTables kGamma;

inline int LinearToGamma(int64_t base) {
  // base: sum of 4 linear values in [0, 4*kGammaScale]; returns 4x-scale.
  int64_t v = base;  // shift = 0
  int64_t tab_pos = v >> (kGammaTabFix + 2);
  if (tab_pos > kGammaTabSize - 1) tab_pos = kGammaTabSize - 1;
  int64_t x = v & ((kGammaTabScale << 2) - 1);
  int64_t y = (int64_t)kGamma.to_gamma[tab_pos + 1] * x +
              (int64_t)kGamma.to_gamma[tab_pos] * ((kGammaTabScale << 2) - x);
  return (int)((y + (kGammaTabScale >> 1)) >> kGammaTabFix);
}

inline uint8_t Clip255(int64_t v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// rgb: [h, w, 3] u8. Y out: [mbh*16, mbw*16]; U/V out: [mbh*8, mbw*8].
void yuv_import(const uint8_t* rgb, int h, int w, uint8_t* Y, uint8_t* U,
                uint8_t* V) {
  const int mbw = (w + 15) >> 4, mbh = (h + 15) >> 4;
  const int ys = mbw * 16, cs = mbw * 8;
  const int yh = mbh * 16, chh = mbh * 8;

  for (int y = 0; y < h; ++y) {
    const uint8_t* row = rgb + (size_t)y * w * 3;
    uint8_t* out = Y + (size_t)y * ys;
    for (int x = 0; x < w; ++x) {
      const int r = row[3 * x], g = row[3 * x + 1], b = row[3 * x + 2];
      out[x] = Clip255((16839LL * r + 33059LL * g + 6420LL * b + kYHalf +
                        (16LL << kYFix)) >> kYFix);
    }
    for (int x = w; x < ys; ++x) out[x] = out[w - 1];
  }
  for (int y = h; y < yh; ++y)
    std::memcpy(Y + (size_t)y * ys, Y + (size_t)(h - 1) * ys, ys);

  const int cw = (w + 1) >> 1, ch = (h + 1) >> 1;
  for (int cy = 0; cy < ch; ++cy) {
    const int y0 = 2 * cy, y1 = (2 * cy + 1 < h) ? 2 * cy + 1 : h - 1;
    const uint8_t* r0 = rgb + (size_t)y0 * w * 3;
    const uint8_t* r1 = rgb + (size_t)y1 * w * 3;
    uint8_t* uo = U + (size_t)cy * cs;
    uint8_t* vo = V + (size_t)cy * cs;
    for (int cx = 0; cx < cw; ++cx) {
      const int x0 = 2 * cx, x1 = (2 * cx + 1 < w) ? 2 * cx + 1 : w - 1;
      int64_t accr = 0, accg = 0, accb = 0;
      const uint8_t* px[4] = {r0 + 3 * x0, r0 + 3 * x1, r1 + 3 * x0,
                              r1 + 3 * x1};
      for (const uint8_t* p : px) {
        accr += kGamma.to_linear[p[0]];
        accg += kGamma.to_linear[p[1]];
        accb += kGamma.to_linear[p[2]];
      }
      const int64_t rg = LinearToGamma(accr);
      const int64_t gg = LinearToGamma(accg);
      const int64_t bg = LinearToGamma(accb);
      uo[cx] = Clip255((-9719 * rg - 19081 * gg + 28800 * bg +
                        (kYHalf << 2) + (128LL << (kYFix + 2))) >>
                       (kYFix + 2));
      vo[cx] = Clip255((28800 * rg - 24116 * gg - 4684 * bg +
                        (kYHalf << 2) + (128LL << (kYFix + 2))) >>
                       (kYFix + 2));
    }
    for (int cx = cw; cx < cs; ++cx) {
      uo[cx] = uo[cw - 1];
      vo[cx] = vo[cw - 1];
    }
  }
  for (int cy = ch; cy < chh; ++cy) {
    std::memcpy(U + (size_t)cy * cs, U + (size_t)(ch - 1) * cs, cs);
    std::memcpy(V + (size_t)cy * cs, V + (size_t)(ch - 1) * cs, cs);
  }
}

}  // extern "C"
