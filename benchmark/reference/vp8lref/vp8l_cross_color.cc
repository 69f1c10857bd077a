// The cross-color search of the lossless encoder: a copy of the second
// half of the measured package's native/src/vp8l_predictor.cc (its
// vp8l_cross_color), unchanged; the first half, the native predictor
// search, is left out (the reference runs the numpy predictor).
//
// ---------------------------------------------------------------------------
// Cross-color transform (encoder side).
//
// Per-tile search of the green->red / green->blue / red->blue multipliers
// (reference encode_predictor.go ColorSpaceTransform / libwebp
// VP8LColorSpaceTransform): halving-step descent on the Shannon entropy of
// the transformed channel histogram, ties preferring zero multipliers.
// ---------------------------------------------------------------------------

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

inline int32_t Delta(int8_t m, int8_t c) {
  return ((int32_t)m * (int32_t)c) >> 5;
}

// n * log2(n) lookup (counts are bounded by the tile pixel count); computed
// with std::log2 so costs are bit-identical to the direct evaluation.
struct SLog2Tab {
  static const int kMax = (1 << 16) + 1;
  double t[kMax];
  SLog2Tab() {
    t[0] = 0.0;
    for (int i = 1; i < kMax; ++i) t[i] = i * std::log2((double)i);
  }
};
static const SLog2Tab kSLog2;

inline double SLog2(int n) {
  return n < SLog2Tab::kMax ? kSLog2.t[n] : n * std::log2((double)n);
}

double HistoBits(const int* histo, int total) {
  if (total == 0) return 0.0;
  double sum = 0.0;
  for (int i = 0; i < 256; ++i) sum += kSLog2.t[histo[i]];
  return SLog2(total) - sum;
}

// Per-tile channel bytes extracted once (the multiplier search re-reads
// them dozens of times per tile).
struct TileBytes {
  uint8_t g[1 << 16], r[1 << 16], b[1 << 16];
  int n = 0;
  // step > 1 subsamples the multiplier *search* (the transform itself is
  // always applied to every pixel); entropy of a 2x-subsampled tile ranks
  // multiplier candidates the same way in practice.
  void Fill(const uint32_t* img, long w, long x0, long y0, long x1, long y1,
            long step) {
    n = 0;
    for (long y = y0; y < y1; y += step) {
      const uint32_t* row = img + y * w;
      for (long x = x0; x < x1; x += step) {
        const uint32_t px = row[x];
        g[n] = (uint8_t)(px >> 8);
        r[n] = (uint8_t)(px >> 16);
        b[n] = (uint8_t)px;
        ++n;
      }
    }
  }
};

double RedCost(const TileBytes& t, int g2r) {
  int histo[256] = {0};
  for (int i = 0; i < t.n; ++i)
    histo[((int)t.r[i] - Delta((int8_t)g2r, (int8_t)t.g[i])) & 0xFF]++;
  double c = HistoBits(histo, t.n);
  if (g2r != 0) c += 0.5;  // prefer zero on ties
  return c;
}

double BlueCost(const TileBytes& t, int g2r, int g2b, int r2b) {
  (void)g2r;
  int histo[256] = {0};
  for (int i = 0; i < t.n; ++i)
    histo[((int)t.b[i] - Delta((int8_t)g2b, (int8_t)t.g[i]) -
           Delta((int8_t)r2b, (int8_t)t.r[i])) & 0xFF]++;
  double c = HistoBits(histo, t.n);
  if (g2b != 0) c += 0.5;
  if (r2b != 0) c += 0.5;
  return c;
}

}  // namespace

extern "C" {

// img: [h, w] u32 residual ARGB (after subtract-green + predictor).
// Writes transformed pixels to out and per-tile multiplier pixels
// (0xff000000 | r2b<<16 | g2b<<8 | g2r) to tiles [ty, tx]. Returns the
// estimated bit gain (entropy reduction) of applying the transform.
double vp8l_cross_color(const uint32_t* img, long h, long w, int bits,
                        uint32_t* out, uint32_t* tiles) {
  const long tile = 1L << bits;
  const long tx = (w + tile - 1) >> bits;
  const long ty = (h + tile - 1) >> bits;
  double gain = 0.0;
  static thread_local TileBytes t;
  for (long tyi = 0; tyi < ty; ++tyi) {
    for (long txi = 0; txi < tx; ++txi) {
      const long x0 = txi * tile, y0 = tyi * tile;
      const long x1 = std::min((txi + 1) * tile, w);
      const long y1 = std::min((tyi + 1) * tile, h);
      const long step = (x1 - x0) * (y1 - y0) > 256 ? 2 : 1;
      t.Fill(img, w, x0, y0, x1, y1, step);
      // Green -> red.
      int g2r = 0;
      double best_r = RedCost(t, 0);
      const double base_r = best_r;
      for (int step = 32; step >= 1; step >>= 1) {
        for (int sgn = -1; sgn <= 1; sgn += 2) {
          const int cand = g2r + sgn * step;
          if (cand < -128 || cand > 127) continue;
          const double c = RedCost(t, cand);
          if (c < best_r) {
            best_r = c;
            g2r = cand;
          }
        }
      }
      // (green, red) -> blue, coordinate descent.
      int g2b = 0, r2b = 0;
      double best_b = BlueCost(t, g2r, 0, 0);
      const double base_b = best_b;
      for (int step = 32; step >= 1; step >>= 1) {
        for (int axis = 0; axis < 2; ++axis) {
          for (int sgn = -1; sgn <= 1; sgn += 2) {
            const int cg = g2b + (axis == 0 ? sgn * step : 0);
            const int cr = r2b + (axis == 1 ? sgn * step : 0);
            if (cg < -128 || cg > 127 || cr < -128 || cr > 127) continue;
            const double c = BlueCost(t, g2r, cg, cr);
            if (c < best_b) {
              best_b = c;
              g2b = cg;
              r2b = cr;
            }
          }
        }
      }
      // Subsampled costs undercount by `step`; rescale so the caller's
      // apply-threshold keeps its meaning.
      gain += step * step * ((base_r - best_r) + (base_b - best_b));
      tiles[tyi * tx + txi] = 0xFF000000u |
                              ((uint32_t)(uint8_t)r2b << 16) |
                              ((uint32_t)(uint8_t)g2b << 8) |
                              (uint32_t)(uint8_t)g2r;
      // Apply.
      for (long y = y0; y < y1; ++y) {
        for (long x = x0; x < x1; ++x) {
          const uint32_t px = img[y * w + x];
          const int8_t g = (int8_t)(px >> 8);
          const int8_t r = (int8_t)(px >> 16);
          const uint32_t nr = ((px >> 16) - Delta((int8_t)g2r, g)) & 0xFF;
          const uint32_t nb = ((px & 0xFF) - Delta((int8_t)g2b, g) -
                               Delta((int8_t)r2b, r)) & 0xFF;
          out[y * w + x] = (px & 0xFF00FF00u) | (nr << 16) | nb;
        }
      }
    }
  }
  return gain;
}

}  // extern "C"
