// Native VP8L predictor transform: per-tile best-of-14 spatial predictor
// selection + residual emission.
//
// Exact parity with webp_tpu_torch/lossless/encode.py predictor_transform
// (reference: internal/lossless/encode_predictor.go ResidualImage):
// interior-rule predictions everywhere (missing neighbors read as 0, the
// TR quirk at the last column), cost proxy sum(min(byte, 256-byte)),
// ties to the lowest mode index, then the row-0/col-0 edge overwrite.

#include <cstddef>
#include <cstdint>
#include <cstring>

using std::size_t;

namespace {

inline uint32_t Avg2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b);
}

inline uint32_t SubPixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (0x00FF00FFu + (a & 0xFF00FF00u) - (b & 0xFF00FF00u)) &
                      0xFF00FF00u;
  const uint32_t rb = (0xFF00FF00u + (a & 0x00FF00FFu) - (b & 0x00FF00FFu)) &
                      0x00FF00FFu;
  return ag | rb;
}

inline int Clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

inline uint32_t Select(uint32_t t, uint32_t l, uint32_t tl) {
  int pa = 0;
  for (int s = 0; s < 32; s += 8) {
    const int tc = (t >> s) & 0xFF, lc = (l >> s) & 0xFF,
              tlc = (tl >> s) & 0xFF;
    pa += (lc > tlc ? lc - tlc : tlc - lc) - (tc > tlc ? tc - tlc : tlc - tc);
  }
  return pa <= 0 ? t : l;
}

inline uint32_t ClampAddSubFull(uint32_t l, uint32_t t, uint32_t tl) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = (int)((l >> s) & 0xFF) + (int)((t >> s) & 0xFF) -
                  (int)((tl >> s) & 0xFF);
    out |= (uint32_t)Clip255(v) << s;
  }
  return out;
}

inline uint32_t ClampAddSubHalf(uint32_t l, uint32_t t, uint32_t tl) {
  const uint32_t avg = Avg2(l, t);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int va = (avg >> s) & 0xFF, vc = (tl >> s) & 0xFF;
    const int d = va - vc;
    const int v = va + (d >= 0 ? d / 2 : -((-d) / 2));
    out |= (uint32_t)Clip255(v) << s;
  }
  return out;
}

// Interior-rule prediction: missing neighbors are 0 (matching the
// zero-filled L/T/TL/TR arrays in _predict_all), TR at the last column is
// the current row's pixel 0.
inline uint32_t Predict(int mode, const uint32_t* img, long w, long x,
                        long y) {
  const uint32_t L = x > 0 ? img[y * w + x - 1] : 0;
  const uint32_t T = y > 0 ? img[(y - 1) * w + x] : 0;
  const uint32_t TL = (x > 0 && y > 0) ? img[(y - 1) * w + x - 1] : 0;
  uint32_t TR = 0;
  if (y > 0) TR = (x + 1 < w) ? img[(y - 1) * w + x + 1] : img[y * w];
  switch (mode) {
    case 0: return 0xFF000000u;
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return Avg2(Avg2(L, TR), T);
    case 6: return Avg2(L, TL);
    case 7: return Avg2(L, T);
    case 8: return Avg2(TL, T);
    case 9: return Avg2(T, TR);
    case 10: return Avg2(Avg2(L, TL), Avg2(T, TR));
    case 11: return Select(T, L, TL);
    case 12: return ClampAddSubFull(L, T, TL);
    default: return ClampAddSubHalf(L, T, TL);
  }
}

// Byte cost LUT: min(b, 256 - b).
struct CostTab {
  long t[256];
  CostTab() {
    for (int b = 0; b < 256; ++b) t[b] = b < 256 - b ? b : 256 - b;
  }
};
static const CostTab kCost;

inline long Cost(uint32_t res) {
  return kCost.t[res & 0xFF] + kCost.t[(res >> 8) & 0xFF] +
         kCost.t[(res >> 16) & 0xFF] + kCost.t[res >> 24];
}

// Interior-row prediction for one mode: x in [xs, xe) with x > 0, y > 0 and
// x + 1 < w guaranteed by the caller; same formulas as Predict() without the
// per-pixel boundary branches, so the bitwise modes auto-vectorize.
template <typename F>
inline void RowInterior(int m, const uint32_t* row, const uint32_t* above,
                        long xs, long xe, F emit) {
  switch (m) {
    case 0:
      for (long x = xs; x < xe; ++x) emit(x, 0xFF000000u);
      break;
    case 1:
      for (long x = xs; x < xe; ++x) emit(x, row[x - 1]);
      break;
    case 2:
      for (long x = xs; x < xe; ++x) emit(x, above[x]);
      break;
    case 3:
      for (long x = xs; x < xe; ++x) emit(x, above[x + 1]);
      break;
    case 4:
      for (long x = xs; x < xe; ++x) emit(x, above[x - 1]);
      break;
    case 5:
      for (long x = xs; x < xe; ++x)
        emit(x, Avg2(Avg2(row[x - 1], above[x + 1]), above[x]));
      break;
    case 6:
      for (long x = xs; x < xe; ++x) emit(x, Avg2(row[x - 1], above[x - 1]));
      break;
    case 7:
      for (long x = xs; x < xe; ++x) emit(x, Avg2(row[x - 1], above[x]));
      break;
    case 8:
      for (long x = xs; x < xe; ++x) emit(x, Avg2(above[x - 1], above[x]));
      break;
    case 9:
      for (long x = xs; x < xe; ++x) emit(x, Avg2(above[x], above[x + 1]));
      break;
    case 10:
      for (long x = xs; x < xe; ++x)
        emit(x, Avg2(Avg2(row[x - 1], above[x - 1]),
                     Avg2(above[x], above[x + 1])));
      break;
    case 11:
      for (long x = xs; x < xe; ++x)
        emit(x, Select(above[x], row[x - 1], above[x - 1]));
      break;
    case 12:
      for (long x = xs; x < xe; ++x)
        emit(x, ClampAddSubFull(row[x - 1], above[x], above[x - 1]));
      break;
    default:
      for (long x = xs; x < xe; ++x)
        emit(x, ClampAddSubHalf(row[x - 1], above[x], above[x - 1]));
      break;
  }
}

}  // namespace

extern "C" {

// img: [h, w] u32 ARGB. out: residuals [h, w] u32. tile_modes: [ty, tx] i32
// with ty = ceil(h / 2^bits), tx = ceil(w / 2^bits).
void vp8l_predictor_transform(const uint32_t* img, long h, long w, int bits,
                              uint32_t* out, int32_t* tile_modes) {
  const long tile = 1L << bits;
  const long tx = (w + tile - 1) >> bits;
  const long ty = (h + tile - 1) >> bits;
  for (long tyi = 0; tyi < ty; ++tyi) {
    for (long txi = 0; txi < tx; ++txi) {
      const long ys = tyi * tile, xs = txi * tile;
      const long ye = ys + tile < h ? ys + tile : h;
      const long xe = xs + tile < w ? xs + tile : w;
      // Interior x range for the branch-free row loop (x > 0, x + 1 < w).
      const long ixs = xs > 0 ? xs : 1;
      const long ixe = xe < w ? xe : w - 1;
      long best_cost = -1;
      int best_mode = 0;
      for (int m = 0; m < 14; ++m) {
        long c = 0;
        for (long y = ys; y < ye; ++y) {
          if (y == 0) {
            for (long x = xs; x < xe; ++x)
              c += Cost(SubPixels(img[x], Predict(m, img, w, x, 0)));
            continue;
          }
          const uint32_t* row = img + y * w;
          const uint32_t* above = row - w;
          if (xs == 0) c += Cost(SubPixels(row[0], Predict(m, img, w, 0, y)));
          if (ixe > ixs)
            RowInterior(m, row, above, ixs, ixe, [&](long x, uint32_t p) {
              c += Cost(SubPixels(row[x], p));
            });
          if (xe == w && w - 1 >= xs && w - 1 > 0)
            c += Cost(SubPixels(row[w - 1], Predict(m, img, w, w - 1, y)));
        }
        if (best_cost < 0 || c < best_cost) {
          best_cost = c;
          best_mode = m;
        }
      }
      tile_modes[tyi * tx + txi] = best_mode;
      const int m = best_mode;
      for (long y = ys; y < ye; ++y) {
        if (y == 0) {
          for (long x = xs; x < xe; ++x)
            out[x] = SubPixels(img[x], Predict(m, img, w, x, 0));
          continue;
        }
        const uint32_t* row = img + y * w;
        const uint32_t* above = row - w;
        uint32_t* orow = out + y * w;
        if (xs == 0) orow[0] = SubPixels(row[0], Predict(m, img, w, 0, y));
        if (ixe > ixs)
          RowInterior(m, row, above, ixs, ixe, [&](long x, uint32_t p) {
            orow[x] = SubPixels(row[x], p);
          });
        if (xe == w && w - 1 >= xs && w - 1 > 0)
          orow[w - 1] = SubPixels(row[w - 1], Predict(m, img, w, w - 1, y));
      }
    }
  }
  // Edge rules (applied after tile selection, matching the Python order):
  // pixel (0,0) predicts black, row 0 uses L, column 0 uses T.
  out[0] = SubPixels(img[0], 0xFF000000u);
  for (long x = 1; x < w; ++x) out[x] = SubPixels(img[x], img[x - 1]);
  for (long y = 1; y < h; ++y)
    out[y * w] = SubPixels(img[y * w], img[(y - 1) * w]);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Cross-color transform (encoder side).
//
// Per-tile search of the green->red / green->blue / red->blue multipliers
// (reference encode_predictor.go ColorSpaceTransform / libwebp
// VP8LColorSpaceTransform): halving-step descent on the Shannon entropy of
// the transformed channel histogram, ties preferring zero multipliers.
// ---------------------------------------------------------------------------

#include <cmath>

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
