// Native YUV420 -> RGB(A) with fancy (4-tap diamond) chroma upsampling.
//
// Exact parity with webp_tpu_torch/lossy/yuv.py (reference:
// internal/dsp/upsample.go UpsampleRgbLinePair + dsp/yuv.go BT.601
// fixed-point constants). The decode hot tail: the native VP8 decoder
// produces planes in ~30 ms/1.5 Mpx, numpy upsampling took 90 ms.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__SSE4_1__)
#include <immintrin.h>
#define WEBPTPU_UPS_SIMD 1
#endif

using std::size_t;

namespace {

constexpr int kYScale = 19077;
constexpr int kRCr = 26149;
constexpr int kGCb = 6419;
constexpr int kGCr = 13320;
constexpr int kBCb = 33050;
constexpr int kRBias = 14234;
constexpr int kGBias = 8708;
constexpr int kBBias = 17685;

inline uint8_t Clip255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

inline void StorePixel(uint8_t* out, int y, int u, int v, int nch) {
  const int yy = (y * kYScale) >> 8;
  out[0] = Clip255((yy + ((v * kRCr) >> 8) - kRBias) >> 6);
  out[1] = Clip255((yy - ((u * kGCb) >> 8) - ((v * kGCr) >> 8) + kGBias) >> 6);
  out[2] = Clip255((yy + ((u * kBCb) >> 8) - kBBias) >> 6);
  if (nch == 4) out[3] = 255;
}

// One chroma component row pair -> full-width row (matches
// _upsample_chroma_row).
void UpsampleRow(const uint8_t* cn, const uint8_t* cf, int width,
                 int32_t* out) {
  out[0] = (3 * cn[0] + cf[0] + 2) >> 2;
  const int last_pair = (width - 1) >> 1;
  for (int x = 0; x < last_pair; ++x) {
    const int tl = cn[x], t = cn[x + 1], l = cf[x], c = cf[x + 1];
    const int avg = tl + t + l + c + 8;
    const int diag12 = (avg + 2 * (t + l)) >> 3;
    const int diag03 = (avg + 2 * (tl + c)) >> 3;
    out[2 * x + 1] = (diag12 + tl) >> 1;
    out[2 * x + 2] = (diag03 + t) >> 1;
  }
  if ((width & 1) == 0 && width >= 2) {
    const int i = (width - 1) >> 1;
    out[width - 1] = (3 * cn[i] + cf[i] + 2) >> 2;
  }
}

}  // namespace

extern "C" {

// Y: [h, y_stride]; U/V: [ceil(h/2), c_stride]; out: [h, w, nch] u8
// (nch 3 or 4; alpha filled with 255 — caller overwrites when ALPH present).
void yuv420_to_rgb_fancy(const uint8_t* Y, int y_stride, const uint8_t* U,
                         const uint8_t* V, int c_stride, int w, int h,
                         uint8_t* out, int nch) {
  const int ch = (h + 1) >> 1;
  // Per-row scratch (VLA-free).
  static thread_local int32_t* bufu = nullptr;
  static thread_local int32_t* bufv = nullptr;
  static thread_local int cap = 0;
  if (cap < w) {
    delete[] bufu;
    delete[] bufv;
    bufu = new int32_t[w];
    bufv = new int32_t[w];
    cap = w;
  }
  for (int r = 0; r < h; ++r) {
    const int near = r >> 1;
    const int far = (r & 1) ? (near + 1 < ch ? near + 1 : ch - 1)
                            : (near > 0 ? near - 1 : 0);
    UpsampleRow(U + (size_t)near * c_stride, U + (size_t)far * c_stride, w,
                bufu);
    UpsampleRow(V + (size_t)near * c_stride, V + (size_t)far * c_stride, w,
                bufv);
    const uint8_t* yrow = Y + (size_t)r * y_stride;
    uint8_t* orow = out + (size_t)r * w * nch;
    // Specialized per-nch loops (constant stride + unconditional alpha
    // store) so the compiler can vectorize the fixed-point math.
    if (nch == 4) {
      int x = 0;
#ifdef WEBPTPU_UPS_SIMD
      // 4 px per step: int32 lanes through the BT.601 fixed-point math,
      // then each RGBA packs as one u32 (r | g<<8 | b<<16 | a<<24).
      const __m128i zero = _mm_setzero_si128();
      const __m128i v255 = _mm_set1_epi32(255);
      for (; x + 4 <= w; x += 4) {
        uint32_t y4;
        std::memcpy(&y4, yrow + x, 4);
        const __m128i yv = _mm_cvtepu8_epi32(_mm_cvtsi32_si128((int)y4));
        const __m128i uv = _mm_loadu_si128((const __m128i*)(bufu + x));
        const __m128i vv = _mm_loadu_si128((const __m128i*)(bufv + x));
        const __m128i yy = _mm_srai_epi32(
            _mm_mullo_epi32(yv, _mm_set1_epi32(kYScale)), 8);
        __m128i r = _mm_srai_epi32(
            _mm_sub_epi32(_mm_add_epi32(yy, _mm_srai_epi32(
                _mm_mullo_epi32(vv, _mm_set1_epi32(kRCr)), 8)),
                _mm_set1_epi32(kRBias)), 6);
        __m128i g = _mm_srai_epi32(
            _mm_add_epi32(_mm_sub_epi32(_mm_sub_epi32(yy, _mm_srai_epi32(
                _mm_mullo_epi32(uv, _mm_set1_epi32(kGCb)), 8)),
                _mm_srai_epi32(_mm_mullo_epi32(vv, _mm_set1_epi32(kGCr)), 8)),
                _mm_set1_epi32(kGBias)), 6);
        __m128i b = _mm_srai_epi32(
            _mm_sub_epi32(_mm_add_epi32(yy, _mm_srai_epi32(
                _mm_mullo_epi32(uv, _mm_set1_epi32(kBCb)), 8)),
                _mm_set1_epi32(kBBias)), 6);
        r = _mm_min_epi32(_mm_max_epi32(r, zero), v255);
        g = _mm_min_epi32(_mm_max_epi32(g, zero), v255);
        b = _mm_min_epi32(_mm_max_epi32(b, zero), v255);
        const __m128i px = _mm_or_si128(
            _mm_or_si128(r, _mm_slli_epi32(g, 8)),
            _mm_or_si128(_mm_slli_epi32(b, 16),
                         _mm_set1_epi32((int)0xFF000000u)));
        _mm_storeu_si128((__m128i*)(orow + (size_t)x * 4), px);
      }
#endif
      for (; x < w; ++x)
        StorePixel(orow + (size_t)x * 4, yrow[x], bufu[x], bufv[x], 4);
    } else {
      for (int x = 0; x < w; ++x)
        StorePixel(orow + (size_t)x * 3, yrow[x], bufu[x], bufv[x], 3);
    }
  }
}

}  // extern "C"
