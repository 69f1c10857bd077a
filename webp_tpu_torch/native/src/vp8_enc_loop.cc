// VP8 encoder macroblock loop (native fast path).
//
// Ports webp_tpu_torch/lossy/encode.py's per-MB closed loop (VP8Encoder
// _encode_mb/_pick_i4 + quant.py quantize_block/trellis_quantize_block +
// cost.py residual_cost) bit-for-bit: the Python implementation is the
// conformance oracle (tests/test_native_parity.py). Behavioral parity with
// the reference's serial encode loop (internal/lossy/encode.go,
// encode_trellis.go TrellisQuantizeBlock, dsp/cost.go GetResidualCost).
//
// All RD arithmetic is int64; transforms match lossy/dsp.py exactly.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__SSE4_1__)
#include <immintrin.h>
#define WEBPTPU_ENC_SIMD 1
#endif
#if defined(__AVX2__)
#define WEBPTPU_ENC_AVX2 1
#endif

namespace {

constexpr int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                             9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                                6, 6, 6, 6, 6, 6, 7, 0};
constexpr int kMaxLevel = 2047;
constexpr int kMaxVariableLevel = 67;
constexpr int64_t kFixedCostsI16[4] = {663, 919, 872, 919};
constexpr int64_t kFixedCostsUV[4] = {302, 984, 439, 642};
// Per-frequency trellis distortion weights (zigzag position).
constexpr int kWeightTrellis[16] = {30, 27, 19, 11, 27, 24, 17, 10,
                                    19, 17, 12, 8, 11, 10, 8, 6};

// Mode numbering (lossy/dsp.py): DC=0, TM=1, V=2, H=3 + DC border variants.
enum { DC_PRED = 0, TM_PRED = 1, V_PRED = 2, H_PRED = 3,
       DC_NO_TOP = 4, DC_NO_LEFT = 5, DC_NO_TOPLEFT = 6 };

// ---------------------------------------------------------------------
// Shared tables handed in from Python (single source of truth).
// ---------------------------------------------------------------------
struct Tables {
  const uint8_t* proba;            // [4][8][3][11]
  const int32_t* cost;             // [4][8][3][68]
  const int32_t* entropy_cost;     // [256]
  const int32_t* level_fixed;      // [2048]
  const int32_t* fixed_costs_i4;   // [10][10][10]
  inline const uint8_t* p(int t, int b, int c) const {
    return proba + ((t * 8 + b) * 3 + c) * 11;
  }
  inline const int32_t* ct(int t, int b, int c) const {
    return cost + ((t * 8 + b) * 3 + c) * 68;
  }
  inline int64_t bit_cost(int bit, int prob) const {
    return entropy_cost[bit ? 255 - prob : prob];
  }
  inline int64_t level_cost(const int32_t* row, int v) const {
    int vf = v < kMaxLevel ? v : kMaxLevel;
    int vv = v < kMaxVariableLevel ? v : kMaxVariableLevel;
    return (int64_t)level_fixed[vf] + row[vv];
  }
};

// Expanded quantizer for one coefficient class (quant.py SegmentQuant).
struct SQ {
  // Materialized int32 copies of the int64 quantizer tables: every value
  // fits easily (q <= 568, iq = 2^17/q <= 32768, bias = B<<9 <= 130560,
  // sharpen <= q), and int32 keeps QuantizeBlock auto-vectorizable.
  int32_t q[16], iq[16], bias[16], sharpen[16];
};

// quantize_block (quant.py:54): raster coeffs -> zigzag levels + raster
// dequant. Returns the zigzag-position nonzero bitmask (bit n set iff
// lv_zz[n] != 0), so callers get `last` and nz flags without rescanning.
// All-int32 arithmetic is exact: the worst-case product is
// |FWHT coeff|(<=16320) * iq(<=32768) + bias ~= 5.4e8 < 2^31.
static uint32_t QuantizeBlock(const int32_t* coeffs, const SQ& sq, int first,
                              int32_t* lv_zz, int32_t* dq_raster) {
#ifdef WEBPTPU_ENC_SIMD
  int32_t c_zz[16], dq_zz[16];
  for (int n = 0; n < 16; ++n) c_zz[n] = coeffs[kZigzag[n]];
  const __m128i kMax = _mm_set1_epi32(kMaxLevel);
  int z_mask = 0;
  for (int k = 0; k < 16; k += 4) {
    const __m128i c = _mm_loadu_si128((const __m128i*)(c_zz + k));
    const __m128i s = _mm_srai_epi32(c, 31);  // sign mask
    const __m128i mag = _mm_add_epi32(
        _mm_sub_epi32(_mm_xor_si128(c, s), s),
        _mm_loadu_si128((const __m128i*)(sq.sharpen + k)));
    __m128i level = _mm_srai_epi32(
        _mm_add_epi32(
            _mm_mullo_epi32(mag, _mm_loadu_si128((const __m128i*)(sq.iq + k))),
            _mm_loadu_si128((const __m128i*)(sq.bias + k))),
        17);
    level = _mm_min_epi32(level, kMax);
    if (first && k == 0) level = _mm_insert_epi32(level, 0, 0);
    const __m128i l = _mm_sub_epi32(_mm_xor_si128(level, s), s);
    _mm_storeu_si128((__m128i*)(lv_zz + k), l);
    _mm_storeu_si128(
        (__m128i*)(dq_zz + k),
        _mm_mullo_epi32(l, _mm_loadu_si128((const __m128i*)(sq.q + k))));
    z_mask |= _mm_movemask_ps(_mm_castsi128_ps(
                  _mm_cmpeq_epi32(l, _mm_setzero_si128())))
              << k;
  }
  for (int n = 0; n < 16; ++n) dq_raster[kZigzag[n]] = dq_zz[n];
  return ~z_mask & 0xFFFFu;
#else
  uint32_t mask = 0;
  for (int i = 0; i < 16; ++i) dq_raster[i] = 0;
  for (int n = 0; n < 16; ++n) {
    int zig = kZigzag[n];
    int32_t c = coeffs[zig];
    bool sign = c < 0;
    int32_t mag = (sign ? -c : c) + sq.sharpen[n];
    int32_t level = (mag * sq.iq[n] + sq.bias[n]) >> 17;
    if (level > kMaxLevel) level = kMaxLevel;
    if (first && n == 0) level = 0;
    int32_t l = sign ? -level : level;
    lv_zz[n] = l;
    dq_raster[zig] = l * sq.q[n];
    if (l) mask |= 1u << n;
  }
  return mask;
#endif
}

#ifdef WEBPTPU_ENC_AVX2
// Zigzag gather/scatter as cross-lane permutes (6 vector ops instead of
// 16 scalar moves). zz[0..7] draws from raster[0..7] except position 3
// (raster[8]); zz[8..15] draws from raster[8..15] except position 4
// (raster[7]) — one blend each way. The scatter uses the inverse
// permutation {0,1,5,6,2,4,7,12, 3,8,11,13,9,10,14,15}.
static inline void ZigzagGather(const int32_t* raster, int32_t* zz) {
  const __m256i lo = _mm256_loadu_si256((const __m256i*)raster);
  const __m256i hi = _mm256_loadu_si256((const __m256i*)(raster + 8));
  __m256i out_lo = _mm256_permutevar8x32_epi32(
      lo, _mm256_setr_epi32(0, 1, 4, 0, 5, 2, 3, 6));
  out_lo = _mm256_blend_epi32(
      out_lo, _mm256_permutevar8x32_epi32(hi, _mm256_setzero_si256()), 0x08);
  __m256i out_hi = _mm256_permutevar8x32_epi32(
      hi, _mm256_setr_epi32(1, 4, 5, 2, 2, 3, 6, 7));
  out_hi = _mm256_blend_epi32(
      out_hi, _mm256_permutevar8x32_epi32(lo, _mm256_set1_epi32(7)), 0x10);
  _mm256_storeu_si256((__m256i*)zz, out_lo);
  _mm256_storeu_si256((__m256i*)(zz + 8), out_hi);
}

static inline void ZigzagScatter(const int32_t* zz, int32_t* raster) {
  const __m256i lo = _mm256_loadu_si256((const __m256i*)zz);
  const __m256i hi = _mm256_loadu_si256((const __m256i*)(zz + 8));
  __m256i out_lo = _mm256_permutevar8x32_epi32(
      lo, _mm256_setr_epi32(0, 1, 5, 6, 2, 4, 7, 7));
  out_lo = _mm256_blend_epi32(
      out_lo, _mm256_permutevar8x32_epi32(hi, _mm256_set1_epi32(4)), 0x80);
  __m256i out_hi = _mm256_permutevar8x32_epi32(
      hi, _mm256_setr_epi32(0, 0, 3, 5, 1, 2, 6, 7));
  out_hi = _mm256_blend_epi32(
      out_hi, _mm256_permutevar8x32_epi32(lo, _mm256_set1_epi32(3)), 0x01);
  _mm256_storeu_si256((__m256i*)raster, out_lo);
  _mm256_storeu_si256((__m256i*)(raster + 8), out_hi);
}

// Two independent blocks quantized at once: block A rides the low 128-bit
// lane, block B the high lane (the quantizer tables are lane-broadcast).
// Same arithmetic as QuantizeBlock, so identical levels/dequant/masks.
static void QuantizeBlock2(const int32_t* cA, const int32_t* cB, const SQ& sq,
                           int first, int32_t* lvA, int32_t* lvB, int32_t* dqA,
                           int32_t* dqB, uint32_t* maskA, uint32_t* maskB) {
  int32_t zzA[16], zzB[16], dqzA[16], dqzB[16];
  ZigzagGather(cA, zzA);
  ZigzagGather(cB, zzB);
  const __m256i kMax = _mm256_set1_epi32(kMaxLevel);
  uint32_t zA = 0, zB = 0;
  for (int k = 0; k < 16; k += 4) {
    const __m256i c = _mm256_inserti128_si256(
        _mm256_castsi128_si256(_mm_loadu_si128((const __m128i*)(zzA + k))),
        _mm_loadu_si128((const __m128i*)(zzB + k)), 1);
    const __m128i sh128 = _mm_loadu_si128((const __m128i*)(sq.sharpen + k));
    const __m128i iq128 = _mm_loadu_si128((const __m128i*)(sq.iq + k));
    const __m128i bi128 = _mm_loadu_si128((const __m128i*)(sq.bias + k));
    const __m128i q128 = _mm_loadu_si128((const __m128i*)(sq.q + k));
    const __m256i s = _mm256_srai_epi32(c, 31);
    const __m256i mag = _mm256_add_epi32(
        _mm256_sub_epi32(_mm256_xor_si256(c, s), s),
        _mm256_broadcastsi128_si256(sh128));
    __m256i level = _mm256_srai_epi32(
        _mm256_add_epi32(
            _mm256_mullo_epi32(mag, _mm256_broadcastsi128_si256(iq128)),
            _mm256_broadcastsi128_si256(bi128)),
        17);
    level = _mm256_min_epi32(level, kMax);
    if (first && k == 0)
      level = _mm256_blend_epi32(level, _mm256_setzero_si256(), 0x11);
    const __m256i l = _mm256_sub_epi32(_mm256_xor_si256(level, s), s);
    _mm_storeu_si128((__m128i*)(lvA + k), _mm256_castsi256_si128(l));
    _mm_storeu_si128((__m128i*)(lvB + k), _mm256_extracti128_si256(l, 1));
    const __m256i dq =
        _mm256_mullo_epi32(l, _mm256_broadcastsi128_si256(q128));
    _mm_storeu_si128((__m128i*)(dqzA + k), _mm256_castsi256_si128(dq));
    _mm_storeu_si128((__m128i*)(dqzB + k), _mm256_extracti128_si256(dq, 1));
    const uint32_t zm = (uint32_t)_mm256_movemask_ps(_mm256_castsi256_ps(
        _mm256_cmpeq_epi32(l, _mm256_setzero_si256())));
    zA |= (zm & 0xF) << k;
    zB |= ((zm >> 4) & 0xF) << k;
  }
  ZigzagScatter(dqzA, dqA);
  ZigzagScatter(dqzB, dqB);
  *maskA = ~zA & 0xFFFFu;
  *maskB = ~zB & 0xFFFFu;
}
#else
static void QuantizeBlock2(const int32_t* cA, const int32_t* cB, const SQ& sq,
                           int first, int32_t* lvA, int32_t* lvB, int32_t* dqA,
                           int32_t* dqB, uint32_t* maskA, uint32_t* maskB) {
  *maskA = QuantizeBlock(cA, sq, first, lvA, dqA);
  *maskB = QuantizeBlock(cB, sq, first, lvB, dqB);
}
#endif

// ---------------------------------------------------------------------
// Transforms (lossy/dsp.py exact integer math).
// ---------------------------------------------------------------------
static inline int64_t Mul1(int64_t a) { return ((a * 20091) >> 16) + a; }
static inline int64_t Mul2(int64_t a) { return (a * 35468) >> 16; }

#ifdef WEBPTPU_ENC_SIMD
// 4x4 int32 transpose: rows r0..r3 -> columns.
static inline void Transpose4(__m128i& r0, __m128i& r1, __m128i& r2,
                              __m128i& r3) {
  const __m128i t0 = _mm_unpacklo_epi32(r0, r1);
  const __m128i t1 = _mm_unpackhi_epi32(r0, r1);
  const __m128i t2 = _mm_unpacklo_epi32(r2, r3);
  const __m128i t3 = _mm_unpackhi_epi32(r2, r3);
  r0 = _mm_unpacklo_epi64(t0, t2);
  r1 = _mm_unpackhi_epi64(t0, t2);
  r2 = _mm_unpacklo_epi64(t1, t3);
  r3 = _mm_unpackhi_epi64(t1, t3);
}

// fdct4x4 of (src - pred): same int32 math as the scalar kernel below,
// vectorized 4 rows (then 4 columns) at a time.
static void FDCT4x4(const int32_t* src, const int32_t* pred, int32_t* out) {
  const __m128i k2217 = _mm_set1_epi32(2217);
  const __m128i k5352 = _mm_set1_epi32(5352);
  __m128i d0 = _mm_sub_epi32(_mm_loadu_si128((const __m128i*)(src + 0)),
                             _mm_loadu_si128((const __m128i*)(pred + 0)));
  __m128i d1 = _mm_sub_epi32(_mm_loadu_si128((const __m128i*)(src + 4)),
                             _mm_loadu_si128((const __m128i*)(pred + 4)));
  __m128i d2 = _mm_sub_epi32(_mm_loadu_si128((const __m128i*)(src + 8)),
                             _mm_loadu_si128((const __m128i*)(pred + 8)));
  __m128i d3 = _mm_sub_epi32(_mm_loadu_si128((const __m128i*)(src + 12)),
                             _mm_loadu_si128((const __m128i*)(pred + 12)));
  // Lanes = rows; vectors = in-row elements.
  Transpose4(d0, d1, d2, d3);
  __m128i a0 = _mm_add_epi32(d0, d3), a1 = _mm_add_epi32(d1, d2);
  __m128i a2 = _mm_sub_epi32(d1, d2), a3 = _mm_sub_epi32(d0, d3);
  __m128i t0 = _mm_slli_epi32(_mm_add_epi32(a0, a1), 3);
  __m128i t2 = _mm_slli_epi32(_mm_sub_epi32(a0, a1), 3);
  __m128i t1 = _mm_srai_epi32(
      _mm_add_epi32(_mm_add_epi32(_mm_mullo_epi32(a2, k2217),
                                  _mm_mullo_epi32(a3, k5352)),
                    _mm_set1_epi32(1812)), 9);
  __m128i t3 = _mm_srai_epi32(
      _mm_add_epi32(_mm_sub_epi32(_mm_mullo_epi32(a3, k2217),
                                  _mm_mullo_epi32(a2, k5352)),
                    _mm_set1_epi32(937)), 9);
  // tmp[i][k]: lanes = rows i, vectors tk = columns k. Pass 2 needs
  // lanes = columns j, vectors = rows m; transpose again.
  Transpose4(t0, t1, t2, t3);
  a0 = _mm_add_epi32(t0, t3);
  a1 = _mm_add_epi32(t1, t2);
  a2 = _mm_sub_epi32(t1, t2);
  a3 = _mm_sub_epi32(t0, t3);
  const __m128i k7 = _mm_set1_epi32(7);
  __m128i o0 = _mm_srai_epi32(_mm_add_epi32(_mm_add_epi32(a0, a1), k7), 4);
  __m128i o2 = _mm_srai_epi32(_mm_add_epi32(_mm_sub_epi32(a0, a1), k7), 4);
  __m128i nz3 = _mm_andnot_si128(_mm_cmpeq_epi32(a3, _mm_setzero_si128()),
                                 _mm_set1_epi32(1));
  __m128i o1 = _mm_add_epi32(
      _mm_srai_epi32(
          _mm_add_epi32(_mm_add_epi32(_mm_mullo_epi32(a2, k2217),
                                      _mm_mullo_epi32(a3, k5352)),
                        _mm_set1_epi32(12000)), 16),
      nz3);
  __m128i o3 = _mm_srai_epi32(
      _mm_add_epi32(_mm_sub_epi32(_mm_mullo_epi32(a3, k2217),
                                  _mm_mullo_epi32(a2, k5352)),
                    _mm_set1_epi32(51000)), 16);
  _mm_storeu_si128((__m128i*)(out + 0), o0);
  _mm_storeu_si128((__m128i*)(out + 4), o1);
  _mm_storeu_si128((__m128i*)(out + 8), o2);
  _mm_storeu_si128((__m128i*)(out + 12), o3);
}
#endif  // WEBPTPU_ENC_SIMD

// fdct4x4 of (src - pred), both raster int32[16] -> int32[16].
// All-int32 arithmetic is exact: |src-pred| <= 255, so pass-1 values stay
// <= 8160 and the largest pass-2 product is |a|(<=16320) * 5352 ~= 8.7e7.
#ifdef WEBPTPU_ENC_SIMD
static void FDCT4x4_Scalar(const int32_t* src, const int32_t* pred,
                           int32_t* out) {
#else
static void FDCT4x4(const int32_t* src, const int32_t* pred, int32_t* out) {
#endif
  int32_t tmp[16];
  for (int i = 0; i < 4; ++i) {
    int32_t d0 = src[i * 4 + 0] - pred[i * 4 + 0];
    int32_t d1 = src[i * 4 + 1] - pred[i * 4 + 1];
    int32_t d2 = src[i * 4 + 2] - pred[i * 4 + 2];
    int32_t d3 = src[i * 4 + 3] - pred[i * 4 + 3];
    int32_t a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[i * 4 + 0] = (a0 + a1) * 8;
    tmp[i * 4 + 1] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[i * 4 + 2] = (a0 - a1) * 8;
    tmp[i * 4 + 3] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
  for (int j = 0; j < 4; ++j) {
    int32_t m0 = tmp[0 * 4 + j], m1 = tmp[1 * 4 + j];
    int32_t m2 = tmp[2 * 4 + j], m3 = tmp[3 * 4 + j];
    int32_t a0 = m0 + m3, a1 = m1 + m2, a2 = m1 - m2, a3 = m0 - m3;
    out[0 * 4 + j] = (a0 + a1 + 7) >> 4;
    out[2 * 4 + j] = (a0 - a1 + 7) >> 4;
    out[1 * 4 + j] = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0);
    out[3 * 4 + j] = (a3 * 2217 - a2 * 5352 + 51000) >> 16;
  }
}

#ifdef WEBPTPU_ENC_AVX2
// 4x4 transpose in each 128-bit lane (two independent blocks at once).
static inline void Transpose4x2(__m256i& r0, __m256i& r1, __m256i& r2,
                                __m256i& r3) {
  const __m256i t0 = _mm256_unpacklo_epi32(r0, r1);
  const __m256i t1 = _mm256_unpackhi_epi32(r0, r1);
  const __m256i t2 = _mm256_unpacklo_epi32(r2, r3);
  const __m256i t3 = _mm256_unpackhi_epi32(r2, r3);
  r0 = _mm256_unpacklo_epi64(t0, t2);
  r1 = _mm256_unpackhi_epi64(t0, t2);
  r2 = _mm256_unpacklo_epi64(t1, t3);
  r3 = _mm256_unpackhi_epi64(t1, t3);
}

// fdct4x4 of two independent (src - pred) blocks: A in the low lane, B in
// the high lane. Identical arithmetic to FDCT4x4, so identical outputs.
static void FDCT4x4_2(const int32_t* srcA, const int32_t* predA, int32_t* outA,
                      const int32_t* srcB, const int32_t* predB,
                      int32_t* outB) {
  const __m256i k2217 = _mm256_set1_epi32(2217);
  const __m256i k5352 = _mm256_set1_epi32(5352);
  auto load2 = [](const int32_t* a, const int32_t* b) {
    return _mm256_inserti128_si256(
        _mm256_castsi128_si256(_mm_loadu_si128((const __m128i*)a)),
        _mm_loadu_si128((const __m128i*)b), 1);
  };
  __m256i d0 = _mm256_sub_epi32(load2(srcA + 0, srcB + 0),
                                load2(predA + 0, predB + 0));
  __m256i d1 = _mm256_sub_epi32(load2(srcA + 4, srcB + 4),
                                load2(predA + 4, predB + 4));
  __m256i d2 = _mm256_sub_epi32(load2(srcA + 8, srcB + 8),
                                load2(predA + 8, predB + 8));
  __m256i d3 = _mm256_sub_epi32(load2(srcA + 12, srcB + 12),
                                load2(predA + 12, predB + 12));
  Transpose4x2(d0, d1, d2, d3);
  __m256i a0 = _mm256_add_epi32(d0, d3), a1 = _mm256_add_epi32(d1, d2);
  __m256i a2 = _mm256_sub_epi32(d1, d2), a3 = _mm256_sub_epi32(d0, d3);
  __m256i t0 = _mm256_slli_epi32(_mm256_add_epi32(a0, a1), 3);
  __m256i t2 = _mm256_slli_epi32(_mm256_sub_epi32(a0, a1), 3);
  __m256i t1 = _mm256_srai_epi32(
      _mm256_add_epi32(_mm256_add_epi32(_mm256_mullo_epi32(a2, k2217),
                                        _mm256_mullo_epi32(a3, k5352)),
                       _mm256_set1_epi32(1812)), 9);
  __m256i t3 = _mm256_srai_epi32(
      _mm256_add_epi32(_mm256_sub_epi32(_mm256_mullo_epi32(a3, k2217),
                                        _mm256_mullo_epi32(a2, k5352)),
                       _mm256_set1_epi32(937)), 9);
  Transpose4x2(t0, t1, t2, t3);
  a0 = _mm256_add_epi32(t0, t3);
  a1 = _mm256_add_epi32(t1, t2);
  a2 = _mm256_sub_epi32(t1, t2);
  a3 = _mm256_sub_epi32(t0, t3);
  const __m256i k7 = _mm256_set1_epi32(7);
  __m256i o0 =
      _mm256_srai_epi32(_mm256_add_epi32(_mm256_add_epi32(a0, a1), k7), 4);
  __m256i o2 =
      _mm256_srai_epi32(_mm256_add_epi32(_mm256_sub_epi32(a0, a1), k7), 4);
  __m256i nz3 = _mm256_andnot_si256(
      _mm256_cmpeq_epi32(a3, _mm256_setzero_si256()), _mm256_set1_epi32(1));
  __m256i o1 = _mm256_add_epi32(
      _mm256_srai_epi32(
          _mm256_add_epi32(_mm256_add_epi32(_mm256_mullo_epi32(a2, k2217),
                                            _mm256_mullo_epi32(a3, k5352)),
                           _mm256_set1_epi32(12000)), 16),
      nz3);
  __m256i o3 = _mm256_srai_epi32(
      _mm256_add_epi32(_mm256_sub_epi32(_mm256_mullo_epi32(a3, k2217),
                                        _mm256_mullo_epi32(a2, k5352)),
                       _mm256_set1_epi32(51000)), 16);
  _mm_storeu_si128((__m128i*)(outA + 0), _mm256_castsi256_si128(o0));
  _mm_storeu_si128((__m128i*)(outA + 4), _mm256_castsi256_si128(o1));
  _mm_storeu_si128((__m128i*)(outA + 8), _mm256_castsi256_si128(o2));
  _mm_storeu_si128((__m128i*)(outA + 12), _mm256_castsi256_si128(o3));
  _mm_storeu_si128((__m128i*)(outB + 0), _mm256_extracti128_si256(o0, 1));
  _mm_storeu_si128((__m128i*)(outB + 4), _mm256_extracti128_si256(o1, 1));
  _mm_storeu_si128((__m128i*)(outB + 8), _mm256_extracti128_si256(o2, 1));
  _mm_storeu_si128((__m128i*)(outB + 12), _mm256_extracti128_si256(o3, 1));
}
#else
static void FDCT4x4_2(const int32_t* srcA, const int32_t* predA, int32_t* outA,
                      const int32_t* srcB, const int32_t* predB,
                      int32_t* outB) {
  FDCT4x4(srcA, predA, outA);
  FDCT4x4(srcB, predB, outB);
}
#endif  // WEBPTPU_ENC_AVX2

// idct4x4: raster dequant int32[16] -> raster residuals int32[16].
static inline int32_t Mul1i(int32_t a) { return ((a * 20091) >> 16) + a; }
static inline int32_t Mul2i(int32_t a) { return (a * 35468) >> 16; }

static void IDCT4x4_Slow(const int32_t* c, int32_t* out) {
  int64_t tmp[16];
  for (int j = 0; j < 4; ++j) {
    int64_t i0 = c[0 * 4 + j], i1 = c[1 * 4 + j];
    int64_t i2 = c[2 * 4 + j], i3 = c[3 * 4 + j];
    int64_t a = i0 + i2, b = i0 - i2;
    int64_t cc = Mul2(i1) - Mul1(i3), d = Mul1(i1) + Mul2(i3);
    tmp[0 * 4 + j] = a + d;
    tmp[1 * 4 + j] = b + cc;
    tmp[2 * 4 + j] = b - cc;
    tmp[3 * 4 + j] = a - d;
  }
  for (int r = 0; r < 4; ++r) {
    int64_t dc = tmp[r * 4 + 0] + 4;
    int64_t a = dc + tmp[r * 4 + 2], b = dc - tmp[r * 4 + 2];
    int64_t cc = Mul2(tmp[r * 4 + 1]) - Mul1(tmp[r * 4 + 3]);
    int64_t d = Mul1(tmp[r * 4 + 1]) + Mul2(tmp[r * 4 + 3]);
    out[r * 4 + 0] = (int32_t)((a + d) >> 3);
    out[r * 4 + 1] = (int32_t)((b + cc) >> 3);
    out[r * 4 + 2] = (int32_t)((b - cc) >> 3);
    out[r * 4 + 3] = (int32_t)((a - d) >> 3);
  }
}

static void IDCT4x4(const int32_t* c, int32_t* out) {
  // int32 fast path: exact whenever max|c| <= 14000 (pass-1 values stay
  // <= 3.85*max|c| = 53.9k, largest pass-2 product 53.9k*35468 ~= 1.9e9
  // < 2^31). Dequantized coefficients exceed this only for extreme
  // level*q combinations; those fall back to the int64 kernel.
  uint32_t mag = 0;
  for (int i = 0; i < 16; ++i) {
    const int32_t v = c[i];
    mag |= (uint32_t)(v < 0 ? -v : v);
  }
  if (mag > 14000u) {
    IDCT4x4_Slow(c, out);
    return;
  }
#ifdef WEBPTPU_ENC_SIMD
  const __m128i k20091 = _mm_set1_epi32(20091);
  const __m128i k35468 = _mm_set1_epi32(35468);
  auto mul1 = [&](__m128i v) {
    return _mm_add_epi32(
        _mm_srai_epi32(_mm_mullo_epi32(v, k20091), 16), v);
  };
  auto mul2 = [&](__m128i v) {
    return _mm_srai_epi32(_mm_mullo_epi32(v, k35468), 16);
  };
  // Pass 1 vectorizes over columns j (lane = j): rows load directly.
  __m128i i0 = _mm_loadu_si128((const __m128i*)(c + 0));
  __m128i i1 = _mm_loadu_si128((const __m128i*)(c + 4));
  __m128i i2 = _mm_loadu_si128((const __m128i*)(c + 8));
  __m128i i3 = _mm_loadu_si128((const __m128i*)(c + 12));
  __m128i a = _mm_add_epi32(i0, i2), b = _mm_sub_epi32(i0, i2);
  __m128i cc = _mm_sub_epi32(mul2(i1), mul1(i3));
  __m128i d = _mm_add_epi32(mul1(i1), mul2(i3));
  __m128i t0 = _mm_add_epi32(a, d);
  __m128i t1 = _mm_add_epi32(b, cc);
  __m128i t2 = _mm_sub_epi32(b, cc);
  __m128i t3 = _mm_sub_epi32(a, d);
  // Pass 2 vectorizes over rows r: transpose in, transpose out.
  Transpose4(t0, t1, t2, t3);
  __m128i dc = _mm_add_epi32(t0, _mm_set1_epi32(4));
  a = _mm_add_epi32(dc, t2);
  b = _mm_sub_epi32(dc, t2);
  cc = _mm_sub_epi32(mul2(t1), mul1(t3));
  d = _mm_add_epi32(mul1(t1), mul2(t3));
  __m128i o0 = _mm_srai_epi32(_mm_add_epi32(a, d), 3);
  __m128i o1 = _mm_srai_epi32(_mm_add_epi32(b, cc), 3);
  __m128i o2 = _mm_srai_epi32(_mm_sub_epi32(b, cc), 3);
  __m128i o3 = _mm_srai_epi32(_mm_sub_epi32(a, d), 3);
  Transpose4(o0, o1, o2, o3);
  _mm_storeu_si128((__m128i*)(out + 0), o0);
  _mm_storeu_si128((__m128i*)(out + 4), o1);
  _mm_storeu_si128((__m128i*)(out + 8), o2);
  _mm_storeu_si128((__m128i*)(out + 12), o3);
#else
  int32_t tmp[16];
  for (int j = 0; j < 4; ++j) {
    int32_t i0 = c[0 * 4 + j], i1 = c[1 * 4 + j];
    int32_t i2 = c[2 * 4 + j], i3 = c[3 * 4 + j];
    int32_t a = i0 + i2, b = i0 - i2;
    int32_t cc = Mul2i(i1) - Mul1i(i3), d = Mul1i(i1) + Mul2i(i3);
    tmp[0 * 4 + j] = a + d;
    tmp[1 * 4 + j] = b + cc;
    tmp[2 * 4 + j] = b - cc;
    tmp[3 * 4 + j] = a - d;
  }
  for (int r = 0; r < 4; ++r) {
    int32_t dc = tmp[r * 4 + 0] + 4;
    int32_t a = dc + tmp[r * 4 + 2], b = dc - tmp[r * 4 + 2];
    int32_t cc = Mul2i(tmp[r * 4 + 1]) - Mul1i(tmp[r * 4 + 3]);
    int32_t d = Mul1i(tmp[r * 4 + 1]) + Mul2i(tmp[r * 4 + 3]);
    out[r * 4 + 0] = (a + d) >> 3;
    out[r * 4 + 1] = (b + cc) >> 3;
    out[r * 4 + 2] = (b - cc) >> 3;
    out[r * 4 + 3] = (a - d) >> 3;
  }
#endif
}

// fwht4x4 over the 16 sub-block DCs (raster [16]) -> int32[16].
// int32 exact: inputs are FDCT DCs (|.| <= 2040), outputs <= 16320.
static void FWHT4x4(const int32_t* d, int32_t* out) {
  int32_t tmp[16];
  for (int i = 0; i < 4; ++i) {
    int32_t c0 = d[i * 4 + 0], c1 = d[i * 4 + 1];
    int32_t c2 = d[i * 4 + 2], c3 = d[i * 4 + 3];
    int32_t a0 = c0 + c2, a1 = c1 + c3, a2 = c1 - c3, a3 = c0 - c2;
    tmp[i * 4 + 0] = a0 + a1;
    tmp[i * 4 + 1] = a3 + a2;
    tmp[i * 4 + 2] = a3 - a2;
    tmp[i * 4 + 3] = a0 - a1;
  }
  for (int j = 0; j < 4; ++j) {
    int32_t r0 = tmp[0 * 4 + j], r1 = tmp[1 * 4 + j];
    int32_t r2 = tmp[2 * 4 + j], r3 = tmp[3 * 4 + j];
    int32_t a0 = r0 + r2, a1 = r1 + r3, a2 = r1 - r3, a3 = r0 - r2;
    out[0 * 4 + j] = (a0 + a1) >> 1;
    out[1 * 4 + j] = (a3 + a2) >> 1;
    out[2 * 4 + j] = (a3 - a2) >> 1;
    out[3 * 4 + j] = (a0 - a1) >> 1;
  }
}

// Inverse WHT: raster [16] -> 16 sub-block DC values (raster).
// int32 exact: no multiplies; |input| <= level_max*q_y2 < 1e6, and the
// butterflies only scale by <= 8x.
static void WHT4x4(const int32_t* c, int32_t* out) {
  int32_t tmp[16];
  for (int j = 0; j < 4; ++j) {
    int32_t i0 = c[0 * 4 + j], i1 = c[1 * 4 + j];
    int32_t i2 = c[2 * 4 + j], i3 = c[3 * 4 + j];
    int32_t a0 = i0 + i3, a1 = i1 + i2, a2 = i1 - i2, a3 = i0 - i3;
    tmp[0 * 4 + j] = a0 + a1;
    tmp[1 * 4 + j] = a3 + a2;
    tmp[2 * 4 + j] = a0 - a1;
    tmp[3 * 4 + j] = a3 - a2;
  }
  for (int r = 0; r < 4; ++r) {
    int32_t dc = tmp[r * 4 + 0] + 3;
    int32_t a0 = dc + tmp[r * 4 + 3];
    int32_t a1 = tmp[r * 4 + 1] + tmp[r * 4 + 2];
    int32_t a2 = tmp[r * 4 + 1] - tmp[r * 4 + 2];
    int32_t a3 = dc - tmp[r * 4 + 3];
    out[r * 4 + 0] = (a0 + a1) >> 3;
    out[r * 4 + 1] = (a3 + a2) >> 3;
    out[r * 4 + 2] = (a0 - a1) >> 3;
    out[r * 4 + 3] = (a3 - a2) >> 3;
  }
}

// ---------------------------------------------------------------------
// Reconstruction + SSE accumulation: rec = clip255(pred + res), returns
// sum((src - rec)^2) over the 16-px block.
// ---------------------------------------------------------------------
static inline int64_t ReconDisto(const int32_t* pred, const int32_t* res,
                                 const int32_t* src, int32_t* rec) {
#ifdef WEBPTPU_ENC_SIMD
  const __m128i zero = _mm_setzero_si128();
  const __m128i v255 = _mm_set1_epi32(255);
  __m128i acc = zero;
  for (int k = 0; k < 16; k += 4) {
    __m128i v = _mm_add_epi32(_mm_loadu_si128((const __m128i*)(pred + k)),
                              _mm_loadu_si128((const __m128i*)(res + k)));
    v = _mm_min_epi32(_mm_max_epi32(v, zero), v255);
    _mm_storeu_si128((__m128i*)(rec + k), v);
    const __m128i d =
        _mm_sub_epi32(_mm_loadu_si128((const __m128i*)(src + k)), v);
    acc = _mm_add_epi32(acc, _mm_mullo_epi32(d, d));  // <= 16*255^2 per lane
  }
  acc = _mm_add_epi32(acc, _mm_srli_si128(acc, 8));
  acc = _mm_add_epi32(acc, _mm_srli_si128(acc, 4));
  return (int64_t)_mm_cvtsi128_si32(acc);
#else
  int64_t disto = 0;
  for (int i = 0; i < 16; ++i) {
    const int v = pred[i] + res[i];
    const int r = v < 0 ? 0 : (v > 255 ? 255 : v);
    rec[i] = r;
    const int64_t d = src[i] - r;
    disto += d * d;
  }
  return disto;
#endif
}

// ---------------------------------------------------------------------
// Intra prediction (lossy/dsp.py pred_block / pred_luma4).
// ---------------------------------------------------------------------
static inline int Clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }
static inline int Avg2(int a, int b) { return (a + b + 1) >> 1; }
static inline int Avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }

// Whole-block predictor: size 16 or 8, out raster int32[size*size].
static void PredBlock(int mode, int size, const int32_t* top,
                      const int32_t* left, int topleft, int32_t* out) {
  int n = size * size;
  switch (mode) {
    case DC_PRED: {
      int sum = size;  // rounding term
      for (int i = 0; i < size; ++i) sum += top[i] + left[i];
      int shift = size == 16 ? 5 : 4;  // log2(size*2)
      int dc = sum >> shift;
      for (int i = 0; i < n; ++i) out[i] = dc;
      return;
    }
    case DC_NO_TOP: {
      int sum = size >> 1;
      for (int i = 0; i < size; ++i) sum += left[i];
      int dc = sum >> (size == 16 ? 4 : 3);
      for (int i = 0; i < n; ++i) out[i] = dc;
      return;
    }
    case DC_NO_LEFT: {
      int sum = size >> 1;
      for (int i = 0; i < size; ++i) sum += top[i];
      int dc = sum >> (size == 16 ? 4 : 3);
      for (int i = 0; i < n; ++i) out[i] = dc;
      return;
    }
    case DC_NO_TOPLEFT:
      for (int i = 0; i < n; ++i) out[i] = 0x80;
      return;
    case V_PRED:
      for (int r = 0; r < size; ++r)
        for (int c = 0; c < size; ++c) out[r * size + c] = top[c];
      return;
    case H_PRED:
      for (int r = 0; r < size; ++r)
        for (int c = 0; c < size; ++c) out[r * size + c] = left[r];
      return;
    default:  // TM_PRED
      for (int r = 0; r < size; ++r)
        for (int c = 0; c < size; ++c)
          out[r * size + c] = Clip255(left[r] + top[c] - topleft);
      return;
  }
}

// All ten 4x4 predictors at once (same per-mode values as lossy/dsp.py
// pred_luma4). The Avg3/Avg2 chains are shared across modes — Avg3 is
// symmetric in its outer arguments, so e.g. B_RD's Avg3(l1,l0,tl) is
// B_HD's Avg3(tl,l0,l1). Mode order: DC,TM,VE,HE,RD,VR,LD,VL,HD,HU.
static void PredLuma4All(const int32_t* top, const int32_t* left, int tl,
                         const int32_t* tr, int32_t preds[][16]) {
  const int t0 = top[0], t1 = top[1], t2 = top[2], t3 = top[3];
  const int l0 = left[0], l1 = left[1], l2 = left[2], l3 = left[3];
  const int t4 = tr[0], t5 = tr[1], t6 = tr[2], t7 = tr[3];
  // Shared 3-tap chains.
  const int a_tl01 = Avg3(tl, t0, t1), a_t012 = Avg3(t0, t1, t2);
  const int a_t123 = Avg3(t1, t2, t3), a_t234 = Avg3(t2, t3, t4);
  const int a_t345 = Avg3(t3, t4, t5), a_t456 = Avg3(t4, t5, t6);
  const int a_t567 = Avg3(t5, t6, t7), a_t677 = Avg3(t6, t7, t7);
  const int a_tll01 = Avg3(tl, l0, l1), a_l012 = Avg3(l0, l1, l2);
  const int a_l123 = Avg3(l1, l2, l3), a_l233 = Avg3(l2, l3, l3);
  const int a_l0tlt0 = Avg3(l0, tl, t0);
  // Shared 2-tap values.
  const int h_tlt0 = Avg2(tl, t0), h_t01 = Avg2(t0, t1);
  const int h_t12 = Avg2(t1, t2), h_t23 = Avg2(t2, t3), h_t34 = Avg2(t3, t4);
  const int h_tll0 = Avg2(tl, l0), h_l01 = Avg2(l0, l1);
  const int h_l12 = Avg2(l1, l2), h_l23 = Avg2(l2, l3);
  int32_t* o;
  o = preds[0];  // B_DC
  {
    const int dc = (t0 + t1 + t2 + t3 + l0 + l1 + l2 + l3 + 4) >> 3;
    for (int i = 0; i < 16; ++i) o[i] = dc;
  }
  o = preds[1];  // B_TM
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) o[r * 4 + c] = Clip255(left[r] + top[c] - tl);
  o = preds[2];  // B_VE
  for (int r = 0; r < 4; ++r) {
    o[r * 4 + 0] = a_tl01; o[r * 4 + 1] = a_t012;
    o[r * 4 + 2] = a_t123; o[r * 4 + 3] = a_t234;
  }
  o = preds[3];  // B_HE
  for (int c = 0; c < 4; ++c) {
    o[0 * 4 + c] = a_tll01; o[1 * 4 + c] = a_l012;
    o[2 * 4 + c] = a_l123;  o[3 * 4 + c] = a_l233;
  }
  o = preds[4];  // B_RD
  o[3 * 4 + 0] = a_l123;  // Avg3(l3,l2,l1)
  o[2 * 4 + 0] = o[3 * 4 + 1] = a_l012;   // Avg3(l2,l1,l0)
  o[1 * 4 + 0] = o[2 * 4 + 1] = o[3 * 4 + 2] = a_tll01;  // Avg3(l1,l0,tl)
  o[0 * 4 + 0] = o[1 * 4 + 1] = o[2 * 4 + 2] = o[3 * 4 + 3] = a_l0tlt0;
  o[0 * 4 + 1] = o[1 * 4 + 2] = o[2 * 4 + 3] = a_tl01;
  o[0 * 4 + 2] = o[1 * 4 + 3] = a_t012;
  o[0 * 4 + 3] = a_t123;
  o = preds[5];  // B_VR
  o[0 * 4 + 0] = o[2 * 4 + 1] = h_tlt0;
  o[0 * 4 + 1] = o[2 * 4 + 2] = h_t01;
  o[0 * 4 + 2] = o[2 * 4 + 3] = h_t12;
  o[0 * 4 + 3] = h_t23;
  o[1 * 4 + 0] = o[3 * 4 + 1] = a_l0tlt0;
  o[1 * 4 + 1] = o[3 * 4 + 2] = a_tl01;
  o[1 * 4 + 2] = o[3 * 4 + 3] = a_t012;
  o[1 * 4 + 3] = a_t123;
  o[2 * 4 + 0] = a_tll01;  // Avg3(l1,l0,tl)
  o[3 * 4 + 0] = a_l012;   // Avg3(l2,l1,l0)
  o = preds[6];  // B_LD
  o[0 * 4 + 0] = a_t012;
  o[0 * 4 + 1] = o[1 * 4 + 0] = a_t123;
  o[0 * 4 + 2] = o[1 * 4 + 1] = o[2 * 4 + 0] = a_t234;
  o[0 * 4 + 3] = o[1 * 4 + 2] = o[2 * 4 + 1] = o[3 * 4 + 0] = a_t345;
  o[1 * 4 + 3] = o[2 * 4 + 2] = o[3 * 4 + 1] = a_t456;
  o[2 * 4 + 3] = o[3 * 4 + 2] = a_t567;
  o[3 * 4 + 3] = a_t677;
  o = preds[7];  // B_VL
  o[0 * 4 + 0] = h_t01;
  o[0 * 4 + 1] = o[2 * 4 + 0] = h_t12;
  o[0 * 4 + 2] = o[2 * 4 + 1] = h_t23;
  o[0 * 4 + 3] = o[2 * 4 + 2] = h_t34;
  o[1 * 4 + 0] = a_t012;
  o[1 * 4 + 1] = o[3 * 4 + 0] = a_t123;
  o[1 * 4 + 2] = o[3 * 4 + 1] = a_t234;
  o[1 * 4 + 3] = o[3 * 4 + 2] = a_t345;
  o[2 * 4 + 3] = a_t456;
  o[3 * 4 + 3] = a_t567;
  o = preds[8];  // B_HD
  o[0 * 4 + 0] = h_tll0;
  o[0 * 4 + 1] = a_l0tlt0;  // Avg3(l0,tl,t0)
  o[0 * 4 + 2] = a_tl01;
  o[0 * 4 + 3] = a_t012;
  o[1 * 4 + 0] = h_l01;
  o[1 * 4 + 1] = a_tll01;
  o[1 * 4 + 2] = o[0 * 4 + 0];
  o[1 * 4 + 3] = o[0 * 4 + 1];
  o[2 * 4 + 0] = h_l12;
  o[2 * 4 + 1] = a_l012;
  o[2 * 4 + 2] = o[1 * 4 + 0];
  o[2 * 4 + 3] = o[1 * 4 + 1];
  o[3 * 4 + 0] = h_l23;
  o[3 * 4 + 1] = a_l123;
  o[3 * 4 + 2] = o[2 * 4 + 0];
  o[3 * 4 + 3] = o[2 * 4 + 1];
  o = preds[9];  // B_HU
  o[0 * 4 + 0] = h_l01;
  o[0 * 4 + 1] = a_l012;
  o[0 * 4 + 2] = h_l12;
  o[0 * 4 + 3] = a_l123;
  o[1 * 4 + 0] = o[0 * 4 + 2];
  o[1 * 4 + 1] = o[0 * 4 + 3];
  o[1 * 4 + 2] = h_l23;
  o[1 * 4 + 3] = a_l233;
  o[2 * 4 + 0] = o[1 * 4 + 2];
  o[2 * 4 + 1] = o[1 * 4 + 3];
  o[2 * 4 + 2] = l3;
  o[2 * 4 + 3] = l3;
  for (int c = 0; c < 4; ++c) o[3 * 4 + c] = l3;
}

// mode adjusted for frame borders (encode.py _check_mode).
static int CheckMode(int mb_x, int mb_y, int mode) {
  if (mode == DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? DC_NO_TOPLEFT : DC_NO_LEFT;
    return mb_y == 0 ? DC_NO_TOP : DC_PRED;
  }
  return mode;
}

// ---------------------------------------------------------------------
// Rate estimation (cost.py residual_cost / variable_level_cost).
// ---------------------------------------------------------------------
#ifdef WEBPTPU_ENC_AVX2
static inline int32_t HSum8(__m256i v) {
  __m128i s = _mm_add_epi32(_mm256_castsi256_si128(v),
                            _mm256_extracti128_si256(v, 1));
  s = _mm_add_epi32(s, _mm_srli_si128(s, 8));
  s = _mm_add_epi32(s, _mm_srli_si128(s, 4));
  return _mm_cvtsi128_si32(s);
}
#endif

// nzmask: zigzag nonzero bitmask of lv (bits below `first` are zero by
// construction — QuantizeBlock forces position 0 off when first=1).
static int64_t ResidualCost(const int32_t* lv, uint32_t nzmask, int first,
                            int ctx0, int ptype, const Tables& T) {
  int n = first;
  int p0 = T.p(ptype, kBands[n], ctx0)[0];
  int64_t cost = ctx0 == 0 ? T.bit_cost(1, p0) : 0;
  if (!nzmask) return T.bit_cost(0, p0);
  const int last = 31 - __builtin_clz(nzmask);
#ifdef WEBPTPU_ENC_AVX2
  if (last >= 6) {
  // All positions at once. cost[n] = level_fixed[min(v_n, 2047)] +
  // cost[ptype][kBands[n]][ctx_n][min(v_n, 67)], and the context chain is
  // NON-recursive — ctx_n = min(|lv[n-1]|, 2) depends only on the previous
  // level, not on accumulated state — so the whole evaluation is two pairs
  // of AVX2 gathers plus a masked lane sum (same trick as the device
  // trellis rate). Per-lane values fit int32 (< 2^20 each, 16 lanes).
  static constexpr int32_t kBand204[16] = {  // kBands[n] * 3 * 68
      0, 204, 408, 612, 1224, 816, 1020, 1224,
      1224, 1224, 1224, 1224, 1224, 1224, 1224, 1428};
  const __m256i a0 = _mm256_abs_epi32(_mm256_loadu_si256((const __m256i*)lv));
  const __m256i two = _mm256_set1_epi32(2);
  const __m256i vmaxv = _mm256_set1_epi32(kMaxVariableLevel);
  const __m256i vmaxf = _mm256_set1_epi32(kMaxLevel);
  const __m256i lanes0 = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
  const __m256i vfirst = _mm256_set1_epi32(first - 1);
  const __m256i vlast = _mm256_set1_epi32(last + 1);
  alignas(32) int32_t cbuf[18];
  _mm256_storeu_si256((__m256i*)(cbuf + 1), _mm256_min_epi32(a0, two));
  const __m256i pband0 = _mm256_add_epi32(
      _mm256_set1_epi32(ptype * 1632),
      _mm256_loadu_si256((const __m256i*)kBand204));
  __m256i a1, pband1;
  if (last >= 8) {
    a1 = _mm256_abs_epi32(_mm256_loadu_si256((const __m256i*)(lv + 8)));
    _mm256_storeu_si256((__m256i*)(cbuf + 9), _mm256_min_epi32(a1, two));
    pband1 = _mm256_add_epi32(
        _mm256_set1_epi32(ptype * 1632),
        _mm256_loadu_si256((const __m256i*)(kBand204 + 8)));
  }
  cbuf[first] = ctx0;
  const __m256i ctxv0 = _mm256_loadu_si256((const __m256i*)cbuf);
  const __m256i idx0 = _mm256_add_epi32(
      _mm256_add_epi32(pband0, _mm256_mullo_epi32(ctxv0, _mm256_set1_epi32(68))),
      _mm256_min_epi32(a0, vmaxv));
  __m256i c0 = _mm256_add_epi32(
      _mm256_i32gather_epi32(T.cost, idx0, 4),
      _mm256_i32gather_epi32(T.level_fixed, _mm256_min_epi32(a0, vmaxf), 4));
  const __m256i m0 = _mm256_and_si256(_mm256_cmpgt_epi32(lanes0, vfirst),
                                      _mm256_cmpgt_epi32(vlast, lanes0));
  int32_t sum = HSum8(_mm256_and_si256(c0, m0));
  if (last >= 8) {
    const __m256i lanes1 = _mm256_setr_epi32(8, 9, 10, 11, 12, 13, 14, 15);
    const __m256i ctxv1 = _mm256_loadu_si256((const __m256i*)(cbuf + 8));
    const __m256i idx1 = _mm256_add_epi32(
        _mm256_add_epi32(pband1,
                         _mm256_mullo_epi32(ctxv1, _mm256_set1_epi32(68))),
        _mm256_min_epi32(a1, vmaxv));
    __m256i c1 = _mm256_add_epi32(
        _mm256_i32gather_epi32(T.cost, idx1, 4),
        _mm256_i32gather_epi32(T.level_fixed, _mm256_min_epi32(a1, vmaxf), 4));
    const __m256i m1 = _mm256_cmpgt_epi32(vlast, lanes1);  // all >= first+1
    sum += HSum8(_mm256_and_si256(c1, m1));
  }
  cost += sum;
  const int vl = lv[last] < 0 ? -lv[last] : lv[last];
  if (last < 15) {
    int b = kBands[last + 1];
    int ctx = vl == 1 ? 1 : 2;
    cost += T.bit_cost(0, T.p(ptype, b, ctx)[0]);
  }
  return cost;
  }
#endif
  // Sparse blocks (the common case at mid quality): the sequential loop
  // is only `last+1` dependent table walks — cheaper than gather latency.
  const int32_t* t = T.ct(ptype, kBands[n], ctx0);
  while (n < last) {
    int v = lv[n] < 0 ? -lv[n] : lv[n];
    cost += T.level_cost(t, v);
    int ctx = v < 2 ? v : 2;
    t = T.ct(ptype, kBands[n + 1], ctx);
    n++;
  }
  int v = lv[n] < 0 ? -lv[n] : lv[n];
  cost += T.level_cost(t, v);
  if (n < 15) {
    int b = kBands[n + 1];
    int ctx = v == 1 ? 1 : 2;
    cost += T.bit_cost(0, T.p(ptype, b, ctx)[0]);
  }
  return cost;
}


// Luma-block rate with intra-MB nz chaining (encode.py _luma_rate).
// masks: per-block zigzag nonzero bitmasks from QuantizeBlock.
static int64_t LumaRate(const int32_t (*lv)[16], const uint32_t* masks,
                        int first, int ptype, uint32_t tnz, uint32_t lnz,
                        const Tables& T) {
  int64_t rate = 0;
  tnz &= 0x0F;
  lnz &= 0x0F;
  int l = 0;
  for (int y = 0; y < 4; ++y) {
    l = lnz & 1;
    for (int x = 0; x < 4; ++x) {
      int bi = y * 4 + x;
      int ctx = l + (tnz & 1);
      rate += ResidualCost(lv[bi], masks[bi], first, ctx, ptype, T);
      l = masks[bi] != 0;
      tnz = (tnz >> 1) | ((uint32_t)l << 7);
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | ((uint32_t)l << 7);
  }
  return rate;
}

// Chroma rate for one plane's 4 blocks (encode.py _uv_rate).
static int64_t UVRate(const int32_t (*lv)[16], const uint32_t* masks, int ch,
                      uint32_t tnz_in, uint32_t lnz_in, const Tables& T) {
  int64_t rate = 0;
  uint32_t tnz = tnz_in >> (4 + ch);
  uint32_t lnz = lnz_in >> (4 + ch);
  int l = 0;
  for (int y = 0; y < 2; ++y) {
    l = lnz & 1;
    for (int x = 0; x < 2; ++x) {
      int bi = y * 2 + x;
      int ctx = l + (tnz & 1);
      rate += ResidualCost(lv[bi], masks[bi], 0, ctx, 2, T);
      l = masks[bi] != 0;
      tnz = (tnz >> 1) | ((uint32_t)l << 3);
    }
    tnz >>= 2;
    lnz = (lnz >> 1) | ((uint32_t)l << 5);
  }
  return rate;
}

// ---------------------------------------------------------------------
// Trellis quantization (quant.py trellis_quantize_block, Viterbi).
// ---------------------------------------------------------------------
// Returns the zigzag nonzero bitmask of out_zz (same convention as
// QuantizeBlock).
static uint32_t TrellisQuantizeBlock(const int32_t* coeffs, const SQ& sq,
                                     int first, int ctx_type, int ctx0,
                                     int64_t lam, const Tables& T,
                                     int32_t* out_zz, int32_t* dq_raster) {
  constexpr int64_t INF = (int64_t)1 << 62;
  if (ctx0 > 2) ctx0 = 2;
  int64_t prev_score[3] = {INF, INF, INF};
  prev_score[ctx0] = 0;
  // path[n][c] = (level, prev_ctx); level INT32_MIN = unset.
  int32_t path_lv[16][3];
  int8_t path_pc[16][3];
  bool path_set[16][3];
  memset(path_set, 0, sizeof(path_set));

  int first_band = kBands[first];
  int p00 = T.p(ctx_type, first_band, ctx0)[0];
  int64_t best_terminal = (int64_t)T.entropy_cost[p00] * lam;
  int best_last_n = -1, best_last_ctx = -1;

  // Positions past the last one with any nonzero candidate (thresh >= 1)
  // cannot change the DP result: the candidate set is empty there, so the
  // ctx-1/2 scores all go to INF and the terminal update (which needs
  // ctx >= 1) can never fire again. Stopping at last_cand is exact.
  int last_cand = first - 1;
  for (int n = first; n < 16; ++n) {
    int64_t c = coeffs[kZigzag[n]];
    if (c < 0) c = -c;
    c += sq.sharpen[n];
    if (((c * sq.iq[n] + 65536) >> 17) >= 1) last_cand = n;
  }

  for (int n = first; n <= last_cand; ++n) {
    int zig = kZigzag[n];
    int band_next = kBands[n + 1];
    int64_t raw = coeffs[zig];
    int sign = raw < 0 ? -1 : 1;
    if (raw < 0) raw = -raw;
    int64_t c0 = raw + sq.sharpen[n];
    if (c0 < 0) c0 = 0;
    int64_t quant = sq.q[n];
    int64_t iquant = sq.iq[n];
    int64_t L0 = (c0 * iquant) >> 17;
    if (L0 > kMaxLevel) L0 = kMaxLevel;
    int64_t thresh = (c0 * iquant + 65536) >> 17;
    if (thresh > kMaxLevel) thresh = kMaxLevel;
    int64_t weight = kWeightTrellis[zig];
    int64_t c0sq = c0 * c0;

    // Candidate levels (L, delta-distortion, next ctx).
    int n_cand = 0;
    int64_t cand_L[2], cand_dd[2];
    int cand_nc[2];
    if (0 < L0 && L0 <= thresh) {
      int64_t err = c0 - L0 * quant;
      cand_L[n_cand] = L0;
      cand_dd[n_cand] = weight * (err * err - c0sq);
      cand_nc[n_cand] = L0 < 2 ? (int)L0 : 2;
      n_cand++;
    }
    if (L0 + 1 <= thresh) {
      int64_t L1 = L0 + 1;
      int64_t err = c0 - L1 * quant;
      cand_L[n_cand] = L1;
      cand_dd[n_cand] = weight * (err * err - c0sq);
      cand_nc[n_cand] = L1 < 2 ? (int)L1 : 2;
      n_cand++;
    }

    int64_t cur_score[3] = {INF, INF, INF};
    int32_t cur_lv[3];
    int8_t cur_pc[3];
    bool cur_set[3] = {false, false, false};
    for (int pc = 0; pc < 3; ++pc) {
      if (prev_score[pc] >= INF) continue;
      const uint8_t* p = T.p(ctx_type, kBands[n], pc);
      // The precomputed ct rows already fold in the not-EOB bit (ctx > 0
      // rows) and the zero/nonzero bit, so a level's rate is a
      // level_cost lookup plus — for ctx 0 rows only, where the table
      // omits it — the not-EOB correction (cost.py
      // compute_level_cost_tables `cost0`).
      const int32_t* row = T.ct(ctx_type, kBands[n], pc);
      const int64_t corr = pc == 0 ? T.entropy_cost[255 - p[0]] : 0;
      int64_t ts = prev_score[pc] + (row[0] + corr) * lam;
      if (ts < cur_score[0]) {
        cur_score[0] = ts;
        cur_lv[0] = 0;
        cur_pc[0] = (int8_t)pc;
        cur_set[0] = true;
      }
      if (n_cand) {
        for (int k = 0; k < n_cand; ++k) {
          int64_t L = cand_L[k];
          int64_t rate = T.level_cost(row, (int)L) + corr;
          int64_t ts2 = prev_score[pc] + rate * lam + 256 * cand_dd[k];
          int nc = cand_nc[k];
          if (ts2 < cur_score[nc]) {
            cur_score[nc] = ts2;
            cur_lv[nc] = (int32_t)(sign * L);
            cur_pc[nc] = (int8_t)pc;
            cur_set[nc] = true;
          }
        }
      }
    }
    for (int c = 0; c < 3; ++c) {
      if (cur_set[c]) {
        path_lv[n][c] = cur_lv[c];
        path_pc[n][c] = cur_pc[c];
        path_set[n][c] = true;
      }
    }
    for (int c = 1; c <= 2; ++c) {
      if (cur_score[c] >= INF) continue;
      int64_t eob = cur_score[c];
      if (n < 15)
        eob += (int64_t)T.entropy_cost[T.p(ctx_type, band_next, c)[0]] * lam;
      if (eob < best_terminal) {
        best_terminal = eob;
        best_last_n = n;
        best_last_ctx = c;
      }
    }
    prev_score[0] = cur_score[0];
    prev_score[1] = cur_score[1];
    prev_score[2] = cur_score[2];
  }

  for (int i = 0; i < 16; ++i) out_zz[i] = 0;
  if (best_last_n >= 0) {
    int ctx = best_last_ctx;
    for (int n = best_last_n; n >= first; --n) {
      if (path_set[n][ctx]) {
        out_zz[n] = path_lv[n][ctx];
        ctx = path_pc[n][ctx];
      }
    }
  }
  uint32_t mask = 0;
  for (int i = 0; i < 16; ++i) dq_raster[i] = 0;
  for (int n = 0; n < 16; ++n) {
    dq_raster[kZigzag[n]] = out_zz[n] * (int32_t)sq.q[n];
    if (out_zz[n]) mask |= 1u << n;
  }
  return mask;
}

// ---------------------------------------------------------------------
// Plane halo extraction (encode.py _mb_halo): B is (size+1) x
// (size+1+tr_count) with top row/left col/corner filled per VP8 borders.
// ---------------------------------------------------------------------
static void MBHalo(const uint8_t* plane, int stride, int x0, int y0, int size,
                   int mb_x, int mb_y, int mb_w, int tr_count, int32_t* B,
                   int bw) {
  // bw = size + 1 + tr_count (row width of B).
  for (int i = 0; i < (size + 1) * bw; ++i) B[i] = 0;
  if (mb_y == 0) {
    for (int i = 0; i < bw; ++i) B[i] = 127;
  } else {
    const uint8_t* above = plane + (size_t)(y0 - 1) * stride;
    for (int i = 0; i < size; ++i) B[1 + i] = above[x0 + i];
    B[0] = mb_x > 0 ? above[x0 - 1] : 129;
    if (tr_count) {
      if (mb_x >= mb_w - 1) {
        for (int i = 0; i < tr_count; ++i)
          B[size + 1 + i] = above[x0 + size - 1];
      } else {
        for (int i = 0; i < tr_count; ++i)
          B[size + 1 + i] = above[x0 + size + i];
      }
    }
  }
  if (mb_x == 0) {
    for (int r = 1; r <= size; ++r) B[r * bw] = 129;
  } else {
    for (int r = 0; r < size; ++r)
      B[(r + 1) * bw] = plane[(size_t)(y0 + r) * stride + x0 - 1];
  }
}

struct Quantizers {
  SQ y1, y2, uv;
  int64_t lam_i16, lam_i4, lam_uv;
  int64_t lam_mode;  // final I4-vs-I16 decision lambda ((q_i4^2)>>7)
  int64_t tlam_i16, tlam_i4;
};

}  // namespace

extern "C" {

// Runs the full closed-loop MB encode (mode decisions, quantization,
// reconstruction). Outputs match VP8Encoder's Python loop bit-for-bit.
//
// quant: int64 [4][3][4][16] — (segment, class y1/y2/uv, field q/iq/bias/
//   sharpen). lambdas: int64 [4][3] — (i16, i4, uv) per segment.
void vp8_encode_mbs(
    const uint8_t* srcY, const uint8_t* srcU, const uint8_t* srcV, int mb_w,
    int mb_h, const uint8_t* seg_map, const int64_t* quant,
    const int64_t* lambdas, const uint8_t* proba, const int32_t* cost_tables,
    const int32_t* entropy_cost, const int32_t* level_fixed,
    const int32_t* fixed_costs_i4, int method, int i4_blocks,
    int64_t i4_header_cap,
    int32_t* levels, int32_t* y2_levels, uint8_t* is_i4, uint8_t* imodes,
    uint8_t* uvmode, uint8_t* skip, uint8_t* recY, uint8_t* recU,
    uint8_t* recV) {
  const Tables T{proba, cost_tables, entropy_cost, level_fixed,
                 fixed_costs_i4};
  const int ys = mb_w * 16, cs = mb_w * 8;

  // Expand per-segment quantizers.
  Quantizers SEG[4];
  for (int s = 0; s < 4; ++s) {
    const int64_t* base = quant + (size_t)s * 3 * 4 * 16;
    auto cls = [&](int c) {
      const int64_t* f = base + (size_t)c * 4 * 16;
      SQ sq;
      for (int i = 0; i < 16; ++i) {
        sq.q[i] = (int32_t)f[i];
        sq.iq[i] = (int32_t)f[16 + i];
        sq.bias[i] = (int32_t)f[32 + i];
        sq.sharpen[i] = (int32_t)f[48 + i];
      }
      return sq;
    };
    SEG[s].y1 = cls(0);
    SEG[s].y2 = cls(1);
    SEG[s].uv = cls(2);
    SEG[s].lam_i16 = lambdas[s * 3 + 0];
    SEG[s].lam_i4 = lambdas[s * 3 + 1];
    SEG[s].lam_uv = lambdas[s * 3 + 2];
    int64_t qi = (SEG[s].y1.q[0] + 15 * SEG[s].y1.q[1] + 8) >> 4;
    int64_t t16 = (qi * qi) >> 2;
    SEG[s].tlam_i16 = t16 > 1 ? t16 : 1;
    int64_t t4 = (7 * qi * qi) >> 3;
    SEG[s].tlam_i4 = t4 > 1 ? t4 : 1;
    int64_t lm = (qi * qi) >> 7;  // encode.py lam["mode"]
    SEG[s].lam_mode = lm > 1 ? lm : 1;
  }

  std::vector<uint32_t> top_nz(mb_w, 0);
  std::vector<uint8_t> top_dc(mb_w, 0);
  std::vector<uint8_t> top_bmodes(mb_w * 4, 0);
  uint8_t left_bmodes[4];

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    uint32_t left_nz = 0;
    uint8_t left_dc = 0;
    memset(left_bmodes, 0, 4);
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const int mb = mb_y * mb_w + mb_x;
      const int seg = seg_map[mb];
      const Quantizers& Q = SEG[seg];
      const int y0 = mb_y * 16, x0 = mb_x * 16;

      // Source luma in sub-block order: src_b[bi][16] raster within block.
      int32_t src_b[16][16];
      for (int bi = 0; bi < 16; ++bi) {
        int by = bi >> 2, bx = bi & 3;
        for (int r = 0; r < 4; ++r)
          for (int c = 0; c < 4; ++c)
            src_b[bi][r * 4 + c] =
                srcY[(size_t)(y0 + by * 4 + r) * ys + x0 + bx * 4 + c];
      }
      // Halo (17 x 21: 16+1 rows, 16+1+4 cols).
      int32_t B[17 * 21];
      MBHalo(recY, ys, x0, y0, 16, mb_x, mb_y, mb_w, 4, B, 21);
      const int32_t* topY = B + 1;        // B[0, 1:17]
      int32_t leftY[16];
      for (int r = 0; r < 16; ++r) leftY[r] = B[(r + 1) * 21];
      const int tlY = B[0];

      const uint32_t tnz = top_nz[mb_x];
      const uint32_t lnz = left_nz;
      const int tdc = top_dc[mb_x], ldc = left_dc;

      // ---- I16: full RD over 4 whole-block modes. Methods 0-1 skip the
      // per-mode transform pipeline: the mode is picked by
      // prediction-domain SSE and only the winner is encoded (reference
      // encode.go maps low methods to rd_opt=none the same way).
      int64_t i16_score = 0;
      int64_t i16_rate = 0, i16_disto = 0;
      int i16_mode = 0;
      int32_t i16_lv[16][16], i16_y2lv[16];
      int32_t i16_coeffs[16][16], i16_pred[256], i16_rec_dcs[16];
      int32_t rec16[16][16];  // per sub-block raster
      bool have_best = false;
      int mode_lo = 0, mode_hi = 4;
      if (method <= 1) {
        int64_t best_sse = 0;
        int best_m = 0;
        for (int mode = 0; mode < 4; ++mode) {
          int m = CheckMode(mb_x, mb_y, mode);
          int32_t pred[256];
          PredBlock(m, 16, topY, leftY, tlY, pred);
          int64_t sse = 0;
          for (int r = 0; r < 16; ++r)
            for (int cidx = 0; cidx < 16; ++cidx) {
              const int32_t d =
                  (int32_t)srcY[(size_t)(y0 + r) * ys + x0 + cidx] -
                  pred[r * 16 + cidx];
              sse += d * d;
            }
          if (mode == 0 || sse < best_sse) {
            best_sse = sse;
            best_m = mode;
          }
        }
        mode_lo = best_m;
        mode_hi = best_m + 1;
      }
      for (int mode = mode_lo; mode < mode_hi; ++mode) {
        int m = CheckMode(mb_x, mb_y, mode);
        int32_t pred[256];
        PredBlock(m, 16, topY, leftY, tlY, pred);
        int32_t pred_b[16][16], coeffs[16][16];
        int32_t dcs[16];
        for (int bi = 0; bi < 16; ++bi) {
          int by = bi >> 2, bx = bi & 3;
          for (int r = 0; r < 4; ++r)
            for (int c = 0; c < 4; ++c)
              pred_b[bi][r * 4 + c] = pred[(by * 4 + r) * 16 + bx * 4 + c];
        }
        for (int bi = 0; bi < 16; bi += 2) {
          FDCT4x4_2(src_b[bi], pred_b[bi], coeffs[bi],
                    src_b[bi + 1], pred_b[bi + 1], coeffs[bi + 1]);
          dcs[bi] = coeffs[bi][0];
          dcs[bi + 1] = coeffs[bi + 1][0];
        }
        int32_t wht[16], y2lv[16], y2dq[16], rdcs[16];
        FWHT4x4(dcs, wht);
        const uint32_t y2mask = QuantizeBlock(wht, Q.y2, 0, y2lv, y2dq);
        WHT4x4(y2dq, rdcs);
        int32_t lv[16][16], dq[16][16];
        uint32_t lvm[16];
        for (int bi = 0; bi < 16; bi += 2) {
          QuantizeBlock2(coeffs[bi], coeffs[bi + 1], Q.y1, 1, lv[bi],
                         lv[bi + 1], dq[bi], dq[bi + 1], &lvm[bi],
                         &lvm[bi + 1]);
          dq[bi][0] = rdcs[bi];
          dq[bi + 1][0] = rdcs[bi + 1];
        }
        int64_t rate = 0;
        if (method >= 2) {  // single-candidate at m<=1: rate not needed
          rate = ResidualCost(y2lv, y2mask, 0, tdc + ldc, 1, T);
          rate += LumaRate(lv, lvm, 1, 0, tnz, lnz, T);
          rate += kFixedCostsI16[mode];
          // disto >= 0: a rate-only loss needs no reconstruction.
          if (have_best && rate * Q.lam_i16 >= i16_score) continue;
        }
        int64_t disto = 0;
        int32_t rec[16][16];
        for (int bi = 0; bi < 16; ++bi) {
          int32_t res[16];
          IDCT4x4(dq[bi], res);
          disto += ReconDisto(pred_b[bi], res, src_b[bi], rec[bi]);
        }
        int64_t score = method >= 2 ? rate * Q.lam_i16 + 256 * disto : 0;
        if (!have_best || score < i16_score) {
          have_best = true;
          i16_score = score;
          i16_rate = rate;
          i16_disto = disto;
          i16_mode = mode;
          memcpy(i16_lv, lv, sizeof(lv));
          memcpy(i16_y2lv, y2lv, sizeof(y2lv));
          memcpy(rec16, rec, sizeof(rec));
          memcpy(i16_coeffs, coeffs, sizeof(coeffs));
          memcpy(i16_pred, pred, sizeof(pred));
          memcpy(i16_rec_dcs, rdcs, sizeof(rdcs));
        }
      }

      // Trellis refinement of the chosen I16 AC blocks (method >= 5).
      if (method >= 5) {
        int nzg[4][4];
        int32_t dq_new[16][16];
        for (int bi = 0; bi < 16; ++bi) {
          int by = bi >> 2, bx = bi & 3;
          int t_ctx = by == 0 ? (int)((tnz >> bx) & 1) : nzg[by - 1][bx];
          int l_ctx = bx == 0 ? (int)((lnz >> by) & 1) : nzg[by][bx - 1];
          TrellisQuantizeBlock(i16_coeffs[bi], Q.y1, 1, 0, t_ctx + l_ctx,
                               Q.tlam_i16, T, i16_lv[bi], dq_new[bi]);
          int any = 0;
          for (int i = 1; i < 16; ++i)
            if (i16_lv[bi][i]) { any = 1; break; }
          nzg[by][bx] = any;
        }
        for (int bi = 0; bi < 16; ++bi) {
          dq_new[bi][0] = i16_rec_dcs[bi];
          int32_t res[16];
          IDCT4x4(dq_new[bi], res);
          int by = bi >> 2, bx = bi & 3;
          for (int r = 0; r < 4; ++r)
            for (int c = 0; c < 4; ++c)
              rec16[bi][r * 4 + c] = Clip255(
                  i16_pred[(by * 4 + r) * 16 + bx * 4 + c] + res[r * 4 + c]);
        }
      }

      // ---- I4 pick (encode.py _pick_i4): sequential 4x4 RD search.
      bool use_i4 = false;
      uint8_t i4_modes[16];
      int32_t i4_levels[16][16];
      int32_t work[17 * 21];
      if (i4_blocks && method >= 3 && i4_header_cap > 0) {
        // The I4-vs-I16 split compares both totals at lam_mode (encode.py
        // _encode_mb: i16_score_mode; reference encode_parallel.go:565).
        const int64_t i16_score_mode =
            i16_rate * Q.lam_mode + 256 * i16_disto;
        memcpy(work, B, sizeof(work));
        int32_t mb_tr[4];
        for (int i = 0; i < 4; ++i) mb_tr[i] = B[17 + i];
        uint8_t tmodes[4], lmodes[4];
        memcpy(tmodes, top_bmodes.data() + mb_x * 4, 4);
        memcpy(lmodes, left_bmodes, 4);
        uint32_t t4 = tnz & 0x0F, l4 = lnz & 0x0F;
        int64_t total_rate = 211, total_disto = 0, total_header = 0;
        bool ok = true;
        for (int n = 0; n < 16 && ok; ++n) {
          int r = n >> 2, c = n & 3;
          int32_t top[4], left[4], tr[4];
          for (int i = 0; i < 4; ++i) {
            top[i] = work[r * 4 * 21 + 1 + c * 4 + i];
            left[i] = work[(1 + r * 4 + i) * 21 + c * 4];
          }
          int tl = work[r * 4 * 21 + c * 4];
          if (c < 3) {
            for (int i = 0; i < 4; ++i) tr[i] = work[r * 4 * 21 + 5 + c * 4 + i];
          } else {
            for (int i = 0; i < 4; ++i) tr[i] = mb_tr[i];
          }
          int32_t sblk[16];
          for (int rr = 0; rr < 4; ++rr)
            for (int cc = 0; cc < 4; ++cc)
              sblk[rr * 4 + cc] =
                  srcY[(size_t)(y0 + r * 4 + rr) * ys + x0 + c * 4 + cc];
          int ctx = ((l4 >> r) & 1) + ((t4 >> c) & 1);
          int tmode = tmodes[c], lmode = lmodes[r];
          // 10-mode search. The rate of every mode is needed before the
          // rate-only skip can fire, so predictions, transforms, and
          // quantization run for all modes up front — in pairs, so the
          // AVX2 kernels process two modes per pass. Selection order and
          // arithmetic are unchanged from the sequential form: same
          // winner, bit for bit.
          const int32_t* fc_row = fixed_costs_i4 + (tmode * 10 + lmode) * 10;
          int32_t preds[10][16], coefs[10][16], lvs[10][16], dqs4[10][16];
          uint32_t msks[10];
          int64_t rates[10];
          PredLuma4All(top, left, tl, tr, preds);
          for (int mode = 0; mode < 10; mode += 2)
            FDCT4x4_2(sblk, preds[mode], coefs[mode],
                      sblk, preds[mode + 1], coefs[mode + 1]);
          for (int mode = 0; mode < 10; mode += 2)
            QuantizeBlock2(coefs[mode], coefs[mode + 1], Q.y1, 0, lvs[mode],
                           lvs[mode + 1], dqs4[mode], dqs4[mode + 1],
                           &msks[mode], &msks[mode + 1]);
          for (int mode = 0; mode < 10; ++mode)
            rates[mode] =
                ResidualCost(lvs[mode], msks[mode], 0, ctx, 3, T) +
                fc_row[mode];
          int64_t best_score = 0;
          int best_mode = 0;
          int32_t best_rec[16];
          int64_t best_disto = 0, best_rate = 0;
          bool have = false;
          for (int mode = 0; mode < 10; ++mode) {
            // disto >= 0, so rate alone losing means the mode loses:
            // skip the IDCT + reconstruction + SSE (exact, same winner).
            if (have && rates[mode] * Q.lam_i4 >= best_score) continue;
            int32_t res[16], rec[16];
            IDCT4x4(dqs4[mode], res);
            const int64_t disto = ReconDisto(preds[mode], res, sblk, rec);
            int64_t score = rates[mode] * Q.lam_i4 + 256 * disto;
            if (!have || score < best_score) {
              have = true;
              best_score = score;
              best_mode = mode;
              memcpy(best_rec, rec, sizeof(rec));
              best_disto = disto;
              best_rate = rates[mode];
            }
          }
          int32_t* best_lv = lvs[best_mode];
          if (method >= 4) {
            // Trellis re-quantization of the winning mode (prediction and
            // coefficients are already on hand).
            int32_t dq_t[16], res[16];
            TrellisQuantizeBlock(coefs[best_mode], Q.y1, 0, 3, ctx,
                                 Q.tlam_i4, T, best_lv, dq_t);
            IDCT4x4(dq_t, res);
            for (int i = 0; i < 16; ++i)
              best_rec[i] = Clip255(preds[best_mode][i] + res[i]);
          }
          i4_modes[n] = (uint8_t)best_mode;
          memcpy(i4_levels[n], best_lv, sizeof(i4_levels[n]));
          for (int rr = 0; rr < 4; ++rr)
            for (int cc = 0; cc < 4; ++cc)
              work[(1 + r * 4 + rr) * 21 + 1 + c * 4 + cc] =
                  best_rec[rr * 4 + cc];
          total_disto += best_disto;
          total_rate += best_rate;
          int nzb = 0;
          for (int i = 0; i < 16; ++i)
            if (best_lv[i]) { nzb = 1; break; }
          t4 = (t4 & ~(1u << c)) | ((uint32_t)nzb << c);
          l4 = (l4 & ~(1u << r)) | ((uint32_t)nzb << r);
          tmodes[c] = (uint8_t)best_mode;
          lmodes[r] = (uint8_t)best_mode;
          total_header += fixed_costs_i4[(tmode * 10 + lmode) * 10 + best_mode];
          if (total_header > i4_header_cap) ok = false;
          if (ok &&
              total_rate * Q.lam_mode + 256 * total_disto >= i16_score_mode)
            ok = false;
        }
        if (ok &&
            total_rate * Q.lam_mode + 256 * total_disto < i16_score_mode) {
          use_i4 = true;
          memcpy(top_bmodes.data() + mb_x * 4, tmodes, 4);
          memcpy(left_bmodes, lmodes, 4);
        }
      }

      int32_t* mb_levels = levels + (size_t)mb * 24 * 16;
      int luma_nz = 0;
      if (use_i4) {
        is_i4[mb] = 1;
        for (int n = 0; n < 16; ++n) {
          imodes[(size_t)mb * 16 + n] = i4_modes[n];
          for (int i = 0; i < 16; ++i) {
            mb_levels[n * 16 + i] = i4_levels[n][i];
            luma_nz += (i4_levels[n][i] != 0);
          }
        }
        for (int i = 0; i < 16; ++i) y2_levels[(size_t)mb * 16 + i] = 0;
        for (int r = 0; r < 16; ++r)
          for (int c = 0; c < 16; ++c)
            recY[(size_t)(y0 + r) * ys + x0 + c] =
                (uint8_t)work[(1 + r) * 21 + 1 + c];
      } else {
        is_i4[mb] = 0;
        memset(imodes + (size_t)mb * 16, 0, 16);
        imodes[(size_t)mb * 16] = (uint8_t)i16_mode;
        for (int bi = 0; bi < 16; ++bi) {
          int by = bi >> 2, bx = bi & 3;
          for (int i = 0; i < 16; ++i) {
            mb_levels[bi * 16 + i] = i16_lv[bi][i];
            luma_nz += (i16_lv[bi][i] != 0);
          }
          for (int r = 0; r < 4; ++r)
            for (int c = 0; c < 4; ++c)
              recY[(size_t)(y0 + by * 4 + r) * ys + x0 + bx * 4 + c] =
                  (uint8_t)rec16[bi][r * 4 + c];
        }
        for (int i = 0; i < 16; ++i) {
          y2_levels[(size_t)mb * 16 + i] = i16_y2lv[i];
          luma_nz += (i16_y2lv[i] != 0);
        }
        // Propagate the bmode context for non-I4 MBs (encode.py encode()).
        for (int k = 0; k < 4; ++k) {
          top_bmodes[mb_x * 4 + k] = (uint8_t)i16_mode;
          left_bmodes[k] = (uint8_t)i16_mode;
        }
      }

      // ---- Chroma RD: 4 modes with real rates.
      const int yc0 = mb_y * 8, xc0 = mb_x * 8;
      int32_t Bu[9 * 9], Bv[9 * 9];
      MBHalo(recU, cs, xc0, yc0, 8, mb_x, mb_y, mb_w, 0, Bu, 9);
      MBHalo(recV, cs, xc0, yc0, 8, mb_x, mb_y, mb_w, 0, Bv, 9);
      int32_t topU[8], leftU[8], topV[8], leftV[8];
      for (int i = 0; i < 8; ++i) {
        topU[i] = Bu[1 + i];
        leftU[i] = Bu[(i + 1) * 9];
        topV[i] = Bv[1 + i];
        leftV[i] = Bv[(i + 1) * 9];
      }
      int32_t srcUb[4][16], srcVb[4][16];
      for (int bi = 0; bi < 4; ++bi) {
        int by = bi >> 1, bx = bi & 1;
        for (int r = 0; r < 4; ++r)
          for (int c = 0; c < 4; ++c) {
            srcUb[bi][r * 4 + c] =
                srcU[(size_t)(yc0 + by * 4 + r) * cs + xc0 + bx * 4 + c];
            srcVb[bi][r * 4 + c] =
                srcV[(size_t)(yc0 + by * 4 + r) * cs + xc0 + bx * 4 + c];
          }
      }
      int64_t best_uv_score = 0;
      int best_uv_mode = 0;
      int32_t best_lvU[4][16], best_lvV[4][16];
      int32_t best_recU[4][16], best_recV[4][16];
      bool have_uv = false;
      int uv_lo = 0, uv_hi = 4;
      if (method <= 1) {
        // Prediction-domain SSE pick (same shortcut as I16 above).
        int64_t best_sse = 0;
        int best_m = 0;
        for (int mode = 0; mode < 4; ++mode) {
          int m = CheckMode(mb_x, mb_y, mode);
          int32_t pu[64], pv[64];
          PredBlock(m, 8, topU, leftU, Bu[0], pu);
          PredBlock(m, 8, topV, leftV, Bv[0], pv);
          int64_t sse = 0;
          for (int r = 0; r < 8; ++r)
            for (int cidx = 0; cidx < 8; ++cidx) {
              const int32_t du =
                  (int32_t)srcU[(size_t)(yc0 + r) * cs + xc0 + cidx] -
                  pu[r * 8 + cidx];
              const int32_t dv =
                  (int32_t)srcV[(size_t)(yc0 + r) * cs + xc0 + cidx] -
                  pv[r * 8 + cidx];
              sse += (int64_t)du * du + (int64_t)dv * dv;
            }
          if (mode == 0 || sse < best_sse) {
            best_sse = sse;
            best_m = mode;
          }
        }
        uv_lo = best_m;
        uv_hi = best_m + 1;
      }
      for (int mode = uv_lo; mode < uv_hi; ++mode) {
        int m = CheckMode(mb_x, mb_y, mode);
        int32_t pu[64], pv[64];
        PredBlock(m, 8, topU, leftU, Bu[0], pu);
        PredBlock(m, 8, topV, leftV, Bv[0], pv);
        int64_t rate = kFixedCostsUV[mode];
        int32_t lvU[4][16], lvV[4][16], rU[4][16], rV[4][16];
        int32_t pbs[2][4][16], dqs[2][4][16];
        uint32_t uvm[2][4];
        // Quantize both planes first: the rate is then known before any
        // reconstruction, so a rate-only loss skips the IDCT+SSE work.
        for (int pl = 0; pl < 2; ++pl) {
          const int32_t(*sb)[16] = pl == 0 ? srcUb : srcVb;
          const int32_t* pred8 = pl == 0 ? pu : pv;
          int32_t(*lv)[16] = pl == 0 ? lvU : lvV;
          int32_t coeffs[4][16];
          for (int bi = 0; bi < 4; ++bi) {
            int by = bi >> 1, bx = bi & 1;
            for (int r = 0; r < 4; ++r)
              for (int c = 0; c < 4; ++c)
                pbs[pl][bi][r * 4 + c] = pred8[(by * 4 + r) * 8 + bx * 4 + c];
          }
          for (int bi = 0; bi < 4; bi += 2) {
            FDCT4x4_2(sb[bi], pbs[pl][bi], coeffs[bi],
                      sb[bi + 1], pbs[pl][bi + 1], coeffs[bi + 1]);
            QuantizeBlock2(coeffs[bi], coeffs[bi + 1], Q.uv, 0, lv[bi],
                           lv[bi + 1], dqs[pl][bi], dqs[pl][bi + 1],
                           &uvm[pl][bi], &uvm[pl][bi + 1]);
          }
          if (method >= 2)
            rate += UVRate(lv, uvm[pl], pl == 0 ? 0 : 2, tnz, lnz, T);
        }
        if (have_uv && rate * Q.lam_uv >= best_uv_score) continue;
        int64_t disto = 0;
        for (int pl = 0; pl < 2; ++pl) {
          const int32_t(*sb)[16] = pl == 0 ? srcUb : srcVb;
          int32_t(*rc)[16] = pl == 0 ? rU : rV;
          for (int bi = 0; bi < 4; ++bi) {
            int32_t res[16];
            IDCT4x4(dqs[pl][bi], res);
            disto += ReconDisto(pbs[pl][bi], res, sb[bi], rc[bi]);
          }
        }
        int64_t score = rate * Q.lam_uv + 256 * disto;
        if (!have_uv || score < best_uv_score) {
          have_uv = true;
          best_uv_score = score;
          best_uv_mode = mode;
          memcpy(best_lvU, lvU, sizeof(lvU));
          memcpy(best_lvV, lvV, sizeof(lvV));
          memcpy(best_recU, rU, sizeof(rU));
          memcpy(best_recV, rV, sizeof(rV));
        }
      }
      uvmode[mb] = (uint8_t)best_uv_mode;
      int uv_nz = 0;
      for (int bi = 0; bi < 4; ++bi) {
        int by = bi >> 1, bx = bi & 1;
        for (int i = 0; i < 16; ++i) {
          mb_levels[(16 + bi) * 16 + i] = best_lvU[bi][i];
          mb_levels[(20 + bi) * 16 + i] = best_lvV[bi][i];
          uv_nz += (best_lvU[bi][i] != 0) + (best_lvV[bi][i] != 0);
        }
        for (int r = 0; r < 4; ++r)
          for (int c = 0; c < 4; ++c) {
            recU[(size_t)(yc0 + by * 4 + r) * cs + xc0 + bx * 4 + c] =
                (uint8_t)best_recU[bi][r * 4 + c];
            recV[(size_t)(yc0 + by * 4 + r) * cs + xc0 + bx * 4 + c] =
                (uint8_t)best_recV[bi][r * 4 + c];
          }
      }
      skip[mb] = (luma_nz + uv_nz) == 0 ? 1 : 0;

      // nz-context update (exact dry run of the token walk, matching
      // vp8_enc.cc WalkMB with use_skip=False).
      {
        uint32_t tnz_io = tnz, lnz_io = lnz;
        int first, ptype;
        if (!is_i4[mb]) {
          int any = 0;
          const int32_t* y2p = y2_levels + (size_t)mb * 16;
          for (int i = 0; i < 16; ++i)
            if (y2p[i]) { any = 1; break; }
          top_dc[mb_x] = left_dc = (uint8_t)any;
          first = 1;
          ptype = 0;
        } else {
          first = 0;
          ptype = 3;
        }
        (void)ptype;
        uint32_t t = tnz_io & 0x0F, l2 = lnz_io & 0x0F;
        int l = 0;
        for (int y = 0; y < 4; ++y) {
          l = l2 & 1;
          for (int x = 0; x < 4; ++x) {
            int bi = y * 4 + x;
            const int32_t* lvp = mb_levels + bi * 16;
            l = 0;
            for (int i = first; i < 16; ++i)
              if (lvp[i]) { l = 1; break; }
            t = (t >> 1) | ((uint32_t)l << 7);
          }
          t >>= 4;
          l2 = (l2 >> 1) | ((uint32_t)l << 7);
        }
        uint32_t out_tnz = t, out_lnz = l2 >> 4;
        for (int ch = 0; ch <= 2; ch += 2) {
          t = tnz_io >> (4 + ch);
          l2 = lnz_io >> (4 + ch);
          for (int y = 0; y < 2; ++y) {
            l = l2 & 1;
            for (int x = 0; x < 2; ++x) {
              int bi = 16 + ch * 2 + y * 2 + x;
              const int32_t* lvp = mb_levels + bi * 16;
              l = 0;
              for (int i = 0; i < 16; ++i)
                if (lvp[i]) { l = 1; break; }
              t = (t >> 1) | ((uint32_t)l << 3);
            }
            t >>= 2;
            l2 = (l2 >> 1) | ((uint32_t)l << 5);
          }
          out_tnz |= (t << 4) << ch;
          out_lnz |= (l2 & 0xF0) << ch;
        }
        top_nz[mb_x] = out_tnz;
        left_nz = out_lnz;
      }
    }
  }
}

// Analysis pass (lossy/analysis.py compute_alphas): per-MB DCT-histogram
// complexity alphas + global UV alpha. Bit-exact vs the numpy oracle
// (incl. round-half-even DC means and truncated UV mean).
void vp8_compute_alphas(const uint8_t* Y, const uint8_t* U, const uint8_t* V,
                        int mb_w, int mb_h, int32_t* mixed_out,
                        int32_t* global_uv_out) {
  const int ys = mb_w * 16, cs = mb_w * 8;
  const int n_mb = mb_w * mb_h;
  int64_t uv_sum = 0;
  for (int mb = 0; mb < n_mb; ++mb) {
    const int mb_y = mb / mb_w, mb_x = mb % mb_w;
    // ---- Luma: 16 blocks vs rounded-mean DC pred.
    int hist[32];
    memset(hist, 0, sizeof(hist));
    {
      const int y0 = mb_y * 16, x0 = mb_x * 16;
      int64_t sum = 0;
      for (int r = 0; r < 16; ++r)
        for (int c = 0; c < 16; ++c) sum += Y[(size_t)(y0 + r) * ys + x0 + c];
      // numpy .mean().round() = round-half-to-even of sum/256.
      double mean = (double)sum / 256.0;
      int32_t dc = (int32_t)__builtin_nearbyint(mean);
      int32_t pred[16], src[16], coeffs[16];
      for (int i = 0; i < 16; ++i) pred[i] = dc;
      for (int bi = 0; bi < 16; ++bi) {
        int by = bi >> 2, bx = bi & 3;
        for (int r = 0; r < 4; ++r)
          for (int c = 0; c < 4; ++c)
            src[r * 4 + c] = Y[(size_t)(y0 + by * 4 + r) * ys + x0 + bx * 4 + c];
        FDCT4x4(src, pred, coeffs);
        for (int i = 0; i < 16; ++i) {
          int v = coeffs[i] < 0 ? -coeffs[i] : coeffs[i];
          v >>= 3;
          hist[v < 31 ? v : 31]++;
        }
      }
    }
    auto alpha_of = [](const int* h) {
      int max_value = 0, last_nz = -1;
      for (int k = 0; k < 32; ++k) {
        if (h[k] > max_value) max_value = h[k];
        if (h[k] > 0) last_nz = k;
      }
      if (last_nz < 1) last_nz = 1;
      int64_t alpha =
          max_value > 1 ? 510LL * last_nz / (max_value > 1 ? max_value : 1) : 0;
      return (int)(alpha < 255 ? alpha : 255);
    };
    int luma = alpha_of(hist);
    // ---- Chroma: U+V 8 blocks vs their joint rounded-mean DC pred.
    memset(hist, 0, sizeof(hist));
    {
      const int y0 = mb_y * 8, x0 = mb_x * 8;
      int64_t sum = 0;
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c)
          sum += U[(size_t)(y0 + r) * cs + x0 + c] +
                 V[(size_t)(y0 + r) * cs + x0 + c];
      double mean = (double)sum / 128.0;
      int32_t dc = (int32_t)__builtin_nearbyint(mean);
      int32_t pred[16], src[16], coeffs[16];
      for (int i = 0; i < 16; ++i) pred[i] = dc;
      for (int pl = 0; pl < 2; ++pl) {
        const uint8_t* P = pl == 0 ? U : V;
        for (int bi = 0; bi < 4; ++bi) {
          int by = bi >> 1, bx = bi & 1;
          for (int r = 0; r < 4; ++r)
            for (int c = 0; c < 4; ++c)
              src[r * 4 + c] =
                  P[(size_t)(y0 + by * 4 + r) * cs + x0 + bx * 4 + c];
          FDCT4x4(src, pred, coeffs);
          for (int i = 0; i < 16; ++i) {
            int v = coeffs[i] < 0 ? -coeffs[i] : coeffs[i];
            v >>= 3;
            hist[v < 31 ? v : 31]++;
          }
        }
      }
    }
    int uv = alpha_of(hist);
    uv_sum += uv;
    int mixed = 255 - ((3 * luma + uv + 2) >> 2);
    mixed_out[mb] = mixed < 0 ? 0 : (mixed > 255 ? 255 : mixed);
  }
  // int(np.mean(uv)) truncates toward zero (values are non-negative).
  *global_uv_out = (int32_t)((double)uv_sum / (double)n_mb);
}

}  // extern "C"
