// Device helpers shared by the port's kernels.
//
// Exact VP8 integer transforms (the reference's transforms.go, op for op as
// in webp_tpu_torch/ops/planar.py), the I16/chroma and I4 predictors, the
// quantizers (with the rate walk of ops/fastpath.py RateTables, and with
// the trellis-lite rd_drop of planar.quantize_p). Every float operation a
// kernel does is spelled with a round-to-nearest intrinsic (__fmul_rn,
// __fadd_rn) so that nvcc cannot contract a multiply and an add into one
// fused operation: the RD scores must round as the plain PyTorch version's
// separate multiply and add do. The build passes -fmad=false as well.
//
// Shifts of negative ints are arithmetic (floor), as in PyTorch and jnp.
// Products that can leave the int32 range (the inverse DCT's constant
// multiplies of large dequantized values) wrap modulo 2^32 through unsigned
// arithmetic, as int32 tensor arithmetic does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wtk {

// Rate constants, packed by ops/fastpath.py pack_rate_consts (same offsets):
// per coefficient type pt, RC_PT ints = lvl [16][8], tail [16][4],
// eob1 [16], eob2 [16], empty [16]; then the fixed mode costs.
constexpr int RC_LVL = 0;
constexpr int RC_TAIL = 128;
constexpr int RC_EOB1 = 192;
constexpr int RC_EOB2 = 208;
constexpr int RC_EMPTY = 224;
constexpr int RC_PT = 240;
constexpr int RC_FC16 = 4 * RC_PT;
constexpr int RC_FCUV = RC_FC16 + 4;
constexpr int RC_I4MODE = RC_FCUV + 4;
constexpr int RC_SIZE = RC_I4MODE + 10;

constexpr int QFIX = 17;
constexpr int MAX_LEVEL = 2047;

__device__ __constant__ int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                           9, 12, 13, 10, 7, 11, 14, 15};
__device__ __constant__ int kWeightY[16] = {38, 32, 20, 9, 32, 28, 17, 7,
                                            20, 17, 10, 4, 9, 7, 4, 2};

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

__device__ __forceinline__ int mul1(int a) {
  return (wrap_mul(a, 20091) >> 16) + a;
}

__device__ __forceinline__ int mul2(int a) { return wrap_mul(a, 35468) >> 16; }

__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// Raster position of zigzag index zz, from a nibble table: it folds to a
// constant where zz is one (unrolled loops), so that arrays indexed by it
// stay in registers (a __constant__ table cannot be folded).
__device__ __forceinline__ int zigzag_pos(int zz) {
  return (int)((0xFEB7ADC963258410ull >> (4 * zz)) & 15);
}

// Zigzag index of raster position p (the inverse of zigzag_pos).
__device__ __forceinline__ int zigzag_index(int p) {
  return (int)((0xFEA9DB83C7426510ull >> (4 * p)) & 15);
}

// One pixel of the I16 and chroma predictors (modes DC, TM, V, H) from the
// masked contour: the left pixel of its row, the top pixel of its column
// and the corner.
__device__ __forceinline__ int pred_dtvh(int mode, int dc, int left, int top,
                                         int tl) {
  return mode == 0 ? dc
         : mode == 1 ? clamp255(left + top - tl)
         : mode == 2 ? top
                     : left;
}

__device__ __forceinline__ int avg2(int a, int b) { return (a + b + 1) >> 1; }
__device__ __forceinline__ int avg3(int a, int b, int c) {
  return (a + 2 * b + c + 2) >> 2;
}

// The 13-pixel contour of a 4x4 subblock and its smoothed strips, from which
// the 10 I4 predictors read (ops/planar.py pred4_all_p): l0..l3 down the
// left, the corner, t0..t3 and the above-right tr0..tr3.
struct I4Contour {
  int l[4], t[4], tl;
  int s3[11], s2[12], s3h[4], s2h[5], dc, ld_tail;

  __device__ __forceinline__ I4Contour(const int* l_, int tl_, const int* t_,
                                       const int* tr) {
    tl = tl_;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      l[k] = l_[k];
      t[k] = t_[k];
    }
    const int ctr[13] = {l[3], l[2], l[1], l[0], tl,    t[0], t[1],
                         t[2], t[3], tr[0], tr[1], tr[2], tr[3]};
#pragma unroll
    for (int k = 0; k < 11; ++k) s3[k] = avg3(ctr[k], ctr[k + 1], ctr[k + 2]);
#pragma unroll
    for (int k = 0; k < 12; ++k) s2[k] = avg2(ctr[k], ctr[k + 1]);
    const int lr[6] = {tl, l[0], l[1], l[2], l[3], l[3]};
#pragma unroll
    for (int k = 0; k < 4; ++k) s3h[k] = avg3(lr[k], lr[k + 1], lr[k + 2]);
#pragma unroll
    for (int k = 0; k < 5; ++k) s2h[k] = avg2(lr[k], lr[k + 1]);
    dc = (t[0] + t[1] + t[2] + t[3] + l[0] + l[1] + l[2] + l[3] + 4) >> 3;
    ld_tail = avg3(tr[2], tr[3], tr[3]);
  }

  // Pixel (r, c) of I4 mode `mode`: DC, TM, VE, HE, RD, VR, LD, VL, HD, HU.
  __device__ __forceinline__ int pred(int mode, int r, int c) const {
    switch (mode) {
      case 0: return dc;
      case 1: return clamp255(l[r] + t[c] - tl);
      case 2: return s3[4 + c];
      case 3: return s3h[r];
      case 4: return s3[3 - r + c];
      case 5:                                                     // VR
        if (r == 0) return s2[4 + c];
        if (r == 1) return s3[3 + c];
        if (r == 2) return c == 0 ? s3[2] : s2[3 + c];
        return c == 0 ? s3[1] : s3[2 + c];
      case 6: {                                                   // LD
        const int k = r + c;
        return k < 6 ? s3[5 + k] : ld_tail;
      }
      case 7:                                                     // VL
        if (r == 0) return s2[5 + c];
        if (r == 1) return s3[5 + c];
        if (r == 2) return c < 3 ? s2[6 + c] : s3[9];
        return c < 3 ? s3[6 + c] : s3[10];
      case 8: {                                                   // HD
        // hd0 = [s2h0 s3_3 s3_4 s3_5]; hd(r) = [s2h_r s3h_(r-1)
        // hd(r-1)[0:2]].
        const int hd0[4] = {s2h[0], s3[3], s3[4], s3[5]};
        const int hd1[4] = {s2h[1], s3h[0], hd0[0], hd0[1]};
        const int hd2[4] = {s2h[2], s3h[1], hd1[0], hd1[1]};
        const int hd3[4] = {s2h[3], s3h[2], hd2[0], hd2[1]};
        return r == 0 ? hd0[c] : r == 1 ? hd1[c] : r == 2 ? hd2[c] : hd3[c];
      }
      default: {                                                  // HU
        const int hu0[4] = {s2h[1], s3h[1], s2h[2], s3h[2]};
        const int hu1[4] = {hu0[2], hu0[3], s2h[3], s3h[3]};
        const int hu2[4] = {hu1[2], hu1[3], l[3], l[3]};
        return r == 0 ? hu0[c] : r == 1 ? hu1[c] : r == 2 ? hu2[c] : l[3];
      }
    }
  }
};

// Forward DCT of d[16] (raster p = r*4 + c, src - pred) into out[16].
__device__ __forceinline__ void fdct4x4(const int* d, int* out) {
  int tmp[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int d0 = d[r * 4], d1 = d[r * 4 + 1], d2 = d[r * 4 + 2],
              d3 = d[r * 4 + 3];
    const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[r * 4 + 0] = (a0 + a1) * 8;
    tmp[r * 4 + 1] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[r * 4 + 2] = (a0 - a1) * 8;
    tmp[r * 4 + 3] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int m0 = tmp[c], m1 = tmp[4 + c], m2 = tmp[8 + c], m3 = tmp[12 + c];
    const int a0 = m0 + m3, a1 = m1 + m2, a2 = m1 - m2, a3 = m0 - m3;
    out[c] = (a0 + a1 + 7) >> 4;
    out[8 + c] = (a0 - a1 + 7) >> 4;
    out[4 + c] = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0 ? 1 : 0);
    out[12 + c] = (a3 * 2217 - a2 * 5352 + 51000) >> 16;
  }
}

// Inverse DCT of raster coefficients in[16] -> residuals out[16].
__device__ __forceinline__ void idct4x4(const int* in, int* out) {
  int tmp[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int i0 = in[c], i1 = in[4 + c], i2 = in[8 + c], i3 = in[12 + c];
    const int a = i0 + i2, b = i0 - i2;
    const int cc = mul2(i1) - mul1(i3);
    const int d = mul1(i1) + mul2(i3);
    tmp[c] = a + d;
    tmp[4 + c] = b + cc;
    tmp[8 + c] = b - cc;
    tmp[12 + c] = a - d;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int dc = tmp[r * 4] + 4;
    const int a = dc + tmp[r * 4 + 2], b = dc - tmp[r * 4 + 2];
    const int cc = mul2(tmp[r * 4 + 1]) - mul1(tmp[r * 4 + 3]);
    const int d = mul1(tmp[r * 4 + 1]) + mul2(tmp[r * 4 + 3]);
    out[r * 4 + 0] = (a + d) >> 3;
    out[r * 4 + 1] = (b + cc) >> 3;
    out[r * 4 + 2] = (b - cc) >> 3;
    out[r * 4 + 3] = (a - d) >> 3;
  }
}

// Forward WHT over the 16 block DCs d[br*4 + bc] -> out[16] (raster).
__device__ __forceinline__ void fwht4x4(const int* d, int* out) {
  int tmp[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int c0 = d[r * 4], c1 = d[r * 4 + 1], c2 = d[r * 4 + 2],
              c3 = d[r * 4 + 3];
    const int a0 = c0 + c2, a1 = c1 + c3, a2 = c1 - c3, a3 = c0 - c2;
    tmp[r * 4 + 0] = a0 + a1;
    tmp[r * 4 + 1] = a3 + a2;
    tmp[r * 4 + 2] = a3 - a2;
    tmp[r * 4 + 3] = a0 - a1;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r0 = tmp[k], r1 = tmp[4 + k], r2 = tmp[8 + k], r3 = tmp[12 + k];
    const int a0 = r0 + r2, a1 = r1 + r3, a2 = r1 - r3, a3 = r0 - r2;
    out[k] = (a0 + a1) >> 1;
    out[4 + k] = (a3 + a2) >> 1;
    out[8 + k] = (a3 - a2) >> 1;
    out[12 + k] = (a0 - a1) >> 1;
  }
}

// Inverse WHT of raster y2 dequant in[16] -> reconstructed DCs out[16].
__device__ __forceinline__ void iwht4x4(const int* in, int* out) {
  int tmp[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int i0 = in[c], i1 = in[4 + c], i2 = in[8 + c], i3 = in[12 + c];
    const int a0 = i0 + i3, a1 = i1 + i2, a2 = i1 - i2, a3 = i0 - i3;
    tmp[c] = a0 + a1;
    tmp[4 + c] = a3 + a2;
    tmp[8 + c] = a0 - a1;
    tmp[12 + c] = a3 - a2;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int dc = tmp[r * 4] + 3;
    const int a0 = dc + tmp[r * 4 + 3];
    const int a1 = tmp[r * 4 + 1] + tmp[r * 4 + 2];
    const int a2 = tmp[r * 4 + 1] - tmp[r * 4 + 2];
    const int a3 = dc - tmp[r * 4 + 3];
    out[r * 4 + 0] = (a0 + a1) >> 3;
    out[r * 4 + 1] = (a3 + a2) >> 3;
    out[r * 4 + 2] = (a0 - a1) >> 3;
    out[r * 4 + 3] = (a3 - a2) >> 3;
  }
}

// sum(WEIGHT_Y * |hadamard4(x)|) of one raster block (TDisto's texture
// measure; ops/p1_kernels.py hadamard4_p).
__device__ __forceinline__ int hadamard_w(const int* x) {
  int t[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int x0 = x[r * 4], x1 = x[r * 4 + 1], x2 = x[r * 4 + 2],
              x3 = x[r * 4 + 3];
    const int a0 = x0 + x2, a1 = x1 + x3, a2 = x1 - x3, a3 = x0 - x2;
    t[r * 4 + 0] = a0 + a1;
    t[r * 4 + 1] = a3 + a2;
    t[r * 4 + 2] = a3 - a2;
    t[r * 4 + 3] = a0 - a1;
  }
  int acc = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r0 = t[k], r1 = t[4 + k], r2 = t[8 + k], r3 = t[12 + k];
    const int a0 = r0 + r2, a1 = r1 + r3, a2 = r1 - r3, a3 = r0 - r2;
    acc += kWeightY[k] * abs(a0 + a1) + kWeightY[4 + k] * abs(a3 + a2) +
           kWeightY[8 + k] * abs(a3 - a2) + kWeightY[12 + k] * abs(a0 - a1);
  }
  return acc;
}

// Quantizes raster coefficients co[16] from zigzag position `first` on and
// returns the approximate rate of the level block (band-exact per-position
// costs, the per-band EOB bit, the empty-block cost), accumulating
// sum((|c| - dequant)^2) into disto. qr points at the quantizer's q row;
// iq, bias and sharpen follow at +16, +32, +48 (zigzag columns). rcp is
// the rate-constant block of the coefficient type. With dq != nullptr the
// signed dequantized values are stored at their raster positions.
// kFolded: the zigzag positions fold to constants, so that co and dq stay
// in registers, and qr is read with plain loads (it may point at shared
// memory; p1_mode). Otherwise the positions come from kZigzag, which puts
// the arrays in local memory and keeps the caller's registers low, and qr
// is read through the read-only cache (i4_search).
template <bool kFolded>
__device__ __forceinline__ int quant_rate(const int* co,
                                          const int* __restrict__ qr,
                                          int first, const int* rcp, int* dq,
                                          int& disto) {
  int rate = 0, run = 0, pend = 0;
  bool has_any = false;
#pragma unroll
  for (int zz = 0; zz < 16; ++zz) {
    if (zz < first) continue;
    const int p = kFolded ? zigzag_pos(zz) : kZigzag[zz];
    auto q_at = [&](int i) { return kFolded ? qr[i] : __ldg(qr + i); };
    const int c = co[p];
    const int ac = abs(c);
    const int mag = ac + q_at(48 + zz);
    int level = (mag * q_at(16 + zz) + q_at(32 + zz)) >> QFIX;
    level = level < MAX_LEVEL ? level : MAX_LEVEL;
    const int dqz = level * q_at(zz);
    if (dq != nullptr) dq[p] = c < 0 ? -dqz : dqz;
    const int e = ac - dqz;
    disto += e * e;
    const int vc = level < 7 ? level : 7;
    int cost = rcp[RC_LVL + zz * 8 + vc];
    if (level >= 8) {
      const int b = level >= 35 ? 3 : (level >= 19 ? 2 : (level >= 11 ? 1 : 0));
      cost += rcp[RC_TAIL + zz * 4 + b];
    }
    run += cost;
    if (level != 0) {
      rate += run;
      run = 0;
      has_any = true;
      pend = level == 1 ? rcp[RC_EOB1 + zz] : rcp[RC_EOB2 + zz];
    }
  }
  return has_any ? rate + pend : rcp[RC_EMPTY + first];
}

// Trellis distortion weights by zigzag position (ops/quant.py _WT).
__device__ __constant__ float kTrellisW[16] = {30, 27, 19, 11, 27, 24, 17, 10,
                                               19, 17, 12, 8,  11, 10, 8,  6};

// TLambda of a quantizer's q row (zigzag columns): floor((q0 + 15 q1 + 8)
// / 16)^2 / 4 in float, rounded op by op as ops/planar.py quantize_p does.
__device__ __forceinline__ float trellis_lambda(const int* qr) {
  const float q0 = __int2float_rn(qr[0]), q1 = __int2float_rn(qr[1]);
  const float base = floorf(
      __fmul_rn(__fadd_rn(__fadd_rn(q0, __fmul_rn(15.0f, q1)), 8.0f), 0.0625f));
  return __fmul_rn(__fmul_rn(base, base), 0.25f);
}

// The trellis-lite drop test of a level of 1 (quantize_rd below): 256 * wt
// * (c^2 - (c - q)^2) < rd * tlam, c the magnitude after sharpening, every
// float operation rounded as the plain version's separate operations.
__device__ __forceinline__ bool rd_drops(int mag, int q, float wt, float rd,
                                         float tlam) {
  const float c0 = __int2float_rn(mag), qf = __int2float_rn(q);
  const float e = __fsub_rn(c0, qf);
  const float dd =
      __fmul_rn(wt, __fsub_rn(__fmul_rn(c0, c0), __fmul_rn(e, e)));
  return __fmul_rn(256.0f, dd) < __fmul_rn(rd, tlam);
}

// The signed level of one raster coefficient c from its zigzag position's
// quantizer entries and trellis weight wt (quantize_rd below, for one
// coefficient), without a branch: the drop test runs on every lane.
__device__ __forceinline__ int quantize_level(int c, int q, int iq, int bias,
                                              int sharpen, float wt, float rd,
                                              float tlam) {
  const int mag = abs(c) + sharpen;
  int level = (mag * iq + bias) >> QFIX;
  level = level < MAX_LEVEL ? level : MAX_LEVEL;
  const bool drop = rd_drops(mag, q, wt, rd, tlam);
  level = ((rd > 0.0f) & (level == 1) & drop) ? 0 : level;
  return c < 0 ? -level : level;
}

// Quantizes raster coefficients co[16] with the quantizer rows at qr (q,
// iq, bias and sharpen at +0, +16, +32, +48; zigzag columns) into signed
// zigzag levels lv[16] and signed raster dequantized values dq[16]
// (ops/planar.py quantize_p). Levels before zigzag position `first` are 0.
// With rd > 0 (rd_drop times the pipeline's multiplier) a level of 1 is
// dropped where 256 * wt * (c^2 - (c - q)^2) < rd * tlam, c the magnitude
// after sharpening: c^2 can pass 2^24, so every float operation is rounded
// as the plain version's separate tensor operations round it.
__device__ __forceinline__ void quantize_rd(const int* co, const int* qr,
                                            int first, float rd, float tlam,
                                            int* lv, int* dq) {
#pragma unroll
  for (int zz = 0; zz < 16; ++zz) {
    const int p = zigzag_pos(zz);
    const int c = co[p];
    const int q = qr[zz];
    const int mag = abs(c) + qr[48 + zz];
    int level = (mag * qr[16 + zz] + qr[32 + zz]) >> QFIX;
    level = level < MAX_LEVEL ? level : MAX_LEVEL;
    if (rd > 0.0f && level == 1 && rd_drops(mag, q, kTrellisW[zz], rd, tlam))
      level = 0;
    if (zz < first) level = 0;
    const int s = c < 0 ? -level : level;
    lv[zz] = s;
    dq[p] = s * q;
  }
}

// rate * lam + D, rounded as two separate float operations.
__device__ __forceinline__ float rd_score(float rate, float lam, float D) {
  return __fadd_rn(__fmul_rn(rate, lam), D);
}

// 64 * disto (+ tlsd * td when td >= 0), rounded op by op.
__device__ __forceinline__ float rd_disto(int disto, float tlsd, int td) {
  float D = __fmul_rn(64.0f, __int2float_rn(disto));
  if (td >= 0) D = __fadd_rn(D, __fmul_rn(tlsd, __int2float_rn(td)));
  return D;
}

// Integer sum over the 16 lanes of a half-warp segment.
__device__ __forceinline__ int sum16(int v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, 16);
  return v;
}

__device__ __forceinline__ int max16(int v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o, 16));
  return v;
}

}  // namespace wtk
