// I4 mode-search kernel: the 10-mode 4x4 intra search for every luma
// subblock, with source-pixel context.
//
// Replaces the TPU kernel webp_tpu/ops/pallas_i4.py `_kernel` (:72, built
// by `_build_call` :311). Plain PyTorch version and launch wrapper:
// webp_tpu_torch/ops/i4_kernel.py (i4_scores_plain / i4_scores).
//
// Per subblock and mode: the prediction from the 13-pixel contour, forward
// DCT, quantization with the segment's y1 rows, the band-exact
// approximate rate plus the mode's signalling cost, 64 * the distortion
// and, with TDisto on, tlsd * the weighted-Hadamard texture difference of
// the reconstruction. Modes that read the above-right strip (VE, LD, VL)
// are banned on the macroblock's rightmost subblock column. Selection runs
// at lambda_i4; the chosen mode's total is re-emitted at lambda_mode.
//
// What bounds it on the H100: integer ALU. Per subblock it reads 32 bytes
// and writes 8, and does ~8.5k integer operations with TDisto on (10 x
// DCT, quantizer, rate walk and TDisto reconstruction; the count
// chip_smoke.py uses for the bound): ~200 operations per byte against the
// card's ~5. The design is one thread per subblock, everything in
// registers (16 source pixels, the 13-pixel contour and its smoothed
// strips), with the 32 input rows read lane-contiguously so that a warp's
// loads coalesce; the rate constants sit in shared memory, the quantizer
// rows are read through the read-only cache. One launch covers the whole
// batch: lane i belongs to image i / n_sb.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
i4_search_kernel(const uint8_t* __restrict__ data, const int* __restrict__ qtab,
                 const float* __restrict__ lams, const int* __restrict__ rc_g,
                 int N, int n_sb, int use_td, int* __restrict__ mode_out,
                 float* __restrict__ score_out) {
  __shared__ int rc[wtk::RC_SIZE];
  for (int i = threadIdx.x; i < wtk::RC_SIZE; i += THREADS) rc[i] = rc_g[i];
  __syncthreads();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= N) return;

  // Rows: 0-15 source pixels (raster), 16-19 l3..l0, 20 tl, 21-24 t0..t3,
  // 25-28 tr0..tr3, 29 is_c3, 30 segment.
  int x[31];
#pragma unroll
  for (int r = 0; r < 31; ++r) x[r] = data[(size_t)r * N + i];
  const int* src = x;
  const int l[4] = {x[19], x[18], x[17], x[16]};
  const int tl = x[20];
  const int t[4] = {x[21], x[22], x[23], x[24]};
  const int tr[4] = {x[25], x[26], x[27], x[28]};
  const bool is_c3 = x[29] != 0;
  const int seg = x[30] & 3;
  const int img = i / n_sb;
  const int* qr = qtab + (size_t)img * 256 + seg * 64;
  const float* lam_r = lams + (size_t)img * 12;
  const float lam = lam_r[seg], tlsd = lam_r[4 + seg], lammd = lam_r[8 + seg];
  const int* rcp = rc + 3 * wtk::RC_PT;

  const wtk::I4Contour ctr(l, tl, t, tr);
  const int ha_src = use_td ? wtk::hadamard_w(src) : 0;

  float best_score = INFINITY, best_rate = 0.f, best_D = 0.f;
  int best_mode = 0;
  for (int mode = 0; mode < 10; ++mode) {
    int pred[16];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) pred[r * 4 + c] = ctr.pred(mode, r, c);
    }
    int d[16], co[16], dq[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) d[p] = src[p] - pred[p];
    wtk::fdct4x4(d, co);
    int disto = 0;
    const int rate = wtk::quant_rate<false>(co, qr, 0, rcp, dq, disto);
    const float rate_m = __int2float_rn(rate + rc[wtk::RC_I4MODE + mode]);
    int td = -1;
    if (use_td) {
      int rec[16];
      wtk::idct4x4(dq, rec);
#pragma unroll
      for (int p = 0; p < 16; ++p) rec[p] = wtk::clamp255(pred[p] + rec[p]);
      td = abs(wtk::hadamard_w(rec) - ha_src) >> 5;
    }
    const float D = wtk::rd_disto(disto, tlsd, td);
    float score = wtk::rd_score(rate_m, lam, D);
    if (is_c3 && (mode == 2 || mode == 6 || mode == 7)) score = INFINITY;
    if (score < best_score) {
      best_score = score;
      best_rate = rate_m;
      best_D = D;
      best_mode = mode;
    }
  }
  mode_out[i] = best_mode;
  score_out[i] = wtk::rd_score(best_rate, lammd, best_D);
}

}  // namespace

extern "C" int i4_search_launch(const void* data, const void* qtab,
                                const void* lams, const void* rc, int N,
                                int n_sb, int use_td, void* mode, void* score,
                                void* stream) {
  const int grid = (N + THREADS - 1) / THREADS;
  i4_search_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int*)qtab, (const float*)lams,
      (const int*)rc, N, n_sb, use_td, (int*)mode, (float*)score);
  return (int)cudaGetLastError();
}
