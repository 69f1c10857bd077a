// Segment-alpha kernel (phase 0): per-macroblock texture alpha and the
// pre-mix UV alpha from the block-major source rows.
//
// Replaces the TPU kernel webp_tpu/ops/pallas_p1.py `_alpha_kernel` (:500,
// built by `_build_alpha_call` :563). Plain PyTorch version and launch
// wrapper: webp_tpu_torch/ops/p1_kernels.py (alphas_plain / alphas).
//
// Per MB: each 4x4 block is DC-removed (round-half-even of the plane
// mean) and forward-DCT'd; a 32-bin histogram of min(|c| >> 3, 31) gives
// alpha = 510 * last_nonzero_bin // max_count (0 when max_count <= 1).
// Luma (16 blocks) and U+V (8 blocks) are mixed as
// clip(255 - ((3 * luma + uv + 2) >> 2), 0, 255).
//
// What bounds it on the H100: integer ALU. Per MB it reads 384 bytes and
// writes 8, and does ~6.3k integer operations (24 DCTs, 384 histogram
// updates; the count chip_smoke.py uses for the bound): ~16 operations
// per byte, above the card's ~5 INT32 operations per byte of HBM
// bandwidth (64 INT32 lanes x 132 SMs against 3.35 TB/s). The design
// keeps the ALU on the DCTs and the histograms and nothing else:
//
// * Tile and loads. A block of 128 threads takes 64 MBs (lanes). Each
//   thread loads 4 source rows x 16 lanes as four 16-byte vector loads (a
//   warp reads 8 rows x 64 contiguous bytes per load: whole sectors) and
//   transposes the 4x4 byte groups in registers (__byte_perm), so that
//   one 32-bit shared store carries 4 rows of one MB.
// * MB-major shared tile. MB m's 384 bytes sit in one row of 416 bytes
//   (104 words), its 4x4 block g (rows 16g..16g+15 of the input) as 16
//   contiguous bytes at chunk g ^ (2 * (m >> 4)): a thread reads a block
//   with one 16-byte load. The stride (104 = 8 mod 32 words) and the XOR
//   swizzle make both sides conflict-free: the 8 threads of a 16-byte
//   load phase (4 MBs x 2 threads) hit 8 different 4-bank chunks, and the
//   32 stores of a transpose step (4 MB groups x 8 row quads) 32 banks.
// * Balanced work. Two threads per MB; thread j takes blocks 2i + j
//   (i = 0..11): 8 luma and 4 chroma blocks each, so no thread idles.
// * DC removal after the DCT. The DC only shifts coefficient 0:
//   fdct(px - dc)[0] = (S >> 1) - 8 dc with S the block's pixel sum, and
//   leaves the other 15 unchanged (the row pass's dc terms cancel in
//   every difference, and 8 * 16 dc divides by 16 exactly). So a thread
//   DCTs its 12 blocks from the raw pixels, bins the 15 AC coefficients at
//   once, and bins the 12 DCs after one shuffle has summed the MB's two
//   plane sums (packed luma | chroma << 16 in one word).
// * The DCT's row pass reads packed pixel words with dp4a: a row's sum,
//   d0 - d1 - d2 + d3, d1 - d2 and d0 - d3 are each one dot product of
//   the word with a +-1 byte vector (the three differences on the word
//   XOR 0x80808080, as signed bytes: their weights sum to zero, so the
//   -128 offset cancels). No byte is unpacked.
// * Histograms without contention. Each thread owns one column of a
//   [32 bins][128 threads] word array in shared memory (luma counts in
//   the low 16 bits, chroma in the high: at most 256 and 128 per MB, so a
//   flat MB cannot overflow them) and adds with a shared atomic whose
//   result is unused (no lane of a warp ever shares a bank, let alone an
//   address, with another: bank = thread mod 32). After a __syncwarp each
//   of the MB's threads sums the two columns over 16 bins, keeps the
//   largest count and the last nonzero bin per plane, and one shuffle
//   joins the halves.

#include "common.cuh"

namespace {

constexpr int N_SRC = 384;
constexpr int TILE = 64;                // MBs per block
constexpr int THREADS = 2 * TILE;       // two threads per MB
constexpr int MB_WORDS = 104;           // per-MB tile row, in 32-bit words
constexpr int BINS = 32;
constexpr int BLOCKS_PER_THREAD = 12;   // of the MB's 24 (16 luma, 8 chroma)

__device__ __forceinline__ int swizzle(int m) { return 2 * ((m >> 4) & 3); }

// min(|c| >> 3, 31): the histogram bin of a coefficient.
__device__ __forceinline__ int bin_of(int c) { return min(abs(c) >> 3, 31); }

__device__ __forceinline__ int hist_alpha(int max_count, int last) {
  if (max_count <= 1) return 0;
  const int a = 510 * max(last, 1) / max_count;
  return a < 255 ? a : 255;
}

__global__ void __launch_bounds__(THREADS)
p1_alpha_kernel(const uint8_t* __restrict__ src, int L, int vec,
                int* __restrict__ alpha_out, int* __restrict__ uv_out) {
  __shared__ __align__(16) uint32_t s_tile[TILE * MB_WORDS];
  __shared__ __align__(16) uint32_t s_hist[BINS * THREADS];
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * TILE;

  // Load and transpose: unit u = (row quad rq, group of 16 lanes lg).
#pragma unroll 1
  for (int u = tid; u < (N_SRC / 4) * (TILE / 16); u += THREADS) {
    const int lg = u & 3, rq = u >> 2;
    const int l = lane0 + 16 * lg;
    uint32_t w[4][4];  // [row 4 rq + k][word q: lanes 4q..4q+3]
    if (vec && l < L) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            src + (size_t)(4 * rq + k) * L + l));
        w[k][0] = v.x;
        w[k][1] = v.y;
        w[k][2] = v.z;
        w[k][3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t x = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int lb = l + 4 * q + b;
            if (lb < L) x |= (uint32_t)src[(size_t)(4 * rq + k) * L + lb] << (8 * b);
          }
          w[k][q] = x;
        }
    }
    const int g = rq >> 2, wq = rq & 3;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t t0 = __byte_perm(w[0][q], w[1][q], 0x5140);
      const uint32_t t1 = __byte_perm(w[0][q], w[1][q], 0x7362);
      const uint32_t t2 = __byte_perm(w[2][q], w[3][q], 0x5140);
      const uint32_t t3 = __byte_perm(w[2][q], w[3][q], 0x7362);
      const uint32_t o[4] = {__byte_perm(t0, t2, 0x5410),
                             __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410),
                             __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 16 * lg + 4 * q + i;
        s_tile[m * MB_WORDS + 4 * (g ^ swizzle(m)) + wq] = o[i];
      }
    }
  }
#pragma unroll
  for (int b = 0; b < BINS; ++b) s_hist[b * THREADS + tid] = 0;
  __syncthreads();

  const int m = tid >> 1, j = tid & 1;
  uint32_t* hist = s_hist + tid;
  int S[BLOCKS_PER_THREAD];
  int psum = 0;  // this thread's luma pixel sum | chroma sum << 16
#pragma unroll
  for (int i = 0; i < BLOCKS_PER_THREAD; ++i) {
    const int g = 2 * i + j;
    const uint32_t inc = i < 8 ? 1u : 0x10000u;  // blocks 0-15 are luma
    const uint4 px = *reinterpret_cast<const uint4*>(
        &s_tile[m * MB_WORDS + 4 * (g ^ swizzle(m))]);
    const uint32_t row[4] = {px.x, px.y, px.z, px.w};
    // Row pass (wtk::fdct4x4's): t[c][r] is column c of row r, with
    // columns 0 and 2 not yet scaled by 8.
    int t[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int x = (int)(row[r] ^ 0x80808080u);
      t[0][r] = (int)__dp4a(row[r], 0x01010101u, 0u);  // d0 + d1 + d2 + d3
      t[2][r] = __dp4a(x, 0x01FFFF01, 0);              // d0 - d1 - d2 + d3
      const int a2 = __dp4a(x, 0x00FF0100, 0);         // d1 - d2
      const int a3 = __dp4a(x, (int)0xFF000001u, 0);   // d0 - d3
      t[1][r] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
      t[3][r] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
    }
    S[i] = t[0][0] + t[0][1] + t[0][2] + t[0][3];
    psum += i < 8 ? S[i] : S[i] << 16;
    // Column pass; coefficient 0 waits for the DC.
    int co[16];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s = (c == 0 || c == 2) ? 8 : 1;
      const int m0 = s * t[c][0], m1 = s * t[c][1], m2 = s * t[c][2],
                m3 = s * t[c][3];
      const int a0 = m0 + m3, a1 = m1 + m2, a2 = m1 - m2, a3 = m0 - m3;
      co[c] = (a0 + a1 + 7) >> 4;
      co[8 + c] = (a0 - a1 + 7) >> 4;
      co[4 + c] = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0 ? 1 : 0);
      co[12 + c] = (a3 * 2217 - a2 * 5352 + 51000) >> 16;
    }
#pragma unroll
    for (int p = 1; p < 16; ++p) atomicAdd(&hist[bin_of(co[p]) * THREADS], inc);
  }

  // The MB's plane sums, its DCs and the 12 DC coefficients.
  psum += __shfl_xor_sync(0xffffffffu, psum, 1);
  const int dcY = (int)rintf(__fmul_rn(__int2float_rn(psum & 0xFFFF), 1.0f / 256.0f));
  const int dcC = (int)rintf(__fmul_rn(__int2float_rn(psum >> 16), 1.0f / 128.0f));
#pragma unroll
  for (int i = 0; i < BLOCKS_PER_THREAD; ++i)
    atomicAdd(&hist[bin_of((S[i] >> 1) - 8 * (i < 8 ? dcY : dcC)) * THREADS],
              i < 8 ? 1u : 0x10000u);
  __syncwarp();

  // Thread j sums the MB's two columns over bins 16j..16j+15.
  int mxY = 0, mxC = 0, lastY = 0, lastC = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int b = 16 * j + k;
    const uint2 h = *reinterpret_cast<const uint2*>(&s_hist[b * THREADS + 2 * m]);
    const uint32_t cnt = h.x + h.y;
    const int y = (int)(cnt & 0xFFFF), c = (int)(cnt >> 16);
    mxY = max(mxY, y);
    mxC = max(mxC, c);
    lastY = y ? b : lastY;
    lastC = c ? b : lastC;
  }
  mxY = max(mxY, __shfl_xor_sync(0xffffffffu, mxY, 1));
  mxC = max(mxC, __shfl_xor_sync(0xffffffffu, mxC, 1));
  lastY = max(lastY, __shfl_xor_sync(0xffffffffu, lastY, 1));
  lastC = max(lastC, __shfl_xor_sync(0xffffffffu, lastC, 1));
  const int luma = hist_alpha(mxY, lastY), uv = hist_alpha(mxC, lastC);
  const int l = lane0 + m;
  if (l < L) {
    if (j == 0) {
      const int a = 255 - ((3 * luma + uv + 2) >> 2);
      alpha_out[l] = a < 0 ? 0 : (a > 255 ? 255 : a);
    } else {
      uv_out[l] = uv;
    }
  }
}

}  // namespace

extern "C" int p1_alpha_launch(const void* src, int L, void* alpha, void* uv,
                               void* stream) {
  // 16-byte row loads need 16-byte aligned rows.
  const int vec = ((uintptr_t)src % 16 == 0) && (L % 16 == 0);
  const int grid = (L + TILE - 1) / TILE;
  p1_alpha_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, L, vec, (int*)alpha, (int*)uv);
  return (int)cudaGetLastError();
}
