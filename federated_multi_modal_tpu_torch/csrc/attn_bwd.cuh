// The attention backward's per-warp tile routines on the tensor cores,
// shared by attention_core_bwd.cu (K1b, K2b and the attention backward of
// K3, K4 and K7; its tiles streamed through a cp.async ring) and
// lnqkv_attention_bwd_dx.cu (P2; its q, k, v and g resident in shared
// memory), for any head width HD that is a multiple of 8 up to 128. What
// attn_fwd.cuh is to the forward.
//
// Numerics are the TPU kernel's _packed_bwd_body
// (federated_multi_modal_tpu/ops/pallas/attention.py): fp32 scores and
// softmax P = exp(s - lse); dP = g v^T in fp32 and delta = rowsum(dP * P)
// over the fp32 P; dS = P * (dP - delta) * scale rounded to bf16 before
// dQ = dS k and dK = dS^T q; bf16(P) for dV = P^T g; fp32 sums. All
// products run on mma.sync m16n8k16 (bf16 in, fp32 accumulate,
// attn_mma.cuh) with S, dP, P and dS in registers:
//   * stats_step: one warp's 16 query rows against a tile of 8 N8 keys, the
//     online row max m, sum l and rescaled sum of exp(s - m) dP, from which
//     stats_rows writes lse = m + log l and delta = that sum / l;
//   * dkdv_step: one warp's 16 key rows against a tile of 8 N8 queries with
//     their lse and delta: S^T and dP^T recomputed, dV += bf16(P)^T g,
//     dK += bf16(dS)^T q;
//   * dq_step: one warp's 16 query rows against a tile of 8 N8 keys,
//     dQ += bf16(dS) k.
// Tiles are row-major with the row stride Shape<HD>::kLd, their columns
// [HD, kHdp) zero (am::zero_pad_columns), so that the contraction over the
// head width runs in whole 16-column steps. N8 = 4 halves a step's score
// registers (32 instead of 64 a thread), for passes that hold two wide
// accumulators (dK and dV at head widths over 64) or run under a
// 128-register cap (P2's 16-warp blocks).
#pragma once

#include "attn_mma.cuh"

namespace fmm {

namespace attn_bwd {

namespace am = attn_mma;
using am::Shape;

template <int N8>
__device__ __forceinline__ void zero_tile(float (&s)[N8][4]) {
#pragma unroll
  for (int nt = 0; nt < N8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
}

// s = x.cx^T / scale + mask / scale and dp = y.cy^T for one warp's rows
// [a_row, a_row + 16) of x_tile and y_tile (rows row0 + [0, 16) of the head)
// against the first 8 N8 rows of cx_tile and cy_tile (columns col0 + [0, 8
// N8)); false, with s all -inf, if the mask leaves the whole warp tile -inf.
// kTrans: the rows are keys and the columns queries (the dK/dV pass).
template <int HD, bool kTrans, bool kMasked, int N8>
__device__ __forceinline__ bool scores_dp(float (&s)[N8][4], float (&dp)[N8][4],
                                          const float* __restrict__ mask, int T, int row0,
                                          int col0, float inv_scale, const bf16* x_tile,
                                          const bf16* y_tile, int a_row, const bf16* cx_tile,
                                          const bf16* cy_tile) {
  using S = Shape<HD>;
  if (am::mask_tile<kTrans, kMasked>(s, mask, T, row0, col0, inv_scale)) return false;
  am::mma_abt<S::kKSteps>(s, x_tile, S::kLd, a_row, cx_tile, S::kLd);
  zero_tile(dp);
  am::mma_abt<S::kKSteps>(dp, y_tile, S::kLd, a_row, cy_tile, S::kLd);
  return true;
}

// Pass 1: the running statistics of one warp's query rows (q_row in qs and
// gs) over one tile of 8 N8 keys (kt, vt).
template <int HD, bool kMasked, int N8>
__device__ __forceinline__ void stats_step(float (&m)[2], float (&l)[2], float (&d)[2],
                                           const float* __restrict__ mask, int T, int row0,
                                           int col0, float scale, float inv_scale,
                                           const bf16* qs, const bf16* gs, int q_row,
                                           const bf16* kt, const bf16* vt) {
  float s[N8][4], dp[N8][4];
  if (scores_dp<HD, false, kMasked>(s, dp, mask, T, row0, col0, inv_scale, qs, gs, q_row, kt,
                                    vt)) {
#pragma unroll
    for (int nt = 0; nt < N8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
    am::online_softmax<true>(s, dp, m, l, d);
  }
}

// lse and delta of one warp's rows row0 + [0, 16) from its running
// statistics, into lse[row] and delta[row] for rows below T.
__device__ __forceinline__ void stats_rows(const float (&m)[2], const float (&l)[2],
                                           const float (&d)[2], int row0, int T,
                                           float* __restrict__ lse, float* __restrict__ delta) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = am::quad_sum(l[r]);
    const float dr = am::quad_sum(d[r]);
    const int row = row0 + (lane >> 2) + 8 * r;
    if ((lane & 3) == 0 && row < T) {
      lse[row] = m[r] + logf(lr);
      delta[row] = dr / lr;
    }
  }
}

// Pass 2: one warp's key rows (k_row in ks and vs; keys row0 + [0, 16))
// against a tile of 8 N8 queries (qt, gt; queries col0 + [0, 8 N8)) whose
// lse and delta start at lse_t and delta_t.
template <int HD, bool kMasked, int N8>
__device__ __forceinline__ void dkdv_step(float (&dk)[Shape<HD>::kNt][4],
                                          float (&dv)[Shape<HD>::kNt][4],
                                          const float* __restrict__ mask, int T, int row0,
                                          int col0, float scale, float inv_scale,
                                          const bf16* ks, const bf16* vs, int k_row,
                                          const bf16* qt, const bf16* gt, const float* lse_t,
                                          const float* delta_t) {
  using S = Shape<HD>;
  const int t = threadIdx.x & 3;
  float s[N8][4], dp[N8][4];
  if (scores_dp<HD, true, kMasked>(s, dp, mask, T, row0, col0, inv_scale, ks, vs, k_row, qt,
                                   gt)) {
#pragma unroll
    for (int nt = 0; nt < N8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const float p = __expf(s[nt][e] * scale - lse_t[col]);
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - delta_t[col]) * scale;
      }
    }
    am::mma_pv<S::kNt>(dv, s, gt, S::kLd);   // dV += bf16(P)^T g
    am::mma_pv<S::kNt>(dk, dp, qt, S::kLd);  // dK += bf16(dS)^T q
  }
}

// Pass 3: one warp's query rows (q_row in qs and gs; queries row0 + [0,
// 16), with lse_r and delta_r of its two fragment rows) against a tile of 8
// N8 keys (kt, vt).
template <int HD, bool kMasked, int N8>
__device__ __forceinline__ void dq_step(float (&dq)[Shape<HD>::kNt][4],
                                        const float* __restrict__ mask, int T, int row0,
                                        int col0, float scale, float inv_scale, const bf16* qs,
                                        const bf16* gs, int q_row, const bf16* kt,
                                        const bf16* vt, const float (&lse_r)[2],
                                        const float (&delta_r)[2]) {
  using S = Shape<HD>;
  float s[N8][4], dp[N8][4];
  if (scores_dp<HD, false, kMasked>(s, dp, mask, T, row0, col0, inv_scale, qs, gs, q_row, kt,
                                    vt)) {
#pragma unroll
    for (int nt = 0; nt < N8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = __expf(s[nt][e] * scale - lse_r[r]);
        dp[nt][e] = p * (dp[nt][e] - delta_r[r]) * scale;
      }
    }
    am::mma_pv<S::kNt>(dq, dp, kt, S::kLd);  // dQ += bf16(dS) k
  }
}

// A 16 x HD fp32 block of one warp's rows (row0 + [0, 16)) rounded to bf16
// into a row-major output at dst with row stride `stride` (rows at or past
// T are not written).
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[Shape<HD>::kNt][4], bf16* dst,
                                           size_t stride, int row0, int T) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
    bf16* p = dst + static_cast<size_t>(row) * stride + 2 * t;
#pragma unroll
    for (int nt = 0; nt < Shape<HD>::kNt; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(p + nt * 8) =
          __floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]);
  }
}

}  // namespace attn_bwd

}  // namespace fmm
