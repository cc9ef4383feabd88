// Device routines shared by the prototype kernels lnqkv_attention_bwd_dx.cu
// (P2) and attention_pair.cu (P3): one attention head of width 64 held in
// shared memory, with its products on the tensor cores (wmma 16x16x16, bf16
// in, fp32 accumulate).
//
// Layout: a head's q, k and v (and g) live in shared memory as (Tp, kLd) bf16
// rows, Tp = T rounded up to 16 (the wmma tile), rows at or past T zero or
// bias-only (their keys are masked, their queries discarded). kLd = 72 keeps
// every 16-row tile 32-byte aligned, as wmma wants, and shifts each row by
// four banks.
#pragma once

#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include "fmm_common.cuh"

namespace fmm {

namespace head_tc {

using namespace nvcuda;

constexpr int kHd = 64;        // head width
constexpr int kLd = kHd + 8;   // shared-memory row stride of q, k, v, g (bf16)
constexpr int kBk = 32;        // contraction step of the LN -> QKV product
constexpr int kStageLd = kBk + 8;
constexpr int kMaxKeyChunks = 8;  // keys per lane in the softmax: Tp <= 256

__host__ __device__ constexpr int round16(int t) { return (t + 15) / 16 * 16; }

// Copy rows [0, T) of a (T, row_stride) bf16 matrix's 64 columns at `src`
// into `dst` (Tp, kLd); rows [T, Tp) become zero.
template <int kThreads>
__device__ __forceinline__ void stage_head(const bf16* __restrict__ src, size_t row_stride,
                                           int T, int Tp, bf16* dst) {
  for (int idx = threadIdx.x; idx < Tp * 8; idx += kThreads) {
    const int t = idx >> 3;
    const int c = idx & 7;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < T) v = *reinterpret_cast<const uint4*>(src + t * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + t * kLd + c * 8) = v;
  }
}

// Row moments of x (T, D) bf16, one warp per row: mean and 1/sqrt(var + eps),
// the variance as the mean of squared deviations (fp32, two passes).
template <int kWarps>
__device__ __forceinline__ void ln_moments(const bf16* __restrict__ x, int T, int D, float eps,
                                           float* mu, float* rstd) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int t = warp; t < T; t += kWarps) {
    const bf16* row = x + static_cast<size_t>(t) * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += __bfloat162float(row[d]);
    const float m = warp_sum(s) / D;
    float v = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float e = __bfloat162float(row[d]) - m;
      v += e * e;
    }
    v = warp_sum(v) / D;
    if (lane == 0) {
      mu[t] = m;
      rstd[t] = rsqrtf(v + eps);
    }
  }
}

// q, k and v of head h (each (Tp, kLd) bf16) from x (T, D) bf16:
//   xn = bf16((x - mu) * rstd * gamma + beta)      (rows >= T: zero)
//   q | k | v = bf16(xn . W[:, cols] (fp32 sums) + float(bias[cols]))
// for the 64 columns of q, k and v of head h in W (D, 3D) bf16. The
// contraction runs in steps of kBk through `stage` (Tp x kStageLd bf16, the
// normalized x tile, then kWarps 16x16 fp32 epilogue tiles after it); W's
// fragments are read from device memory (it stays in L2). Warp w owns the
// 16-row tiles w, w + kWarps, ... of each of the three 64-column outputs.
template <int kWarps>
__device__ void ln_qkv_head(const bf16* __restrict__ x, const bf16* __restrict__ W,
                            const bf16* __restrict__ bias, const float* __restrict__ gamma,
                            const float* __restrict__ beta, const float* mu, const float* rstd,
                            int T, int Tp, int D, int h, bf16* q, bf16* k, bf16* v,
                            bf16* stage) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kRowTiles = 256 / 16 / kWarps;  // per warp, Tp <= 256
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_rt = Tp / 16;
  const int ld_w = 3 * D;
  float* scratch = reinterpret_cast<float*>(stage + static_cast<size_t>(Tp) * kStageLd) +
                   warp * 16 * 16;
  bf16* outs[3] = {q, k, v};
  for (int part = 0; part < 3; ++part) {
    const int col0 = part * D + h * kHd;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRowTiles][4];
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) wmma::fill_fragment(acc[r][c], 0.f);
    for (int k0 = 0; k0 < D; k0 += kBk) {
      __syncthreads();  // the stage (and last part's epilogue tiles) are free
      for (int idx = threadIdx.x; idx < Tp * (kBk / 8); idx += kThreads) {
        const int t = idx / (kBk / 8);
        const int c = (idx % (kBk / 8)) * 8;
        uint4 packed = make_uint4(0, 0, 0, 0);
        if (t < T) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(x + static_cast<size_t>(t) * D + k0 + c);
          const bf16* xv = reinterpret_cast<const bf16*>(&raw);
          __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&packed);
          const float m = mu[t];
          const float rs = rstd[t];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = k0 + c + 2 * e;
            const float a = (__bfloat162float(xv[2 * e]) - m) * rs * gamma[d] + beta[d];
            const float b = (__bfloat162float(xv[2 * e + 1]) - m) * rs * gamma[d + 1] + beta[d + 1];
            pv[e] = __floats2bfloat162_rn(a, b);
          }
        }
        *reinterpret_cast<uint4*>(stage + t * kStageLd + c) = packed;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBk; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          wmma::load_matrix_sync(bw[c], W + static_cast<size_t>(k0 + kk) * ld_w + col0 + c * 16,
                                 ld_w);
        }
#pragma unroll
        for (int r = 0; r < kRowTiles; ++r) {
          const int rt = warp + r * kWarps;
          if (rt < n_rt) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ax;
            wmma::load_matrix_sync(ax, stage + rt * 16 * kStageLd + kk, kStageLd);
#pragma unroll
            for (int c = 0; c < 4; ++c) wmma::mma_sync(acc[r][c], ax, bw[c], acc[r][c]);
          }
        }
      }
    }
    // Epilogue: + bias in fp32, one rounding; lane owns row lane / 2 and
    // 8 columns of each 16x16 tile.
    const int er = lane >> 1;
    const int ec = (lane & 1) * 8;
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r) {
      const int rt = warp + r * kWarps;
      if (rt >= n_rt) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        wmma::store_matrix_sync(scratch, acc[r][c], 16, wmma::mem_row_major);
        __syncwarp();
        const uint4 braw = *reinterpret_cast<const uint4*>(bias + col0 + c * 16 + ec);
        const bf16* bv = reinterpret_cast<const bf16*>(&braw);
        uint4 packed;
        __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pv[e] = __floats2bfloat162_rn(scratch[er * 16 + ec + 2 * e] + __bfloat162float(bv[2 * e]),
                                        scratch[er * 16 + ec + 2 * e + 1] +
                                            __bfloat162float(bv[2 * e + 1]));
        }
        *reinterpret_cast<uint4*>(outs[part] + (rt * 16 + er) * kLd + c * 16 + ec) = packed;
        __syncwarp();
      }
    }
  }
}

// Bytes of `stage` that ln_qkv_head needs.
__host__ __device__ constexpr size_t ln_qkv_stage_bytes(int Tp, int warps) {
  return static_cast<size_t>(Tp) * kStageLd * 2 + static_cast<size_t>(warps) * 16 * 16 * 4;
}

// fp32 elements of one warp's tile in attention_head's `sbuf`: 16 rows of Tp
// scores, and at least the 16 x kHd fp32 output that later goes through it.
__host__ __device__ constexpr int warp_tile_floats(int Tp) { return 16 * (Tp > kHd ? Tp : kHd); }

// softmax(q k^T * scale, keys >= valid_T at -inf) v for one head held in
// shared memory, rows [0, T) of the bf16 result written to `out` (row stride
// out_stride elements). `sbuf` holds kWarps tiles of warp_tile_floats(Tp).
// Warp w takes the 16-row query tiles w, w + kWarps, ...: S = Q K^T on the
// tensor cores into its (16, Tp) fp32 tile, the fp32 softmax row by row (p
// rounded to bf16 and written over the consumed front of its own fp32 rows),
// O = P V on the tensor cores, and the 16x64 fp32 result through the same
// tile to bf16.
template <int kWarps>
__device__ void attention_head(const bf16* q, const bf16* k, const bf16* v, int T, int Tp,
                               int valid_T, float scale, float* sbuf, bf16* __restrict__ out,
                               size_t out_stride) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sb = sbuf + static_cast<size_t>(warp) * warp_tile_floats(Tp);
  bf16* pb = reinterpret_cast<bf16*>(sb);
  const int n_t = Tp / 16;
  for (int it = warp; it < n_t; it += kWarps) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> aq[kHd / 16];
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
      wmma::load_matrix_sync(aq[kk], q + it * 16 * kLd + kk * 16, kLd);
    for (int jt = 0; jt < n_t; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(bk, k + jt * 16 * kLd + kk * 16, kLd);
        wmma::mma_sync(s, aq[kk], bk, s);
      }
      wmma::store_matrix_sync(sb + jt * 16, s, Tp, wmma::mem_row_major);
    }
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const float* row = sb + r * Tp;
      float vals[kMaxKeyChunks];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < kMaxKeyChunks; ++c) {
        const int j = lane + 32 * c;
        float sv = -CUDART_INF_F;
        if (j < Tp && j < valid_T) sv = row[j] * scale;
        vals[c] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxKeyChunks; ++c) {
        vals[c] = expf(vals[c] - mx);
        sum += vals[c];
      }
      sum = warp_sum(sum);
      __syncwarp();  // row r is read by every lane before its bf16 row lands
#pragma unroll
      for (int c = 0; c < kMaxKeyChunks; ++c) {
        const int j = lane + 32 * c;
        if (j < Tp) pb[r * Tp + j] = __float2bfloat16(vals[c] / sum);
      }
      __syncwarp();
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[kHd / 16];
#pragma unroll
    for (int c = 0; c < kHd / 16; ++c) wmma::fill_fragment(o[c], 0.f);
    for (int kt = 0; kt < n_t; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ap;
      wmma::load_matrix_sync(ap, pb + kt * 16, Tp);
#pragma unroll
      for (int c = 0; c < kHd / 16; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, v + kt * 16 * kLd + c * 16, kLd);
        wmma::mma_sync(o[c], ap, bv, o[c]);
      }
    }
    __syncwarp();  // P is consumed: the tile takes the fp32 output
#pragma unroll
    for (int c = 0; c < kHd / 16; ++c)
      wmma::store_matrix_sync(sb + c * 16, o[c], kHd, wmma::mem_row_major);
    __syncwarp();
    for (int idx = lane; idx < 16 * (kHd / 8); idx += 32) {
      const int r = idx / (kHd / 8);
      const int c = (idx % (kHd / 8)) * 8;
      const int t = it * 16 + r;
      if (t < T) {
        uint4 packed;
        __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pv[e] = __floats2bfloat162_rn(sb[r * kHd + c + 2 * e], sb[r * kHd + c + 2 * e + 1]);
        *reinterpret_cast<uint4*>(out + t * out_stride + c) = packed;
      }
    }
    __syncwarp();
  }
}

}  // namespace head_tc

}  // namespace fmm
