// The LN1 -> QKV stage of one head, shared by lnqkv_attention.cu (P1) and
// lnqkv_attention_bwd_dx.cu (P2), so that the two recompute the same bits:
// the head's q, k and v = bf16(bf16(LN(x)) . W_h + b_h) of one batch row,
// written into shared memory by a block of 16 warps.
//
// Numerics are the TPU prototypes' (tools/attn_microbench.py): LN in fp32
// (eps 1e-5; the moments from moments_kernel, the variance as the mean of
// squared deviations), the normalized x rounded to bf16, the product's sums
// in fp32 with the (bf16) bias added in fp32 before the one rounding.
//
// Design: the row's LN moments come once per row, not once per head, from
// moments_kernel (one warp a row) into a (B, T, 2) fp32 scratch. The head's
// 192 QKV columns are one tiled mma.sync GEMM (m16n8k16, bf16 in, fp32
// accumulate): the contraction over D streams in 64-deep steps through a
// two-stage cp.async ring of x rows and W's 64 x 192 head columns, each
// thread normalizing in place the x chunks it copied; warp w owns rows
// [32 (w / 2), + 32) and 96 of the 192 columns, 96 fp32 accumulators a
// thread, so x is read and normalized once per head and there are two
// barriers per 64-deep step. The bias is added in fp32 and q, k and v are
// rounded once into shared memory over the ring (which they outlive). T is
// bounded by the 8 x 32 GEMM rows: T <= 256.
#pragma once

#include "attn_mma.cuh"

namespace fmm {

namespace ln_qkv {

namespace am = attn_mma;

constexpr int kHd = 64;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = kWarps * 16;
constexpr int kCols = 3 * kHd;  // q, k and v of one head
constexpr int kBk = 64;         // contraction step
constexpr int kXLd = kBk + 8;   // x stage row stride (bf16)
constexpr int kWLd = kCols + 8;  // W stage row stride (bf16)
constexpr int kLd = am::Shape<kHd>::kLd;  // q, k and v row stride (bf16)
constexpr int kMomentWarps = 8;

// Shared memory at T: the ring (two stages of round32(T) x rows and kBk W
// rows), then, over it once the GEMM is done, q, k and v of Tp =
// round64(T) rows each (q at the region's start, k at + Tp kLd, v at + 2 Tp
// kLd).
struct Layout {
  int Tx, Tp;
  size_t stage_elems, bytes;
  __host__ __device__ explicit Layout(int T)
      : Tx((T + 31) / 32 * 32),
        Tp((T + am::kTile - 1) / am::kTile * am::kTile),
        stage_elems(static_cast<size_t>(Tx) * kXLd + kBk * kWLd) {
    const size_t ring = 2 * stage_elems;
    const size_t qkv = 3 * static_cast<size_t>(Tp) * kLd;
    bytes = (ring > qkv ? ring : qkv) * sizeof(bf16);
  }
};

namespace {

// Row mean and 1/sqrt(var + eps) of x (rows, D) bf16, one warp a row, the
// variance as the mean of squared deviations (fp32, two passes).
__global__ void __launch_bounds__(kMomentWarps * 32)
    moments_kernel(const bf16* __restrict__ x, float2* __restrict__ stats, int rows, int D,
                   float eps) {
  const int row = blockIdx.x * kMomentWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const uint4* r = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * D);
  const int n = D / 8;
  float s = 0.f;
  for (int c = lane; c < n; c += 32) {
    const uint4 raw = r[c];
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += __bfloat162float(e[i]);
  }
  const float m = fmm::warp_sum(s) / D;
  float v = 0.f;
  for (int c = lane; c < n; c += 32) {
    const uint4 raw = r[c];
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = __bfloat162float(e[i]) - m;
      v += d * d;
    }
  }
  v = fmm::warp_sum(v) / D;
  if (lane == 0) stats[row] = make_float2(m, rsqrtf(v + eps));
}

// The moments of x (rows, D) into stats (rows float2) on `stream`.
inline cudaError_t launch_moments(const bf16* x, float2* stats, int rows, int D,
                                  cudaStream_t stream) {
  moments_kernel<<<(rows + kMomentWarps - 1) / kMomentWarps, kMomentWarps * 32, 0, stream>>>(
      x, stats, rows, D, 1e-5f);
  return cudaGetLastError();
}

}  // namespace

// q, k and v of head h of batch row b into `region` (Layout(T).bytes of
// shared memory) by the block's kThreads threads: xb is the row's (T, D)
// x, sb its (T,) moments; rows [T, Tp) take the bias only (finite keys and
// values, which the attention masks). Ends with a block barrier. Copies
// the caller issued before the call, and did not commit, join the first
// copy group and have landed when it returns.
__device__ __forceinline__ void project_head(const bf16* __restrict__ xb,
                                             const bf16* __restrict__ W,
                                             const bf16* __restrict__ bias,
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ beta,
                                             const float2* __restrict__ sb, int T, int D, int h,
                                             bf16* region) {
  const Layout L(T);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // The GEMM: warp w owns rows [32 rg, 32 rg + 32) and columns [96 ch, 96 ch
  // + 96) of the head's q | k | v; a row group past T only takes the bias.
  const int rg = warp >> 1;
  const int ch = warp & 1;
  const bool busy = rg * 32 < T;
  auto xs_of = [&](int step) { return region + (step & 1) * L.stage_elems; };
  auto ws_of = [&](int step) { return xs_of(step) + static_cast<size_t>(L.Tx) * kXLd; };
  // x rows [0, Tx) (zeros at or past T) and W's head columns, rows [k0, k0 +
  // kBk); the same thread normalizes the x chunks it copies.
  auto prefetch = [&](int step) {
    const int k0 = step * kBk;
    bf16* xs = xs_of(step);
    bf16* ws = ws_of(step);
    for (int idx = threadIdx.x; idx < L.Tx * (kBk / 8); idx += kThreads) {
      const int r = idx >> 3;
      const int c = idx & 7;
      const bool valid = r < T;
      am::cp_async16(xs + r * kXLd + c * 8,
                     valid ? xb + static_cast<size_t>(r) * D + k0 + c * 8 : xb, valid);
    }
    for (int idx = threadIdx.x; idx < kBk * (kCols / 8); idx += kThreads) {
      const int r = idx / (kCols / 8);
      const int c = idx - r * (kCols / 8);
      const int col = (c >> 3) * D + h * kHd + (c & 7) * 8;  // part c / 8 of q | k | v
      am::cp_async16(ws + r * kWLd + c * 8, W + static_cast<size_t>(k0 + r) * 3 * D + col, true);
    }
  };
  auto normalize = [&](int step) {
    const int k0 = step * kBk;
    bf16* xs = xs_of(step);
    for (int idx = threadIdx.x; idx < L.Tx * (kBk / 8); idx += kThreads) {
      const int r = idx >> 3;
      const int c = idx & 7;
      if (r >= T) continue;
      uint4* chunk = reinterpret_cast<uint4*>(xs + r * kXLd + c * 8);
      const uint4 raw = *chunk;
      const bf16* xv = reinterpret_cast<const bf16*>(&raw);
      const float2 ms = __ldg(sb + r);
      const int d0 = k0 + c * 8;
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(gamma + d0));
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(gamma + d0 + 4));
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(beta + d0));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(beta + d0 + 4));
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint4 packed;
      __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lo = (__bfloat162float(xv[2 * e]) - ms.x) * ms.y * g[2 * e] + bt[2 * e];
        const float hi =
            (__bfloat162float(xv[2 * e + 1]) - ms.x) * ms.y * g[2 * e + 1] + bt[2 * e + 1];
        pv[e] = __floats2bfloat162_rn(lo, hi);
      }
      *chunk = packed;
    }
  };

  float acc[2][12][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 12; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int n_steps = D / kBk;
  prefetch(0);
  am::cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) prefetch(step + 1);
    am::cp_async_commit();
    am::cp_async_wait<1>();
    normalize(step);
    __syncthreads();
    if (busy) {
      const bf16* xs = xs_of(step);
      const bf16* ws = ws_of(step);
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        uint32_t a0[4], a1[4];
        am::load_a(a0, xs, kXLd, rg * 32, kk * 16);
        am::load_a(a1, xs, kXLd, rg * 32 + 16, kk * 16);
#pragma unroll
        for (int np = 0; np < 6; ++np) {
          uint32_t bw[4];
          am::load_b_rows_k(bw, ws, kWLd, kk * 16, ch * 96 + np * 16);
          am::mma(acc[0][2 * np], a0, bw[0], bw[1]);
          am::mma(acc[0][2 * np + 1], a0, bw[2], bw[3]);
          am::mma(acc[1][2 * np], a1, bw[0], bw[1]);
          am::mma(acc[1][2 * np + 1], a1, bw[2], bw[3]);
        }
      }
    }
    __syncthreads();  // the stage is consumed (the last one before q, k, v land)
  }

  // q, k and v = bf16(acc + bias) over the ring, rows [0, Tp) (rows at or
  // past T take the bias only).
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 12; ++nt) {
    const int col = ch * 96 + nt * 8 + 2 * t;
    const int part = col >> 6;
    const int c = col & 63;
    const float2 bb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + part * D + h * kHd + c));
    bf16* dst = region + static_cast<size_t>(part) * L.Tp * kLd + c;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rg * 32 + mt * 16 + g + 8 * r;
        if (row < L.Tp)
          *reinterpret_cast<__nv_bfloat162*>(dst + row * kLd) = __floats2bfloat162_rn(
              acc[mt][nt][2 * r] + bb.x, acc[mt][nt][2 * r + 1] + bb.y);
      }
  }
  __syncthreads();
}

}  // namespace ln_qkv

}  // namespace fmm
