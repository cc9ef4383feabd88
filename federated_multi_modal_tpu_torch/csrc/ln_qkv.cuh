// The LN1 -> QKV stage of one head, shared by lnqkv_attention.cu (P1) and
// lnqkv_attention_bwd_dx.cu (P2), so that the two recompute the same bits:
// the head's q, k and v = bf16(bf16(LN(x)) . W_h + b_h) of up to kMaxT rows
// of one batch row, by a block of 16 warps, into shared memory (the fused
// kernels) or device memory (the projection kernel of the streamed route).
//
// Numerics are the TPU prototypes' (tools/attn_microbench.py): LN in fp32
// (eps 1e-5; the moments from moments_kernel, the variance as the mean of
// squared deviations), the normalized x rounded to bf16, the product's sums
// in fp32 with the (bf16) bias added in fp32 before the one rounding.
//
// Widths: the head width HD is a template parameter, a multiple of 16
// (instances 16, 32, 64, 128 and 160; the wrapper zero-pads each head's W
// and bias columns to the next instance, so the kernels' head width is
// decoupled from the model's, and zero columns give zero q, k and v
// columns). The contraction runs over Dk, x's row stride, a multiple of 64
// (the wrapper zero-pads x's columns and gamma and beta; the moments count
// the model's D columns only). W is (Dk, 3 Dq) with Dq = H HD: part p of
// head h at columns p Dq + h HD.
//
// Design: the row's LN moments come once per row, not once per head, from
// moments_kernel (one warp a row) into a (B, T, 2) fp32 scratch. The head's
// 3 HD QKV columns are a tiled mma.sync GEMM (m16n8k16, bf16 in, fp32
// accumulate) in passes of at most 192 columns (one at HD <= 64, two at
// 128, three at 160): the contraction over Dk streams in 64-deep steps
// through a two-stage cp.async ring of x rows and the pass's W columns, each
// thread normalizing in place the x chunks it copied; warp w owns rows
// [32 (w / 2), + 32) and half of the pass's 16-column units, at most 96
// fp32 accumulators a thread, so each pass reads and normalizes x once and
// there are two barriers per 64-deep step. The bias is added in fp32 and q,
// k and v are rounded once into the destination. A fused kernel (one pass)
// writes them over the ring, which they outlive. kMaxT rows: the 8 x 32
// GEMM rows.
#pragma once

#include "attn_mma.cuh"

namespace fmm {

namespace ln_qkv {

namespace am = attn_mma;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = kWarps * 16;
constexpr int kBk = 64;         // contraction step
constexpr int kXLd = kBk + 8;   // x stage row stride (bf16)
constexpr int kMomentWarps = 8;

// The GEMM's split of one head's 3 HD columns into 16-column units: passes
// of at most 12 units (192 columns), each row group's two warps taking up to
// kWarpUnits of a pass's units.
template <int HD>
struct Split {
  static_assert(HD % 16 == 0, "the projection's head width is a multiple of 16");
  static constexpr int kCols = 3 * HD;  // q, k and v of one head
  static constexpr int kUnits = kCols / 16;
  static constexpr int kPasses = (kUnits + 11) / 12;
  static constexpr int kPassUnits = (kUnits + kPasses - 1) / kPasses;
  static constexpr int kWarpUnits = (kPassUnits + 1) / 2;
  static constexpr int kWLd = kPassUnits * 16 + 8;  // W stage row stride (bf16)
  static constexpr int kLd = am::Shape<HD>::kLd;    // q, k and v row stride in shared memory
};

// Shared memory at T: the ring (two stages of round32(T) x rows and kBk W
// rows), then, over it once the GEMM is done, q, k and v of Tp =
// round64(T) rows each (q at the region's start, k at + Tp kLd, v at + 2 Tp
// kLd).
template <int HD>
struct Layout {
  int Tx, Tp;
  size_t stage_elems, bytes;
  __host__ __device__ explicit Layout(int T)
      : Tx((T + 31) / 32 * 32),
        Tp((T + am::kTile - 1) / am::kTile * am::kTile),
        stage_elems(static_cast<size_t>(Tx) * kXLd + kBk * Split<HD>::kWLd) {
    const size_t ring = 2 * stage_elems;
    const size_t qkv = 3 * static_cast<size_t>(Tp) * Split<HD>::kLd;
    bytes = (ring > qkv ? ring : qkv) * sizeof(bf16);
  }
};

// Where q, k and v go: element c of part p (q, k, v) of row r at dst + p
// part_stride + r row_stride + c, rows below `rows` written.
struct Dest {
  bf16* dst;
  size_t part_stride;
  size_t row_stride;
  int rows;
};

namespace {

// Row mean and 1/sqrt(var + eps) of x (rows, ld) bf16 over its first D
// columns (the rest are zeros), one warp a row, the variance as the mean of
// squared deviations (fp32, two passes).
__global__ void __launch_bounds__(kMomentWarps * 32)
    moments_kernel(const bf16* __restrict__ x, float2* __restrict__ stats, int rows, int D,
                   int ld, float eps) {
  const int row = blockIdx.x * kMomentWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const uint4* r = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * ld);
  const int n = ld / 8;
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
      const float d = 8 * c + i < D ? __bfloat162float(e[i]) - m : 0.f;
      v += d * d;
    }
  }
  v = fmm::warp_sum(v) / D;
  if (lane == 0) stats[row] = make_float2(m, rsqrtf(v + eps));
}

// The moments of x (rows, ld), over its first D columns, into stats (rows
// float2) on `stream`.
inline cudaError_t launch_moments(const bf16* x, float2* stats, int rows, int D, int ld,
                                  cudaStream_t stream) {
  moments_kernel<<<(rows + kMomentWarps - 1) / kMomentWarps, kMomentWarps * 32, 0, stream>>>(
      x, stats, rows, D, ld, 1e-5f);
  return cudaGetLastError();
}

}  // namespace

// q, k and v of head h (width HD, of H) for T <= kMaxT rows into `dest`, by
// the block's kThreads threads, through the ring in `ring` (2
// Layout<HD>(T).stage_elems of shared memory): xb is the rows' (T, Dk) x,
// sb their (T,) moments; rows [T, dest.rows) take the bias only (finite keys
// and values, which the attention masks). Ends with a block barrier. Copies
// the caller issued before the call, and did not commit, join the first
// copy group and have landed when it returns.
template <int HD>
__device__ __forceinline__ void project_head(const bf16* __restrict__ xb,
                                             const bf16* __restrict__ W,
                                             const bf16* __restrict__ bias,
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ beta,
                                             const float2* __restrict__ sb, int T, int Dk,
                                             int H, int h, bf16* ring, const Dest& dest) {
  using P = Split<HD>;
  const Layout<HD> L(T);
  const size_t w_stride = 3 * static_cast<size_t>(H) * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // warp w owns rows [32 rg, 32 rg + 32) and units [kWarpUnits ch, + kWarpUnits)
  // of each pass; a row group past T only takes the bias.
  const int rg = warp >> 1;
  const int ch = warp & 1;
  const bool busy = rg * 32 < T;
  auto xs_of = [&](int step) { return ring + (step & 1) * L.stage_elems; };
  auto ws_of = [&](int step) { return xs_of(step) + static_cast<size_t>(L.Tx) * kXLd; };
  // column c (of the head's 3 HD) in W and the bias: part c / HD, its column c % HD
  auto w_col = [&](int c) { return (c / HD) * H * HD + h * HD + c % HD; };
  const int n_steps = Dk / kBk;

  for (int pass = 0; pass < P::kPasses; ++pass) {
    const int col0 = pass * P::kPassUnits * 16;  // the pass's first column
    const int pass_cols = min(P::kPassUnits * 16, P::kCols - col0);
    // x rows [0, Tx) (zeros at or past T) and the pass's W columns, rows [k0,
    // k0 + kBk); the same thread normalizes the x chunks it copies.
    auto prefetch = [&](int step) {
      const int k0 = step * kBk;
      bf16* xs = xs_of(step);
      bf16* ws = ws_of(step);
      for (int idx = threadIdx.x; idx < L.Tx * (kBk / 8); idx += kThreads) {
        const int r = idx >> 3;
        const int c = idx & 7;
        const bool valid = r < T;
        am::cp_async16(xs + r * kXLd + c * 8,
                       valid ? xb + static_cast<size_t>(r) * Dk + k0 + c * 8 : xb, valid);
      }
      const int chunks = pass_cols / 8;
      for (int idx = threadIdx.x; idx < kBk * chunks; idx += kThreads) {
        const int r = idx / chunks;
        const int c = idx - r * chunks;
        am::cp_async16(ws + r * P::kWLd + c * 8,
                       W + static_cast<size_t>(k0 + r) * w_stride + w_col(col0 + c * 8), true);
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

    float acc[2][2 * P::kWarpUnits][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2 * P::kWarpUnits; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

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
          for (int u = 0; u < P::kWarpUnits; ++u) {
            const int unit = ch * P::kWarpUnits + u;  // within the pass
            if (unit * 16 >= pass_cols) break;
            uint32_t bw[4];
            am::load_b_rows_k(bw, ws, P::kWLd, kk * 16, unit * 16);
            am::mma(acc[0][2 * u], a0, bw[0], bw[1]);
            am::mma(acc[0][2 * u + 1], a0, bw[2], bw[3]);
            am::mma(acc[1][2 * u], a1, bw[0], bw[1]);
            am::mma(acc[1][2 * u + 1], a1, bw[2], bw[3]);
          }
        }
      }
      __syncthreads();  // the stage is consumed (the last one before q, k, v land)
    }

    // q, k and v = bf16(acc + bias), rows [0, dest.rows) (rows at or past T
    // take the bias only).
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 2 * P::kWarpUnits; ++nt) {
      const int col = (ch * P::kWarpUnits) * 16 + nt * 8 + 2 * t;  // within the pass
      if (col >= pass_cols) break;
      const int part = (col0 + col) / HD;
      const int c = (col0 + col) % HD;
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bias + w_col(col0 + col)));
      bf16* dst = dest.dst + part * dest.part_stride + c;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = rg * 32 + mt * 16 + g + 8 * r;
          if (row < dest.rows)
            *reinterpret_cast<__nv_bfloat162*>(dst + row * dest.row_stride) =
                __floats2bfloat162_rn(acc[mt][nt][2 * r] + bb.x, acc[mt][nt][2 * r + 1] + bb.y);
        }
    }
    __syncthreads();
  }
}

// q, k and v of head h into shared memory at `region` (Layout<HD>(T).bytes),
// over the ring: the fused kernels' form, one GEMM pass.
template <int HD>
__device__ __forceinline__ void project_head_resident(const bf16* __restrict__ xb,
                                                      const bf16* __restrict__ W,
                                                      const bf16* __restrict__ bias,
                                                      const float* __restrict__ gamma,
                                                      const float* __restrict__ beta,
                                                      const float2* __restrict__ sb, int T,
                                                      int Dk, int H, int h, bf16* region) {
  static_assert(Split<HD>::kPasses == 1, "q, k and v overwrite the ring after one pass");
  const int Tp = Layout<HD>(T).Tp;
  project_head<HD>(xb, W, bias, gamma, beta, sb, T, Dk, H, h, region,
                   Dest{region, static_cast<size_t>(Tp) * Split<HD>::kLd,
                        static_cast<size_t>(Split<HD>::kLd), Tp});
}

}  // namespace ln_qkv

}  // namespace fmm
