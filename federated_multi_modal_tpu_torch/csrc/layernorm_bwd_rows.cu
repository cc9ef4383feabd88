// layernorm_bwd_rows: the backward of LayerNorm over the last axis of a
// (rows, D) matrix, with the residual branch's gradient added, and
// column_sum: fp32 sums over the rows of a (rows, N) matrix.
//
// For each row, with the moments of x recomputed in fp32 (two passes, as
// the forward computes them) and x^ = (x - mean) * rstd:
//   gv = dxn * gamma
//   dx = dres + rstd * (gv - mean(gv) - x^ * mean(gv * x^))   (dres may be null)
// written in fp32 or bf16 (and optionally a second bf16 copy), and the
// per-block partial column sums of dxn * x^ (d gamma) and dxn (d beta),
// unless the caller wants none (P2, which returns no parameter gradient:
// a separate instantiation, so that the kernels with partials stay as they
// were).
//
// Replaces the two LayerNorm backwards and every column reduction of the
// TPU kernel _train_bwd_kernel
// (federated_multi_modal_tpu/ops/pallas/fused_block.py): LN2's, giving the
// fp32 dyh (residual gradient dout, the bf16 output cotangent), and LN1's,
// giving the block's dx in x's dtype (residual gradient dyh); dg1/db1 and
// dg2/db2; and for the trainable block the bias gradients db_qkv and db_fc
// (sums of the bf16 dqkv and dh), db_out and db_proj (sums of the fp32 dyh
// and dout), all accumulated in fp32. With no residual branch (dres null)
// it is the LayerNorm backward of fused_ln_attention_bwd, giving that
// kernel's dx, dgamma and dbeta.
// Bound on the H100: bytes. At the vision shape (101,888 rows of 768) LN2's
// backward reads fp32 y and dxn2 and bf16 dout (784 MB) and writes fp32 and
// bf16 dyh (470 MB), ~0.37 ms at 3.35 TB/s; a column sum reads its matrix
// once (the bf16 dh of width 3072, 626 MB: ~0.19 ms).
// Design: one warp per row, lanes striding the row so that each load is
// coalesced; a row's x and dxn stay in registers (at most 32 values a
// lane, D <= 1024) across the moment, mean and output passes. Each warp
// adds its rows' d gamma and d beta terms into its own shared-memory row
// (no atomics), the block sums its warps' rows and writes one partial per
// block; column_sum then reduces the partials, and serves the bias
// gradients as well: thread per column (coalesced across the warp), the
// rows split over blockIdx.y into partial sums that a second column_sum
// over the partials adds up. Every sum runs in a fixed order, so the
// results do not change from run to run.
#include "fmm_common.cuh"

namespace {

using fmm::bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = 32;  // D <= 32 * 32
constexpr int kMaxD = 32 * kPerLane;

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename Tx, typename Tres, typename Tout, bool kPartials>
__global__ void __launch_bounds__(kThreads)
    layernorm_bwd_rows_kernel(const Tx* __restrict__ x, const float* __restrict__ dxn,
                              const Tres* __restrict__ dres, const float* __restrict__ gamma,
                              Tout* __restrict__ dx, bf16* __restrict__ dx_copy,
                              float* __restrict__ partial, int rows, int D, int rows_per_block,
                              float eps) {
  extern __shared__ float acc[];  // [kWarps][2][D], with kPartials
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* acc_g = acc + static_cast<size_t>(warp) * 2 * D;
  float* acc_b = acc_g + D;
  if constexpr (kPartials) {
    for (int j = lane; j < D; j += 32) {
      acc_g[j] = 0.f;
      acc_b[j] = 0.f;
    }
  }
  const long long row_begin = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long row_end = min(static_cast<long long>(rows), row_begin + rows_per_block);
  const float inv_d = 1.f / D;

  for (long long row = row_begin + warp; row < row_end; row += kWarps) {
    const Tx* xr = x + row * D;
    const float* dr = dxn + row * D;
    float xv[kPerLane];
    float dv[kPerLane];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      xv[t] = j < D ? fmm::to_f32(xr[j]) : 0.f;
      dv[t] = j < D ? dr[j] : 0.f;
      sum += xv[t];
    }
    const float mean = fmm::warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const float d = lane + 32 * t < D ? xv[t] - mean : 0.f;
      sq += d * d;
    }
    const float rstd = rsqrtf(fmm::warp_sum(sq) / D + eps);
    float s1 = 0.f;
    float s2 = 0.f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < D) {
        xv[t] = (xv[t] - mean) * rstd;  // x^ from here on
        const float gv = dv[t] * gamma[j];
        s1 += gv;
        s2 += gv * xv[t];
        if constexpr (kPartials) {
          acc_g[j] += dv[t] * xv[t];
          acc_b[j] += dv[t];
        }
      }
    }
    const float m1 = fmm::warp_sum(s1) * inv_d;
    const float m2 = fmm::warp_sum(s2) * inv_d;
    const Tres* rr = dres != nullptr ? dres + row * D : nullptr;
    Tout* orow = dx + row * D;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < D) {
        const float gv = dv[t] * gamma[j];
        const float g = rstd * (gv - m1 - xv[t] * m2);
        const float v = rr != nullptr ? fmm::to_f32(rr[j]) + g : g;
        store_f(orow + j, v);
        if (dx_copy != nullptr) dx_copy[row * D + j] = __float2bfloat16(v);
      }
    }
  }
  if constexpr (!kPartials) return;
  __syncthreads();
  // The block's partial: its warps' rows summed in warp order.
  for (int j = threadIdx.x; j < 2 * D; j += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += acc[static_cast<size_t>(w) * 2 * D + j];
    partial[static_cast<size_t>(blockIdx.x) * 2 * D + j] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    column_sum_kernel(const T* __restrict__ x, float* __restrict__ out, long long rows,
                      long long N, long long rows_per_split) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= N) return;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r1 = min(rows, r0 + rows_per_split);
  float s = 0.f;
  for (long long r = r0; r < r1; ++r) s += fmm::to_f32(x[r * N + c]);
  out[static_cast<long long>(blockIdx.y) * N + c] = s;
}

template <typename Tx, typename Tres, typename Tout>
cudaError_t launch_ln_bwd(const void* x, const void* dxn, const void* dres, const void* gamma,
                          void* dx, void* dx_copy, void* partial, int rows, int D,
                          int rows_per_block, float eps, cudaStream_t stream) {
  auto kernel = partial != nullptr ? layernorm_bwd_rows_kernel<Tx, Tres, Tout, true>
                                   : layernorm_bwd_rows_kernel<Tx, Tres, Tout, false>;
  const size_t smem =
      partial != nullptr ? static_cast<size_t>(kWarps) * 2 * D * sizeof(float) : 0;
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const Tx*>(x), static_cast<const float*>(dxn), static_cast<const Tres*>(dres),
      static_cast<const float*>(gamma), static_cast<Tout*>(dx), static_cast<bf16*>(dx_copy),
      static_cast<float*>(partial), rows, D, rows_per_block, eps);
  return cudaGetLastError();
}

template <typename Tx, typename Tres>
cudaError_t dispatch_out(int out_f32, const void* x, const void* dxn, const void* dres,
                         const void* gamma, void* dx, void* dx_copy, void* partial, int rows,
                         int D, int rows_per_block, float eps, cudaStream_t s) {
  return out_f32 ? launch_ln_bwd<Tx, Tres, float>(x, dxn, dres, gamma, dx, dx_copy, partial, rows,
                                                  D, rows_per_block, eps, s)
                 : launch_ln_bwd<Tx, Tres, bf16>(x, dxn, dres, gamma, dx, dx_copy, partial, rows,
                                                 D, rows_per_block, eps, s);
}

}  // namespace

// x (rows, D) bf16 or fp32, dxn (rows, D) fp32, dres (rows, D) bf16 or
// fp32 or null, gamma (D,) fp32; dx (rows, D) bf16 or fp32, dx_copy (rows, D) bf16
// or null; partial (ceil(rows / rows_per_block), 2, D) fp32 or null: per
// block, the sums of dxn * x^ and of dxn over its rows. All contiguous,
// D <= 1024.
FMM_EXPORT int fmm_layernorm_bwd_rows(const void* x, int x_f32, const void* dxn, const void* dres,
                                      int dres_f32, const void* gamma, void* dx, int dx_f32,
                                      void* dx_copy, void* partial, int rows, int D,
                                      int rows_per_block, float eps, void* stream) {
  if (rows < 1 || D < 1 || D > kMaxD || rows_per_block < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_f32) {
    err = dres_f32 ? dispatch_out<float, float>(dx_f32, x, dxn, dres, gamma, dx, dx_copy, partial,
                                                rows, D, rows_per_block, eps, s)
                   : dispatch_out<float, bf16>(dx_f32, x, dxn, dres, gamma, dx, dx_copy, partial,
                                               rows, D, rows_per_block, eps, s);
  } else {
    err = dres_f32 ? dispatch_out<bf16, float>(dx_f32, x, dxn, dres, gamma, dx, dx_copy, partial,
                                               rows, D, rows_per_block, eps, s)
                   : dispatch_out<bf16, bf16>(dx_f32, x, dxn, dres, gamma, dx, dx_copy, partial,
                                              rows, D, rows_per_block, eps, s);
  }
  return err;
}

// x (rows, N) bf16 or fp32; out (splits, N) fp32: split s sums rows
// [s * rows_per_split, (s + 1) * rows_per_split). Contiguous.
FMM_EXPORT int fmm_column_sum(const void* x, int x_f32, void* out, long long rows, long long N,
                              int splits, long long rows_per_split, void* stream) {
  if (rows < 1 || N < 1 || splits < 1 || splits > 65535 || rows_per_split < 1 ||
      static_cast<long long>(splits) * rows_per_split < rows) {
    return cudaErrorInvalidValue;
  }
  const long long col_blocks = (N + kThreads - 1) / kThreads;
  if (col_blocks > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(col_blocks), static_cast<unsigned>(splits));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    column_sum_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                       static_cast<float*>(out), rows, N,
                                                       rows_per_split);
  } else {
    column_sum_kernel<bf16><<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(x),
                                                      static_cast<float*>(out), rows, N,
                                                      rows_per_split);
  }
  return cudaGetLastError();
}
