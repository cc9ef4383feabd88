// eva_rows: the row kernels of EVA-CLIP's vision block
// (ops/kernels/eva_block.py) that CLIP's block has no use for:
//
//   layernorm_rows_ld: LayerNorm of a (rows, ld) bf16 matrix over its first
//     D columns (fp32 moments over those alone, two passes), bf16 out, zeros
//     in columns D .. ld: LN_ffn over the SwiGLU hidden's 2730 valid columns
//     at the padded stride of 2736.
//   layernorm_bwd_gate: LN_ffn's backward and the gate's in one pass. For
//     each row, from the saved bf16 pair (x1_j, x2_j) of the gate product
//     (interleaved, 2 ld wide), g_j = bf16(silu(x1_j) * x2_j) is recomputed
//     as gemm_epilogue.cu's gate epilogue computed it; with x^ = (g - mean)
//     * rstd and gv = dgn * gamma,
//       dg  = rstd * (gv - mean(gv) - x^ * mean(gv * x^))
//       dx1 = dg * x2 * silu'(x1),  dx2 = dg * silu(x1)
//     written interleaved in bf16 (zeros past D), and one partial a block
//     of the column sums of dgn * x^ (d gamma) and dgn (d beta), which
//     column_sum (layernorm_bwd_rows.cu) adds.
//   rope_rows: q and k of a (M, 3D) bf16 QKV turned in place by a (T, 32)
//     (cos, sin) table at row % T, by -theta for the backward: d(QKV) of
//     the attention backward taken back to the unrotated q and k.
//
// Bound on the H100: bytes. At EVA02-CLIP-L/14's 124,800 rows of 2736,
// layernorm_rows_ld reads and writes 683 MB each way (~0.41 ms at 3.35
// TB/s); layernorm_bwd_gate reads the 1.37 GB pair and the 1.37 GB fp32
// dgn and writes a 1.37 GB pair (~1.2 ms); rope_rows reads and writes the
// 511 MB of q and k (~0.31 ms).
// Design: layernorm_rows_ld is layernorm_rows.cu's warp a row with a
// stride; layernorm_bwd_gate is a persistent grid of 256-thread blocks, a
// row a block at a time, each thread owning columns tid + 256 k (at most
// 12) in registers, so that a row is read once and gamma, d gamma and d
// beta stay in registers across rows (block sums through shared memory in
// a fixed order: the results repeat bit for bit); rope_rows is one thread
// per 8 columns, 16-byte accesses.
#include "fmm_common.cuh"

namespace {

using fmm::bf16;

constexpr int kLnWarps = 8;
constexpr int kThreads = 256;
constexpr int kPer = 12;  // columns a thread: ld <= 3072
constexpr int kWarpsBlock = kThreads / 32;

__global__ void __launch_bounds__(kLnWarps * 32)
    layernorm_rows_ld_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                             const float* __restrict__ beta, bf16* __restrict__ out, int rows,
                             int D, int ld, float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kLnWarps + warp;
  if (row >= rows) return;
  const bf16* xr = x + row * ld;
  bf16* orow = out + row * ld;
  float sum = 0.f;
  for (int j = lane; j < D; j += 32) sum += __bfloat162float(xr[j]);
  const float mean = fmm::warp_sum(sum) / D;
  float sq = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float d = __bfloat162float(xr[j]) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(fmm::warp_sum(sq) / D + eps);
  for (int j = lane; j < D; j += 32) {
    const float y = (__bfloat162float(xr[j]) - mean) * rstd;
    orow[j] = __float2bfloat16(y * gamma[j] + beta[j]);
  }
  for (int j = D + lane; j < ld; j += 32) orow[j] = __float2bfloat16(0.f);
}

// The block's sums of a and b, in warp order (every thread gets them).
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
  a = fmm::warp_sum(a);
  b = fmm::warp_sum(b);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  float2 t = red[0];
#pragma unroll
  for (int w = 1; w < kWarpsBlock; ++w) {
    t.x += red[w].x;
    t.y += red[w].y;
  }
  __syncthreads();
  return t;
}

__device__ __forceinline__ float sigmoid_fast(float a) {
  return __fdividef(1.f, 1.f + __expf(-a));
}

__global__ void __launch_bounds__(kThreads)
    layernorm_bwd_gate_kernel(const bf16* __restrict__ pre, const float* __restrict__ dgn,
                              const float* __restrict__ gamma, bf16* __restrict__ dpair,
                              float* __restrict__ partial, int rows, int D, int ld, float eps) {
  __shared__ float2 red[kWarpsBlock];
  const int tid = threadIdx.x;
  float gam[kPer], dgam[kPer], dbet[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = tid + kThreads * k;
    gam[k] = j < D ? gamma[j] : 0.f;
    dgam[k] = 0.f;
    dbet[k] = 0.f;
  }
  const float inv_d = 1.f / static_cast<float>(D);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(pre) + row * ld;
    const float* dr = dgn + row * ld;
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dpair) + row * ld;
    float a[kPer], b[kPer], g[kPer], dn[kPer];
    float s1 = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = tid + kThreads * k;
      a[k] = b[k] = g[k] = dn[k] = 0.f;
      if (j < D) {
        const float2 ab = __bfloat1622float2(pr[j]);
        a[k] = ab.x;
        b[k] = ab.y;
        // gemm_epilogue.cu's gate_of, rounded as the product stored it
        g[k] = __bfloat162float(__float2bfloat16(a[k] * sigmoid_fast(a[k]) * b[k]));
        dn[k] = dr[j];
        s1 += g[k];
      }
    }
    const float mean = block_sum2(s1, 0.f, red).x * inv_d;
    float s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = tid + kThreads * k;
      if (j < D) {
        const float d = g[k] - mean;
        s2 += d * d;
      }
    }
    const float rstd = rsqrtf(block_sum2(s2, 0.f, red).x * inv_d + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = tid + kThreads * k;
      if (j < D) {
        const float xh = (g[k] - mean) * rstd;
        const float gv = dn[k] * gam[k];
        m1 += gv;
        m2 += gv * xh;
      }
    }
    const float2 m = block_sum2(m1, m2, red);
    m1 = m.x * inv_d;
    m2 = m.y * inv_d;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = tid + kThreads * k;
      if (j < D) {
        const float xh = (g[k] - mean) * rstd;
        const float dg = rstd * (dn[k] * gam[k] - m1 - xh * m2);
        const float s = sigmoid_fast(a[k]);
        out[j] = __floats2bfloat162_rn(dg * b[k] * (s + a[k] * s * (1.f - s)), dg * a[k] * s);
        dgam[k] += dn[k] * xh;
        dbet[k] += dn[k];
      } else if (j < ld) {
        out[j] = __floats2bfloat162_rn(0.f, 0.f);
      }
    }
  }
  float* part = partial + static_cast<long long>(blockIdx.x) * 2 * ld;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = tid + kThreads * k;
    if (j < ld) {
      part[j] = dgam[k];
      part[ld + j] = dbet[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    rope_rows_kernel(bf16* __restrict__ qkv, const float2* __restrict__ table, int M, int T,
                     int D, float sign) {
  const int groups = 2 * D / 8;  // 8-column groups of q and k in a row
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = idx / groups;
  if (row >= M) return;
  const int col = static_cast<int>(idx - row * groups) * 8;
  const float2* tr = table + static_cast<int>(row % T) * 32;
  uint4* p = reinterpret_cast<uint4*>(qkv + row * 3 * D + col);
  uint4 raw = *p;
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 cs = tr[((col + 2 * i) & 63) >> 1];
    const float2 x = __bfloat1622float2(v[i]);
    const float s = sign * cs.y;
    v[i] = __floats2bfloat162_rn(x.x * cs.x - x.y * s, x.y * cs.x + x.x * s);
  }
  *p = raw;
}

}  // namespace

// x, out (rows, ld) bf16; gamma, beta (D,) fp32; D <= ld; contiguous.
FMM_EXPORT int fmm_layernorm_rows_ld(const void* x, const void* gamma, const void* beta,
                                     void* out, int rows, int D, int ld, float eps,
                                     void* stream) {
  if (rows < 1 || D < 1 || ld < D) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((rows + kLnWarps - 1) / kLnWarps);
  layernorm_rows_ld_kernel<<<blocks, kLnWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(out), rows, D, ld, eps);
  return cudaGetLastError();
}

// pre, dpair (rows, 2 ld) bf16; dgn (rows, ld) fp32; gamma (D,) fp32;
// partial (blocks, 2 ld) fp32; D <= ld <= 3072, ld even; contiguous and
// 16-byte aligned.
FMM_EXPORT int fmm_layernorm_bwd_gate(const void* pre, const void* dgn, const void* gamma,
                                      void* dpair, void* partial, int rows, int D, int ld,
                                      int blocks, float eps, void* stream) {
  if (rows < 1 || D < 1 || ld < D || ld > kThreads * kPer || blocks < 1) {
    return cudaErrorInvalidValue;
  }
  layernorm_bwd_gate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(pre), static_cast<const float*>(dgn),
      static_cast<const float*>(gamma), static_cast<bf16*>(dpair),
      static_cast<float*>(partial), rows, D, ld, eps);
  return cudaGetLastError();
}

// qkv (M, 3D) bf16 in place, D a multiple of 64 (heads of 64); table (T,
// 32) float2 (cos, sin); M a multiple of T; inverse turns by -theta.
FMM_EXPORT int fmm_rope_rows(void* qkv, const void* table, int M, int T, int D, int inverse,
                             void* stream) {
  if (M < 1 || T < 1 || M % T != 0 || D < 64 || D % 64 != 0) return cudaErrorInvalidValue;
  const long long threads = static_cast<long long>(M) * (2 * D / 8);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  rope_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<bf16*>(qkv), static_cast<const float2*>(table), M, T, D,
      inverse ? -1.f : 1.f);
  return cudaGetLastError();
}
