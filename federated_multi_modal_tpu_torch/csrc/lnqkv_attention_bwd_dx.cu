// lnqkv_attention_bwd_dx: dx of lnqkv_attention for the output cotangent dy,
// recomputed from x alone (LN, QKV, scores and probabilities), in one kernel.
//
// Replaces the prototype TPU kernel
// tools/attn_microbench.py::fused_lnqkv_attention_bwd_dx (pallas_call at
// :207), with its numerics: per head, with g the head's slice of dy,
//   dv = P^T g (p rounded to bf16), dp = g v^T (fp32),
//   ds = bf16(p32 * (dp - rowsum(dp * p32)) * scale),
//   dq = ds k, dk = ds^T q, each rounded to bf16;
//   dxn = [dq | dk | dv] . W^T summed in fp32 over every head;
//   dx = rstd * (dxn gamma - mean(dxn gamma) - xhat mean(dxn gamma xhat)).
// Like the TPU kernel it computes no parameter gradient.
//
// Bound on the H100: operations. At x (512, 200, 768) the attention backward
// is 126 GFLOP and dxn 362 GFLOP: 0.494 ms at 989 TFLOP/s (the recomputation
// not counted), against ~0.16 ms for x, dy, W and dx.
// Design: dxn sums over all heads, and the LayerNorm backward needs whole
// rows of it; on the TPU this overflowed VMEM. Here one thread block per row
// b loops over the heads: it recomputes the head's q, k and v into shared
// memory (the LN -> QKV product of head_tc.cuh, wmma), runs the head's
// attention backward on the CUDA cores in two phases as
// attention_core_bwd.cu does (one warp per query row for dq and the row
// statistics, then one warp per key row for dk and dv, P and dS recomputed
// with the same fp32 operations), keeps dq, dk and dv in shared memory, and
// adds [dq | dk | dv] . W_h^T (wmma, W_h^T's fragments read from device
// memory) into an fp32 dxn slice of device memory that only this block
// touches. After the last head it runs the LayerNorm backward on its rows.
// No atomics: the sums run in one order, so the kernel repeats bit for bit.
// 1092 bytes of shared memory per padded token: T <= 208. The attention on
// the CUDA cores (rows 72 elements apart: 4-way bank conflicts), and x read
// 36 times per row, are what keep it far from its bound.
#include "head_tc.cuh"

namespace {

using fmm::bf16;
using namespace nvcuda;
namespace ht = fmm::head_tc;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 208;
constexpr int kLd2 = ht::kLd / 2;  // row stride in bf16 pairs

// dq, dk and dv, which also hold the LN -> QKV stage while q, k, v are made
__host__ __device__ size_t grad_region_bytes(int Tp) {
  const size_t grads = static_cast<size_t>(Tp) * 3 * ht::kLd * sizeof(bf16);
  const size_t stage = ht::ln_qkv_stage_bytes(Tp, kWarps);
  return grads > stage ? grads : stage;
}

size_t smem_bytes(int Tp) {
  // q, k, v, g; the dq, dk, dv region; two fp32 rows per warp; row max, sum
  // and delta; mu and rstd
  return static_cast<size_t>(Tp) * 4 * ht::kLd * sizeof(bf16) + grad_region_bytes(Tp) +
         static_cast<size_t>(Tp) * (2 * kWarps + 5) * sizeof(float);
}

__device__ __forceinline__ float dot_head(const bf16* a, const bf16* b) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(b);
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < ht::kHd / 2; ++d) {
    const float2 af = __bfloat1622float2(a2[d]);
    const float2 bf = __bfloat1622float2(b2[d]);
    acc = fmaf(af.x, bf.x, acc);
    acc = fmaf(af.y, bf.y, acc);
  }
  return acc;
}

// Explicitly rounded (no contraction into an fma) so both phases compute
// the same bits.
__device__ __forceinline__ float score(const bf16* qi, const bf16* kj, float scale) {
  return __fmul_rn(dot_head(qi, kj), scale);
}

__device__ __forceinline__ float dscore(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

__global__ void __launch_bounds__(kThreads)
    lnqkv_attention_bwd_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W,
                                  const bf16* __restrict__ bias, const float* __restrict__ gamma,
                                  const float* __restrict__ beta, const bf16* __restrict__ dy,
                                  float* __restrict__ dxn_all, bf16* __restrict__ dx, int T,
                                  int D, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Tp = ht::round16(T);
  const size_t head = static_cast<size_t>(Tp) * ht::kLd;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + head;
  bf16* vs = ks + head;
  bf16* gs = vs + head;
  bf16* dq = gs + head;
  bf16* dk = dq + head;
  bf16* dv = dk + head;
  float* bufs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(dq) +
                                         grad_region_bytes(Tp));
  float* row_max = bufs + 2 * kWarps * Tp;
  float* row_sum = row_max + Tp;
  float* row_delta = row_sum + Tp;
  float* mu = row_delta + Tp;
  float* rstd = mu + Tp;

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bf16* xb = x + static_cast<size_t>(b) * T * D;
  const bf16* dyb = dy + static_cast<size_t>(b) * T * D;
  float* dxn = dxn_all + static_cast<size_t>(b) * Tp * D;
  float* buf_a = bufs + static_cast<size_t>(warp) * 2 * Tp;
  float* buf_b = buf_a + Tp;
  const int ld_w = 3 * D;
  const int n_rt = Tp / 16;

  ht::ln_moments<kWarps>(xb, T, D, 1e-5f, mu, rstd);
  for (int h = 0; h < H; ++h) {
    // ln_qkv_head starts with a barrier: the last head's dq, dk and dv (its
    // stage) are consumed, and the moments are published
    ht::ln_qkv_head<kWarps>(xb, W, bias, gamma, beta, mu, rstd, T, Tp, D, h, qs, ks, vs, dq);
    ht::stage_head<kThreads>(dyb + h * ht::kHd, D, T, Tp, gs);
    __syncthreads();

    // Phase 1: one warp per query row i -> dq_i and the row statistics.
    for (int i = warp; i < T; i += kWarps) {
      const bf16* qi = qs + i * ht::kLd;
      const bf16* gi = gs + i * ht::kLd;
      float mx = -CUDART_INF_F;
      for (int j = lane; j < T; j += 32) {
        const float s = score(qi, ks + j * ht::kLd, scale);
        buf_a[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmm::warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < T; j += 32) {
        const float e = expf(__fsub_rn(buf_a[j], mx));
        buf_a[j] = e;
        sum += e;
      }
      sum = fmm::warp_sum(sum);
      float delta = 0.f;
      for (int j = lane; j < T; j += 32) {
        const float p = __fdiv_rn(buf_a[j], sum);
        const float dp = dot_head(gi, vs + j * ht::kLd);
        buf_a[j] = p;
        buf_b[j] = dp;
        delta += dp * p;
      }
      delta = fmm::warp_sum(delta);
      for (int j = lane; j < T; j += 32) buf_a[j] = round_bf16(dscore(buf_a[j], buf_b[j], delta, scale));
      if (lane == 0) {
        row_max[i] = mx;
        row_sum[i] = sum;
        row_delta[i] = delta;
      }
      __syncwarp();
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(ks) + lane;
      float ax = 0.f;
      float ay = 0.f;
      for (int j = 0; j < T; ++j) {
        const float dsj = buf_a[j];
        const float2 kf = __bfloat1622float2(k2[j * kLd2]);
        ax = fmaf(dsj, kf.x, ax);
        ay = fmaf(dsj, kf.y, ay);
      }
      reinterpret_cast<__nv_bfloat162*>(dq + i * ht::kLd)[lane] = __floats2bfloat162_rn(ax, ay);
      __syncwarp();
    }
    __syncthreads();

    // Phase 2: one warp per key row j -> dk_j and dv_j.
    for (int j = warp; j < T; j += kWarps) {
      const bf16* kj = ks + j * ht::kLd;
      const bf16* vj = vs + j * ht::kLd;
      for (int i = lane; i < T; i += 32) {
        const float s = score(qs + i * ht::kLd, kj, scale);
        const float p = __fdiv_rn(expf(__fsub_rn(s, row_max[i])), row_sum[i]);
        const float dp = dot_head(gs + i * ht::kLd, vj);
        buf_a[i] = round_bf16(dscore(p, dp, row_delta[i], scale));
        buf_b[i] = round_bf16(p);
      }
      __syncwarp();
      const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(qs) + lane;
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(gs) + lane;
      float kx = 0.f;
      float ky = 0.f;
      float vx = 0.f;
      float vy = 0.f;
      for (int i = 0; i < T; ++i) {
        const float dsi = buf_a[i];
        const float pi = buf_b[i];
        const float2 qf = __bfloat1622float2(q2[i * kLd2]);
        const float2 gf = __bfloat1622float2(g2[i * kLd2]);
        kx = fmaf(dsi, qf.x, kx);
        ky = fmaf(dsi, qf.y, ky);
        vx = fmaf(pi, gf.x, vx);
        vy = fmaf(pi, gf.y, vy);
      }
      reinterpret_cast<__nv_bfloat162*>(dk + j * ht::kLd)[lane] = __floats2bfloat162_rn(kx, ky);
      reinterpret_cast<__nv_bfloat162*>(dv + j * ht::kLd)[lane] = __floats2bfloat162_rn(vx, vy);
      __syncwarp();
    }
    __syncthreads();

    // dxn (+)= [dq | dk | dv] . W_h^T: 16x16 output tiles of (Tp, D), warp w
    // taking tiles w, w + kWarps, ...; rows at or past T carry whatever the
    // padded rows of dq, dk, dv hold and are never read.
    const bf16* parts[3] = {dq, dk, dv};
    const int n_ct = D / 16;
    for (int tile = warp; tile < n_rt * n_ct; tile += kWarps) {
      const int rt = tile / n_ct;
      const int ct = tile % n_ct;
      float* dst = dxn + static_cast<size_t>(rt) * 16 * D + ct * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (h == 0) {
        wmma::fill_fragment(acc, 0.f);
      } else {
        wmma::load_matrix_sync(acc, dst, D, wmma::mem_row_major);
      }
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        const bf16* w_cols = W + static_cast<size_t>(ct) * 16 * ld_w + part * D + h * ht::kHd;
#pragma unroll
        for (int kk = 0; kk < ht::kHd; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
          wmma::load_matrix_sync(a, parts[part] + rt * 16 * ht::kLd + kk, ht::kLd);
          wmma::load_matrix_sync(bw, w_cols + kk, ld_w);
          wmma::mma_sync(acc, a, bw, acc);
        }
      }
      wmma::store_matrix_sync(dst, acc, D, wmma::mem_row_major);
    }
  }
  __syncthreads();  // every tile of dxn is written

  // LayerNorm backward, one warp per row.
  bf16* dxb = dx + static_cast<size_t>(b) * T * D;
  for (int t = warp; t < T; t += kWarps) {
    const bf16* xr = xb + static_cast<size_t>(t) * D;
    const float* dr = dxn + static_cast<size_t>(t) * D;
    const float m = mu[t];
    const float rs = rstd[t];
    float s1 = 0.f;
    float s2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float gv = dr[d] * gamma[d];
      const float xhat = (__bfloat162float(xr[d]) - m) * rs;
      s1 += gv;
      s2 += gv * xhat;
    }
    const float m1 = fmm::warp_sum(s1) / D;
    const float m2 = fmm::warp_sum(s2) / D;
    for (int d = lane; d < D; d += 32) {
      const float gv = dr[d] * gamma[d];
      const float xhat = (__bfloat162float(xr[d]) - m) * rs;
      dxb[static_cast<size_t>(t) * D + d] = __float2bfloat16(rs * (gv - m1 - xhat * m2));
    }
  }
}

}  // namespace

// x and dy (B, T, D) bf16, W (D, 3D) bf16, bias (3D,) bf16, gamma and beta
// (D,) fp32, dxn (B, round16(T), D) fp32 scratch, dx (B, T, D) bf16;
// contiguous and 16-byte aligned; D = 64 H and a multiple of 32; T <= 208.
FMM_EXPORT int fmm_lnqkv_attention_bwd_dx(const void* x, const void* W, const void* bias,
                                          const void* gamma, const void* beta, const void* dy,
                                          void* dxn, void* dx, int B, int T, int D, int H,
                                          float scale, void* stream) {
  if (T < 1 || T > kMaxT || B < 1 || D != H * ht::kHd || D % ht::kBk != 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(ht::round16(T));
  cudaError_t err = cudaFuncSetAttribute(lnqkv_attention_bwd_dx_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lnqkv_attention_bwd_dx_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(W), static_cast<const bf16*>(bias),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const bf16*>(dy), static_cast<float*>(dxn), static_cast<bf16*>(dx), T, D, H,
      scale);
  return cudaGetLastError();
}
