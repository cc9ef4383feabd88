// attention_core_bwd: d(QKV) of attention_core, per (row b, head h), read
// straight from a packed (B, T, 3D) bf16 QKV tensor and the output
// cotangent g (B, T, D), written into a packed (B, T, 3D) bf16 gradient.
//
// Replaces the backward attention of two TPU kernels:
//   * federated_multi_modal_tpu/ops/pallas/attention.py
//     attention_packed_bwd_masked (_packed_bwd_body, behind the custom VJP of
//     packed_attention_masked), the text tower's block-causal packed rows;
//   * the per-head attention backward of _train_bwd_kernel in
//     ops/pallas/fused_block.py (behind fused_block_train and
//     fused_block_train_dw), the vision tower, with no mask.
// Numerics follow the TPU kernels: fp32 scores, softmax and dP = g.v^T;
// rowsum(dP * P) over the fp32 P; p rounded to bf16 for dV = P^T g;
// dS = P * (dP - rowsum) * scale rounded to bf16 before dQ = dS k and
// dK = dS^T q; fp32 sums; bf16 outputs.
//
// Bound on the H100: at the text shape (200, 120, 1536) a launch reads
// ~98 MB and writes ~74 MB for ~1.5 GFLOP of products (five per (query,
// key) pair on the mask's 1,500 finite pairs), and at the vision shape
// (512, 200, 2304) ~629 MB in and ~472 MB out for ~157 GFLOP; both are
// bound by memory at 3.35 TB/s (~0.05 ms and ~0.33 ms).
// Design: one thread block per (b, h) stages q, k, v and g of its head in
// shared memory once (rows padded to 66 elements, so that 32 lanes reading
// 32 different rows hit 32 different banks). The dK and dV sums run over
// the query axis, which a block cannot hold as fp32 accumulators beside
// q, k, v and g at T = 200 (~100 KB more); so the kernel runs in two phases,
// as FlashAttention-2's backward does:
//   1. one warp per query row i: scores, softmax, dP, rowsum and dS of the
//      row, dQ_i = sum_j dS_ij k_j; the row's max, sum and rowsum are kept;
//   2. one warp per key row j: P_ij and dP_ij recomputed from the kept row
//      statistics (the same fp32 operations in the same order, so the same
//      bits as in phase 1), dK_j = sum_i dS_ij q_i and dV_j = sum_i P_ij g_i.
// The products run on the CUDA cores in fp32, so the kernel is bound by fp32
// issue rate, far from its memory bound; moving them onto the tensor cores
// is the step that would bring it there.
#include <math_constants.h>
#include <stdint.h>

#include "fmm_common.cuh"

namespace {

using fmm::bf16;

constexpr int kHeadDim = 64;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kHeadDim + 2;
// 227 KB of shared memory per block: q, k, v, g (132 B/token each), two
// fp32 rows per warp (128 B/token) and three fp32 row statistics (12
// B/token) fit up to T = 347.
constexpr int kMaxT = 320;

size_t smem_bytes(int T) {
  return static_cast<size_t>(T) *
         (4 * kStride * sizeof(bf16) + 2 * kWarps * sizeof(float) + 3 * sizeof(float));
}

__device__ __forceinline__ float dot_head(const bf16* a, const bf16* b) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(b);
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kHeadDim / 2; ++d) {
    const float2 af = __bfloat1622float2(a2[d]);
    const float2 bf = __bfloat1622float2(b2[d]);
    acc = fmaf(af.x, bf.x, acc);
    acc = fmaf(af.y, bf.y, acc);
  }
  return acc;
}

// The scaled, masked score. Explicitly rounded operations (no contraction
// into an fma) so that both phases compute the same bits.
__device__ __forceinline__ float score(const bf16* qi, const bf16* kj, const float* mask, int i,
                                       int j, int T, float scale) {
  float s = __fmul_rn(dot_head(qi, kj), scale);
  if (mask != nullptr) s = __fadd_rn(s, mask[static_cast<size_t>(i) * T + j]);
  return s;
}

__device__ __forceinline__ float dscore(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store_row_chunk(bf16* dst, uint4 v) {
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

__global__ void __launch_bounds__(kThreads)
    attention_core_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                              const float* __restrict__ mask, bf16* __restrict__ dqkv, int T,
                              int D, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + static_cast<size_t>(T) * kStride;
  bf16* vs = ks + static_cast<size_t>(T) * kStride;
  bf16* gs = vs + static_cast<size_t>(T) * kStride;
  float* row_max = reinterpret_cast<float*>(gs + static_cast<size_t>(T) * kStride);
  float* row_sum = row_max + T;
  float* row_delta = row_sum + T;
  float* bufs = row_delta + T;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const bf16* base = qkv + static_cast<size_t>(b) * T * row_stride + h * kHeadDim;
  const bf16* gbase = g + static_cast<size_t>(b) * T * D + h * kHeadDim;
  bf16* dbase = dqkv + static_cast<size_t>(b) * T * row_stride + h * kHeadDim;

  // Stage this head's q, k, v and g: 8 chunks of 16 bytes per token each.
  for (int idx = threadIdx.x; idx < T * 8; idx += kThreads) {
    const int t = idx >> 3;
    const int c = idx & 7;
    const bf16* src = base + t * row_stride + c * 8;
    const size_t so = static_cast<size_t>(t) * kStride + c * 8;
    store_row_chunk(qs + so, *reinterpret_cast<const uint4*>(src));
    store_row_chunk(ks + so, *reinterpret_cast<const uint4*>(src + D));
    store_row_chunk(vs + so, *reinterpret_cast<const uint4*>(src + 2 * D));
    store_row_chunk(gs + so, *reinterpret_cast<const uint4*>(gbase + static_cast<size_t>(t) * D + c * 8));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* buf_a = bufs + static_cast<size_t>(warp) * 2 * T;
  float* buf_b = buf_a + T;
  constexpr int kStride2 = kStride / 2;  // row stride in bf16 pairs

  // Phase 1: one warp per query row i -> dQ_i and the row statistics.
  for (int i = warp; i < T; i += kWarps) {
    const bf16* qi = qs + static_cast<size_t>(i) * kStride;
    const bf16* gi = gs + static_cast<size_t>(i) * kStride;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < T; j += 32) {
      const float s = score(qi, ks + static_cast<size_t>(j) * kStride, mask, i, j, T, scale);
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
      const float dp = dot_head(gi, vs + static_cast<size_t>(j) * kStride);
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
      const float2 kf = __bfloat1622float2(k2[j * kStride2]);
      ax = fmaf(dsj, kf.x, ax);
      ay = fmaf(dsj, kf.y, ay);
    }
    reinterpret_cast<__nv_bfloat162*>(dbase + static_cast<size_t>(i) * row_stride)[lane] =
        __floats2bfloat162_rn(ax, ay);
    __syncwarp();
  }
  __syncthreads();

  // Phase 2: one warp per key row j -> dK_j and dV_j.
  for (int j = warp; j < T; j += kWarps) {
    const bf16* kj = ks + static_cast<size_t>(j) * kStride;
    const bf16* vj = vs + static_cast<size_t>(j) * kStride;
    for (int i = lane; i < T; i += 32) {
      const float s = score(qs + static_cast<size_t>(i) * kStride, kj, mask, i, j, T, scale);
      const float p = __fdiv_rn(expf(__fsub_rn(s, row_max[i])), row_sum[i]);
      const float dp = dot_head(gs + static_cast<size_t>(i) * kStride, vj);
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
      const float2 qf = __bfloat1622float2(q2[i * kStride2]);
      const float2 gf = __bfloat1622float2(g2[i * kStride2]);
      kx = fmaf(dsi, qf.x, kx);
      ky = fmaf(dsi, qf.y, ky);
      vx = fmaf(pi, gf.x, vx);
      vy = fmaf(pi, gf.y, vy);
    }
    bf16* drow = dbase + static_cast<size_t>(j) * row_stride;
    reinterpret_cast<__nv_bfloat162*>(drow + D)[lane] = __floats2bfloat162_rn(kx, ky);
    reinterpret_cast<__nv_bfloat162*>(drow + 2 * D)[lane] = __floats2bfloat162_rn(vx, vy);
    __syncwarp();
  }
}

}  // namespace

// qkv (B, T, 3D) bf16, g (B, T, D) bf16, mask (T, T) fp32 or null, dqkv
// (B, T, 3D) bf16; all contiguous and 16-byte aligned, D = H * 64.
FMM_EXPORT int fmm_attention_core_bwd(const void* qkv, const void* g, const void* mask, void* dqkv,
                                      int B, int T, int D, int H, float scale, void* stream) {
  if (T < 1 || T > kMaxT || D != H * kHeadDim || B < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T);
  cudaError_t err = cudaFuncSetAttribute(attention_core_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_core_bwd_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), static_cast<const float*>(mask),
      static_cast<bf16*>(dqkv), T, D, H, scale);
  return cudaGetLastError();
}
