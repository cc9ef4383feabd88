// attention_core: per (row b, head h) softmax(q k^T * scale + M) v, read
// straight from a packed (B, T, 3D) bf16 QKV tensor.
//
// Replaces the attention of two TPU kernels:
//   * federated_multi_modal_tpu/ops/pallas/attention.py
//     attention_packed_fwd_masked (behind packed_attention_masked), the text
//     tower's block-causal packed rows;
//   * the per-head loop of _block_body32 in ops/pallas/fused_block.py
//     (behind fused_block_residual), the vision tower, with no mask.
// Numerics follow the TPU kernels: fp32 scores and softmax, keys at index
// >= valid_T set to -inf, p rounded to bf16 before P.V, fp32 P.V sums, bf16
// output.
//
// Bound on the H100: at the text shape (200, 120, 1536) a launch moves
// ~98 MB (qkv in, out back) for ~6 GFLOP, and at the vision shape
// (512, 199, 2304) ~626 MB for ~62 GFLOP; both are bound by memory at
// 3.35 TB/s (~29 us and ~0.19 ms).
// Design: one thread block per (b, h) stages its q, k and v head slices in
// shared memory once, so each qkv byte is read once from device memory, as
// the bound counts it. The products run on the CUDA cores in fp32, one warp
// per query row: lanes own keys for q.k (K rows padded to 66 elements so
// that 32 lanes read 32 different banks) and own two output columns each
// for P.V. That makes the kernel bound by fp32 issue rate, not by memory;
// moving both products onto the tensor cores (mma or wgmma) is the step
// that would bring it to its bound.
#include <math_constants.h>
#include <stdint.h>

#include "fmm_common.cuh"

namespace {

using fmm::bf16;

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKStride = kHeadDim + 2;
// 227 KB of shared memory per block: q, v (128 B/token), k (132 B/token)
// and one fp32 probability row per warp (32 B/token) fit up to T = 553.
constexpr int kMaxT = 512;

size_t smem_bytes(int T) {
  return static_cast<size_t>(T) * (2 * kHeadDim * sizeof(bf16) + kKStride * sizeof(bf16) +
                                   kWarps * sizeof(float));
}

__global__ void __launch_bounds__(kThreads)
    attention_core_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                          bf16* __restrict__ out, int T, int D, int H, int valid_T,
                          float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* vs = qs + static_cast<size_t>(T) * kHeadDim;
  bf16* ks = vs + static_cast<size_t>(T) * kHeadDim;
  float* prob = reinterpret_cast<float*>(ks + static_cast<size_t>(T) * kKStride);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const bf16* base = qkv + static_cast<size_t>(b) * T * row_stride + h * kHeadDim;

  // Stage this head's q, k and v: 8 chunks of 16 bytes per token each.
  for (int idx = threadIdx.x; idx < T * 8; idx += kThreads) {
    const int t = idx >> 3;
    const int c = idx & 7;
    const bf16* src = base + t * row_stride + c * 8;
    const uint4 qv = *reinterpret_cast<const uint4*>(src);
    const uint4 kv = *reinterpret_cast<const uint4*>(src + D);
    const uint4 vv = *reinterpret_cast<const uint4*>(src + 2 * D);
    *reinterpret_cast<uint4*>(qs + t * kHeadDim + c * 8) = qv;
    *reinterpret_cast<uint4*>(vs + t * kHeadDim + c * 8) = vv;
    uint32_t* kd = reinterpret_cast<uint32_t*>(ks + t * kKStride + c * 8);
    kd[0] = kv.x;
    kd[1] = kv.y;
    kd[2] = kv.z;
    kd[3] = kv.w;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* p = prob + warp * T;
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(vs) + lane;

  for (int i = warp; i < T; i += kWarps) {
    const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(qs + i * kHeadDim);
    float row_max = -CUDART_INF_F;
    for (int j = lane; j < T; j += 32) {
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(ks + j * kKStride);
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim / 2; ++d) {
        const float2 qf = __bfloat1622float2(q2[d]);
        const float2 kf = __bfloat1622float2(k2[d]);
        acc = fmaf(qf.x, kf.x, acc);
        acc = fmaf(qf.y, kf.y, acc);
      }
      float s = acc * scale;
      if (mask != nullptr) s += mask[static_cast<size_t>(i) * T + j];
      if (j >= valid_T) s = -CUDART_INF_F;
      p[j] = s;
      row_max = fmaxf(row_max, s);
    }
    row_max = fmm::warp_max(row_max);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(p[j] - row_max);
      p[j] = e;
      sum += e;
    }
    sum = fmm::warp_sum(sum);
    for (int j = lane; j < T; j += 32) p[j] = __bfloat162float(__float2bfloat16(p[j] / sum));
    __syncwarp();

    float ox = 0.f;
    float oy = 0.f;
    for (int j = 0; j < T; ++j) {
      const float pj = p[j];
      const float2 vf = __bfloat1622float2(v2[j * (kHeadDim / 2)]);
      ox = fmaf(pj, vf.x, ox);
      oy = fmaf(pj, vf.y, oy);
    }
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
                              out + (static_cast<size_t>(b) * T + i) * D + h * kHeadDim) +
                          lane;
    *dst = __floats2bfloat162_rn(ox, oy);
    __syncwarp();
  }
}

}  // namespace

// qkv (B, T, 3D) bf16, mask (T, T) fp32 or null, out (B, T, D) bf16; all
// contiguous, D = H * 64.
FMM_EXPORT int fmm_attention_core(const void* qkv, const void* mask, void* out, int B, int T,
                                  int D, int H, int valid_T, float scale, void* stream) {
  if (T < 1 || T > kMaxT || D != H * kHeadDim || B < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_core_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(mask), static_cast<bf16*>(out), T,
      D, H, valid_T, scale);
  return cudaGetLastError();
}
