// attention_split: per (row b, head h) softmax(q k^T * scale + M) v over three
// separate (B, T, D) bf16 operands, each with its own row stride, for any head
// width that is a multiple of 8 up to 128.
//
// Replaces federated_multi_modal_tpu/ops/pallas/attention.py fused_attention
// (_attn_kernel_nomask at pallas_call :127, _attn_kernel at :147), the
// attention that multi_head_attention runs when T >= 32 and the heads do not
// pack into 128 lanes (behind fused_attention_diff and
// multi_head_attention_pallas). The row strides let the caller pass the
// column split of a packed (B, T, 3D) QKV tensor with no copy. Numerics
// follow _attn_body: fp32 scores and softmax, the additive fp32 mask, p
// rounded to bf16 before P.V, fp32 P.V sums, bf16 output. The TPU kernel pads
// T to a multiple of 8 and sets the padded keys to -inf; here every block
// handles its exact T, which gives the same result.
//
// Bound on the H100: bytes. At (64, 257, 1280) with 16 heads of 80 a launch
// reads q, k and v and writes the output, 168 MB (~50 us at 3.35 TB/s), for
// 21.6 GFLOP (~22 us at 989 TFLOP/s); at (256, 77, 768) with 8 heads of 96 and
// a causal mask ~121 MB (~36 us) for ~2.4 GFLOP on the mask's finite pairs.
// Design: attention_core.cu's, with the head width a template parameter: one
// thread block per (b, h) stages its q, k and v slices in shared memory once
// (k rows padded by two elements so that 32 lanes read 32 banks), one warp
// per query row, lanes own keys for q.k and one or two bf16 pairs of output
// columns for P.V. The products run on the CUDA cores in fp32, so the kernel
// is bound by fp32 issue rate, not by memory; the tensor cores are the step
// that would bring it to its bound. Shared memory caps T: q, v (4 HD bytes a
// token), k (2 HD + 4) and one fp32 probability row per warp (32) within the
// 227 KB a block may use, 553 tokens at HD = 64 and 289 at HD = 128.
#include <math_constants.h>
#include <stdint.h>

#include "fmm_common.cuh"

namespace {

using fmm::bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kMaxSmem = 232448;

size_t smem_bytes(int T, int hd) {
  return static_cast<size_t>(T) *
         (2 * hd * sizeof(bf16) + (hd + 2) * sizeof(bf16) + kWarps * sizeof(float));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    attention_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, int q_stride, int k_stride, int v_stride,
                           const float* __restrict__ mask, bf16* __restrict__ out, int T, int D,
                           int H, float scale) {
  constexpr int kKStride = HD + 2;
  constexpr int kChunks = HD / 8;
  constexpr int kPairs = HD / 2;
  constexpr int kPairsPerLane = (kPairs + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* vs = qs + static_cast<size_t>(T) * HD;
  bf16* ks = vs + static_cast<size_t>(T) * HD;
  float* prob = reinterpret_cast<float*>(ks + static_cast<size_t>(T) * kKStride);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const bf16* qb = q + static_cast<size_t>(b) * T * q_stride + h * HD;
  const bf16* kb = k + static_cast<size_t>(b) * T * k_stride + h * HD;
  const bf16* vb = v + static_cast<size_t>(b) * T * v_stride + h * HD;

  // Stage this head's q, k and v: HD / 8 chunks of 16 bytes per token each.
  for (int idx = threadIdx.x; idx < T * kChunks; idx += kThreads) {
    const int t = idx / kChunks;
    const int c = idx % kChunks;
    const uint4 qv = *reinterpret_cast<const uint4*>(qb + static_cast<size_t>(t) * q_stride + c * 8);
    const uint4 kv = *reinterpret_cast<const uint4*>(kb + static_cast<size_t>(t) * k_stride + c * 8);
    const uint4 vv = *reinterpret_cast<const uint4*>(vb + static_cast<size_t>(t) * v_stride + c * 8);
    *reinterpret_cast<uint4*>(qs + t * HD + c * 8) = qv;
    *reinterpret_cast<uint4*>(vs + t * HD + c * 8) = vv;
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

  for (int i = warp; i < T; i += kWarps) {
    const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(qs + i * HD);
    float row_max = -CUDART_INF_F;
    for (int j = lane; j < T; j += 32) {
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(ks + j * kKStride);
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kPairs; ++d) {
        const float2 qf = __bfloat1622float2(q2[d]);
        const float2 kf = __bfloat1622float2(k2[d]);
        acc = fmaf(qf.x, kf.x, acc);
        acc = fmaf(qf.y, kf.y, acc);
      }
      float s = acc * scale;
      if (mask != nullptr) s += mask[static_cast<size_t>(i) * T + j];
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

    float2 acc[kPairsPerLane];
#pragma unroll
    for (int u = 0; u < kPairsPerLane; ++u) acc[u] = make_float2(0.f, 0.f);
    for (int j = 0; j < T; ++j) {
      const float pj = p[j];
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(vs + j * HD);
#pragma unroll
      for (int u = 0; u < kPairsPerLane; ++u) {
        const int c = lane + 32 * u;
        if (c < kPairs) {
          const float2 vf = __bfloat1622float2(v2[c]);
          acc[u].x = fmaf(pj, vf.x, acc[u].x);
          acc[u].y = fmaf(pj, vf.y, acc[u].y);
        }
      }
    }
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        out + (static_cast<size_t>(b) * T + i) * D + h * HD);
#pragma unroll
    for (int u = 0; u < kPairsPerLane; ++u) {
      const int c = lane + 32 * u;
      if (c < kPairs) dst[c] = __floats2bfloat162_rn(acc[u].x, acc[u].y);
    }
    __syncwarp();
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, int q_stride, int k_stride,
           int v_stride, const void* mask, void* out, int B, int T, int D, int H, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(T, HD);
  cudaError_t err = cudaFuncSetAttribute(
      attention_split_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_split_kernel<HD><<<B * H, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      q_stride, k_stride, v_stride, static_cast<const float*>(mask), static_cast<bf16*>(out), T,
      D, H, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v (B, T, D) bf16 with row strides q_stride, k_stride, v_stride (in
// elements; each a multiple of 8, batch stride T * row stride, 16-byte aligned
// base), mask (T, T) fp32 contiguous or null, out (B, T, D) bf16 contiguous;
// D = H * head_dim with head_dim a multiple of 8 up to 128.
FMM_EXPORT int fmm_attention_split(const void* q, const void* k, const void* v, int q_stride,
                                   int k_stride, int v_stride, const void* mask, void* out,
                                   int B, int T, int D, int H, int head_dim, float scale,
                                   void* stream) {
  if (B < 1 || T < 1 || H < 1 || D != H * head_dim || q_stride % 8 || k_stride % 8 ||
      v_stride % 8 || q_stride < D || k_stride < D || v_stride < D ||
      smem_bytes(T, head_dim) > kMaxSmem)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define FMM_HEAD_DIM(n) \
  case n:               \
    return launch<n>(q, k, v, q_stride, k_stride, v_stride, mask, out, B, T, D, H, scale, s);
    FMM_HEAD_DIM(8)
    FMM_HEAD_DIM(16)
    FMM_HEAD_DIM(24)
    FMM_HEAD_DIM(32)
    FMM_HEAD_DIM(40)
    FMM_HEAD_DIM(48)
    FMM_HEAD_DIM(56)
    FMM_HEAD_DIM(64)
    FMM_HEAD_DIM(72)
    FMM_HEAD_DIM(80)
    FMM_HEAD_DIM(88)
    FMM_HEAD_DIM(96)
    FMM_HEAD_DIM(104)
    FMM_HEAD_DIM(112)
    FMM_HEAD_DIM(120)
    FMM_HEAD_DIM(128)
#undef FMM_HEAD_DIM
    default:
      return cudaErrorInvalidValue;
  }
}
