// lnqkv_attention: LN1 -> QKV product -> attention in one kernel, QKV never
// written to device memory. out (B, T, D) = per head h
//   softmax(q_h k_h^T * scale) v_h,  [q | k | v] = bf16(bf16(LN(x)) . W + b)
// (the out-projection is not part of it).
//
// Replaces the prototype TPU kernel
// tools/attn_microbench.py::fused_lnqkv_attention (pallas_call at :110), with
// its numerics: LN in fp32 (eps 1e-5), the normalized x rounded to bf16, the
// QKV product in fp32 sums with the (bf16) bias added in fp32 before one
// rounding, fp32 scores and softmax, p rounded to bf16 before P.V.
//
// Bound on the H100: operations. At x (512, 200, 768) bf16 and W (768, 2304)
// the QKV product is 362 GFLOP and the attention 63 GFLOP: 0.430 ms at
// 989 TFLOP/s, against 0.095 ms to read x and W and write out (318 MB).
// Design: the TPU kernel keeps a (GB, T, D) block of x and all of W (3.4 MB)
// in VMEM; an SM has 227 KB. So one thread block per (b, head h) computes the
// row moments of x[b], then the head's 192 QKV columns as three 64-column
// products whose contraction over D streams in steps of 32 (the normalized
// x tile built in shared memory from x, W's fragments read from device
// memory and L2), wmma bf16 with fp32 accumulators; the bias is added in
// fp32 and q, k and v (T x 64 each) stay in shared memory, where the
// head's attention runs on the tensor cores as attention_pair.cu's does
// (head_tc.cuh). The LN moments and the reads of x repeat for each of the 12
// heads (and each of q, k and v): x[b] is read 36 times, from L2 after the
// first; sharing them across a row's heads, and wgmma, are the later steps.
#include "head_tc.cuh"

namespace {

using fmm::bf16;
namespace ht = fmm::head_tc;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 240;

__host__ __device__ size_t sbuf_bytes(int Tp) {
  const size_t scores = static_cast<size_t>(kWarps) * ht::warp_tile_floats(Tp) * sizeof(float);
  const size_t stage = ht::ln_qkv_stage_bytes(Tp, kWarps);
  return scores > stage ? scores : stage;
}

size_t smem_bytes(int Tp) {
  return static_cast<size_t>(Tp) * 3 * ht::kLd * sizeof(bf16) + sbuf_bytes(Tp) +
         2 * static_cast<size_t>(Tp) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
    lnqkv_attention_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W,
                           const bf16* __restrict__ bias, const float* __restrict__ gamma,
                           const float* __restrict__ beta, bf16* __restrict__ out, int T, int D,
                           int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Tp = ht::round16(T);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + static_cast<size_t>(Tp) * ht::kLd;
  bf16* vs = ks + static_cast<size_t>(Tp) * ht::kLd;
  unsigned char* region = reinterpret_cast<unsigned char*>(vs + static_cast<size_t>(Tp) * ht::kLd);
  float* mu = reinterpret_cast<float*>(region + sbuf_bytes(Tp));
  float* rstd = mu + Tp;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const bf16* xb = x + static_cast<size_t>(b) * T * D;
  ht::ln_moments<kWarps>(xb, T, D, 1e-5f, mu, rstd);
  // ln_qkv_head starts with a barrier, which also publishes the moments
  ht::ln_qkv_head<kWarps>(xb, W, bias, gamma, beta, mu, rstd, T, Tp, D, h, qs, ks, vs,
                          reinterpret_cast<bf16*>(region));
  __syncthreads();  // q, k, v complete; the stage becomes score tiles
  ht::attention_head<kWarps>(qs, ks, vs, T, Tp, T, scale, reinterpret_cast<float*>(region),
                             out + static_cast<size_t>(b) * T * D + h * ht::kHd, D);
}

}  // namespace

// x (B, T, D) bf16, W (D, 3D) bf16, bias (3D,) bf16, gamma and beta (D,)
// fp32, out (B, T, D) bf16; contiguous and 16-byte aligned; D = 64 H and a
// multiple of 32; T <= 240.
FMM_EXPORT int fmm_lnqkv_attention(const void* x, const void* W, const void* bias,
                                   const void* gamma, const void* beta, void* out, int B, int T,
                                   int D, int H, float scale, void* stream) {
  if (T < 1 || T > kMaxT || B < 1 || D != H * ht::kHd || D % ht::kBk != 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(ht::round16(T));
  cudaError_t err = cudaFuncSetAttribute(lnqkv_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lnqkv_attention_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(W), static_cast<const bf16*>(bias),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<bf16*>(out),
      T, D, H, scale);
  return cudaGetLastError();
}
