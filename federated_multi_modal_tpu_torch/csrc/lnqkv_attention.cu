// lnqkv_attention: LN1 -> QKV product -> attention in one kernel, QKV never
// written to device memory. out (B, T, D) = per head h
//   softmax(q_h k_h^T * scale) v_h,  [q | k | v] = bf16(bf16(LN(x)) . W + b)
// (the out-projection is not part of it).
//
// Replaces the prototype TPU kernel
// tools/attn_microbench.py::fused_lnqkv_attention (pallas_call at :110), with
// its numerics: LN in fp32 (eps 1e-5), the normalized x rounded to bf16, the
// QKV product in fp32 sums with the (bf16) bias added in fp32 before one
// rounding, fp32 scores and softmax, p normalized and then rounded to bf16
// before P.V.
//
// Bound on the H100: operations. At x (512, 200, 768) bf16 and W (768, 2304)
// the QKV product is 362 GFLOP and the attention 63 GFLOP: 0.430 ms at
// 989 TFLOP/s, against 0.095 ms to read x and W and write out (318 MB).
// Design: the TPU kernel keeps a (GB, T, D) block of x and all of W (3.4 MB)
// in VMEM; an SM has 227 KB, and a head's q, k and v at T = 256 take 108 KB.
// So one block of 16 warps per (b, head h):
// * the LN moments of each row come once per row, not once per head, from a
//   small first launch into a (B, T, 2) fp32 scratch (one warp a row);
// * the head's q, k and v come from ln_qkv.cuh's LN -> QKV stage (a tiled
//   mma.sync GEMM through a two-stage cp.async ring, x normalized once per
//   head, the bias added in fp32 before one rounding) into shared memory;
//   P2 recomputes them with the same code;
// * the attention runs from there through attn_fwd.cuh's tile routine (two
//   passes over the resident key tiles, no barrier; the scores correctly
//   rounded from the fp64 tensor cores, as attention_core.cu's), warp w
//   taking query rows [16 w, 16 w + 16).
// T is bounded by the 16 warps x 16 query rows (and 8 x 32 GEMM rows): T <=
// 256, where shared memory is 122 KB; registers (512 threads, at most 128
// each) hold one block an SM. That is what holds it back: with no second
// block to switch to, each 64-deep step's copies, normalization and two
// barriers stall the SM beside its MMAs, and the attention's two passes
// (there is no register room for one) run its fp64 q.k and expf twice.
#include "attn_fwd.cuh"
#include "ln_qkv.cuh"

namespace {

using fmm::bf16;
namespace af = fmm::attn_fwd;
namespace lq = fmm::ln_qkv;

__global__ void __launch_bounds__(lq::kThreads, 1)
    lnqkv_attention_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W,
                           const bf16* __restrict__ bias, const float* __restrict__ gamma,
                           const float* __restrict__ beta, const float2* __restrict__ stats,
                           bf16* __restrict__ out, int T, int D, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  lq::project_head(x + static_cast<size_t>(b) * T * D, W, bias, gamma, beta,
                   stats + static_cast<size_t>(b) * T, T, D, h, qs);

  const int Tp = lq::Layout(T).Tp;
  const int row0 = (threadIdx.x >> 5) * 16;
  if (row0 < T) {
    const bf16* ks = qs + static_cast<size_t>(Tp) * lq::kLd;
    af::attend_resident<lq::kHd, false, true>(qs, ks, ks + static_cast<size_t>(Tp) * lq::kLd,
                                              nullptr, T, T, row0, scale,
                                              out + static_cast<size_t>(b) * T * D + h * lq::kHd,
                                              D);
  }
}

cudaError_t allow_smem(size_t bytes) {
  return cudaFuncSetAttribute(lnqkv_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// x (B, T, D) bf16, W (D, 3D) bf16, bias (3D,) bf16, gamma and beta (D,)
// fp32, stats a (B, T, 2) fp32 scratch for the LN moments, out (B, T, D)
// bf16; contiguous and 16-byte aligned; D = 64 H; T <= 256.
FMM_EXPORT int fmm_lnqkv_attention(const void* x, const void* W, const void* bias,
                                   const void* gamma, const void* beta, void* stats, void* out,
                                   int B, int T, int D, int H, float scale, void* stream) {
  if (T < 1 || T > lq::kMaxT || B < 1 || H < 1 || D != H * lq::kHd) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = lq::launch_moments(static_cast<const bf16*>(x), static_cast<float2*>(stats),
                                       B * T, D, s);
  if (err != cudaSuccess) return err;
  const size_t smem = lq::Layout(T).bytes;
  err = allow_smem(smem);
  if (err != cudaSuccess) return err;
  lnqkv_attention_kernel<<<B * H, lq::kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(W), static_cast<const bf16*>(bias),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float2*>(stats), static_cast<bf16*>(out), T, D, H, scale);
  return cudaGetLastError();
}

// Resident blocks per SM of the main kernel at T tokens (registers and
// shared memory as built) into *blocks, its dynamic shared memory into
// *smem_bytes; `masked` is unused (the kernel has no mask).
FMM_EXPORT int fmm_lnqkv_attention_blocks_per_sm(int T, int masked, int* blocks,
                                                 int* smem_bytes) {
  (void)masked;
  if (T < 1 || T > lq::kMaxT) return cudaErrorInvalidValue;
  const size_t smem = lq::Layout(T).bytes;
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lnqkv_attention_kernel,
                                                       lq::kThreads, smem);
}
