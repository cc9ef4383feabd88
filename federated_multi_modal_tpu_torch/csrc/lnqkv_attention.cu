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
// The fused kernel is built at head widths 16, 32 and 64 (HD, a template
// parameter of ln_qkv.cuh; other widths reach it zero-padded by the
// wrapper). Past 256 tokens, or at head widths 128 and 160, where a head's
// q, k and v (or the attention's accumulators in 512 threads' registers)
// do not fit, the wrapper takes the streamed route instead:
// fmm_lnqkv_project writes each head's q, k and v, 256 rows a block through
// the same LN -> QKV stage, into a (B, T, 3 Dq) bf16 scratch, and the
// attention streams the K and V tiles from there through attn_fwd.cuh's
// ring (attention_split.cu, K8's kernel, whose instances cover these
// widths; its q.k sums run on the bf16 tensor cores, not the fp64 ones).
// The scratch is the device-memory round trip that the fused kernel
// avoids: 6 B T Dq bytes more.
#include "attn_fwd.cuh"
#include "ln_qkv.cuh"

namespace {

using fmm::bf16;
namespace af = fmm::attn_fwd;
namespace lq = fmm::ln_qkv;

template <int HD>
__global__ void __launch_bounds__(lq::kThreads, 1)
    lnqkv_attention_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W,
                           const bf16* __restrict__ bias, const float* __restrict__ gamma,
                           const float* __restrict__ beta, const float2* __restrict__ stats,
                           bf16* __restrict__ out, int T, int Dk, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kLd = lq::Split<HD>::kLd;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  lq::project_head_resident<HD>(x + static_cast<size_t>(b) * T * Dk, W, bias, gamma, beta,
                                stats + static_cast<size_t>(b) * T, T, Dk, H, h, qs);

  const int Tp = lq::Layout<HD>(T).Tp;
  const int row0 = (threadIdx.x >> 5) * 16;
  if (row0 < T) {
    const bf16* ks = qs + static_cast<size_t>(Tp) * kLd;
    af::attend_resident<HD, false, true>(qs, ks, ks + static_cast<size_t>(Tp) * kLd, nullptr, T,
                                         T, row0, scale,
                                         out + static_cast<size_t>(b) * T * H * HD + h * HD,
                                         H * HD);
  }
}

// q, k and v of head h, rows [256 c, 256 c + 256) of batch row b (block
// (b, h, c)), into qkv (B, T, 3 H HD).
template <int HD>
__global__ void __launch_bounds__(lq::kThreads, 1)
    lnqkv_project_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W,
                         const bf16* __restrict__ bias, const float* __restrict__ gamma,
                         const float* __restrict__ beta, const float2* __restrict__ stats,
                         bf16* __restrict__ qkv, int T, int Dk, int H, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x % n_chunks;
  const int bh = blockIdx.x / n_chunks;
  const int h = bh % H;
  const int b = bh / H;
  const int r0 = c * lq::kMaxT;
  const int rows = min(lq::kMaxT, T - r0);
  const size_t rs = 3 * static_cast<size_t>(H) * HD;
  const size_t row = static_cast<size_t>(b) * T + r0;
  lq::project_head<HD>(x + row * Dk, W, bias, gamma, beta, stats + row, rows, Dk, H, h,
                       reinterpret_cast<bf16*>(smem),
                       lq::Dest{qkv + row * rs + h * HD, static_cast<size_t>(H) * HD, rs, rows});
}

template <int HD>
cudaError_t allow_smem(size_t bytes) {
  return cudaFuncSetAttribute(lnqkv_attention_kernel<HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int HD>
int launch_fused(const void* x, const void* W, const void* bias, const void* gamma,
                 const void* beta, const void* stats, void* out, int B, int T, int Dk, int H,
                 float scale, cudaStream_t s) {
  const size_t smem = lq::Layout<HD>(T).bytes;
  const cudaError_t err = allow_smem<HD>(smem);
  if (err != cudaSuccess) return err;
  lnqkv_attention_kernel<HD><<<B * H, lq::kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(W), static_cast<const bf16*>(bias),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float2*>(stats), static_cast<bf16*>(out), T, Dk, H, scale);
  return cudaGetLastError();
}

template <int HD>
int launch_project(const void* x, const void* W, const void* bias, const void* gamma,
                   const void* beta, const void* stats, void* qkv, int B, int T, int Dk, int H,
                   cudaStream_t s) {
  // the ring of a whole 256-row chunk
  const size_t smem = 2 * lq::Layout<HD>(lq::kMaxT).stage_elems * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(lnqkv_project_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_chunks = (T + lq::kMaxT - 1) / lq::kMaxT;
  lnqkv_project_kernel<HD><<<B * H * n_chunks, lq::kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(W), static_cast<const bf16*>(bias),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float2*>(stats), static_cast<bf16*>(qkv), T, Dk, H, n_chunks);
  return cudaGetLastError();
}

bool shapes_ok(int B, int T, int D, int Dk, int H) {
  return B >= 1 && T >= 1 && H >= 1 && D >= 1 && D <= Dk && Dk % lq::kBk == 0;
}

}  // namespace

// x (B, T, Dk) bf16 (the model's D columns, then zeros), W (Dk, 3 H HD)
// bf16, bias (3 H HD,) bf16, gamma and beta (Dk,) fp32 (zeros past D), stats
// a (B, T, 2) fp32 scratch for the LN moments, out (B, T, H HD) bf16;
// contiguous and 16-byte aligned; Dk a multiple of 64; head width HD 16, 32
// or 64; T <= 256.
FMM_EXPORT int fmm_lnqkv_attention(const void* x, const void* W, const void* bias,
                                   const void* gamma, const void* beta, void* stats, void* out,
                                   int B, int T, int D, int Dk, int H, int HD, float scale,
                                   void* stream) {
  if (!shapes_ok(B, T, D, Dk, H) || T > lq::kMaxT) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = lq::launch_moments(static_cast<const bf16*>(x),
                                             static_cast<float2*>(stats), B * T, D, Dk, s);
  if (err != cudaSuccess) return err;
  switch (HD) {
#define FMM_LAUNCH(n) \
  case n:             \
    return launch_fused<n>(x, W, bias, gamma, beta, stats, out, B, T, Dk, H, scale, s);
    FMM_LAUNCH(16) FMM_LAUNCH(32) FMM_LAUNCH(64)
#undef FMM_LAUNCH
    default:
      return cudaErrorInvalidValue;
  }
}

// The streamed route's first half: the LN moments into stats, then q, k and
// v of every head into qkv (B, T, 3 H HD) bf16; the other operands as
// fmm_lnqkv_attention's; any T; head width HD 16, 32, 64, 128 or 160.
FMM_EXPORT int fmm_lnqkv_project(const void* x, const void* W, const void* bias,
                                 const void* gamma, const void* beta, void* stats, void* qkv,
                                 int B, int T, int D, int Dk, int H, int HD, void* stream) {
  if (!shapes_ok(B, T, D, Dk, H)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = lq::launch_moments(static_cast<const bf16*>(x),
                                             static_cast<float2*>(stats), B * T, D, Dk, s);
  if (err != cudaSuccess) return err;
  switch (HD) {
#define FMM_LAUNCH(n) \
  case n:             \
    return launch_project<n>(x, W, bias, gamma, beta, stats, qkv, B, T, Dk, H, s);
    FMM_LAUNCH(16) FMM_LAUNCH(32) FMM_LAUNCH(64) FMM_LAUNCH(128) FMM_LAUNCH(160)
#undef FMM_LAUNCH
    default:
      return cudaErrorInvalidValue;
  }
}

// Resident blocks per SM of the fused kernel at head width 64 and T tokens
// (registers and shared memory as built) into *blocks, its dynamic shared
// memory into *smem_bytes; `masked` is unused (the kernel has no mask).
FMM_EXPORT int fmm_lnqkv_attention_blocks_per_sm(int T, int masked, int* blocks,
                                                 int* smem_bytes) {
  (void)masked;
  if (T < 1 || T > lq::kMaxT) return cudaErrorInvalidValue;
  const size_t smem = lq::Layout<64>(T).bytes;
  const cudaError_t err = allow_smem<64>(smem);
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lnqkv_attention_kernel<64>,
                                                       lq::kThreads, smem);
}
