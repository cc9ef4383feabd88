// lnqkv_attention_bwd: the attention half of P2, dx of lnqkv_attention for
// the output cotangent dy, recomputed from x alone: per (row b, head h) the
// head's q, k and v (LN -> QKV) and its attention backward, written as a
// packed d(QKV) (B, T, 3D) bf16 scratch. The wrapper
// (ops/kernels/prototypes.py::fused_lnqkv_attention_bwd_dx_cuda) follows it
// with dxn = d(QKV) . W^T on gemm_wgmma.cu and the LayerNorm backward on
// layernorm_bwd_rows.cu.
//
// Replaces the prototype TPU kernel
// tools/attn_microbench.py::fused_lnqkv_attention_bwd_dx (pallas_call at
// :207), with its numerics: per head, with g the head's slice of dy,
//   dv = P^T g (p rounded to bf16), dp = g v^T (fp32),
//   ds = bf16(p32 * (dp - rowsum(dp * p32)) * scale),
//   dq = ds k, dk = ds^T q, each rounded to bf16;
//   dxn = [dq | dk | dv] . W^T summed in fp32 over every head;
//   dx = rstd * (dxn gamma - mean(dxn gamma) - xhat mean(dxn gamma xhat)).
// Like the TPU kernel it computes no parameter gradient. The scores are
// summed on the bf16 tensor cores (fp32 accumulate), as the attention
// backward's (attention_core_bwd.cu); P2 is held to its plain version at
// 2^-5 of the largest value.
//
// Bound on the H100 (the whole of P2): operations. At x (512, 200, 768) the
// attention backward is 126 GFLOP and dxn 362 GFLOP: 0.494 ms at 989
// TFLOP/s (the recomputation not counted), against ~0.16 ms for x, dy, W
// and dx.
// Design: the TPU kernel keeps a batch row's whole (T, D) dxn in VMEM and
// runs its heads one after another; on the H100 that gave one block per
// row b (512 blocks) and a per-head read-modify-write of dxn in device
// memory. Here the sum over heads is the contraction of one GEMM instead:
// 1. the LN moments of each row, from ln_qkv.cuh's moments launch (P1's) into
//    a (B, T, 2) fp32 scratch;
// 2. one block of 16 warps per (b, h), 6,144 blocks at the shape above: the
//    head's q, k and v from ln_qkv.cuh's LN -> QKV stage into shared memory
//    (the bits P1 computes), g_h beside them (its copies overlap the GEMM's
//    first step), then the attention backward from the resident tiles with
//    attn_bwd.cuh's routines, every product on the tensor cores and S, dP,
//    P and dS in registers: the row statistics (lse, delta) of warp w's 16
//    query rows into shared memory; dK and dV of warp w's 16 key rows; dQ of
//    its 16 query rows. Score tiles are 16 x 32 (N8 = 4): 512 threads hold
//    at most 128 registers each, and dK, dV and two 16 x 64 score tiles
//    would not fit. dq, dk and dv are rounded to bf16, as the TPU kernel
//    rounds them before its concat, into the (B, T, 3D) scratch. No atomics.
// 3. dxn = d(QKV) . W^T (gemm_wgmma.cu: wgmma fed by TMA), fp32 (B T, D);
// 4. dx from layernorm_bwd_rows.cu with no residual branch and no dgamma
//    or dbeta partials.
// No sum crosses blocks, so P2 repeats bit for bit. T <= 256: 16 warps of 16
// rows, and q, k, v and g of 256 rows (plus the GEMM stage's ring) take
// 151 KB of shared memory, one block an SM. Built at head widths 16, 32 and
// 64 (HD, as P1's fused kernel; the wrapper zero-pads other widths' W, bias
// and dy columns to the next instance). Past 256 tokens, or at head widths
// 128 and 160, where dK and dV of a warp's rows do not fit beside the scores
// in 128 registers, the wrapper streams instead: q, k and v from P1's
// fmm_lnqkv_project into a (B, T, 3 Dq) scratch, then attention_core_bwd.cu's
// three passes (attn_bwd.cuh's key loop, keys streamed) into the d(QKV)
// scratch, then steps 3 and 4 as here.
#include "attn_bwd.cuh"
#include "ln_qkv.cuh"

namespace {

using fmm::bf16;
namespace am = fmm::attn_mma;
namespace ab = fmm::attn_bwd;
namespace lq = fmm::ln_qkv;

constexpr int kN8 = 4;               // 32-column score tiles
constexpr int kStep = 8 * kN8;       // keys or queries a step takes

// Shared memory at T: ln_qkv.cuh's region (its ring, then q, k and v),
// g_h (Tp rows), then lse and delta (Tp floats each).
template <int HD>
struct Layout {
  int Tp;
  size_t g_off, stats_off, bytes;
  __host__ __device__ explicit Layout(int T) {
    const lq::Layout<HD> L(T);
    Tp = L.Tp;
    g_off = L.bytes;
    stats_off = g_off + static_cast<size_t>(Tp) * lq::Split<HD>::kLd * sizeof(bf16);
    bytes = stats_off + 2 * static_cast<size_t>(Tp) * sizeof(float);
  }
};

template <int HD>
__global__ void __launch_bounds__(lq::kThreads, 1)
    lnqkv_attention_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W,
                               const bf16* __restrict__ bias, const float* __restrict__ gamma,
                               const float* __restrict__ beta, const float2* __restrict__ stats,
                               const bf16* __restrict__ dy, bf16* __restrict__ dqkv, int T,
                               int Dk, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kLd = lq::Split<HD>::kLd;
  const Layout<HD> L(T);
  const int Tp = L.Tp;
  const int Dq = H * HD;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + static_cast<size_t>(Tp) * kLd;
  bf16* vs = ks + static_cast<size_t>(Tp) * kLd;
  bf16* gs = reinterpret_cast<bf16*>(smem + L.g_off);
  float* lse = reinterpret_cast<float*>(smem + L.stats_off);
  float* delta = lse + Tp;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;

  // g_h, rows [0, Tp) (zeros at or past T): its copies join the LN -> QKV
  // stage's first copy group. lse and delta start at zero, the value the
  // rows at or past T keep (their probabilities and dS are zero).
  const bf16* gb = dy + static_cast<size_t>(b) * T * Dq + h * HD;
  for (int r0 = 0; r0 < Tp; r0 += am::kTile)
    am::load_tile<HD, lq::kThreads>(gs + r0 * kLd, kLd, gb, Dq, r0, T);
  for (int i = threadIdx.x; i < 2 * Tp; i += lq::kThreads) lse[i] = 0.f;
  lq::project_head_resident<HD>(x + static_cast<size_t>(b) * T * Dk, W, bias, gamma, beta,
                                stats + static_cast<size_t>(b) * T, T, Dk, H, h, qs);

  const int row0 = (threadIdx.x >> 5) * 16;  // warp w: rows [16 w, 16 w + 16)
  const float inv_scale = 1.f / scale;

  // 1. lse and delta of the warp's query rows.
  if (row0 < T) {
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l[2] = {0.f, 0.f};
    float d[2] = {0.f, 0.f};
    for (int c = 0; c < T; c += kStep)
      ab::stats_step<HD, false, kN8>(m, l, d, nullptr, T, row0, c, scale, inv_scale, qs, gs,
                                     row0, ks + c * kLd, vs + c * kLd);
    ab::stats_rows(m, l, d, row0, T, lse, delta);
  }
  __syncthreads();
  if (row0 >= T) return;

  const size_t rs = 3 * static_cast<size_t>(Dq);
  bf16* out = dqkv + static_cast<size_t>(b) * T * rs + h * HD;
  // 2. dK and dV of the warp's key rows.
  {
    float dk[am::Shape<HD>::kNt][4], dv[am::Shape<HD>::kNt][4];
    ab::zero_tile(dk);
    ab::zero_tile(dv);
    for (int c = 0; c < T; c += kStep)
      ab::dkdv_step<HD, false, kN8>(dk, dv, nullptr, T, row0, c, scale, inv_scale, ks, vs,
                                    row0, qs + c * kLd, gs + c * kLd, lse + c, delta + c);
    ab::store_rows<HD>(dk, out + Dq, rs, row0, T);
    ab::store_rows<HD>(dv, out + 2 * Dq, rs, row0, T);
  }
  // 3. dQ of the warp's query rows.
  const int lane = threadIdx.x & 31;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = lse[row0 + (lane >> 2) + 8 * r];
    delta_r[r] = delta[row0 + (lane >> 2) + 8 * r];
  }
  float dq[am::Shape<HD>::kNt][4];
  ab::zero_tile(dq);
  for (int c = 0; c < T; c += kStep)
    ab::dq_step<HD, false, kN8>(dq, nullptr, T, row0, c, scale, inv_scale, qs, gs, row0,
                                ks + c * kLd, vs + c * kLd, lse_r, delta_r);
  ab::store_rows<HD>(dq, out, rs, row0, T);
}

template <int HD>
cudaError_t allow_smem(size_t bytes) {
  return cudaFuncSetAttribute(lnqkv_attention_bwd_kernel<HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int HD>
int launch(const void* x, const void* W, const void* bias, const void* gamma, const void* beta,
           const void* dy, const void* stats, void* dqkv, int B, int T, int Dk, int H,
           float scale, cudaStream_t s) {
  const size_t smem = Layout<HD>(T).bytes;
  const cudaError_t err = allow_smem<HD>(smem);
  if (err != cudaSuccess) return err;
  lnqkv_attention_bwd_kernel<HD><<<B * H, lq::kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(W), static_cast<const bf16*>(bias),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float2*>(stats), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dqkv), T, Dk, H, scale);
  return cudaGetLastError();
}

}  // namespace

// x (B, T, Dk) bf16 (the model's D columns, then zeros), W (Dk, 3 H HD)
// bf16, bias (3 H HD,) bf16, gamma and beta (Dk,) fp32, dy (B, T, H HD)
// bf16, stats a (B, T, 2) fp32 scratch for the LN moments, dqkv
// (B, T, 3 H HD) bf16 out; contiguous and 16-byte aligned; Dk a multiple of
// 64; head width HD 16, 32 or 64; T <= 256. Launches the moments and the
// attention backward.
FMM_EXPORT int fmm_lnqkv_attention_bwd_dqkv(const void* x, const void* W, const void* bias,
                                            const void* gamma, const void* beta, const void* dy,
                                            void* stats, void* dqkv, int B, int T, int D,
                                            int Dk, int H, int HD, float scale, void* stream) {
  if (T < 1 || T > lq::kMaxT || B < 1 || H < 1 || D < 1 || D > Dk || Dk % lq::kBk)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = lq::launch_moments(static_cast<const bf16*>(x),
                                             static_cast<float2*>(stats), B * T, D, Dk, s);
  if (err != cudaSuccess) return err;
  switch (HD) {
#define FMM_LAUNCH(n) \
  case n:             \
    return launch<n>(x, W, bias, gamma, beta, dy, stats, dqkv, B, T, Dk, H, scale, s);
    FMM_LAUNCH(16) FMM_LAUNCH(32) FMM_LAUNCH(64)
#undef FMM_LAUNCH
    default:
      return cudaErrorInvalidValue;
  }
}

// Resident blocks per SM of the attention kernel at head width 64 and T
// tokens into *blocks, its dynamic shared memory into *smem_bytes; `masked`
// is unused.
FMM_EXPORT int fmm_lnqkv_attention_bwd_dqkv_blocks_per_sm(int T, int masked, int* blocks,
                                                          int* smem_bytes) {
  (void)masked;
  if (T < 1 || T > lq::kMaxT) return cudaErrorInvalidValue;
  const size_t smem = Layout<64>(T).bytes;
  const cudaError_t err = allow_smem<64>(smem);
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lnqkv_attention_bwd_kernel<64>,
                                                       lq::kThreads, smem);
}
