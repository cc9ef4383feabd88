// attention_pair: packed-QKV attention, softmax(q k^T * scale) v per head,
// with one thread block per (row b, 128-lane head group), the group's heads
// (two of width 64) taken in turn, and both products on the tensor cores.
//
// Replaces the prototype TPU kernel tools/attn_microbench.py::_build_packed4d
// (pallas_call at :351): K2's forward (attention_packed_fwd) computed as one
// batched dot per 128-lane head group, grid (B // GB, D // 128), instead of a
// loop over the group's heads. Numerics as K2's: T padded (here to the wmma
// tile of 16), keys at or past valid_T at -inf, fp32 scores and softmax, p
// rounded to bf16 before P.V, fp32 P.V sums, bf16 output cut back to T.
//
// Bound on the H100: memory. At qkv (512, 200, 2304) bf16 it reads 472 MB and
// writes 157 MB (0.19 ms at 3.35 TB/s) for 63 GFLOP (0.064 ms at 989 TFLOP/s).
// Design: a head's q, k and v (T x 64 each) are read once into shared memory
// (rows padded to 16, zero past T); each warp takes 16-row query tiles:
// S = Q K^T by wmma into a per-warp fp32 (16, Tp) tile, the softmax in fp32
// with p rounded to bf16 in place, O = P V by wmma (head_tc.cuh). The two
// heads of a group go one after the other so that a head's fp32 score tiles
// fit beside its q, k and v: 944 bytes of shared memory per padded token,
// T <= 240. wmma (not wgmma), one block per SM at T = 200 and no overlap of
// the loads with the products keep it off its bound; those are the later
// steps.
#include "head_tc.cuh"

namespace {

using fmm::bf16;
namespace ht = fmm::head_tc;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 240;

size_t smem_bytes(int Tp) {
  return static_cast<size_t>(Tp) * 3 * ht::kLd * sizeof(bf16) +
         static_cast<size_t>(kWarps) * ht::warp_tile_floats(Tp) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
    attention_pair_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T, int D,
                          int valid_T, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Tp = ht::round16(T);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + static_cast<size_t>(Tp) * ht::kLd;
  bf16* vs = ks + static_cast<size_t>(Tp) * ht::kLd;
  float* sbuf = reinterpret_cast<float*>(vs + static_cast<size_t>(Tp) * ht::kLd);

  const int groups = D / 128;
  const int b = blockIdx.x / groups;
  const int grp = blockIdx.x % groups;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  for (int hh = 0; hh < 128 / ht::kHd; ++hh) {
    const int col = grp * 128 + hh * ht::kHd;
    const bf16* base = qkv + static_cast<size_t>(b) * T * row_stride + col;
    if (hh > 0) __syncthreads();  // the previous head's tiles are consumed
    ht::stage_head<kThreads>(base, row_stride, T, Tp, qs);
    ht::stage_head<kThreads>(base + D, row_stride, T, Tp, ks);
    ht::stage_head<kThreads>(base + 2 * D, row_stride, T, Tp, vs);
    __syncthreads();
    ht::attention_head<kWarps>(qs, ks, vs, T, Tp, valid_T, scale, sbuf,
                               out + static_cast<size_t>(b) * T * D + col, D);
  }
}

}  // namespace

// qkv (B, T, 3D) bf16, out (B, T, D) bf16, contiguous and 16-byte aligned;
// D a multiple of 128 with heads of 64 (H = D / 64); keys at or past valid_T
// (1 <= valid_T <= round16(T)) get -inf.
FMM_EXPORT int fmm_attention_pair(const void* qkv, void* out, int B, int T, int D, int H,
                                  int valid_T, float scale, void* stream) {
  if (T < 1 || T > kMaxT || B < 1 || D % 128 != 0 || D != H * ht::kHd || valid_T < 1 ||
      valid_T > ht::round16(T)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(ht::round16(T));
  cudaError_t err = cudaFuncSetAttribute(attention_pair_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_pair_kernel<<<B * (D / 128), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), T, D, valid_T, scale);
  return cudaGetLastError();
}
