// attention_core_bwd: d(QKV) of attention_core, per (row b, head h), read
// straight from a packed (B, T, 3D) bf16 QKV tensor and the output
// cotangent g (B, T, D), written into a packed (B, T, 3D) bf16 gradient.
//
// Replaces the backward attention of two TPU kernels:
//   * federated_multi_modal_tpu/ops/pallas/attention.py
//     attention_packed_bwd_masked (:533) and attention_packed_bwd (:422),
//     both with the body _packed_bwd_body (:298-346): the text tower's
//     block-causal packed rows and the mask-free vision rows;
//   * the per-head attention backward of _fbt_bwd in ops/pallas/fused_block.py
//     (:1307, behind fused_block_train and fused_block_train_dw), the vision
//     tower, with no mask.
// Numerics follow _packed_bwd_body: fp32 scores and softmax P; bf16(P) for
// dV = P^T g; dP = g v^T in fp32 and delta = rowsum(dP * P) over the fp32 P;
// dS = P * (dP - delta) * scale rounded to bf16 before dQ = dS k and
// dK = dS^T q; fp32 sums; bf16 outputs. As on the TPU, the forward saves qkv
// only and the backward recomputes the probabilities.
//
// Bound on the H100: at the text shape (200, 120, 1536) a launch reads
// ~98 MB and writes ~74 MB for ~1.5 GFLOP of products (five per (query,
// key) pair on the mask's finite pairs), and at the vision shape
// (512, 200, 2304) ~629 MB in and ~472 MB out for ~157 GFLOP; both are
// bound by memory at 3.35 TB/s (~0.05 ms and ~0.33 ms).
// Design: FlashAttention-2's backward in three passes, keys streamed, so no
// T cap; every block is 4 warps over a 64-row tile, 16 rows a warp, every
// T x T product on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate) with scores, probabilities and dS in registers, and the
// streamed tiles in a two-stage cp.async ring (attn_mma.cuh):
//   1. statistics, one block per (b, h, 64-query tile): streams the K and V
//      tiles, S = q k^T and dP = g v^T, the online row max m and sum l and
//      the rescaled sum of exp(s - m) dP; writes lse = m + log l and
//      delta = that sum / l, fp32 (B, H, T) each, into the caller's scratch;
//   2. dK and dV, one block per (b, h, 64-key tile), K and V of the tile
//      held in shared memory: streams the q and g tiles with their lse and
//      delta, recomputes S^T and dP^T, P = exp(s - lse), dS, and sums
//      dV += bf16(P)^T g and dK += bf16(dS)^T q in registers;
//   3. dQ, one block per (b, h, 64-query tile): streams the K and V tiles,
//      recomputes S, dP, P and dS, and sums dQ += bf16(dS) k in registers.
// Nothing is summed across blocks, so two runs give the same bits. A warp
// whose 16 x 64 mask tile is all -inf skips it (its probabilities are
// exactly 0), and so does a warp whose rows all lie past T. Each pass is
// built with a mask (read straight into the score fragments) and without,
// so that the vision rows pay no registers for it. Shared memory: 55 KB a
// block in passes 1 and 3, 56 KB in 2.
#include <limits.h>

#include "attn_mma.cuh"

namespace {

using fmm::bf16;
namespace am = fmm::attn_mma;

constexpr int kHd = 64;  // head width
constexpr int kLd = kHd + 8;
constexpr int kKSteps = kHd / 16;
constexpr int kNt = kHd / 8;
constexpr int kTileElems = am::kTile * kLd;
// passes 1 and 3: q and g of the query tile, two stages of k and v
constexpr size_t kRowPassSmem = 6 * kTileElems * sizeof(bf16);
// pass 2: k and v of the key tile, two stages of q, g, lse and delta
constexpr size_t kKeyPassSmem = 6 * kTileElems * sizeof(bf16) + 4 * am::kTile * sizeof(float);

struct Args {
  const bf16* qkv;
  const bf16* g;
  const float* mask;  // (T, T) or null
  float* lse;         // (B, H, T)
  float* delta;       // (B, H, T)
  bf16* dqkv;
  int T, D, H, n_tiles;
  float scale;
};

struct Head {
  const bf16* q;  // row stride 3D; k at + D, v at + 2D
  const bf16* g;  // row stride D
  bf16* dq;       // row stride 3D; dk at + D, dv at + 2D
  size_t stats;   // offset of (b, h) in lse and delta
  int tile0;      // first row of this block's tile
};

__device__ __forceinline__ Head locate(const Args& a) {
  const int tile = blockIdx.x % a.n_tiles;
  const int bh = blockIdx.x / a.n_tiles;
  const int h = bh % a.H;
  const int b = bh / a.H;
  const size_t rs = 3 * static_cast<size_t>(a.D);
  Head hd;
  hd.q = a.qkv + static_cast<size_t>(b) * a.T * rs + h * kHd;
  hd.g = a.g + static_cast<size_t>(b) * a.T * a.D + h * kHd;
  hd.dq = a.dqkv + static_cast<size_t>(b) * a.T * rs + h * kHd;
  hd.stats = static_cast<size_t>(bh) * a.T;
  hd.tile0 = tile * am::kTile;
  return hd;
}

__device__ __forceinline__ void scale_tile(float (&s)[8][4], float scale) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
}

__device__ __forceinline__ void zero_tile(float (&s)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
}

// A 16 x 64 fp32 block of the warp's rows (row0 + [0, 16)) into a row-major
// (T, 3D) bf16 output at dst (rows at or past T are not written).
__device__ __forceinline__ void store_rows(const float (&acc)[kNt][4], bf16* dst, size_t stride,
                                           int row0, int T) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
    bf16* p = dst + static_cast<size_t>(row) * stride + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(p + nt * 8) =
          __floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]);
  }
}

// Pass 1: lse and delta of each query row.
template <bool kMasked>
__global__ void __launch_bounds__(am::kThreads) attention_core_bwd_stats_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + kTileElems;
  bf16* ks = gs + kTileElems;      // two stages
  bf16* vs = ks + 2 * kTileElems;  // two stages
  const Head hd = locate(a);
  const size_t rs = 3 * static_cast<size_t>(a.D);
  const int T = a.T;
  const int warp = threadIdx.x >> 5;
  const int row0 = hd.tile0 + warp * 16;

  const int n_kt = (T + am::kTile - 1) / am::kTile;
  auto prefetch = [&](int j) {
    const int st = j & 1;
    am::load_tile<kHd>(ks + st * kTileElems, kLd, hd.q + a.D, rs, j * am::kTile, T);
    am::load_tile<kHd>(vs + st * kTileElems, kLd, hd.q + 2 * a.D, rs, j * am::kTile, T);
  };
  am::load_tile<kHd>(qs, kLd, hd.q, rs, hd.tile0, T);
  am::load_tile<kHd>(gs, kLd, hd.g, a.D, hd.tile0, T);
  prefetch(0);
  am::cp_async_commit();

  const float inv_scale = 1.f / a.scale;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float d[2] = {0.f, 0.f};
  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) prefetch(j + 1);
    am::cp_async_commit();
    am::cp_async_wait<1>();
    __syncthreads();
    const int st = j & 1;
    float s[8][4], dp[8][4];
    if (!am::mask_tile<false, kMasked>(s, a.mask, T, row0, j * am::kTile, inv_scale)) {
      zero_tile(dp);
      am::mma_abt<kKSteps>(s, qs, kLd, warp * 16, ks + st * kTileElems, kLd);
      am::mma_abt<kKSteps>(dp, gs, kLd, warp * 16, vs + st * kTileElems, kLd);
      scale_tile(s, a.scale);
      am::online_softmax<true>(s, dp, m, l, d);
    }
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = am::quad_sum(l[r]);
    const float dr = am::quad_sum(d[r]);
    const int row = row0 + (lane >> 2) + 8 * r;
    if ((lane & 3) == 0 && row < T) {
      a.lse[hd.stats + row] = m[r] + logf(lr);
      a.delta[hd.stats + row] = dr / lr;
    }
  }
}

// Pass 2: dK and dV of each key row. Its four 16 x 64 fp32 tiles (S^T, dP^T,
// dK, dV) take 128 registers a thread; the compiler is held to three blocks
// an SM (168 registers), which it otherwise overshoots.
template <bool kMasked>
__global__ void __launch_bounds__(am::kThreads, 3) attention_core_bwd_dkdv_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTileElems;
  bf16* qs = vs + kTileElems;      // two stages
  bf16* gs = qs + 2 * kTileElems;  // two stages
  float* lse_s = reinterpret_cast<float*>(gs + 2 * kTileElems);  // two stages
  float* delta_s = lse_s + 2 * am::kTile;                        // two stages
  const Head hd = locate(a);
  const size_t rs = 3 * static_cast<size_t>(a.D);
  const int T = a.T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row0 = hd.tile0 + warp * 16;  // this warp's keys

  const int n_qt = (T + am::kTile - 1) / am::kTile;
  auto prefetch = [&](int i) {
    const int st = i & 1;
    am::load_tile<kHd>(qs + st * kTileElems, kLd, hd.q, rs, i * am::kTile, T);
    am::load_tile<kHd>(gs + st * kTileElems, kLd, hd.g, a.D, i * am::kTile, T);
    am::load_values(lse_s + st * am::kTile, a.lse + hd.stats, i * am::kTile, T);
    am::load_values(delta_s + st * am::kTile, a.delta + hd.stats, i * am::kTile, T);
  };
  am::load_tile<kHd>(ks, kLd, hd.q + a.D, rs, hd.tile0, T);
  am::load_tile<kHd>(vs, kLd, hd.q + 2 * a.D, rs, hd.tile0, T);
  prefetch(0);
  am::cp_async_commit();

  const float inv_scale = 1.f / a.scale;
  float dk[kNt][4], dv[kNt][4];
  zero_tile(dk);
  zero_tile(dv);
  for (int i = 0; i < n_qt; ++i) {
    if (i + 1 < n_qt) prefetch(i + 1);
    am::cp_async_commit();
    am::cp_async_wait<1>();
    __syncthreads();
    const int st = i & 1;
    const bf16* qt = qs + st * kTileElems;
    const bf16* gt = gs + st * kTileElems;
    const float* lse_t = lse_s + st * am::kTile;
    const float* delta_t = delta_s + st * am::kTile;
    float s[8][4], dp[8][4];
    // rows are this warp's keys, columns the tile's queries: S^T and dP^T
    if (!am::mask_tile<true, kMasked>(s, a.mask, T, row0, i * am::kTile, inv_scale)) {
      am::mma_abt<kKSteps>(s, ks, kLd, warp * 16, qt, kLd);
      zero_tile(dp);
      am::mma_abt<kKSteps>(dp, vs, kLd, warp * 16, gt, kLd);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          const float p = __expf(s[nt][e] * a.scale - lse_t[col]);
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - delta_t[col]) * a.scale;
        }
      }
      am::mma_pv<kNt>(dv, s, gt, kLd);   // dV += bf16(P)^T g
      am::mma_pv<kNt>(dk, dp, qt, kLd);  // dK += bf16(dS)^T q
    }
    __syncthreads();
  }
  store_rows(dk, hd.dq + a.D, rs, row0, T);
  store_rows(dv, hd.dq + 2 * a.D, rs, row0, T);
}

// Pass 3: dQ of each query row. Its three fp32 tiles (S, dP, dQ) leave room
// for four blocks an SM, three with a mask (whose loads take registers too).
template <bool kMasked>
__global__ void __launch_bounds__(am::kThreads, kMasked ? 3 : 4)
    attention_core_bwd_dq_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + kTileElems;
  bf16* ks = gs + kTileElems;      // two stages
  bf16* vs = ks + 2 * kTileElems;  // two stages
  const Head hd = locate(a);
  const size_t rs = 3 * static_cast<size_t>(a.D);
  const int T = a.T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = hd.tile0 + warp * 16;

  const int n_kt = (T + am::kTile - 1) / am::kTile;
  auto prefetch = [&](int j) {
    const int st = j & 1;
    am::load_tile<kHd>(ks + st * kTileElems, kLd, hd.q + a.D, rs, j * am::kTile, T);
    am::load_tile<kHd>(vs + st * kTileElems, kLd, hd.q + 2 * a.D, rs, j * am::kTile, T);
  };
  am::load_tile<kHd>(qs, kLd, hd.q, rs, hd.tile0, T);
  am::load_tile<kHd>(gs, kLd, hd.g, a.D, hd.tile0, T);
  prefetch(0);
  am::cp_async_commit();

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    lse_r[r] = row < T ? a.lse[hd.stats + row] : 0.f;
    delta_r[r] = row < T ? a.delta[hd.stats + row] : 0.f;
  }

  const float inv_scale = 1.f / a.scale;
  float dq[kNt][4];
  zero_tile(dq);
  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) prefetch(j + 1);
    am::cp_async_commit();
    am::cp_async_wait<1>();
    __syncthreads();
    const int st = j & 1;
    const bf16* kt = ks + st * kTileElems;
    float s[8][4], dp[8][4];
    if (!am::mask_tile<false, kMasked>(s, a.mask, T, row0, j * am::kTile, inv_scale)) {
      zero_tile(dp);
      am::mma_abt<kKSteps>(s, qs, kLd, warp * 16, kt, kLd);
      am::mma_abt<kKSteps>(dp, gs, kLd, warp * 16, vs + st * kTileElems, kLd);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = __expf(s[nt][e] * a.scale - lse_r[r]);
          dp[nt][e] = p * (dp[nt][e] - delta_r[r]) * a.scale;
        }
      }
      am::mma_pv<kNt>(dq, dp, kt, kLd);  // dQ += bf16(dS) k
    }
    __syncthreads();
  }
  store_rows(dq, hd.dq, rs, row0, T);
}

template <bool kMasked>
cudaError_t allow_smem() {
  cudaError_t err = cudaFuncSetAttribute(attention_core_bwd_stats_kernel<kMasked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kRowPassSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_core_bwd_dkdv_kernel<kMasked>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kKeyPassSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_core_bwd_dq_kernel<kMasked>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kRowPassSmem));
  return err;
}

template <bool kMasked>
int launch(const Args& a, int blocks, cudaStream_t s) {
  cudaError_t err = allow_smem<kMasked>();
  if (err != cudaSuccess) return err;
  attention_core_bwd_stats_kernel<kMasked><<<blocks, am::kThreads, kRowPassSmem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_core_bwd_dkdv_kernel<kMasked><<<blocks, am::kThreads, kKeyPassSmem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_core_bwd_dq_kernel<kMasked><<<blocks, am::kThreads, kRowPassSmem, s>>>(a);
  return cudaGetLastError();
}

template <bool kMasked>
int blocks_per_sm(int pass, int* blocks) {
  const cudaError_t err = allow_smem<kMasked>();
  if (err != cudaSuccess) return err;
  switch (pass) {
    case 1:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, attention_core_bwd_stats_kernel<kMasked>, am::kThreads, kRowPassSmem);
    case 2:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, attention_core_bwd_dkdv_kernel<kMasked>, am::kThreads, kKeyPassSmem);
    case 3:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, attention_core_bwd_dq_kernel<kMasked>, am::kThreads, kRowPassSmem);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv (B, T, 3D) bf16, g (B, T, D) bf16, mask (T, T) fp32 or null, stats
// (2, B, H, T) fp32 scratch (lse, then delta), dqkv (B, T, 3D) bf16; all
// contiguous and 16-byte aligned, D = H * 64. Launches the three passes.
FMM_EXPORT int fmm_attention_core_bwd(const void* qkv, const void* g, const void* mask,
                                      void* stats, void* dqkv, int B, int T, int D, int H,
                                      float scale, void* stream) {
  if (T < 1 || D != H * kHd || B < 1) return cudaErrorInvalidValue;
  const int n_tiles = (T + am::kTile - 1) / am::kTile;
  const long long blocks = static_cast<long long>(n_tiles) * H * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  float* lse = static_cast<float*>(stats);
  const Args a{static_cast<const bf16*>(qkv), static_cast<const bf16*>(g),
               static_cast<const float*>(mask), lse, lse + static_cast<size_t>(B) * H * T,
               static_cast<bf16*>(dqkv), T, D, H, n_tiles, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(blocks);
  return mask != nullptr ? launch<true>(a, n, s) : launch<false>(a, n, s);
}

// Resident blocks per SM of pass `pass` (1 statistics, 2 dK/dV, 3 dQ), with
// a mask or without, into *blocks, its dynamic shared memory into
// *smem_bytes.
FMM_EXPORT int fmm_attention_core_bwd_blocks_per_sm(int pass, int masked, int* blocks,
                                                    int* smem_bytes) {
  *smem_bytes = static_cast<int>(pass == 2 ? kKeyPassSmem : kRowPassSmem);
  return masked ? blocks_per_sm<true>(pass, blocks) : blocks_per_sm<false>(pass, blocks);
}
