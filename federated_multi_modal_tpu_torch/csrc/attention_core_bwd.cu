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
// T cap, for any head width HD that is a multiple of 8 up to 128 (a
// template parameter, as in the forward); every block is 4 warps over a
// 64-row tile, 16 rows a warp, every T x T product on the tensor cores
// through attn_bwd.cuh's tile routines (mma.sync m16n8k16, bf16 in, fp32
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
// so that the vision rows pay no registers for it. Shared memory: six
// 64-row tiles a block (55 KB at head width 64, 104 KB at 128; pass 2 adds
// 1 KB of lse and delta). Up to head width 64 the dK/dV pass holds its four
// 16 x 64 fp32 tiles (S^T, dP^T, dK, dV: 128 registers) at three blocks an
// SM; above 64 it takes each streamed query tile in two halves of 32
// (attn_bwd.cuh's N8 = 4), so that dK and dV of up to 128 columns fit
// beside the scores at two blocks an SM.
#include <limits.h>

#include "attn_bwd.cuh"

namespace {

using fmm::bf16;
namespace am = fmm::attn_mma;
namespace ab = fmm::attn_bwd;

template <int HD>
struct Pass {
  using S = am::Shape<HD>;
  static constexpr int kE = S::kTileElems;
  // passes 1 and 3: q and g of the query tile, two stages of k and v
  static constexpr size_t kRowSmem = 6 * kE * sizeof(bf16);
  // pass 2: k and v of the key tile, two stages of q, g, lse and delta
  static constexpr size_t kKeySmem = 6 * kE * sizeof(bf16) + 4 * am::kTile * sizeof(float);
  // query columns a dK/dV step takes: the whole 64-row tile, or half of it
  // where dK and dV are wider than 64
  static constexpr int kKeyN8 = HD <= 64 ? 8 : 4;
  static constexpr int kKeyMinBlocks = HD <= 64 ? 3 : 2;
  static constexpr int kQMinBlocks = HD <= 64 ? 4 : 2;
  static constexpr int kQMinBlocksMasked = HD <= 64 ? 3 : 2;
};

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

template <int HD>
__device__ __forceinline__ Head locate(const Args& a) {
  const int tile = blockIdx.x % a.n_tiles;
  const int bh = blockIdx.x / a.n_tiles;
  const int h = bh % a.H;
  const int b = bh / a.H;
  const size_t rs = 3 * static_cast<size_t>(a.D);
  Head hd;
  hd.q = a.qkv + static_cast<size_t>(b) * a.T * rs + h * HD;
  hd.g = a.g + static_cast<size_t>(b) * a.T * a.D + h * HD;
  hd.dq = a.dqkv + static_cast<size_t>(b) * a.T * rs + h * HD;
  hd.stats = static_cast<size_t>(bh) * a.T;
  hd.tile0 = tile * am::kTile;
  return hd;
}

// Pass 1: lse and delta of each query row.
template <int HD, bool kMasked>
__global__ void __launch_bounds__(am::kThreads) attention_core_bwd_stats_kernel(Args a) {
  using S = am::Shape<HD>;
  constexpr int E = S::kTileElems;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + E;
  bf16* ks = gs + E;      // two stages
  bf16* vs = ks + 2 * E;  // two stages
  am::zero_pad_columns<HD, am::kThreads>(qs, 6 * am::kTile);
  const Head hd = locate<HD>(a);
  const size_t rs = 3 * static_cast<size_t>(a.D);
  const int T = a.T;
  const int warp = threadIdx.x >> 5;
  const int row0 = hd.tile0 + warp * 16;

  const int n_kt = (T + am::kTile - 1) / am::kTile;
  auto prefetch = [&](int j) {
    const int st = j & 1;
    am::load_tile<HD>(ks + st * E, S::kLd, hd.q + a.D, rs, j * am::kTile, T);
    am::load_tile<HD>(vs + st * E, S::kLd, hd.q + 2 * a.D, rs, j * am::kTile, T);
  };
  am::load_tile<HD>(qs, S::kLd, hd.q, rs, hd.tile0, T);
  am::load_tile<HD>(gs, S::kLd, hd.g, a.D, hd.tile0, T);
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
    ab::stats_step<HD, kMasked, 8>(m, l, d, a.mask, T, row0, j * am::kTile, a.scale, inv_scale,
                                   qs, gs, warp * 16, ks + st * E, vs + st * E);
    __syncthreads();
  }
  ab::stats_rows(m, l, d, row0, T, a.lse + hd.stats, a.delta + hd.stats);
}

// Pass 2: dK and dV of each key row. Up to head width 64 its four 16 x 64
// fp32 tiles (S^T, dP^T, dK, dV) take 128 registers a thread; the compiler
// is held to three blocks an SM (168 registers), which it otherwise
// overshoots. Wider heads take the query tile in halves, at two blocks.
template <int HD, bool kMasked>
__global__ void __launch_bounds__(am::kThreads, Pass<HD>::kKeyMinBlocks)
    attention_core_bwd_dkdv_kernel(Args a) {
  using S = am::Shape<HD>;
  constexpr int E = S::kTileElems;
  constexpr int N8 = Pass<HD>::kKeyN8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + E;
  bf16* qs = vs + E;      // two stages
  bf16* gs = qs + 2 * E;  // two stages
  float* lse_s = reinterpret_cast<float*>(gs + 2 * E);  // two stages
  float* delta_s = lse_s + 2 * am::kTile;               // two stages
  am::zero_pad_columns<HD, am::kThreads>(ks, 6 * am::kTile);
  const Head hd = locate<HD>(a);
  const size_t rs = 3 * static_cast<size_t>(a.D);
  const int T = a.T;
  const int warp = threadIdx.x >> 5;
  const int row0 = hd.tile0 + warp * 16;  // this warp's keys

  const int n_qt = (T + am::kTile - 1) / am::kTile;
  auto prefetch = [&](int i) {
    const int st = i & 1;
    am::load_tile<HD>(qs + st * E, S::kLd, hd.q, rs, i * am::kTile, T);
    am::load_tile<HD>(gs + st * E, S::kLd, hd.g, a.D, i * am::kTile, T);
    am::load_values(lse_s + st * am::kTile, a.lse + hd.stats, i * am::kTile, T);
    am::load_values(delta_s + st * am::kTile, a.delta + hd.stats, i * am::kTile, T);
  };
  am::load_tile<HD>(ks, S::kLd, hd.q + a.D, rs, hd.tile0, T);
  am::load_tile<HD>(vs, S::kLd, hd.q + 2 * a.D, rs, hd.tile0, T);
  prefetch(0);
  am::cp_async_commit();

  const float inv_scale = 1.f / a.scale;
  float dk[S::kNt][4], dv[S::kNt][4];
  ab::zero_tile(dk);
  ab::zero_tile(dv);
  for (int i = 0; i < n_qt; ++i) {
    if (i + 1 < n_qt) prefetch(i + 1);
    am::cp_async_commit();
    am::cp_async_wait<1>();
    __syncthreads();
    const int st = i & 1;
    // rows are this warp's keys, columns the tile's queries: S^T and dP^T
#pragma unroll
    for (int c = 0; c < am::kTile; c += 8 * N8)
      ab::dkdv_step<HD, kMasked, N8>(dk, dv, a.mask, T, row0, i * am::kTile + c, a.scale,
                                     inv_scale, ks, vs, warp * 16, qs + st * E + c * S::kLd,
                                     gs + st * E + c * S::kLd, lse_s + st * am::kTile + c,
                                     delta_s + st * am::kTile + c);
    __syncthreads();
  }
  ab::store_rows<HD>(dk, hd.dq + a.D, rs, row0, T);
  ab::store_rows<HD>(dv, hd.dq + 2 * a.D, rs, row0, T);
}

// Pass 3: dQ of each query row. Its three fp32 tiles (S, dP, dQ) leave room
// for four blocks an SM at head widths up to 64, three with a mask (whose
// loads take registers too); two above.
template <int HD, bool kMasked>
__global__ void __launch_bounds__(am::kThreads,
                                kMasked ? Pass<HD>::kQMinBlocksMasked : Pass<HD>::kQMinBlocks)
    attention_core_bwd_dq_kernel(Args a) {
  using S = am::Shape<HD>;
  constexpr int E = S::kTileElems;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + E;
  bf16* ks = gs + E;      // two stages
  bf16* vs = ks + 2 * E;  // two stages
  am::zero_pad_columns<HD, am::kThreads>(qs, 6 * am::kTile);
  const Head hd = locate<HD>(a);
  const size_t rs = 3 * static_cast<size_t>(a.D);
  const int T = a.T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = hd.tile0 + warp * 16;

  const int n_kt = (T + am::kTile - 1) / am::kTile;
  auto prefetch = [&](int j) {
    const int st = j & 1;
    am::load_tile<HD>(ks + st * E, S::kLd, hd.q + a.D, rs, j * am::kTile, T);
    am::load_tile<HD>(vs + st * E, S::kLd, hd.q + 2 * a.D, rs, j * am::kTile, T);
  };
  am::load_tile<HD>(qs, S::kLd, hd.q, rs, hd.tile0, T);
  am::load_tile<HD>(gs, S::kLd, hd.g, a.D, hd.tile0, T);
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
  float dq[S::kNt][4];
  ab::zero_tile(dq);
  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) prefetch(j + 1);
    am::cp_async_commit();
    am::cp_async_wait<1>();
    __syncthreads();
    const int st = j & 1;
    ab::dq_step<HD, kMasked, 8>(dq, a.mask, T, row0, j * am::kTile, a.scale, inv_scale, qs, gs,
                                warp * 16, ks + st * E, vs + st * E, lse_r, delta_r);
    __syncthreads();
  }
  ab::store_rows<HD>(dq, hd.dq, rs, row0, T);
}

template <int HD, bool kMasked>
cudaError_t allow_smem() {
  cudaError_t err = cudaFuncSetAttribute(attention_core_bwd_stats_kernel<HD, kMasked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Pass<HD>::kRowSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_core_bwd_dkdv_kernel<HD, kMasked>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Pass<HD>::kKeySmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_core_bwd_dq_kernel<HD, kMasked>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Pass<HD>::kRowSmem));
  return err;
}

template <int HD, bool kMasked>
int launch(const Args& a, int blocks, cudaStream_t s) {
  cudaError_t err = allow_smem<HD, kMasked>();
  if (err != cudaSuccess) return err;
  attention_core_bwd_stats_kernel<HD, kMasked><<<blocks, am::kThreads, Pass<HD>::kRowSmem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_core_bwd_dkdv_kernel<HD, kMasked><<<blocks, am::kThreads, Pass<HD>::kKeySmem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_core_bwd_dq_kernel<HD, kMasked><<<blocks, am::kThreads, Pass<HD>::kRowSmem, s>>>(a);
  return cudaGetLastError();
}

template <int HD, bool kMasked>
int blocks_per_sm(int pass, int* blocks, int* smem_bytes) {
  const cudaError_t err = allow_smem<HD, kMasked>();
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(pass == 2 ? Pass<HD>::kKeySmem : Pass<HD>::kRowSmem);
  switch (pass) {
    case 1:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, attention_core_bwd_stats_kernel<HD, kMasked>, am::kThreads,
          Pass<HD>::kRowSmem);
    case 2:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, attention_core_bwd_dkdv_kernel<HD, kMasked>, am::kThreads,
          Pass<HD>::kKeySmem);
    case 3:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, attention_core_bwd_dq_kernel<HD, kMasked>, am::kThreads, Pass<HD>::kRowSmem);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv (B, T, 3D) bf16, g (B, T, D) bf16, mask (T, T) fp32 or null, stats
// (2, B, H, T) fp32 scratch (lse, then delta), dqkv (B, T, 3D) bf16; all
// contiguous and 16-byte aligned, D = H * head width, the head width a
// multiple of 8 up to 128. Launches the three passes.
FMM_EXPORT int fmm_attention_core_bwd(const void* qkv, const void* g, const void* mask,
                                      void* stats, void* dqkv, int B, int T, int D, int H,
                                      float scale, void* stream) {
  if (T < 1 || B < 1 || H < 1 || D % H) return cudaErrorInvalidValue;
  const int n_tiles = (T + am::kTile - 1) / am::kTile;
  const long long blocks = static_cast<long long>(n_tiles) * H * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  float* lse = static_cast<float*>(stats);
  const Args a{static_cast<const bf16*>(qkv), static_cast<const bf16*>(g),
               static_cast<const float*>(mask), lse, lse + static_cast<size_t>(B) * H * T,
               static_cast<bf16*>(dqkv), T, D, H, n_tiles, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(blocks);
  switch (D / H) {
#define FMM_LAUNCH(hd) \
  case hd:             \
    return mask != nullptr ? launch<hd, true>(a, n, s) : launch<hd, false>(a, n, s);
    FMM_HEAD_DIMS(FMM_LAUNCH)
#undef FMM_LAUNCH
    default:
      return cudaErrorInvalidValue;
  }
}

// Resident blocks per SM of one pass (variant = head width + 256 x pass;
// pass 1 statistics, 2 dK/dV, 3 dQ), with a mask or without, into *blocks,
// its dynamic shared memory into *smem_bytes.
FMM_EXPORT int fmm_attention_core_bwd_blocks_per_sm(int variant, int masked, int* blocks,
                                                    int* smem_bytes) {
  const int pass = variant >> 8;
  switch (variant & 255) {
#define FMM_OCCUPANCY(hd)                                                \
  case hd:                                                               \
    return masked ? blocks_per_sm<hd, true>(pass, blocks, smem_bytes)    \
                  : blocks_per_sm<hd, false>(pass, blocks, smem_bytes);
    FMM_HEAD_DIMS(FMM_OCCUPANCY)
#undef FMM_OCCUPANCY
    default:
      return cudaErrorInvalidValue;
  }
}
