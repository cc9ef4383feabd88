// attention_core: per (row b, head h) softmax(q k^T * scale + M) v, read
// straight from a packed (B, T, 3D) bf16 QKV tensor, for any head width that
// is a multiple of 8 up to 128 and any T.
//
// Replaces the attention of two TPU kernels:
//   * federated_multi_modal_tpu/ops/pallas/attention.py
//     attention_packed_fwd_masked (pallas_call :497, behind
//     packed_attention_masked), the text tower's block-causal packed rows,
//     and attention_packed_fwd (:386, behind packed_attention), the same with
//     no mask; both run _packed_fwd_body (:261);
//   * the per-head loop of _block_body32 in ops/pallas/fused_block.py
//     (behind fused_block_residual and the other fused blocks), the vision
//     tower, with no mask.
// Numerics follow the TPU kernels: fp32 scores and softmax, keys at index
// >= valid_T set to -inf (the TPU's padding of T to a multiple of 8), p
// normalized and then rounded to bf16 before P.V, fp32 P.V sums, bf16
// output. Each fp32 score is the correctly rounded q.k (summed on the fp64
// tensor cores, attn_fwd.cuh): a 16-image train step through twelve
// random-init blocks turns a score's last fp32 bit, through p's bf16
// rounding, into gradient differences at the limit of chip_smoke.py's
// whole-step check, whose reference forward is exact.
//
// Bound on the H100: bytes. At the text shape (200, 120, 1536) with 8 heads
// a launch moves ~98 MB (qkv in, out back; ~29 us at 3.35 TB/s) for ~0.6
// GFLOP on the mask's finite pairs, and at the vision shape (512, 200, 2304)
// with 12 heads ~629 MB (~0.19 ms) for ~63 GFLOP (~64 us at 989 TFLOP/s; the
// half of it that is q.k takes ~0.47 ms at the fp64 tensor cores' 67
// TFLOP/s).
// Design (attn_fwd.cuh over attn_mma.cuh): one block of 4 warps per (b, h,
// 64-query tile), each warp 16 query rows; K and V tiles of 64 keys stream
// through a two-stage cp.async ring; Q.K^T runs on mma.sync m8n8k4 fp64 and
// P.V on mma.sync m16n8k16 bf16, both fed by ldmatrix, the scores in
// registers. The mask goes straight into the score fragments; a warp whose
// 16 x 64 mask tile is all -inf skips that tile (block-causal text rows,
// causal 77-token rows). To round p after the normalization, rows of up to
// 256 keys at head widths up to 64 take one pass with every score of the
// warp held in registers (4 key tiles, 128 fp32 a thread; 2 tiles when T <=
// 128, for three blocks an SM instead of two); longer rows and wider heads
// take two passes over the key tiles (statistics, then p and P.V), as
// attention_split.cu (K8) does. All are instantiations of one kernel;
// fmm_attention_core_forced forces one, so that tests and timings can hold
// them against each other. The blocks of one (b, h) are adjacent in the
// grid, so its K and V tiles come from L2 after the first block.
// What keeps it above its bound: the fp64 q.k (at T = 200, 256 padded keys,
// ~52 GFLOP, 0.77 ms at the fp64 peak, with the bf16 operands converted to
// fp64 on the way); one pass holds over 200 registers (two blocks, eight
// warps, an SM); the softmax's expf and division run per score on the CUDA
// cores, and each key tile costs two block barriers.
#include <limits.h>

#include "attn_fwd.cuh"

namespace {

using fmm::bf16;
namespace am = fmm::attn_mma;
namespace af = fmm::attn_fwd;

template <int HD, bool kMasked, int kKt>
__global__ void __launch_bounds__(am::kThreads, af::Smem<HD, kKt>::kMinBlocks)
    attention_core_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                          bf16* __restrict__ out, int T, int D, int H, int valid_T, int n_tiles,
                          float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % H;
  const int b = bh / H;
  const int row_stride = 3 * D;
  const bf16* base = qkv + static_cast<size_t>(b) * T * row_stride + h * HD;
  const af::Tile tile{base,       base + D,   base + 2 * D,
                      row_stride, row_stride, row_stride,
                      mask,       out + static_cast<size_t>(b) * T * D + h * HD,
                      D,          T,          valid_T,
                      qt * am::kTile, scale};
  af::attention_tile<HD, kMasked, kKt, true>(tile, reinterpret_cast<bf16*>(smem));
}

template <int HD, bool kMasked, int kKt>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(attention_core_kernel<HD, kMasked, kKt>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(af::Smem<HD, kKt>::kBytes));
}

template <int HD, bool kMasked, int kKt>
int launch(const void* qkv, const void* mask, void* out, int B, int T, int D, int H, int valid_T,
           float scale, cudaStream_t stream) {
  const int n_tiles = (T + am::kTile - 1) / am::kTile;
  const long long blocks = static_cast<long long>(n_tiles) * H * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<HD, kMasked, kKt>();
  if (err != cudaSuccess) return err;
  attention_core_kernel<HD, kMasked, kKt>
      <<<static_cast<int>(blocks), am::kThreads, af::Smem<HD, kKt>::kBytes, stream>>>(
          static_cast<const bf16*>(qkv), static_cast<const float*>(mask),
          static_cast<bf16*>(out), T, D, H, valid_T, n_tiles, scale);
  return cudaGetLastError();
}

// Head widths up to this take one pass for rows of up to 4 key tiles.
constexpr int kOnePassMaxHd = 64;

// The key tiles a warp holds in registers when the kernel chooses: 2 or 4
// for one pass over n_kt key tiles, 0 for two passes.
int chosen_key_tiles(int hd, int n_kt) {
  if (hd > kOnePassMaxHd || n_kt > 4) return 0;
  return n_kt <= 2 ? 2 : 4;
}

template <int HD, bool kMasked>
int launch(const void* qkv, const void* mask, void* out, int B, int T, int D, int H, int valid_T,
           float scale, int key_tiles, cudaStream_t stream) {
  const int n_kt = (valid_T + am::kTile - 1) / am::kTile;
  if (key_tiles == 0)
    return launch<HD, kMasked, 0>(qkv, mask, out, B, T, D, H, valid_T, scale, stream);
  if constexpr (HD <= kOnePassMaxHd) {
    if (key_tiles == 2 && n_kt <= 2)
      return launch<HD, kMasked, 2>(qkv, mask, out, B, T, D, H, valid_T, scale, stream);
    if (key_tiles == 4 && n_kt <= 4)
      return launch<HD, kMasked, 4>(qkv, mask, out, B, T, D, H, valid_T, scale, stream);
  }
  return cudaErrorInvalidValue;
}

template <int HD, bool kMasked, int kKt>
int blocks_per_sm(int* blocks, int* smem_bytes) {
  const cudaError_t err = allow_smem<HD, kMasked, kKt>();
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(af::Smem<HD, kKt>::kBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attention_core_kernel<HD, kMasked, kKt>, am::kThreads, af::Smem<HD, kKt>::kBytes);
}

template <int HD, bool kMasked>
int blocks_per_sm(int kt, int* blocks, int* smem_bytes) {
  if (kt == 0) return blocks_per_sm<HD, kMasked, 0>(blocks, smem_bytes);
  if constexpr (HD <= kOnePassMaxHd) {
    if (kt == 2) return blocks_per_sm<HD, kMasked, 2>(blocks, smem_bytes);
    if (kt == 4) return blocks_per_sm<HD, kMasked, 4>(blocks, smem_bytes);
  }
  return cudaErrorInvalidValue;
}

int dispatch(const void* qkv, const void* mask, void* out, int B, int T, int D, int H,
             int valid_T, float scale, int key_tiles, void* stream) {
  if (B < 1 || T < 1 || H < 1 || D % H || valid_T < 1 || valid_T > T)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D / H) {
#define FMM_LAUNCH(n)                                                                       \
  case n:                                                                                   \
    return mask != nullptr                                                                  \
               ? launch<n, true>(qkv, mask, out, B, T, D, H, valid_T, scale, key_tiles, s)  \
               : launch<n, false>(qkv, mask, out, B, T, D, H, valid_T, scale, key_tiles, s);
    FMM_HEAD_DIMS(FMM_LAUNCH)
#undef FMM_LAUNCH
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv (B, T, 3D) bf16, mask (T, T) fp32 or null, out (B, T, D) bf16; all
// contiguous, 16-byte aligned; D = H * head width, the head width a multiple
// of 8 up to 128; keys at or past valid_T (1 <= valid_T <= T) are -inf. The
// kernel takes one pass or two as fmm_attention_core_key_tiles says.
FMM_EXPORT int fmm_attention_core(const void* qkv, const void* mask, void* out, int B, int T,
                                  int D, int H, int valid_T, float scale, void* stream) {
  if (H < 1 || D % H) return cudaErrorInvalidValue;
  return dispatch(qkv, mask, out, B, T, D, H, valid_T, scale,
                  chosen_key_tiles(D / H, (valid_T + am::kTile - 1) / am::kTile), stream);
}

// The key tiles fmm_attention_core holds in registers at this head width
// and valid_T: 2 or 4 (one pass), 0 (two passes).
FMM_EXPORT int fmm_attention_core_key_tiles(int head_dim, int valid_T) {
  return chosen_key_tiles(head_dim, (valid_T + am::kTile - 1) / am::kTile);
}

// fmm_attention_core with its variant forced, for tests and timings only:
// key_tiles 0 takes two passes, 2 or 4 one pass (head widths up to 64,
// valid_T up to 64 key_tiles); anything else is refused.
FMM_EXPORT int fmm_attention_core_forced(const void* qkv, const void* mask, void* out, int B,
                                         int T, int D, int H, int valid_T, float scale,
                                         int key_tiles, void* stream) {
  return dispatch(qkv, mask, out, B, T, D, H, valid_T, scale, key_tiles, stream);
}

// Resident blocks per SM of one instantiation, with a mask or without
// (registers and shared memory as built) into *blocks, its dynamic shared
// memory into *smem_bytes. variant = head width + 256 * key tiles held in
// registers (0: two passes; 2 or 4: one pass).
FMM_EXPORT int fmm_attention_core_blocks_per_sm(int variant, int masked, int* blocks,
                                                int* smem_bytes) {
  const int kt = variant >> 8;
  switch (variant & 255) {
#define FMM_OCCUPANCY(n)                                                 \
  case n:                                                                \
    return masked ? blocks_per_sm<n, true>(kt, blocks, smem_bytes)       \
                  : blocks_per_sm<n, false>(kt, blocks, smem_bytes);
    FMM_HEAD_DIMS(FMM_OCCUPANCY)
#undef FMM_OCCUPANCY
    default:
      return cudaErrorInvalidValue;
  }
}
