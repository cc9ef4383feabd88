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
// Bound on the H100: bytes for the bf16 arithmetic, the fp64 tensor cores
// for the exact scores. At the text shape (200, 120, 1536) with 8 heads a
// launch moves ~98 MB (qkv in, out back; ~29 us at 3.35 TB/s) for ~0.6
// GFLOP on the mask's finite pairs, and at the vision shape (512, 200, 2304)
// with 12 heads ~629 MB (~0.19 ms) for ~63 GFLOP (~64 us at 989 TFLOP/s).
// The exact q.k is the kernel's own bound: 32.7 GFLOP on the live 8-key
// tiles and 16-row warps at ViT-B/16, 0.49 ms at the fp64 tensor cores' 67
// TFLOP/s (66.0-66.4 measured for independent m16n8k8 products on an H100),
// and 70.6 GFLOP, 1.05 ms, at ViT-L/14's (480, 260, 3072) with 16 heads.
// Design (attn_fwd.cuh over attn_mma.cuh): one block of 4 warps per (b, h,
// 64-query tile), each warp 16 query rows, the scores in registers; P.V on
// mma.sync m16n8k16 bf16. Without a mask, rows of up to 272 keys at head
// widths up to 64 (every vision tower's) take attention_core_f64_kernel:
// one pass whose q.k runs on mma.sync m16n8k8 fp64 from Q and K tiles the
// block converts to fp64 once, into shared memory, read with 16-byte loads
// in the fragments' order (attention_tile_f64); its instances hold 128, 208
// or 272 keys' scores, ViT-L/14's 260 in one pass, and up to 208 keys run
// three blocks an SM. A last query tile of at most 16 rows (ViT-B/16's 8 of
// 200, ViT-L/14's 4 of 260) goes to attention_core_f64_tail_kernel, blocks
// of one warp in a second launch: on a block of 4 warps it held its SM slot
// as long as a full tile. With a mask (the text tower's K1), and past those
// rows or widths, attention_core_kernel: q.k on mma.sync m8n8k4 fp64 with
// the bf16 fragments converted on the way (and, with a mask, each 16-key
// step of P.V summed there too); the mask goes straight into the score
// fragments, and a warp whose 16 x 64 mask tile is all -inf skips that tile
// (block-causal text rows, causal 77-token rows). To round p after the
// normalization, rows of up to 256 keys at head widths up to 64 take one
// pass with every score of the warp held in registers (4 key tiles, 128
// fp32 a thread; 2 tiles when T <= 128, for three blocks an SM instead of
// two); longer rows and wider heads take two passes over the key tiles
// (statistics, then p and P.V), as attention_split.cu (K8) does.
// fmm_attention_core_forced forces any instance, so that tests and timings
// can hold them against each other. The blocks of one (b, h) are adjacent
// in the grid, so its K and V tiles come from L2 after the first block.
// What keeps it above its bound (H100, 700 W, the forced instances alone):
// ViT-B/16's launch takes 1.56 ms (the parent design's one pass 3.27, its
// fp64 fragments converted per warp inside the product loop; 31 % of the
// fp64 floor), ViT-L/14's 3.69 ms (two passes before, 9.67; 28 %). Each
// block streams its K and V tiles through barriers and converts them for
// its 64 queries alone, and the occupancy is set by the scores' registers
// (three blocks an SM ran ViT-B/16 at 1.73 ms before the tail launch,
// against two blocks' 1.89 and one block's 3.07).
#include <limits.h>

#include "attn_fwd.cuh"

namespace {

using fmm::bf16;
namespace am = fmm::attn_mma;
namespace af = fmm::attn_fwd;

// Block (b, h, query tile) of the grid: its rows of the packed qkv and out;
// its queries start at q_first + the tile's index times tile_rows.
__device__ __forceinline__ af::Tile tile_of(const bf16* qkv, const float* mask, bf16* out, int T,
                                            int D, int H, int valid_T, int n_tiles, float scale,
                                            int q_first = 0, int tile_rows = am::kTile) {
  const int qt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % H;
  const int b = bh / H;
  const int row_stride = 3 * D;
  const bf16* base = qkv + static_cast<size_t>(b) * T * row_stride + h * (D / H);
  return af::Tile{base,       base + D,   base + 2 * D,
                  row_stride, row_stride, row_stride,
                  mask,       out + static_cast<size_t>(b) * T * D + h * (D / H),
                  D,          T,          valid_T,
                  q_first + qt * tile_rows, scale};
}

template <int HD, bool kMasked, int kKt>
__global__ void __launch_bounds__(am::kThreads, af::Smem<HD, kKt>::kMinBlocks)
    attention_core_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                          bf16* __restrict__ out, int T, int D, int H, int valid_T, int n_tiles,
                          float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  af::attention_tile<HD, kMasked, kKt, true>(tile_of(qkv, mask, out, T, D, H, valid_T, n_tiles,
                                                     scale),
                                             reinterpret_cast<bf16*>(smem));
}

// Without a mask, rows of up to 8 kN8 keys at head widths up to 64: one pass
// on fp64 operands converted once a block (attn_fwd.cuh, attention_tile_f64),
// kWarps warps of 16 queries a block: 4 for the 64-query tiles, 1 for a last
// tile of at most 16 queries (attention_core_f64_tail_kernel).
template <int HD, int kN8, int kWarps>
__device__ __forceinline__ void f64_block(const bf16* qkv, bf16* out, int T, int D, int H,
                                          int valid_T, int n_tiles, float scale, int q_first) {
  extern __shared__ __align__(16) unsigned char smem[];
  af::attention_tile_f64<HD, kN8, kWarps>(
      tile_of(qkv, nullptr, out, T, D, H, valid_T, n_tiles, scale, q_first, 16 * kWarps), smem);
}

template <int HD, int kN8>
__global__ void __launch_bounds__(am::kThreads, af::F64Plan<HD, kN8>::kMinBlocks)
    attention_core_f64_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T, int D,
                              int H, int valid_T, int n_tiles, float scale) {
  f64_block<HD, kN8, am::kWarps>(qkv, out, T, D, H, valid_T, n_tiles, scale, 0);
}

template <int HD, int kN8>
__global__ void __launch_bounds__(32, af::F64Plan<HD, kN8, 1>::kMinBlocks)
    attention_core_f64_tail_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T,
                                   int D, int H, int valid_T, float scale, int q_first) {
  f64_block<HD, kN8, 1>(qkv, out, T, D, H, valid_T, 1, scale, q_first);
}

template <int HD, bool kMasked, int kKt>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(attention_core_kernel<HD, kMasked, kKt>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(af::Smem<HD, kKt>::kBytes));
}

template <int HD, int kN8>
cudaError_t allow_smem_f64() {
  const cudaError_t err = cudaFuncSetAttribute(attention_core_f64_kernel<HD, kN8>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(af::F64Plan<HD, kN8>::kBytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(attention_core_f64_tail_kernel<HD, kN8>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(af::F64Plan<HD, kN8, 1>::kBytes));
}

// Head widths up to this take one pass (rows of up to 256 keys with a mask,
// 272 without).
constexpr int kOnePassMaxHd = 64;

// The instances of each kind: keys a warp's scores hold in registers, 0 for
// two passes. With a mask, 2 or 4 64-key tiles (3 blocks an SM at 2); without,
// 16, 26 or 34 8-key tiles (ViT-B/16's 200 keys take 208, ViT-L/14's 259 and
// 260 take 272).
constexpr int kMaskedHeld[] = {128, 256};
constexpr int kF64Held[] = {128, 208, 272};

// The keys held in registers when the kernel chooses, for n_keys valid keys.
int chosen_held_keys(int hd, int n_keys, bool masked) {
  if (hd > kOnePassMaxHd) return 0;
  if (masked) {
    for (int held : kMaskedHeld)
      if (n_keys <= held) return held;
  } else {
    for (int held : kF64Held)
      if (n_keys <= held) return held;
  }
  return 0;
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

// The 64-query tiles on blocks of 4 warps; a last tile of at most 16
// queries (ViT-B/16's 8 of 200, ViT-L/14's 4 of 260) on blocks of one warp,
// a second launch: a block of 4 warps there would hold its SM slot as long as
// a full one for a quarter of the work.
template <int HD, int kN8>
int launch_f64(const void* qkv, void* out, int B, int T, int D, int H, int valid_T, float scale,
               cudaStream_t stream) {
  const int rest = T % am::kTile;
  const bool tail = rest > 0 && rest <= 16;
  const int n_tiles = tail ? T / am::kTile : (T + am::kTile - 1) / am::kTile;
  const long long blocks = static_cast<long long>(n_tiles) * H * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem_f64<HD, kN8>();
  if (err != cudaSuccess) return err;
  if (n_tiles > 0) {
    attention_core_f64_kernel<HD, kN8>
        <<<static_cast<int>(blocks), am::kThreads, af::F64Plan<HD, kN8>::kBytes, stream>>>(
            static_cast<const bf16*>(qkv), static_cast<bf16*>(out), T, D, H, valid_T, n_tiles,
            scale);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return launched;
  }
  if (tail) {
    attention_core_f64_tail_kernel<HD, kN8>
        <<<H * B, 32, af::F64Plan<HD, kN8, 1>::kBytes, stream>>>(
            static_cast<const bf16*>(qkv), static_cast<bf16*>(out), T, D, H, valid_T, scale,
            n_tiles * am::kTile);
  }
  return cudaGetLastError();
}

template <int HD, bool kMasked>
int launch(const void* qkv, const void* mask, void* out, int B, int T, int D, int H, int valid_T,
           float scale, int held, cudaStream_t stream) {
  if (held == 0)
    return launch<HD, kMasked, 0>(qkv, mask, out, B, T, D, H, valid_T, scale, stream);
  if (valid_T > held) return cudaErrorInvalidValue;
  if constexpr (HD <= kOnePassMaxHd) {
    if constexpr (kMasked) {
      if (held == 128) return launch<HD, true, 2>(qkv, mask, out, B, T, D, H, valid_T, scale, stream);
      if (held == 256) return launch<HD, true, 4>(qkv, mask, out, B, T, D, H, valid_T, scale, stream);
    } else {
      if (held == 128) return launch_f64<HD, 16>(qkv, out, B, T, D, H, valid_T, scale, stream);
      if (held == 208) return launch_f64<HD, 26>(qkv, out, B, T, D, H, valid_T, scale, stream);
      if (held == 272) return launch_f64<HD, 34>(qkv, out, B, T, D, H, valid_T, scale, stream);
    }
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

template <int HD, int kN8>
int blocks_per_sm_f64(int* blocks, int* smem_bytes) {
  const cudaError_t err = allow_smem_f64<HD, kN8>();
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(af::F64Plan<HD, kN8>::kBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attention_core_f64_kernel<HD, kN8>, am::kThreads, af::F64Plan<HD, kN8>::kBytes);
}

template <int HD, bool kMasked>
int blocks_per_sm(int held, int* blocks, int* smem_bytes) {
  if (held == 0) return blocks_per_sm<HD, kMasked, 0>(blocks, smem_bytes);
  if constexpr (HD <= kOnePassMaxHd) {
    if constexpr (kMasked) {
      if (held == 128) return blocks_per_sm<HD, true, 2>(blocks, smem_bytes);
      if (held == 256) return blocks_per_sm<HD, true, 4>(blocks, smem_bytes);
    } else {
      if (held == 128) return blocks_per_sm_f64<HD, 16>(blocks, smem_bytes);
      if (held == 208) return blocks_per_sm_f64<HD, 26>(blocks, smem_bytes);
      if (held == 272) return blocks_per_sm_f64<HD, 34>(blocks, smem_bytes);
    }
  }
  return cudaErrorInvalidValue;
}

int dispatch(const void* qkv, const void* mask, void* out, int B, int T, int D, int H,
             int valid_T, float scale, int held, void* stream) {
  if (B < 1 || T < 1 || H < 1 || D % H || valid_T < 1 || valid_T > T)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D / H) {
#define FMM_LAUNCH(n)                                                                  \
  case n:                                                                              \
    return mask != nullptr                                                             \
               ? launch<n, true>(qkv, mask, out, B, T, D, H, valid_T, scale, held, s)  \
               : launch<n, false>(qkv, mask, out, B, T, D, H, valid_T, scale, held, s);
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
// kernel takes one pass or two as fmm_attention_core_held_keys says.
FMM_EXPORT int fmm_attention_core(const void* qkv, const void* mask, void* out, int B, int T,
                                  int D, int H, int valid_T, float scale, void* stream) {
  if (H < 1 || D % H) return cudaErrorInvalidValue;
  return dispatch(qkv, mask, out, B, T, D, H, valid_T, scale,
                  chosen_held_keys(D / H, valid_T, mask != nullptr), stream);
}

// The keys a warp's scores hold in registers in fmm_attention_core at this
// head width and valid_T, with a mask or without: 128 or 256 with a mask,
// 128, 208 or 272 without (one pass); 0 (two passes).
FMM_EXPORT int fmm_attention_core_held_keys(int head_dim, int valid_T, int masked) {
  return chosen_held_keys(head_dim, valid_T, masked != 0);
}

// fmm_attention_core with its variant forced, for tests and timings only:
// held 0 takes two passes, else one pass holding that many keys (as
// fmm_attention_core_held_keys answers; head widths up to 64, valid_T up to
// held); anything else is refused.
FMM_EXPORT int fmm_attention_core_forced(const void* qkv, const void* mask, void* out, int B,
                                         int T, int D, int H, int valid_T, float scale, int held,
                                         void* stream) {
  return dispatch(qkv, mask, out, B, T, D, H, valid_T, scale, held, stream);
}

// Resident blocks per SM of one instantiation, with a mask or without
// (registers and shared memory as built) into *blocks, its dynamic shared
// memory into *smem_bytes. variant = head width + 256 * the keys it holds
// in registers (0: two passes).
FMM_EXPORT int fmm_attention_core_blocks_per_sm(int variant, int masked, int* blocks,
                                                int* smem_bytes) {
  const int held = variant >> 8;
  switch (variant & 255) {
#define FMM_OCCUPANCY(n)                                                 \
  case n:                                                                \
    return masked ? blocks_per_sm<n, true>(held, blocks, smem_bytes)     \
                  : blocks_per_sm<n, false>(held, blocks, smem_bytes);
    FMM_HEAD_DIMS(FMM_OCCUPANCY)
#undef FMM_OCCUPANCY
    default:
      return cudaErrorInvalidValue;
  }
}
