// attention_pair: packed-QKV attention, softmax(q k^T * scale) v per head,
// by 128-lane head group: one block per (row b, group of 128 / hd heads,
// 64-query tile), one ring of the group's key and value tiles feeding all of
// its heads, every product on the tensor cores.
//
// Replaces the prototype TPU kernel tools/attn_microbench.py::_build_packed4d
// (pallas_call at :351): K2's forward (attention_packed_fwd) computed as one
// batched dot per 128-lane head group, grid (B // GB, D // 128), instead of a
// loop over the group's heads, for every head width its _packed_hp takes
// here: 8, 16, 32, 64 and 128 (16, 8, 4, 2 and 1 heads a group). Numerics as K2's: fp32
// scores and softmax, p rounded to bf16 before P.V, fp32 P.V sums, bf16
// output; keys at or past T (the TPU's padding) at -inf, or, for a planted
// fault, at or past valid_T.
//
// Bound on the H100: memory. At qkv (512, 200, 2304) bf16 it reads 472 MB and
// writes 157 MB (0.19 ms at 3.35 TB/s) for 63 GFLOP (0.064 ms at 989 TFLOP/s).
// Design (attn_fwd.cuh's attention_tile with kGroup = 128 / hd, bf16 q.k as
// K8's, not attention_core.cu's fp64 one): a block is 4 warps per head of the
// group, each warp 16 query rows of one head; the group's Q tile and its K
// and V tiles are 64 x 128 bf16 (each row copy 256 contiguous bytes) and
// stream through one two-stage cp.async ring, so one copy serves every head
// of the group (the TPU's head-pair idea on this card). At head width 64
// (8 warps, 256 threads) a row of up to 256 keys takes one pass with every
// score in registers (4 key tiles, 128 fp32 a thread), longer rows two; at
// 32 (16 warps, 512 threads, at most 128 registers each) and 128 (four
// warps whose 64 output accumulators leave no room for 128 scores) two
// passes (row statistics, then p and P.V). Any T. What keeps it off its
// bound: each key tile costs two block barriers across all the group's
// warps, and the softmax's expf and division run per score on the CUDA
// cores.
// Heads of 16 and 8: at four warps a head a group of 8 heads of 16 is 32
// warps, 1,024 threads, the most a block may have, each held to 64
// registers (the two-pass tile's 32 score and 8 output accumulators fit
// beside the fragments; ptxas -v reports any spill); a group of 16 heads of
// 8 would be 2,048. So heads of 8 run as heads of 16: the wrapper
// (ops/kernels/prototypes.py::packed4d_attention_cuda) zero-pads each head's
// q, k and v columns to 16, with the scale of the true width (zero columns
// leave q.k unchanged; their P.V columns are sliced off), and one padded
// 128-lane group carries 8 of the original heads. The Q.K^T contraction
// runs in whole 16-column steps, so a head of 8 could not share a step with
// its neighbour in any case.
#include <limits.h>

#include "attn_fwd.cuh"

namespace {

using fmm::bf16;
namespace am = fmm::attn_mma;
namespace af = fmm::attn_fwd;

constexpr int kGroupCols = 128;

template <int HD>
constexpr int kGroupOf = kGroupCols / HD;  // heads a block serves

template <int HD, int kKt>
using GroupSmem = af::Smem<HD, kKt, kGroupOf<HD>>;

template <int HD, int kKt>
__global__ void __launch_bounds__(af::Group<HD, kGroupOf<HD>>::kThreads, 1)
    attention_pair_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T, int D,
                          int valid_T, int n_tiles, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qt = blockIdx.x % n_tiles;
  const int bg = blockIdx.x / n_tiles;
  const int groups = D / kGroupCols;
  const int grp = bg % groups;
  const int b = bg / groups;
  const int row_stride = 3 * D;
  const bf16* base = qkv + static_cast<size_t>(b) * T * row_stride + grp * kGroupCols;
  const af::Tile tile{base,       base + D,   base + 2 * D,
                      row_stride, row_stride, row_stride,
                      nullptr,    out + static_cast<size_t>(b) * T * D + grp * kGroupCols,
                      D,          T,          valid_T,
                      qt * am::kTile, scale};
  af::attention_tile<HD, false, kKt, false, kGroupOf<HD>>(tile, reinterpret_cast<bf16*>(smem));
}

template <int HD, int kKt>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(attention_pair_kernel<HD, kKt>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(GroupSmem<HD, kKt>::kBytes));
}

// The key tiles held in registers: 4 (one pass) at head width 64 for up to
// 256 keys, else 0 (two passes).
int key_tiles(int hd, int n_keys) {
  return hd == 64 && n_keys <= 4 * am::kTile ? 4 : 0;
}

template <int HD, int kKt>
int launch(const void* qkv, void* out, int B, int T, int D, int valid_T, float scale,
           cudaStream_t stream) {
  const int n_tiles = (T + am::kTile - 1) / am::kTile;
  const long long blocks = static_cast<long long>(n_tiles) * (D / kGroupCols) * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<HD, kKt>();
  if (err != cudaSuccess) return err;
  constexpr int kThreads = af::Group<HD, kGroupOf<HD>>::kThreads;
  attention_pair_kernel<HD, kKt><<<static_cast<int>(blocks), kThreads,
                                   GroupSmem<HD, kKt>::kBytes, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), T, D, valid_T, n_tiles, scale);
  return cudaGetLastError();
}

template <int HD, int kKt>
int blocks_per_sm(int* blocks, int* smem_bytes) {
  const cudaError_t err = allow_smem<HD, kKt>();
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(GroupSmem<HD, kKt>::kBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attention_pair_kernel<HD, kKt>, af::Group<HD, kGroupOf<HD>>::kThreads,
      GroupSmem<HD, kKt>::kBytes);
}

}  // namespace

// qkv (B, T, 3D) bf16, out (B, T, D) bf16, contiguous and 16-byte aligned;
// D a multiple of 128 with heads of 16, 32, 64 or 128 (H = D / head width);
// keys at or past valid_T (1 <= valid_T) get -inf, and keys in [T, valid_T)
// are zero rows that take part.
FMM_EXPORT int fmm_attention_pair(const void* qkv, void* out, int B, int T, int D, int H,
                                  int valid_T, float scale, void* stream) {
  if (T < 1 || B < 1 || H < 1 || D % kGroupCols || D % H || valid_T < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = D / H;
  const bool one_pass = key_tiles(hd, valid_T) == 4;
  switch (hd) {
    case 16:
      return launch<16, 0>(qkv, out, B, T, D, valid_T, scale, s);
    case 32:
      return launch<32, 0>(qkv, out, B, T, D, valid_T, scale, s);
    case 64:
      return one_pass ? launch<64, 4>(qkv, out, B, T, D, valid_T, scale, s)
                      : launch<64, 0>(qkv, out, B, T, D, valid_T, scale, s);
    case 128:
      return launch<128, 0>(qkv, out, B, T, D, valid_T, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Resident blocks per SM of one instantiation (variant = head width + 256 x
// key tiles held in registers, 0 or 4) into *blocks, its dynamic shared
// memory into *smem_bytes; `masked` is unused (the kernel has no mask).
FMM_EXPORT int fmm_attention_pair_blocks_per_sm(int variant, int masked, int* blocks,
                                                int* smem_bytes) {
  (void)masked;
  switch (variant) {
    case 16:
      return blocks_per_sm<16, 0>(blocks, smem_bytes);
    case 32:
      return blocks_per_sm<32, 0>(blocks, smem_bytes);
    case 64:
      return blocks_per_sm<64, 0>(blocks, smem_bytes);
    case 64 + 256 * 4:
      return blocks_per_sm<64, 4>(blocks, smem_bytes);
    case 128:
      return blocks_per_sm<128, 0>(blocks, smem_bytes);
    default:
      return cudaErrorInvalidValue;
  }
}

// The key tiles fmm_attention_pair holds in registers at this head width
// and valid_T: 4 (one pass) or 0 (two passes).
FMM_EXPORT int fmm_attention_pair_key_tiles(int head_dim, int valid_T) {
  return key_tiles(head_dim, valid_T);
}
