// attention_split: per (row b, head h) softmax(q k^T * scale + M) v over three
// separate (B, T, D) bf16 operands, each with its own row stride, for any head
// width that is a multiple of 8 up to 128, or a multiple of 32 from 160 to
// 288 (FMM_WIDE_HEAD_DIMS), and any T. The wrapper
// (ops/kernels/attention.py::fused_attention_cuda) zero-pads every other
// width up to 288 to the next of these, with the scale of the true width.
//
// Replaces federated_multi_modal_tpu/ops/pallas/attention.py fused_attention
// (_attn_kernel_nomask at pallas_call :127, _attn_kernel at :147, body
// _attn_body :64-80), the attention that multi_head_attention runs when
// T >= 32 and the heads do not pack into 128 lanes (behind
// fused_attention_diff and multi_head_attention_pallas). The row strides let
// the caller pass the column split of a packed (B, T, 3D) QKV tensor with no
// copy. Numerics follow _attn_body: fp32 scores times the scale plus the fp32
// mask, the fp32 softmax normalized and then rounded to bf16, P.V summed in
// fp32, bf16 output. The TPU kernel pads T to a multiple of 8 and sets the
// padded keys to -inf; here keys past T are -inf in the ragged last tile.
//
// Bound on the H100: bytes. At (64, 257, 1280) with 16 heads of 80 a launch
// reads q, k and v and writes the output, 168 MB (~50 us at 3.35 TB/s), for
// 21.6 GFLOP (~22 us at 989 TFLOP/s); at (256, 77, 768) with 8 heads of 96 and
// a causal mask ~121 MB (~36 us) for ~2.4 GFLOP on the mask's finite pairs.
// Design (the two-pass forward of attn_fwd.cuh, which attention_core.cu
// shares): one block of 4 warps per (b, h, 64-query tile), each warp 16 query
// rows; K and V tiles of 64 keys stream through a two-stage cp.async ring in
// shared memory (attn_mma.cuh), and both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate) with the scores kept in
// registers. To round p at the TPU kernel's point, normalized before P.V,
// the block passes over the key tiles twice: first the online row max and
// sum, then the scores again, p = bf16(exp(s - m) / l) and O += P.V. The
// second Q.K^T costs little: the kernel is bound by bytes, and the K tiles
// come back from L2. Head widths that are not a multiple of 16 are
// zero-padded to the next 16 in shared memory for Q.K^T; P.V's columns go in
// steps of 8. Shared memory is one Q tile and two stages of K and V, 5 x 64
// rows of (16 ceil(HD / 16) + 8) bf16: 87 KB at HD = 128, 56 KB at HD = 80,
// whatever T is.
// Widths past 128: of the two ways to widen the kernel (a wider HD instance,
// or 128-column chunks with q.k summed over the chunks and P.V written a
// chunk at a time), this takes the wider instance: attn_fwd.cuh's tile
// routine is generic in HD, the Q.K^T contraction reads its fragments from
// shared memory step by step, and only the output accumulators (HD / 2 fp32
// a thread) and the five tiles grow: 185 KB of shared memory and 144
// accumulator registers at 288, one block an SM, under the 255-register
// cap (ptxas -v reports the spills, if any, for each instance). A chunked
// pass would recompute the scores once per chunk; the wider instance reads
// each K and V tile once a pass. Past 288 the five tiles would outgrow the
// SM's 227 KB, so the wrapper raises there. The Q fragments are read from shared memory at each use,
// not held in registers, and the compiler is held to the registers that let as many
// blocks share an SM as their shared memory allows (up to 4), for more warps
// in flight. A warp whose 16 x 64 mask tile is all -inf skips that tile (its
// probabilities are exactly 0); the mask is read straight into the score
// fragments, all of a tile's loads in flight at once, and the kernel is
// built with a mask and without, so that a mask-free call pays nothing.
#include <limits.h>

#include "attn_fwd.cuh"

namespace {

using fmm::bf16;
namespace am = fmm::attn_mma;
namespace af = fmm::attn_fwd;

// Two passes at every T: Q, two K stages and two V stages in shared memory.
template <int HD>
using Smem = af::Smem<HD, 0>;

template <int HD, bool kMasked>
__global__ void __launch_bounds__(am::kThreads, Smem<HD>::kMinBlocks)
    attention_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, int q_stride, int k_stride, int v_stride,
                           const float* __restrict__ mask, bf16* __restrict__ out, int T, int D,
                           int H, int n_tiles, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % H;
  const int b = bh / H;
  const af::Tile tile{q + static_cast<size_t>(b) * T * q_stride + h * HD,
                      k + static_cast<size_t>(b) * T * k_stride + h * HD,
                      v + static_cast<size_t>(b) * T * v_stride + h * HD,
                      q_stride, k_stride, v_stride,
                      mask, out + static_cast<size_t>(b) * T * D + h * HD, D,
                      T, T, qt * am::kTile, scale};
  af::attention_tile<HD, kMasked, 0, false>(tile, reinterpret_cast<bf16*>(smem));
}

template <int HD, bool kMasked>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(attention_split_kernel<HD, kMasked>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Smem<HD>::kBytes));
}

template <int HD, bool kMasked>
int launch(const void* q, const void* k, const void* v, int q_stride, int k_stride,
           int v_stride, const void* mask, void* out, int B, int T, int D, int H, float scale,
           cudaStream_t stream) {
  const int n_tiles = (T + am::kTile - 1) / am::kTile;
  const long long blocks = static_cast<long long>(n_tiles) * H * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<HD, kMasked>();
  if (err != cudaSuccess) return err;
  attention_split_kernel<HD, kMasked>
      <<<static_cast<int>(blocks), am::kThreads, Smem<HD>::kBytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          q_stride, k_stride, v_stride, static_cast<const float*>(mask), static_cast<bf16*>(out),
          T, D, H, n_tiles, scale);
  return cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, int q_stride, int k_stride,
           int v_stride, const void* mask, void* out, int B, int T, int D, int H, float scale,
           cudaStream_t stream) {
  return mask != nullptr
             ? launch<HD, true>(q, k, v, q_stride, k_stride, v_stride, mask, out, B, T, D, H,
                                scale, stream)
             : launch<HD, false>(q, k, v, q_stride, k_stride, v_stride, mask, out, B, T, D, H,
                                 scale, stream);
}

template <int HD, bool kMasked>
int blocks_per_sm(int* blocks, int* smem_bytes) {
  const cudaError_t err = allow_smem<HD, kMasked>();
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(Smem<HD>::kBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attention_split_kernel<HD, kMasked>, am::kThreads, Smem<HD>::kBytes);
}

}  // namespace

// q, k, v (B, T, D) bf16 with row strides q_stride, k_stride, v_stride (in
// elements; each a multiple of 8, batch stride T * row stride, 16-byte aligned
// base), mask (T, T) fp32 contiguous or null, out (B, T, D) bf16 contiguous;
// D = H * head_dim with head_dim a multiple of 8 up to 128 or one of
// FMM_WIDE_HEAD_DIMS.
FMM_EXPORT int fmm_attention_split(const void* q, const void* k, const void* v, int q_stride,
                                   int k_stride, int v_stride, const void* mask, void* out,
                                   int B, int T, int D, int H, int head_dim, float scale,
                                   void* stream) {
  if (B < 1 || T < 1 || H < 1 || D != H * head_dim || q_stride % 8 || k_stride % 8 ||
      v_stride % 8 || q_stride < D || k_stride < D || v_stride < D)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define FMM_LAUNCH(n) \
  case n:             \
    return launch<n>(q, k, v, q_stride, k_stride, v_stride, mask, out, B, T, D, H, scale, s);
    FMM_HEAD_DIMS(FMM_LAUNCH)
    FMM_WIDE_HEAD_DIMS(FMM_LAUNCH)
#undef FMM_LAUNCH
    default:
      return cudaErrorInvalidValue;
  }
}

// Resident blocks per SM of the kernel at head width head_dim, with a mask
// or without (registers and shared memory as built) into *blocks, its
// dynamic shared memory into *smem_bytes.
FMM_EXPORT int fmm_attention_split_blocks_per_sm(int head_dim, int masked, int* blocks,
                                                 int* smem_bytes) {
  switch (head_dim) {
#define FMM_OCCUPANCY(n)                                                  \
  case n:                                                                 \
    return masked ? blocks_per_sm<n, true>(blocks, smem_bytes)          \
                  : blocks_per_sm<n, false>(blocks, smem_bytes);
    FMM_HEAD_DIMS(FMM_OCCUPANCY)
    FMM_WIDE_HEAD_DIMS(FMM_OCCUPANCY)
#undef FMM_OCCUPANCY
    default:
      return cudaErrorInvalidValue;
  }
}
