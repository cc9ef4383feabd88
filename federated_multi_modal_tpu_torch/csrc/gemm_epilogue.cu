// gemm_epilogue: C = epilogue(op(A) . op(W)) in bf16 with fp32 accumulation
// on Hopper's warpgroup tensor-core instruction (wgmma), its operands
// brought into shared memory by the Tensor Memory Accelerator (TMA), in
// three layouts (all row-major in memory, none transposed in memory):
//   NN: A (M, K) . W (K, N)     -- W in the JAX package's input-major layout
//   NT: A (M, K) . W^T, W (N, K) -- the backward's dA = dC . W^T
//   TN: A^T . W, A (K, M), W (K, N) -- the weight gradient dW = X^T . dC,
//       contracting the batch-row axis; it may split that axis over tiles
//       into fp32 partial products (out holds one per split).
// The fused epilogue, in this order:
//   v = acc (+ bf16 bias[n])
//   pre_out[m, n] = v                        (bf16 or fp32, optional)
//   v = QuickGELU(v)                         (optional)
//   v = v * QuickGELU'(h[m, n])              (h bf16 or fp32, optional)
//   v = v (+ residual[m, n], bf16 or fp32)
//   C = v stored as bf16 or fp32.
// Each combination that is built is its own kernel instance, the epilogue's
// flags template parameters (kInstances below); a launch asks for one of
// them or is refused.
//
// Replaces the products inside the TPU whole-block kernels
// (federated_multi_modal_tpu/ops/pallas/fused_block.py): QKV (+b),
// out-projection (+b, +x, fp32 y), fc (+b, QuickGELU, and the saved
// pre-activation h of _train_fwd_kernel) and proj (+b, +y) of the forward
// (_block_body32 at :528, 555, 569, 574; the K6a body at :151, 176); and of
// _train_bwd_kernel the activation gradients dg = dout.W_proj^T with
// dh = dg * QuickGELU'(h), dxn2 = dh.W_fc^T, da = dyh.W_out^T,
// dyln1 = dqkv.W_qkv^T (NT) and the weight gradients xn2^T.dh,
// gelu(h)^T.dout, a^T.dyh, xn1^T.dqkv (TN). Its NT instance with no
// epilogue and fp32 out also serves P2's dxn = d(QKV) . W^T
// (fmm_gemm_nt_f32; tools/attn_microbench.py::fused_lnqkv_attention_bwd_dx).
//
// Bound on the H100: operations, for all but the out-projection. At
// ViT-B/16 (M = 102,400 rows, D 768, hidden 3072) the four forward products
// are 1.45 TFLOP, ~1.47 ms at 989 TFLOP/s dense bf16; the out-projection
// alone (121 GFLOP against 157 MB of A, 157 MB of x and 315 MB of fp32 y) is
// bounded by its bytes, ~0.19 ms at 3.35 TB/s.
//
// Design (the warp-specialised persistent Hopper GEMM): one block an SM,
// each walking 128 x 256 output tiles (tile t, t + grid, ...; N fastest, so
// the blocks in flight share 128-row bands of A and W stays in L2) with
// three warpgroups. Warpgroup 0 is the producer: it gives up its registers
// (setmaxnreg 40) and one thread keeps a ring of 4 shared-memory stages
// filled by TMA (a 128 x 64 tile of A and a 64 x 256 tile of W, 48 KB,
// 128-byte swizzled), each stage with a "full" mbarrier (the bytes landed)
// and an "empty" one (both consumers are done with it). Warpgroups 1 and 2
// are the consumers (setmaxnreg 232), each owning 64 rows of the tile: per
// stage four wgmma m64n256k16 into 128 fp32 accumulators a thread. An
// operand whose contraction axis is not contiguous (NN's and TN's W, TN's
// A) is read MN-major through wgmma's transpose immediates. A consumer
// keeps one wgmma group in flight (wait_group 1) and frees a stage only
// when the group after it is issued. Since the producer runs ahead across
// tiles, the next tile's loads land while the consumers run the epilogue.
// The epilogue works on the accumulator fragments in registers (the bias,
// QuickGELU, h and the residual read in the fragments' own layout; h and
// the residual are brought into L2 by a bulk prefetch as the tile's main
// loop starts, and read a half tile at a time); each warp stages its 16 rows
// in 32-column chunks in shared memory of its own, and writes them out with
// 16-byte stores, a row's 64 or 128 bytes by adjacent lanes. What keeps it
// off its bound: the epilogue runs while the tile's tensor cores wait (both
// consumers finish one tile together), which costs the out-projection and
// the products with QuickGELU or h most. The TMA fills what lies past M, N or K with zeros; rows
// and columns past M and N are not written. Each output element is summed
// by one block in one order (a split's partial too), so two launches give
// the same bits.
#include <cuda.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using fmm::bf16;
namespace wg = fmm::wg;

constexpr int kBM = 128;       // rows of the output tile
constexpr int kBN = 256;       // columns of the output tile
constexpr int kBK = 64;        // contraction step: one 128-byte row of bf16
constexpr int kStages = 4;
constexpr int kConsumers = 2;  // warpgroups of 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTileA = kBM * kBK * 2;
constexpr int kTileB = kBN * kBK * 2;
constexpr int kStageBytes = kTileA + kTileB;
constexpr int kChunk = 64 * kBK * 2;  // one 64-wide MN-major chunk (or 64 K-major rows)
constexpr int kCols = 32;             // columns of an output chunk staged at a time
constexpr int kLd = kCols + 8;        // its row stride in elements (against bank conflicts)

enum Layout : int { kNN = 0, kNT = 1, kTN = 2 };

// The epilogue's flags as one code: bias (bit 0), QuickGELU (bit 1), then
// two bits each for pre_out, h and the residual (0 absent, 1 bf16, 2 fp32)
// and the output's type (bit 8: fp32).
constexpr int code(int bias, int gelu, int pre, int dgelu, int res, int out_f32) {
  return bias | gelu << 1 | pre << 2 | dgelu << 4 | res << 6 | out_f32 << 8;
}

template <int E>
struct Epi {
  static constexpr bool bias = E & 1;
  static constexpr bool gelu = (E >> 1) & 1;
  static constexpr int pre = (E >> 2) & 3;
  static constexpr int dgelu = (E >> 4) & 3;
  static constexpr int res = (E >> 6) & 3;
  static constexpr bool out_f32 = (E >> 8) & 1;
  static constexpr int pre_bytes = 16 * kLd * (pre == 0 ? 0 : pre == 1 ? 2 : 4);
  static constexpr int warp_bytes = pre_bytes + 16 * kLd * (out_f32 ? 4 : 2);
};

// 1 KB to align the stages (the 128-byte swizzle repeats every 1 KB), the
// stages, the eight consumer warps' staging chunks, then the full and empty
// barriers.
template <int E>
constexpr size_t smem_bytes() {
  return 1024 + kStages * kStageBytes + 8 * Epi<E>::warp_bytes + 2 * kStages * sizeof(uint64_t);
}

struct Params {
  int M, N, K;
  int k_per_split;
  int tiles_n;   // 256-column tiles
  int tiles_mn;  // output tiles of one split
  int tiles;     // tiles_mn x splits
  const bf16* bias;
  void* pre;
  const void* dgelu;
  const void* res;
  void* out;
};

// sigmoid(1.702 h) with the fast exponential and division, a few ulp of
// fp32 (on an H100, fc's product at M = 102,400 took 1.49 ms with
// the IEEE reciprocal __frcp_rn and 0.92 ms with this)
__device__ __forceinline__ float sigmoid_qg(float h) {
  return __fdividef(1.f, 1.f + __expf(-1.702f * h));
}

// Bring the 256 columns from n0 of a warp's 16 rows of an epilogue input
// into L2 ahead of the epilogue (one bulk prefetch a row, lanes 0-15).
template <int F32>
__device__ __forceinline__ void prefetch_rows(const void* base, int row0, int n0, int M, int N,
                                              int lane) {
  const int row = row0 + lane;
  if (lane < 16 && row < M) {
    const int cols = N - n0 < kBN ? N - n0 : kBN;
    const char* addr = static_cast<const char*>(base) +
                       (static_cast<size_t>(row) * N + n0) * (F32 ? 4 : 2);
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(addr),
                 "r"(cols * (F32 ? 4 : 2))
                 : "memory");
  }
}

template <int F32>
__device__ __forceinline__ float2 load2(const void* p, size_t off) {
  if constexpr (F32) {
    return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + off);
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p) + off));
  }
}

template <int F32>
__device__ __forceinline__ void stage2(unsigned char* st, int r, int c, float v0, float v1) {
  if constexpr (F32) {
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(st) + r * kLd + c) = make_float2(v0, v1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(st) + r * kLd + c) =
        __floats2bfloat162_rn(v0, v1);
  }
}

// A warp's staged 16 x 32 chunk to dst rows row0.., columns col0.., 16
// bytes a lane.
template <int F32>
__device__ __forceinline__ void write_chunk(const unsigned char* st, void* dst, size_t base,
                                            int row0, int col0, int M, int N, int lane) {
  constexpr int kPer = F32 ? 4 : 8;          // elements in 16 bytes
  constexpr int kLanesPerRow = kCols / kPer;
#pragma unroll
  for (int i = 0; i < 16 * kLanesPerRow / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / kLanesPerRow;
    const int c = (idx % kLanesPerRow) * kPer;
    const int row = row0 + r;
    const int col = col0 + c;
    if (row < M && col < N) {
      const size_t off = base + static_cast<size_t>(row) * N + col;
      const uint4 v = *reinterpret_cast<const uint4*>(st + (r * kLd + c) * (F32 ? 4 : 2));
      if constexpr (F32) {
        *reinterpret_cast<uint4*>(static_cast<float*>(dst) + off) = v;
      } else {
        *reinterpret_cast<uint4*>(static_cast<bf16*>(dst) + off) = v;
      }
    }
  }
}

// The epilogue of one consumer warp's 16 x 256 rows of the tile, from its
// accumulator fragments (d[4 j + e] at row g + 8 (e / 2), column
// 8 j + 2 t + e % 2 of the warp's rows, lane = 4 g + t). The tile is taken
// in two halves of 128 columns: the half's inputs (h, the residual) are
// loaded first, all at once, then its four 32-column chunks are finished,
// staged and written.
template <int E>
__device__ __forceinline__ void epilogue(const float (&d)[128], const Params& p,
                                         unsigned char* st, int row0, int n0, int z, int lane) {
  using EP = Epi<E>;
  constexpr int kHalfJ = kBN / 16;  // 8-column groups j in a half
  unsigned char* st_pre = st;
  unsigned char* st_out = st + EP::pre_bytes;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t out_base = static_cast<size_t>(z) * p.M * p.N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float2 hin[EP::dgelu != 0 ? 2 * kHalfJ : 1];
    float2 rin[EP::res != 0 ? 2 * kHalfJ : 1];
#pragma unroll
    for (int jh = 0; jh < kHalfJ; ++jh) {
      const int col = n0 + 8 * (half * kHalfJ + jh) + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + g + 8 * h;
        const bool in = row < p.M && col < p.N;
        const size_t off = static_cast<size_t>(row) * p.N + col;
        if constexpr (EP::dgelu != 0)
          hin[2 * jh + h] = in ? load2<EP::dgelu == 2>(p.dgelu, off) : make_float2(0.f, 0.f);
        if constexpr (EP::res != 0)
          rin[2 * jh + h] = in ? load2<EP::res == 2>(p.res, off) : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int ch = 0; ch < kHalfJ / 4; ++ch) {
      const int c = half * (kHalfJ / 4) + ch;  // the 32-column chunk
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int jh = 4 * ch + jj;
        const int j = half * kHalfJ + jh;
        const int lc = 8 * jj + 2 * t;
        const int col = n0 + c * kCols + lc;
        float2 b = make_float2(0.f, 0.f);
        if constexpr (EP::bias) {
          if (col < p.N)
            b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.bias + col));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lr = g + 8 * h;
          float v0 = d[4 * j + 2 * h];
          float v1 = d[4 * j + 2 * h + 1];
          if constexpr (EP::bias) {
            v0 += b.x;
            v1 += b.y;
          }
          if constexpr (EP::pre != 0) stage2<EP::pre == 2>(st_pre, lr, lc, v0, v1);
          if constexpr (EP::gelu) {
            v0 = v0 * sigmoid_qg(v0);
            v1 = v1 * sigmoid_qg(v1);
          }
          if constexpr (EP::dgelu != 0) {
            const float2 hh = hin[2 * jh + h];
            const float s0 = sigmoid_qg(hh.x);
            const float s1 = sigmoid_qg(hh.y);
            v0 = v0 * (s0 * (1.f + 1.702f * hh.x * (1.f - s0)));
            v1 = v1 * (s1 * (1.f + 1.702f * hh.y * (1.f - s1)));
          }
          if constexpr (EP::res != 0) {
            v0 += rin[2 * jh + h].x;
            v1 += rin[2 * jh + h].y;
          }
          stage2<EP::out_f32>(st_out, lr, lc, v0, v1);
        }
      }
      __syncwarp();
      if constexpr (EP::pre != 0) {
        write_chunk<EP::pre == 2>(st_pre, p.pre, 0, row0, n0 + c * kCols, p.M, p.N, lane);
      }
      write_chunk<EP::out_f32>(st_out, p.out, out_base, row0, n0 + c * kCols, p.M, p.N, lane);
      __syncwarp();
    }
  }
}

template <int L, int E>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_epilogue_kernel(const __grid_constant__ CUtensorMap a_map,
                         const __grid_constant__ CUtensorMap b_map, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* staged = smem + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + 8 * Epi<E>::warp_bytes);
  uint64_t* empty = full + kStages;
  const int wgi = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // The producer: one thread keeps the ring full, across tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int z = tile / p.tiles_mn;
        const int rem = tile - z * p.tiles_mn;
        const int m0 = rem / p.tiles_n * kBM;
        const int n0 = rem % p.tiles_n * kBN;
        const int k_begin = z * p.k_per_split;
        const int nk = (min(p.K, k_begin + p.k_per_split) - k_begin + kBK - 1) / kBK;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages;
          wg::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          unsigned char* a_s = smem + s * kStageBytes;
          unsigned char* b_s = a_s + kTileA;
          const int k0 = k_begin + kt * kBK;
          wg::mbar_expect_tx(&full[s], kStageBytes);
          if constexpr (L == kTN) {
#pragma unroll
            for (int c = 0; c < kBM / 64; ++c)
              wg::tma_load_2d(a_s + c * kChunk, &a_map, &full[s], m0 + 64 * c, k0);
          } else {
            wg::tma_load_2d(a_s, &a_map, &full[s], k0, m0);
          }
          if constexpr (L == kNT) {
            wg::tma_load_2d(b_s, &b_map, &full[s], k0, n0);
          } else {
#pragma unroll
            for (int c = 0; c < kBN / 64; ++c)
              wg::tma_load_2d(b_s + c * kChunk, &b_map, &full[s], n0 + 64 * c, k0);
          }
        }
      }
    }
  } else {
    // A consumer: rows [64 cw, 64 cw + 64) of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wgi - 1;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    unsigned char* st = staged + (cw * 4 + warp) * Epi<E>::warp_bytes;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int z = tile / p.tiles_mn;
      const int rem = tile - z * p.tiles_mn;
      const int m0 = rem / p.tiles_n * kBM;
      const int n0 = rem % p.tiles_n * kBN;
      const int k_begin = z * p.k_per_split;
      const int nk = (min(p.K, k_begin + p.k_per_split) - k_begin + kBK - 1) / kBK;
      const int row0 = m0 + cw * 64 + warp * 16;
      if constexpr (Epi<E>::dgelu != 0)
        prefetch_rows<Epi<E>::dgelu == 2>(p.dgelu, row0, n0, p.M, p.N, lane);
      if constexpr (Epi<E>::res != 0)
        prefetch_rows<Epi<E>::res == 2>(p.res, row0, n0, p.M, p.N, lane);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        wg::mbar_wait(&full[s], (it / kStages) & 1);
        const uint32_t a_base = wg::smem_u32(smem + s * kStageBytes) + cw * kChunk;
        const uint32_t b_base = wg::smem_u32(smem + s * kStageBytes + kTileA);
        wg::wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k) {
          const uint64_t da = L == kTN ? wg::desc_mn_major(a_base + k * 16 * 128, kChunk)
                                       : wg::desc_k_major(a_base + k * 32);
          const uint64_t db = L == kNT ? wg::desc_k_major(b_base + k * 32)
                                       : wg::desc_mn_major(b_base + k * 16 * 128, kChunk);
          wg::wgmma_m64n256k16<L == kTN, L != kNT>(d, da, db, kt > 0 || k > 0);
        }
        wg::wgmma_commit();
        // the group before this one is done: its stage goes back to the producer
        wg::wgmma_wait<1>();
        if (kt > 0) wg::mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wg::wgmma_wait<0>();
      wg::fence_operands(d);
      wg::mbar_arrive(&empty[(it - 1) % kStages]);
      epilogue<E>(d, p, st, row0, n0, z, lane);
    }
  }
}

template <int L, int E>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(gemm_epilogue_kernel<L, E>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes<E>()));
}

template <int L, int E>
cudaError_t launch(const CUtensorMap& a_map, const CUtensorMap& b_map, const Params& p,
                   int grid, cudaStream_t stream) {
  const cudaError_t err = allow_smem<L, E>();
  if (err != cudaSuccess) return err;
  gemm_epilogue_kernel<L, E><<<grid, kThreads, smem_bytes<E>(), stream>>>(a_map, b_map, p);
  return cudaGetLastError();
}

template <int L, int E>
cudaError_t occupancy(int* blocks, int* smem) {
  const cudaError_t err = allow_smem<L, E>();
  if (err != cudaSuccess) return err;
  *smem = static_cast<int>(smem_bytes<E>());
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gemm_epilogue_kernel<L, E>,
                                                       kThreads, smem_bytes<E>());
}

struct Instance {
  int layout;
  int code;
  cudaError_t (*launch)(const CUtensorMap&, const CUtensorMap&, const Params&, int, cudaStream_t);
  cudaError_t (*occupancy)(int*, int*);
};

// The instances built (layout, code(bias, gelu, pre, h, residual, out_f32)):
// every product of the vision blocks and P2 (QKV; out-projection into an
// fp32 y, into bf16 and, in the block group, from and into the fp32
// stream; fc, with bf16 or fp32 h beside it; proj; dh with bf16 or fp32 h;
// dxn2, dyln1 and P2's dxn in fp32; da in bf16; the weight gradients), and
// NN's other plain, bias and QuickGELU forms in either output type.
#define FMM_INSTANCE(L, C) {L, C, launch<L, C>, occupancy<L, C>},
const Instance kInstances[] = {
    FMM_INSTANCE(kNN, code(0, 0, 0, 0, 0, 0))
    FMM_INSTANCE(kNN, code(0, 0, 0, 0, 0, 1))
    FMM_INSTANCE(kNN, code(1, 0, 0, 0, 0, 0))
    FMM_INSTANCE(kNN, code(1, 0, 0, 0, 0, 1))
    FMM_INSTANCE(kNN, code(1, 1, 0, 0, 0, 0))
    FMM_INSTANCE(kNN, code(1, 1, 0, 0, 0, 1))
    FMM_INSTANCE(kNN, code(1, 0, 0, 0, 1, 0))
    FMM_INSTANCE(kNN, code(1, 0, 0, 0, 1, 1))
    FMM_INSTANCE(kNN, code(1, 0, 0, 0, 2, 0))
    FMM_INSTANCE(kNN, code(1, 0, 0, 0, 2, 1))
    FMM_INSTANCE(kNN, code(1, 1, 1, 0, 0, 0))
    FMM_INSTANCE(kNN, code(1, 1, 2, 0, 0, 0))
    FMM_INSTANCE(kNT, code(0, 0, 0, 0, 0, 0))
    FMM_INSTANCE(kNT, code(0, 0, 0, 0, 0, 1))
    FMM_INSTANCE(kNT, code(0, 0, 0, 1, 0, 0))
    FMM_INSTANCE(kNT, code(0, 0, 0, 2, 0, 0))
    FMM_INSTANCE(kTN, code(0, 0, 0, 0, 0, 1))
};
#undef FMM_INSTANCE

const Instance* find_instance(int layout, int c) {
  for (const Instance& inst : kInstances)
    if (inst.layout == layout && inst.code == c) return &inst;
  return nullptr;
}

int field(const void* ptr, int f32) { return ptr == nullptr ? 0 : f32 ? 2 : 1; }

}  // namespace

// layout 0 (NN): A (M, K), W (K, N); 1 (NT): A (M, K), W (N, K); 2 (TN):
// A (K, M), W (K, N). bias (N,) bf16, pre_out, dgelu_in, residual and out
// (M, N), each bf16 or fp32 by its flag, or null; the layout and the
// epilogue must be one of the instances built (kInstances), else the launch
// is refused (cudaErrorInvalidValue). With splits > 1 (TN, fp32 out, no
// epilogue) split s contracts k in [s * k_per_split, (s + 1) * k_per_split)
// into out[s]; k_per_split is a multiple of 64. All contiguous and 16-byte
// aligned; N % 8 == 0, and K % 8 == 0 (NN, NT) or M % 8 == 0 (TN).
FMM_EXPORT int fmm_gemm_epilogue(const void* A, const void* W, int layout, int M, int N, int K,
                                 int splits, int k_per_split, const void* bias, void* pre_out,
                                 int pre_f32, int gelu, const void* dgelu_in, int dgelu_f32,
                                 const void* residual, int residual_f32, void* out, int out_f32,
                                 void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 8 != 0 || splits < 1) return cudaErrorInvalidValue;
  if (layout == kTN ? M % 8 != 0 : K % 8 != 0) return cudaErrorInvalidValue;
  if (k_per_split % kBK != 0 || static_cast<long long>(splits) * k_per_split < K ||
      static_cast<long long>(splits - 1) * k_per_split >= K) {
    return cudaErrorInvalidValue;
  }
  const int c = code(bias != nullptr, gelu != 0, field(pre_out, pre_f32),
                     field(dgelu_in, dgelu_f32), field(residual, residual_f32), out_f32 != 0);
  if (splits > 1 && c != code(0, 0, 0, 0, 0, 1)) return cudaErrorInvalidValue;
  const Instance* inst = find_instance(layout, c);
  if (inst == nullptr) return cudaErrorInvalidValue;
  const long long tiles_mn =
      static_cast<long long>((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles_mn * splits > INT32_MAX) return cudaErrorInvalidValue;
  CUtensorMap a_map, b_map;
  const bool a_ok = layout == kTN ? wg::make_map(&a_map, A, M, K, 64)
                                  : wg::make_map(&a_map, A, K, M, kBM);
  const bool b_ok = layout == kNT ? wg::make_map(&b_map, W, K, N, kBN)
                                  : wg::make_map(&b_map, W, N, K, 64);
  if (!a_ok || !b_ok) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const Params p{M, N, K, k_per_split, (N + kBN - 1) / kBN, static_cast<int>(tiles_mn),
                 static_cast<int>(tiles_mn * splits), static_cast<const bf16*>(bias), pre_out,
                 dgelu_in, residual, out};
  const int grid = p.tiles < sms ? p.tiles : sms;
  return inst->launch(a_map, b_map, p, grid, static_cast<cudaStream_t>(stream));
}

// P2's product: C (M, N) fp32 = A (M, K) . B (N, K)^T, the NT instance with
// no epilogue; A, B bf16 and C contiguous and 16-byte aligned, K and N
// multiples of 8.
FMM_EXPORT int fmm_gemm_nt_f32(const void* A, const void* B, void* C, int M, int N, int K,
                               void* stream) {
  if (K < 1) return cudaErrorInvalidValue;
  return fmm_gemm_epilogue(A, B, kNT, M, N, K, 1, (K + kBK - 1) / kBK * kBK, nullptr, nullptr,
                           0, 0, nullptr, 0, nullptr, 0, C, 1, stream);
}

// Resident blocks per SM of one instance into *blocks, its dynamic shared
// memory into *smem_bytes: `variant` is layout * 512 + the epilogue's code
// (kInstances); `masked` is unused.
FMM_EXPORT int fmm_gemm_epilogue_blocks_per_sm(int variant, int masked, int* blocks,
                                               int* smem_bytes) {
  (void)masked;
  const Instance* inst = find_instance(variant / 512, variant % 512);
  if (inst == nullptr) return cudaErrorInvalidValue;
  return inst->occupancy(blocks, smem_bytes);
}
