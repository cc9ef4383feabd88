// gemm_wgmma: C (M, N) fp32 = A (M, K) . B (N, K)^T, A and B bf16 with K
// contiguous (both K-major, nothing transposed), on Hopper's warpgroup
// tensor-core instruction (wgmma) with its operands brought into shared
// memory by the Tensor Memory Accelerator (TMA).
//
// Serves P2 (lnqkv_attention_bwd_dx.cu's wrapper): dxn = d(QKV) . W^T, the
// sum over every head of the TPU prototype
// tools/attn_microbench.py::fused_lnqkv_attention_bwd_dx (pallas_call at
// :207), with W (D, 3D) as stored the K-major B operand and d(QKV) (B T, 3D)
// the K-major A. fp32 sums, fp32 out, no rounding of the sum.
//
// Bound on the H100: operations. At P2's shape (M = 102,400, N = 768, K =
// 2,304) it is 362 GFLOP, 0.366 ms at 989 TFLOP/s, against 472 MB of A,
// 3.5 MB of B and 315 MB of C (0.235 ms at 3.35 TB/s).
// Design (the usual warp-specialized Hopper GEMM, kept simple): one
// 128 x 128 tile of C per block, three warpgroups: warpgroup 0 is the
// producer, one thread of which keeps a ring of kStages shared-memory stages
// (a 128 x 64 tile of A and of B each, 32 KB) filled by TMA, each stage with
// a "full" mbarrier (the copy's bytes landed) and an "empty" one (both
// consumers are done with it); warpgroups 1 and 2 are the consumers, each
// owning 64 rows of the tile: per 64-deep stage four wgmma m64n128k16 from
// the 128-byte-swizzled tiles, 64 fp32 accumulators a thread, written
// straight to C at the end (rows past M and columns past N dropped; the TMA
// fills what lies past M, N or K with zeros). The 6 blocks of one 128-row
// band of A are adjacent in the grid, so A comes from device memory about
// once. Each block sums its whole K in one order and no sum crosses blocks,
// so two runs give the same bits. What keeps it off its bound: each
// consumer waits for its products before it frees a stage (no second
// wgmma group in flight), one block an SM (129 KB of shared memory) leaves
// the epilogue's stores unhidden, and C is written without TMA.
#include <cuda.h>
#include <limits.h>
#include <stdint.h>

#include "fmm_common.cuh"

namespace {

using fmm::bf16;

constexpr int kBM = 128;       // rows of A and C a block takes
constexpr int kBN = 128;       // rows of B (columns of C) a block takes
constexpr int kBK = 64;        // contraction step: one 128-byte row of bf16
constexpr int kStages = 4;
constexpr int kConsumers = 2;  // warpgroups of 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTileABytes = kBM * kBK * 2;
constexpr int kTileBBytes = kBN * kBK * 2;
constexpr int kStageBytes = kTileABytes + kTileBBytes;
// 1 KB to align the stages (the 128-byte swizzle repeats every 1 KB), the
// stages, then the full and empty barriers
constexpr size_t kSmem = 1024 + kStages * kStageBytes + 2 * kStages * sizeof(uint64_t);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of this parity has completed. A wait that
// outlasts any real copy or product (2^26 polls, each of which suspends the
// thread for a while) traps, so that a fault shows as a failed launch and
// not as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The box at (c0 along K, c1 along the rows) of a 2-D tensor map into dst,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor of a K-major tile whose rows are 128
// bytes, 128-byte swizzled as the TMA wrote them: the start address, the
// leading byte offset (unused for this layout, 16), the stride between
// 8-row groups (1024 bytes) and the swizzle mode.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d (64 x 128 fp32 over the warpgroup) += A (64 x 16) . B (128 x 16)^T, or
// d = the product when !accumulate.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    gemm_nt_f32_kernel(const __grid_constant__ CUtensorMap a_map,
                       const __grid_constant__ CUtensorMap b_map, float* __restrict__ c, int M,
                       int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x >> 7;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int n_k = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: one thread keeps the ring full.
    if (threadIdx.x == 0) {
      for (int it = 0; it < n_k; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* stage = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load_2d(stage, &a_map, &full[s], it * kBK, m0);
        tma_load_2d(stage + kTileABytes, &b_map, &full[s], it * kBK, n0);
      }
    }
    return;
  }

  // A consumer: rows [64 cw, 64 cw + 64) of the tile.
  const int cw = wg - 1;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int it = 0; it < n_k; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint32_t a_addr = smem_u32(smem + s * kStageBytes) + cw * 64 * 128;
    const uint32_t b_addr = smem_u32(smem + s * kStageBytes + kTileABytes);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k)
      wgmma_m64n128k16(d, sw128_desc(a_addr + 32 * k), sw128_desc(b_addr + 32 * k), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(d);
    mbar_arrive(&empty[s]);
  }

  // d[4 j + e] lies at row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2 of
  // the warpgroup's 64 x 128 block (w its warp, lane = 4 g + t).
  const int lane = threadIdx.x & 31;
  const int row = m0 + cw * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * (lane & 3);
    if (col >= N) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row + 8 * r;
      if (rr < M)
        *reinterpret_cast<float2*>(c + static_cast<size_t>(rr) * N + col) =
            make_float2(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the CUDA runtime's entry-point
// lookup (the library links no libcuda of its own).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, K) bf16 row-major matrix as a tensor map of boxes of kBK x
// box_rows, 128-byte swizzled, zeros past its edges.
bool make_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * sizeof(bf16)};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t allow_smem() {
  return cudaFuncSetAttribute(gemm_nt_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmem));
}

}  // namespace

// C (M, N) fp32 = A (M, K) . B (N, K)^T; A, B bf16 and C contiguous, A and
// B 16-byte aligned, C 8-byte aligned; K and N multiples of 8.
FMM_EXPORT int fmm_gemm_nt_f32(const void* A, const void* B, void* C, int M, int N, int K,
                               void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 8 || N % 8 || (M + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap a_map, b_map;
  if (!make_map(&a_map, A, M, K, kBM) || !make_map(&b_map, B, N, K, kBN))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_nt_f32_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      a_map, b_map, static_cast<float*>(C), M, N, K);
  return cudaGetLastError();
}

// Resident blocks per SM of the kernel into *blocks, its dynamic shared
// memory into *smem_bytes; `variant` and `masked` are unused.
FMM_EXPORT int fmm_gemm_nt_f32_blocks_per_sm(int variant, int masked, int* blocks,
                                             int* smem_bytes) {
  (void)variant;
  (void)masked;
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(kSmem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gemm_nt_f32_kernel, kThreads,
                                                       kSmem);
}
