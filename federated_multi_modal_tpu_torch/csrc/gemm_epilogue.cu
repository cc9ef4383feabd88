// gemm_epilogue: C = epilogue(A . W) with A (M, K) and W (K, N) row-major
// bf16 (W in the JAX package's input-major layout), fp32 accumulation on
// the tensor cores, and a fused epilogue:
//   v = acc (+ bf16 bias[n]) (QuickGELU) (+ residual[m, n], bf16 or fp32)
//   C = v stored as bf16 or fp32.
//
// Replaces the four products inside the TPU whole-block kernel
// (federated_multi_modal_tpu/ops/pallas/fused_block.py, _block_body32):
// QKV (+b), out-projection (+b, +x, fp32 y), fc (+b, QuickGELU) and proj
// (+b, +y).
// Bound on the H100: operations. At the vision shape (M = 101,888 rows,
// ViT-B/16) the four products are 1.44 TFLOP against ~1.2 GB of operands
// and results: ~1.46 ms at 989 TFLOP/s dense bf16 against ~0.36 ms of
// memory traffic.
// Design: 128x128 output tiles, 8 warps each owning a 64x32 sub-tile as
// 4x2 wmma 16x16x16 bf16 fragments with fp32 accumulators; K advances in
// steps of 32 through a two-stage cp.async ring in shared memory (rows
// padded by 8 elements against bank conflicts). Consecutive blocks share
// one 128-row tile of A, so A streams from device memory about once while
// W stays in L2. The epilogue goes fragment by fragment through a per-warp
// fp32 scratch tile, each lane finishing 8 contiguous outputs with 16- or
// 32-byte accesses. wgmma and TMA (the card's full tensor-core rate) are
// the later step.
#include <mma.h>
#include <stdint.h>

#include "fmm_common.cuh"

namespace {

using fmm::bf16;
using namespace nvcuda;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int kThreads = 256;
constexpr int A_LD = BK + 8;
constexpr int B_LD = BN + 8;

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem_ptr, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem_ptr), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Epilogue {
  const bf16* bias;      // (N,) or null
  const void* residual;  // (M, N) or null
  int residual_f32;
  int gelu;
  void* out;  // (M, N)
  int out_f32;
};

__device__ __forceinline__ void load_tile(bf16 (*As)[A_LD], bf16 (*Bs)[B_LD],
                                          const bf16* __restrict__ A,
                                          const bf16* __restrict__ W, int M, int N, int K, int m0,
                                          int n0, int k0) {
  // A: 128 rows x 4 chunks of 8 elements; W: 32 rows x 16 chunks.
  for (int i = threadIdx.x; i < BM * (BK / 8); i += kThreads) {
    const int r = i / (BK / 8);
    const int c = i % (BK / 8);
    const int gm = m0 + r;
    const int gk = k0 + c * 8;
    const bool ok = gm < M && gk < K;
    cp_async16(&As[r][c * 8], ok ? A + static_cast<size_t>(gm) * K + gk : A, ok);
  }
  for (int i = threadIdx.x; i < BK * (BN / 8); i += kThreads) {
    const int r = i / (BN / 8);
    const int c = i % (BN / 8);
    const int gk = k0 + r;
    const int gn = n0 + c * 8;
    const bool ok = gk < K && gn < N;
    cp_async16(&Bs[r][c * 8], ok ? W + static_cast<size_t>(gk) * N + gn : W, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
    gemm_epilogue_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, int M, int N,
                         int K, Epilogue ep) {
  __shared__ __align__(128) bf16 As[2][BM][A_LD];
  __shared__ __align__(128) bf16 Bs[2][BK][B_LD];
  __shared__ __align__(128) float Cs[kThreads / 32][16 * 16];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 2;  // 2 warp rows of 64
  const int wn = warp & 3;   // 4 warp columns of 32

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + BK - 1) / BK;
  load_tile(As[0], Bs[0], A, W, M, N, K, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile(As[(kt + 1) & 1], Bs[(kt + 1) & 1], A, W, M, N, K, m0, n0, (kt + 1) * BK);
    }
    cp_async_commit();  // possibly empty: keeps one group per iteration
    cp_async_wait_one();
    __syncthreads();
    const int s = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], &As[s][wm * 64 + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], &Bs[s][kk][wn * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: lane owns row (lane / 2) and columns 8 * (lane % 2) .. +8 of
  // each 16x16 fragment.
  float* scratch = Cs[warp];
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 64 + i * 16 + r;
      const int gn = n0 + wn * 32 + j * 16 + c0;
      if (gm < M && gn < N) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = scratch[r * 16 + c0 + e];
        if (ep.bias != nullptr) {
          const uint4 braw = *reinterpret_cast<const uint4*>(ep.bias + gn);
          const bf16* bv = reinterpret_cast<const bf16*>(&braw);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(bv[e]);
        }
        if (ep.gelu) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = v[e] * (1.f / (1.f + expf(-1.702f * v[e])));
        }
        const size_t off = static_cast<size_t>(gm) * N + gn;
        if (ep.residual != nullptr) {
          if (ep.residual_f32) {
            const float4* rp = reinterpret_cast<const float4*>(
                static_cast<const float*>(ep.residual) + off);
            const float4 r0 = rp[0];
            const float4 r1 = rp[1];
            v[0] += r0.x; v[1] += r0.y; v[2] += r0.z; v[3] += r0.w;
            v[4] += r1.x; v[5] += r1.y; v[6] += r1.z; v[7] += r1.w;
          } else {
            const uint4 rraw =
                *reinterpret_cast<const uint4*>(static_cast<const bf16*>(ep.residual) + off);
            const bf16* rv = reinterpret_cast<const bf16*>(&rraw);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(rv[e]);
          }
        }
        if (ep.out_f32) {
          float4* op = reinterpret_cast<float4*>(static_cast<float*>(ep.out) + off);
          op[0] = make_float4(v[0], v[1], v[2], v[3]);
          op[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          uint4 packed;
          __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
          *reinterpret_cast<uint4*>(static_cast<bf16*>(ep.out) + off) = packed;
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

// A (M, K), W (K, N), bias (N,) bf16 or null, residual (M, N) bf16 or fp32
// or null, out (M, N) bf16 or fp32; all contiguous, 16-byte aligned, with
// N % 8 == 0 and K % 8 == 0.
FMM_EXPORT int fmm_gemm_epilogue(const void* A, const void* W, const void* bias,
                                 const void* residual, int residual_f32, void* out, int out_f32,
                                 int M, int N, int K, int gelu, void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 8 != 0 || K % 8 != 0) return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  Epilogue ep{static_cast<const bf16*>(bias), residual, residual_f32, gelu, out, out_f32};
  gemm_epilogue_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(W), M, N, K, ep);
  return cudaGetLastError();
}
