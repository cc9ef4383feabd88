// gemm_epilogue: C = epilogue(op(A) . op(W)) in bf16 with fp32 accumulation
// on the tensor cores, in three layouts (all row-major in memory):
//   NN: A (M, K) . W (K, N)     -- W in the JAX package's input-major layout
//   NT: A (M, K) . W^T, W (N, K) -- the backward's dA = dC . W^T
//   TN: A^T . W, A (K, M), W (K, N) -- the weight gradient dW = X^T . dC,
//       contracting the batch-row axis; it may split that axis over
//       blockIdx.z into fp32 partial products (out holds one per split).
// The fused epilogue, in this order:
//   v = acc (+ bf16 bias[n])
//   pre_out[m, n] = v                        (bf16 or fp32, optional)
//   v = QuickGELU(v)                         (optional)
//   v = v * QuickGELU'(h[m, n])              (h bf16 or fp32, optional)
//   v = v (+ residual[m, n], bf16 or fp32)
//   C = v stored as bf16 or fp32.
//
// Replaces the products inside the TPU whole-block kernels
// (federated_multi_modal_tpu/ops/pallas/fused_block.py): QKV (+b),
// out-projection (+b, +x, fp32 y), fc (+b, QuickGELU, and the saved
// pre-activation h of _train_fwd_kernel) and proj (+b, +y) of the forward
// (_block_body32, _train_fwd_kernel); and of _train_bwd_kernel the
// activation gradients dg = dout.W_proj^T with dh = dg * QuickGELU'(h),
// dxn2 = dh.W_fc^T, da = dyh.W_out^T, dyln1 = dqkv.W_qkv^T (NT) and the
// weight gradients xn2^T.dh, gelu(h)^T.dout, a^T.dyh, xn1^T.dqkv (TN).
// Bound on the H100: operations. At the vision shape (M = 101,888 rows of
// ViT-B/16) the four forward products are 1.44 TFLOP against ~1.2 GB of
// operands and results: ~1.46 ms at 989 TFLOP/s dense bf16 against
// ~0.36 ms of memory traffic; the backward's activation and weight
// gradients are another 1.44 TFLOP each.
// Design: 128x128 output tiles, 8 warps each owning a 64x32 sub-tile as
// 4x2 wmma 16x16x16 bf16 fragments with fp32 accumulators; K advances in
// steps of 32 through a two-stage cp.async ring in shared memory (rows
// padded by 8 elements against bank conflicts). A transposed operand is
// staged as it lies in memory and read by wmma in column-major order, so no
// operand is transposed in device memory. Consecutive blocks share one
// 128-row tile of A, so A streams from device memory about once while W
// stays in L2. The epilogue goes fragment by fragment through a per-warp
// fp32 scratch tile (the ring's memory, free by then), each lane finishing
// 8 contiguous outputs with 16- or 32-byte accesses. wgmma and TMA (the
// card's full tensor-core rate) are the later step.
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "fmm_common.cuh"

namespace {

using fmm::bf16;
using namespace nvcuda;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int kThreads = 256;
constexpr int kPad = 8;

enum Layout : int { kNN = 0, kNT = 1, kTN = 2 };

// One pipeline's shared-memory tiles, two stages each, as each layout
// stages its operands.
template <int L>
struct Tiles;
template <>
struct Tiles<kNN> {
  bf16 a[2][BM][BK + kPad];
  bf16 b[2][BK][BN + kPad];
};
template <>
struct Tiles<kNT> {
  bf16 a[2][BM][BK + kPad];
  bf16 b[2][BN][BK + kPad];  // W rows n, contiguous k
};
template <>
struct Tiles<kTN> {
  bf16 a[2][BK][BM + kPad];  // A rows k, contiguous m
  bf16 b[2][BK][BN + kPad];
};

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
  void* pre_out;         // (M, N) or null: v after the bias, before QuickGELU
  int pre_f32;
  int gelu;
  const void* dgelu_in;  // (M, N) or null: multiply by QuickGELU'(dgelu_in)
  int dgelu_f32;
  const void* residual;  // (M, N) or null
  int residual_f32;
  void* out;             // (M, N), or (splits, M, N) for a split contraction
  int out_f32;
};

template <int L>
__device__ __forceinline__ void load_tile(Tiles<L>& t, int s, const bf16* __restrict__ A,
                                          const bf16* __restrict__ W, int M, int N, int K,
                                          int m0, int n0, int k0, int k_end) {
  if constexpr (L == kTN) {
    // A stored (K, M): 32 rows of k x 16 chunks of 8 m.
    for (int i = threadIdx.x; i < BK * (BM / 8); i += kThreads) {
      const int r = i / (BM / 8);
      const int c = i % (BM / 8);
      const int gk = k0 + r;
      const int gm = m0 + c * 8;
      const bool ok = gk < k_end && gm < M;
      cp_async16(&t.a[s][r][c * 8], ok ? A + static_cast<size_t>(gk) * M + gm : A, ok);
    }
  } else {
    // A stored (M, K): 128 rows x 4 chunks of 8 k.
    for (int i = threadIdx.x; i < BM * (BK / 8); i += kThreads) {
      const int r = i / (BK / 8);
      const int c = i % (BK / 8);
      const int gm = m0 + r;
      const int gk = k0 + c * 8;
      const bool ok = gm < M && gk < k_end;
      cp_async16(&t.a[s][r][c * 8], ok ? A + static_cast<size_t>(gm) * K + gk : A, ok);
    }
  }
  if constexpr (L == kNT) {
    // W stored (N, K): 128 rows of n x 4 chunks of 8 k.
    for (int i = threadIdx.x; i < BN * (BK / 8); i += kThreads) {
      const int r = i / (BK / 8);
      const int c = i % (BK / 8);
      const int gn = n0 + r;
      const int gk = k0 + c * 8;
      const bool ok = gn < N && gk < k_end;
      cp_async16(&t.b[s][r][c * 8], ok ? W + static_cast<size_t>(gn) * K + gk : W, ok);
    }
  } else {
    // W stored (K, N): 32 rows of k x 16 chunks of 8 n.
    for (int i = threadIdx.x; i < BK * (BN / 8); i += kThreads) {
      const int r = i / (BN / 8);
      const int c = i % (BN / 8);
      const int gk = k0 + r;
      const int gn = n0 + c * 8;
      const bool ok = gk < k_end && gn < N;
      cp_async16(&t.b[s][r][c * 8], ok ? W + static_cast<size_t>(gk) * N + gn : W, ok);
    }
  }
}

__device__ __forceinline__ void load8(const void* p, int f32, size_t off, float* v) {
  if (f32) {
    const float4* rp = reinterpret_cast<const float4*>(static_cast<const float*>(p) + off);
    const float4 r0 = rp[0];
    const float4 r1 = rp[1];
    v[0] = r0.x; v[1] = r0.y; v[2] = r0.z; v[3] = r0.w;
    v[4] = r1.x; v[5] = r1.y; v[6] = r1.z; v[7] = r1.w;
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p) + off);
    const bf16* bv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(bv[e]);
  }
}

__device__ __forceinline__ void store8(void* p, int f32, size_t off, const float* v) {
  if (f32) {
    float4* op = reinterpret_cast<float4*>(static_cast<float*>(p) + off);
    op[0] = make_float4(v[0], v[1], v[2], v[3]);
    op[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 packed;
    __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(static_cast<bf16*>(p) + off) = packed;
  }
}

__device__ __forceinline__ float sigmoid_qg(float h) { return 1.f / (1.f + expf(-1.702f * h)); }

template <int L>
__global__ void __launch_bounds__(kThreads)
    gemm_epilogue_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, int M, int N,
                         int K, int k_per_split, Epilogue ep) {
  using ALayout = std::conditional_t<L == kTN, wmma::col_major, wmma::row_major>;
  using BLayout = std::conditional_t<L == kNT, wmma::col_major, wmma::row_major>;
  constexpr int a_ld = L == kTN ? BM + kPad : BK + kPad;
  constexpr int b_ld = L == kNT ? BK + kPad : BN + kPad;
  static_assert(sizeof(Tiles<L>) >= sizeof(float) * (kThreads / 32) * 16 * 16,
                "the epilogue scratch reuses the ring");
  __shared__ __align__(128) unsigned char smem_raw[sizeof(Tiles<L>)];
  Tiles<L>& t = *reinterpret_cast<Tiles<L>*>(smem_raw);

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 2;  // 2 warp rows of 64
  const int wn = warp & 3;   // 4 warp columns of 32

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (k_end - k_begin + BK - 1) / BK;
  load_tile<L>(t, 0, A, W, M, N, K, m0, n0, k_begin, k_end);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile<L>(t, (kt + 1) & 1, A, W, M, N, K, m0, n0, k_begin + (kt + 1) * BK, k_end);
    }
    cp_async_commit();  // possibly empty: keeps one group per iteration
    cp_async_wait_one();
    __syncthreads();
    const int s = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * 64 + i * 16;
        if constexpr (L == kTN) {
          wmma::load_matrix_sync(af[i], &t.a[s][kk][row], a_ld);
        } else {
          wmma::load_matrix_sync(af[i], &t.a[s][row][kk], a_ld);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + j * 16;
        if constexpr (L == kNT) {
          wmma::load_matrix_sync(bfr[j], &t.b[s][col][kk], b_ld);
        } else {
          wmma::load_matrix_sync(bfr[j], &t.b[s][kk][col], b_ld);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: lane owns row (lane / 2) and columns 8 * (lane % 2) .. +8 of
  // each 16x16 fragment.
  float* scratch = reinterpret_cast<float*>(smem_raw) + warp * 16 * 16;
  const size_t out_base = static_cast<size_t>(blockIdx.z) * M * N;
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
        const size_t off = static_cast<size_t>(gm) * N + gn;
        if (ep.bias != nullptr) {
          const uint4 braw = *reinterpret_cast<const uint4*>(ep.bias + gn);
          const bf16* bv = reinterpret_cast<const bf16*>(&braw);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(bv[e]);
        }
        if (ep.pre_out != nullptr) store8(ep.pre_out, ep.pre_f32, off, v);
        if (ep.gelu) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = v[e] * sigmoid_qg(v[e]);
        }
        if (ep.dgelu_in != nullptr) {
          float h[8];
          load8(ep.dgelu_in, ep.dgelu_f32, off, h);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float sg = sigmoid_qg(h[e]);
            v[e] = v[e] * (sg * (1.f + 1.702f * h[e] * (1.f - sg)));
          }
        }
        if (ep.residual != nullptr) {
          float res[8];
          load8(ep.residual, ep.residual_f32, off, res);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += res[e];
        }
        store8(ep.out, ep.out_f32, out_base + off, v);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// layout 0 (NN): A (M, K), W (K, N); 1 (NT): A (M, K), W (N, K); 2 (TN):
// A (K, M), W (K, N). bias (N,) bf16, pre_out, dgelu_in, residual and out
// (M, N), each bf16 or fp32 by its flag, or null. With splits > 1 (TN,
// fp32 out, no epilogue) split s contracts k in [s * k_per_split,
// (s + 1) * k_per_split) into out[s]. All contiguous and 16-byte aligned;
// N % 8 == 0, and K % 8 == 0 (NN, NT) or M % 8 == 0 (TN).
FMM_EXPORT int fmm_gemm_epilogue(const void* A, const void* W, int layout, int M, int N, int K,
                                 int splits, int k_per_split, const void* bias, void* pre_out,
                                 int pre_f32, int gelu, const void* dgelu_in, int dgelu_f32,
                                 const void* residual, int residual_f32, void* out, int out_f32,
                                 void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 8 != 0 || splits < 1) return cudaErrorInvalidValue;
  if (layout == kTN ? M % 8 != 0 : K % 8 != 0) return cudaErrorInvalidValue;
  if (k_per_split % BK != 0 || static_cast<long long>(splits) * k_per_split < K ||
      static_cast<long long>(splits - 1) * k_per_split >= K) {
    return cudaErrorInvalidValue;
  }
  const bool epilogue = bias != nullptr || pre_out != nullptr || gelu || dgelu_in != nullptr ||
                        residual != nullptr;
  if (splits > 1 && (epilogue || !out_f32)) return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  Epilogue ep{static_cast<const bf16*>(bias), pre_out, pre_f32, gelu, dgelu_in, dgelu_f32,
              residual, residual_f32, out, out_f32};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* w = static_cast<const bf16*>(W);
  switch (layout) {
    case kNN:
      gemm_epilogue_kernel<kNN><<<grid, kThreads, 0, s>>>(a, w, M, N, K, k_per_split, ep);
      break;
    case kNT:
      gemm_epilogue_kernel<kNT><<<grid, kThreads, 0, s>>>(a, w, M, N, K, k_per_split, ep);
      break;
    case kTN:
      gemm_epilogue_kernel<kTN><<<grid, kThreads, 0, s>>>(a, w, M, N, K, k_per_split, ep);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
