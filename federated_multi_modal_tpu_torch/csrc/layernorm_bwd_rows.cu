// layernorm_bwd_rows: the backward of LayerNorm over the last axis of a
// (rows, D) matrix, with the residual branch's gradient added, and
// column_sum: fp32 sums over the rows of a (rows, N) matrix.
//
// For each row, with the moments of x recomputed in fp32 (two passes, as
// the forward computes them) and x^ = (x - mean) * rstd:
//   gv = dxn * gamma
//   dx = dres + rstd * (gv - mean(gv) - x^ * mean(gv * x^))   (dres may be null)
// written in fp32 or bf16 (and optionally a second bf16 copy), and the
// per-block partial column sums of dxn * x^ (d gamma) and dxn (d beta),
// unless the caller wants none (P2, which returns no parameter gradient:
// a separate instantiation, whose dx bits are those of the one with
// partials).
//
// Replaces the two LayerNorm backwards and every column reduction of the
// TPU kernel _train_bwd_kernel
// (federated_multi_modal_tpu/ops/pallas/fused_block.py): LN2's, giving the
// fp32 dyh (residual gradient dout, the bf16 output cotangent), and LN1's,
// giving the block's dx in x's dtype (residual gradient dyh); dg1/db1 and
// dg2/db2; and for the trainable block the bias gradients db_qkv and db_fc
// (sums of the bf16 dqkv and dh), db_out and db_proj (sums of the fp32 dyh
// and dout), all accumulated in fp32. With no residual branch (dres null)
// it is the LayerNorm backward of fused_ln_attention_bwd, giving that
// kernel's dx, dgamma and dbeta.
//
// Bound on the H100: bytes. At the vision shape (102,400 rows of 768) LN2's
// backward reads fp32 y and dxn2 and bf16 dout (786 MB) and writes fp32 and
// bf16 dyh (472 MB), ~0.38 ms at 3.35 TB/s; LN1's reads bf16 x and fp32
// dyln1 and dyh and writes bf16 dx (944 MB, ~0.28 ms); K7's and P2's, with
// no residual, 629 MB (~0.19 ms). A column sum reads its matrix once (the
// bf16 dh of width 3072, 629 MB: ~0.19 ms).
//
// Design: one warp per row, a persistent grid (ln_bwd_plan in
// ops/kernels/fused_block.py: SMs x resident blocks, each warp taking rows
// warp, warp + stride, ... of the grid's warps), so that every SM stays
// busy to the last rows and no wave is left a quarter full.
//   - Each lane owns groups of 8 columns (8 * (lane + 32 t)), the same in
//     every row: a bf16 group is one 16-byte access, an fp32 group two, and
//     gamma is read once into registers. The per-lane arrays are sized to
//     D's bucket (D <= 256, 512, 768, 1024), not to 1024.
//   - Two rows in flight per warp: the next row's x and dxn are loaded
//     into registers before the current row's reductions start.
//   - Two rounds of warp sums, not four: sum x with sum gv, then the
//     squared deviations with sum gv * (x - mean) (times rstd, the sum of
//     gv * x^), two independent chains of shuffles each.
//   - d gamma and d beta stay in registers, a lane summing its own columns
//     over its rows; the block adds its warps' sums once at the end, in warp
//     order, and writes one partial; column_sum adds the partials.
// A width that is not a multiple of 8 takes a scalar instance (groups of
// one column, 8 to 32 a lane by D's bucket). Every sum runs in a fixed order
// for a given grid, so the results repeat bit for bit; dx never depends on
// the grid.
#include "fmm_common.cuh"

namespace {

using fmm::bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 1024;
constexpr int kSumThreads = 256;  // column_sum's block

// kVec values of T as they lie in memory (16-byte aligned from 16 bytes on).
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec < 16 ? sizeof(T) * kVec : 16) Pack {
  T v[kVec];
};

template <typename T, int kVec>
__device__ __forceinline__ void load_stream(Pack<T, kVec>& p, const T* src) {
  constexpr int kBytes = static_cast<int>(sizeof(T)) * kVec;
  static_assert(kVec == 1 || kBytes % 16 == 0, "a group is whole 16-byte accesses");
  if constexpr (kVec == 1) {
    p.v[0] = __ldcs(src);
  } else {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      reinterpret_cast<uint4*>(p.v)[i] = __ldcs(reinterpret_cast<const uint4*>(src) + i);
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int kVec>
__device__ __forceinline__ void store(T* dst, const float (&v)[kVec]) {
  Pack<T, kVec> p;
#pragma unroll
  for (int i = 0; i < kVec; ++i) p.v[i] = from_f32<T>(v[i]);
  *reinterpret_cast<Pack<T, kVec>*>(dst) = p;
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

struct Params {
  const void* x;
  const float* dxn;
  const void* dres;
  const float* gamma;
  void* dx;
  bf16* dx_copy;
  float* partial;
  int rows;
  int D;
  float eps;
};

// What selects an instance, besides D.
struct Variant {
  int x_f32, dres_f32, dx_f32, partials;
};

// Dynamic shared memory: the block's d gamma / d beta reduction.
template <bool kPartials>
size_t smem_bytes(int D) {
  return kPartials ? static_cast<size_t>(kWarps) * 2 * D * sizeof(float) : 0;
}

template <typename Tx, typename Tres, typename Tout, bool kPartials, int kVec, int kBucket>
__global__ void __launch_bounds__(kThreads) layernorm_bwd_rows_kernel(const Params p) {
  constexpr int kGroups = kBucket * 8 / kVec;  // groups of kVec columns a lane owns
  extern __shared__ __align__(16) float red[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int D = p.D;
  const int n_groups = D / kVec;
  const long long rows = p.rows;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const Tx* __restrict__ x = static_cast<const Tx*>(p.x);
  const float* __restrict__ dxn = p.dxn;
  const Tres* __restrict__ dres = static_cast<const Tres*>(p.dres);
  Tout* __restrict__ dx = static_cast<Tout*>(p.dx);
  bf16* __restrict__ dx_copy = p.dx_copy;
  const bool has_res = dres != nullptr;
  const float inv_d = 1.f / D;

  bool valid[kGroups];
  float gam[kGroups][kVec];
  float acc_g[kPartials ? kGroups : 1][kVec];
  float acc_b[kPartials ? kGroups : 1][kVec];
#pragma unroll
  for (int t = 0; t < kGroups; ++t) {
    valid[t] = lane + 32 * t < n_groups;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      gam[t][i] = valid[t] ? __ldg(p.gamma + (lane + 32 * t) * kVec + i) : 0.f;
      if constexpr (kPartials) {
        acc_g[t][i] = 0.f;
        acc_b[t][i] = 0.f;
      }
    }
  }

  // The next row, in registers as it was loaded.
  Pack<Tx, kVec> px[kGroups];
  Pack<float, kVec> pd[kGroups];
  auto fetch = [&](long long row) {
#pragma unroll
    for (int t = 0; t < kGroups; ++t) {
      if (valid[t]) {
        const long long at = row * D + (lane + 32 * t) * kVec;
        load_stream(px[t], x + at);
        load_stream(pd[t], dxn + at);
      }
    }
  };
  if (first < rows) fetch(first);

  for (long long row = first; row < rows; row += stride) {
    float xv[kGroups][kVec];
    float dv[kGroups][kVec];
    Pack<Tres, kVec> pr[kGroups];
#pragma unroll
    for (int t = 0; t < kGroups; ++t) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        xv[t][i] = valid[t] ? fmm::to_f32(px[t].v[i]) : 0.f;
        dv[t][i] = valid[t] ? pd[t].v[i] : 0.f;
      }
    }
    if (row + stride < rows) fetch(row + stride);
    if (has_res) {
#pragma unroll
      for (int t = 0; t < kGroups; ++t) {
        if (valid[t]) load_stream(pr[t], dres + row * D + (lane + 32 * t) * kVec);
      }
    }

    // Every operation below is rounded as written (no contraction left to
    // the compiler), so dx has the same bits with or without partials.
    // Round 1: the mean of x and of gv = dxn * gamma.
    float sx = 0.f;
    float s1 = 0.f;
#pragma unroll
    for (int t = 0; t < kGroups; ++t) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        sx = __fadd_rn(sx, xv[t][i]);
        s1 = __fmaf_rn(dv[t][i], gam[t][i], s1);
      }
    }
    warp_sum2(sx, s1);
    const float mean = __fdiv_rn(sx, D);
    // Round 2: the variance about that mean, and sum gv * (x - mean).
    float sq = 0.f;
    float s2 = 0.f;
#pragma unroll
    for (int t = 0; t < kGroups; ++t) {
      if (valid[t]) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float d = __fsub_rn(xv[t][i], mean);
          sq = __fmaf_rn(d, d, sq);
          s2 = __fmaf_rn(__fmul_rn(dv[t][i], gam[t][i]), d, s2);
        }
      }
    }
    warp_sum2(sq, s2);
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(sq, D), p.eps));
    const float m1 = __fmul_rn(s1, inv_d);
    const float m2 = __fmul_rn(__fmul_rn(s2, rstd), inv_d);

#pragma unroll
    for (int t = 0; t < kGroups; ++t) {
      if (valid[t]) {
        float out[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float xh = __fmul_rn(__fsub_rn(xv[t][i], mean), rstd);
          const float gv = __fmul_rn(dv[t][i], gam[t][i]);
          const float g = __fmul_rn(rstd, __fsub_rn(__fsub_rn(gv, m1), __fmul_rn(xh, m2)));
          out[i] = has_res ? __fadd_rn(fmm::to_f32(pr[t].v[i]), g) : g;
          if constexpr (kPartials) {
            acc_g[t][i] = __fmaf_rn(dv[t][i], xh, acc_g[t][i]);
            acc_b[t][i] = __fadd_rn(acc_b[t][i], dv[t][i]);
          }
        }
        const long long at = row * D + (lane + 32 * t) * kVec;
        store<Tout, kVec>(dx + at, out);
        if (dx_copy != nullptr) store<bf16, kVec>(dx_copy + at, out);
      }
    }
  }

  if constexpr (kPartials) {
    // The block's partial: its warps' sums added in warp order.
    float* mine = red + static_cast<size_t>(warp) * 2 * D;
#pragma unroll
    for (int t = 0; t < kGroups; ++t) {
      if (valid[t]) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          mine[(lane + 32 * t) * kVec + i] = acc_g[t][i];
          mine[D + (lane + 32 * t) * kVec + i] = acc_b[t][i];
        }
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * D; j += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[static_cast<size_t>(w) * 2 * D + j];
      p.partial[static_cast<size_t>(blockIdx.x) * 2 * D + j] = s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    column_sum_kernel(const T* __restrict__ x, float* __restrict__ out, long long rows,
                      long long N, long long rows_per_split) {
  const long long c = static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (c >= N) return;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r1 = min(rows, r0 + rows_per_split);
  float s = 0.f;
  for (long long r = r0; r < r1; ++r) s += fmm::to_f32(x[r * N + c]);
  out[static_cast<long long>(blockIdx.y) * N + c] = s;
}

// Launch one instance on `blocks` blocks, or, with `occupancy` given,
// launch nothing and write its resident blocks per SM and dynamic shared
// memory to occupancy[0..1].
template <typename Tx, typename Tres, typename Tout, bool kPartials, int kVec, int kBucket>
cudaError_t run(const Params& p, int blocks, cudaStream_t stream, int* occupancy) {
  auto kernel = layernorm_bwd_rows_kernel<Tx, Tres, Tout, kPartials, kVec, kBucket>;
  const size_t smem = smem_bytes<kPartials>(p.D);  // at most 32 KB: no opt-in
  if (occupancy != nullptr) {
    occupancy[1] = static_cast<int>(smem);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[0], kernel, kThreads, smem);
  }
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tx, typename Tres, typename Tout, bool kP>
cudaError_t by_width(const Params& p, int blocks, cudaStream_t s, int* occ) {
  const int bucket = (p.D + 255) / 256;
  if (p.D % 8 != 0) {
    switch (bucket) {
      case 1:
        return run<Tx, Tres, Tout, kP, 1, 1>(p, blocks, s, occ);
      case 2:
        return run<Tx, Tres, Tout, kP, 1, 2>(p, blocks, s, occ);
      case 3:
        return run<Tx, Tres, Tout, kP, 1, 3>(p, blocks, s, occ);
      default:
        return run<Tx, Tres, Tout, kP, 1, 4>(p, blocks, s, occ);
    }
  }
  switch (bucket) {
    case 1:
      return run<Tx, Tres, Tout, kP, 8, 1>(p, blocks, s, occ);
    case 2:
      return run<Tx, Tres, Tout, kP, 8, 2>(p, blocks, s, occ);
    case 3:
      return run<Tx, Tres, Tout, kP, 8, 3>(p, blocks, s, occ);
    default:
      return run<Tx, Tres, Tout, kP, 8, 4>(p, blocks, s, occ);
  }
}

template <typename Tx, typename Tres, typename Tout>
cudaError_t by_partials(const Params& p, const Variant& v, int blocks, cudaStream_t s, int* occ) {
  return v.partials ? by_width<Tx, Tres, Tout, true>(p, blocks, s, occ)
                    : by_width<Tx, Tres, Tout, false>(p, blocks, s, occ);
}

template <typename Tx, typename Tres>
cudaError_t by_out(const Params& p, const Variant& v, int blocks, cudaStream_t s, int* occ) {
  return v.dx_f32 ? by_partials<Tx, Tres, float>(p, v, blocks, s, occ)
                  : by_partials<Tx, Tres, bf16>(p, v, blocks, s, occ);
}

template <typename Tx>
cudaError_t by_res(const Params& p, const Variant& v, int blocks, cudaStream_t s, int* occ) {
  return v.dres_f32 ? by_out<Tx, float>(p, v, blocks, s, occ)
                    : by_out<Tx, bf16>(p, v, blocks, s, occ);
}

cudaError_t dispatch(const Params& p, const Variant& v, int blocks, cudaStream_t s, int* occ) {
  if (p.D < 1 || p.D > kMaxD) return cudaErrorInvalidValue;
  return v.x_f32 ? by_res<float>(p, v, blocks, s, occ) : by_res<bf16>(p, v, blocks, s, occ);
}

}  // namespace

// x (rows, D) bf16 or fp32, dxn (rows, D) fp32, dres (rows, D) bf16 or
// fp32 or null, gamma (D,) fp32; dx (rows, D) bf16 or fp32, dx_copy (rows,
// D) bf16 or null; partial (blocks, 2, D) fp32 or null: per block, the sums
// of dxn * x^ and of dxn over its warps' rows. All contiguous and 16-byte
// aligned, D <= 1024. Warp w of the grid's blocks * 4 takes rows w, w +
// blocks * 4, ...
FMM_EXPORT int fmm_layernorm_bwd_rows(const void* x, int x_f32, const void* dxn, const void* dres,
                                      int dres_f32, const void* gamma, void* dx, int dx_f32,
                                      void* dx_copy, void* partial, int rows, int D, int blocks,
                                      float eps, void* stream) {
  if (rows < 1 || blocks < 1) return cudaErrorInvalidValue;
  const Params p{x,  static_cast<const float*>(dxn), dres, static_cast<const float*>(gamma),
                 dx, static_cast<bf16*>(dx_copy),     static_cast<float*>(partial),
                 rows, D, eps};
  const Variant v{x_f32, dres != nullptr && dres_f32, dx_f32, partial != nullptr};
  return dispatch(p, v, blocks, static_cast<cudaStream_t>(stream), nullptr);
}

// Resident blocks per SM and dynamic shared memory of the instance that
// fmm_layernorm_bwd_rows would launch for variant = D | x_f32 << 11 |
// dres_f32 << 12 | dx_f32 << 13 | partials << 14 (`masked` is not used).
// Launches nothing.
FMM_EXPORT int fmm_layernorm_bwd_rows_blocks_per_sm(int variant, int masked, int* blocks,
                                                    int* smem) {
  (void)masked;
  const int D = variant & 2047;
  const Variant v{(variant >> 11) & 1, (variant >> 12) & 1, (variant >> 13) & 1,
                  (variant >> 14) & 1};
  const Params p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, D, 0.f};
  int occ[2] = {0, 0};
  const cudaError_t err = dispatch(p, v, 1, nullptr, occ);
  *blocks = occ[0];
  *smem = occ[1];
  return err;
}

// x (rows, N) bf16 or fp32; out (splits, N) fp32: split s sums rows
// [s * rows_per_split, (s + 1) * rows_per_split). Contiguous.
FMM_EXPORT int fmm_column_sum(const void* x, int x_f32, void* out, long long rows, long long N,
                              int splits, long long rows_per_split, void* stream) {
  if (rows < 1 || N < 1 || splits < 1 || splits > 65535 || rows_per_split < 1 ||
      static_cast<long long>(splits) * rows_per_split < rows) {
    return cudaErrorInvalidValue;
  }
  const long long col_blocks = (N + kSumThreads - 1) / kSumThreads;
  if (col_blocks > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(col_blocks), static_cast<unsigned>(splits));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    column_sum_kernel<float><<<grid, kSumThreads, 0, s>>>(static_cast<const float*>(x),
                                                          static_cast<float*>(out), rows, N,
                                                          rows_per_split);
  } else {
    column_sum_kernel<bf16><<<grid, kSumThreads, 0, s>>>(static_cast<const bf16*>(x),
                                                         static_cast<float*>(out), rows, N,
                                                         rows_per_split);
  }
  return cudaGetLastError();
}
