// Tensor-core tile routines shared by the attention kernels: the forward
// (attn_fwd.cuh, behind attention_core.cu, attention_split.cu and
// lnqkv_attention.cu) and attention_core_bwd.cu (K1b, K2b and the attention
// backward of K3, K4 and K7): warp-level mma.sync m16n8k16 products (bf16
// in, fp32 accumulate) with ldmatrix fragment loads from shared memory, the
// cp.async copies that stream 64-row tiles through a ring of shared-memory
// stages, the additive mask read straight into accumulator fragments, and
// the online row max and sum of a softmax over fragment rows.
//
// A block is 4 warps; a tile is 64 rows, 16 per warp. Fragment layout (PTX
// ISA, mma.m16n8k16), lane = 4 g + t: a 16x8 fp32 accumulator c holds c[0],
// c[1] at row g, columns 2t and 2t + 1, and c[2], c[3] at row g + 8. The
// 16x16 bf16 A operand holds a[0] (row g, columns 2t, 2t + 1), a[1] (row
// g + 8), a[2] (row g, columns 2t + 8, 2t + 9) and a[3] (row g + 8); the
// 16x8 B operand holds b[0] (k 2t, 2t + 1 at column g) and b[1] (k 2t + 8,
// 2t + 9). So two accumulators side by side, rounded to bf16 pairs, are the
// A operand of the next product over those 16 columns, and scores and
// probabilities never leave registers (FlashAttention-2's layout).
//
// Shared-memory tiles are row-major with a row stride of (width + 8) bf16:
// the eight rows one ldmatrix reads start 16 bytes apart modulo 128, on
// eight different groups of four banks.
//
// A warp's score tile is 16 rows by 8 N8 columns (N8 = 8: a whole 64-row
// tile of the other operand; N8 = 4: half of one, where registers are
// short), held as N8 accumulators.
#pragma once

#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include "fmm_common.cuh"

// The head widths the attention sources are built for: multiples of 8 up
// to 128.
#define FMM_HEAD_DIMS(X) \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(72) X(80) X(88) X(96) X(104) X(112) X(120) X(128)

// The wider instances of the split-head forward (attention_split.cu): head
// widths past 128 in steps of 32 up to 288, each a whole Q, K and V tile
// row in shared memory and HD / 2 fp32 output accumulators a thread.
#define FMM_WIDE_HEAD_DIMS(X) X(160) X(192) X(224) X(256) X(288)

namespace fmm {

namespace attn_mma {

constexpr int kTile = 64;  // rows of a query or key tile
constexpr int kWarps = 4;  // 16 rows of a tile each
constexpr int kThreads = 32 * kWarps;

// One head of width HD in shared-memory tiles: the Q.K^T contraction
// zero-padded to a multiple of 16 (kHdp), the row stride kLd, and kNt
// 8-column tiles of an output row.
template <int HD>
struct Shape {
  static constexpr int kHdp = (HD + 15) / 16 * 16;
  static constexpr int kLd = kHdp + 8;
  static constexpr int kKSteps = kHdp / 16;
  static constexpr int kNt = HD / 8;
  static constexpr int kTileElems = kTile * kLd;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, asynchronously; zeros
// when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows [row0, row0 + n_rows) of a (T, stride) bf16 matrix at src, its first
// kCols columns (a multiple of 8), into dst (n_rows rows of ld elements), by
// the block's kBlockThreads threads; rows at or past T become zero. One copy
// group's worth: the caller commits.
template <int kCols, int kBlockThreads = kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* __restrict__ src,
                                          size_t stride, int row0, int T, int n_rows = kTile) {
  constexpr int kChunks = kCols / 8;
  for (int idx = threadIdx.x; idx < n_rows * kChunks; idx += kBlockThreads) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const bool valid = row0 + r < T;
    const bf16* s = valid ? src + static_cast<size_t>(row0 + r) * stride + c * 8 : src;
    cp_async16(dst + r * ld + c * 8, s, valid);
  }
}

// Columns [HD, kHdp) of the first `rows` rows at `tiles` enter Q.K^T as
// zeros; the copies never write them.
template <int HD, int kThreads>
__device__ __forceinline__ void zero_pad_columns(bf16* tiles, int rows) {
  using S = Shape<HD>;
  if (S::kHdp != HD) {
    for (int r = threadIdx.x; r < rows; r += kThreads)
      *reinterpret_cast<uint4*>(tiles + r * S::kLd + HD) = make_uint4(0, 0, 0, 0);
  }
}

// fp32 values [row0, row0 + kTile) of a length-T vector into dst; zeros at
// or past T.
__device__ __forceinline__ void load_values(float* dst, const float* __restrict__ src, int row0,
                                            int T) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool valid = row0 + i < T;
    cp_async4(dst + i, valid ? src + row0 + i : src, valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a b on the tensor cores: a 16x16 bf16, b 16x8 bf16, c 16x8 fp32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b with the product summed on the tensor cores from zero and added
// to c on the CUDA cores, rounded to nearest. The tensor cores' fp32 sums
// truncate: a product chained onto a large accumulator loses the low bits
// of the sum toward zero at every step, a bias that (c += a b) repeated
// along a row of keys carries into the result.
__device__ __forceinline__ void mma_rn(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma(d, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// mma_rn where kRn, else mma.
template <bool kRn>
__device__ __forceinline__ void mma_acc(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  if constexpr (kRn)
    mma_rn(c, a, b0, b1);
  else
    mma(c, a, b0, b1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of rows [r0, r0 + 16), columns [k0, k0 + 16) of a tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int r0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// The B operands of the two 8-column tiles n0 and n0 + 8 over k [k0, k0 +
// 16), from a tile that holds n along its rows (K for Q.K^T): b[0], b[1] of
// the first, b[2], b[3] of the second.
__device__ __forceinline__ void load_b_rows_n(uint32_t (&b)[4], const bf16* tile, int ld, int n0,
                                              int k0) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;
  ldsm_x4(b, tile + (n0 + (m >> 1) * 8 + (lane & 7)) * ld + k0 + (m & 1) * 8);
}

// The same from a tile that holds k along its rows (V for P.V).
__device__ __forceinline__ void load_b_rows_k(uint32_t (&b)[4], const bf16* tile, int ld, int k0,
                                              int n0) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;
  ldsm_x4_trans(b, tile + (k0 + (m & 1) * 8 + (lane & 7)) * ld + n0 + (m >> 1) * 8);
}

// One 8-column tile n0 of the latter.
__device__ __forceinline__ void load_b_rows_k_x2(uint32_t (&b)[2], const bf16* tile, int ld,
                                                 int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x2_trans(b, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0);
}

// acc (16 x 8 N8, as N8 accumulators) += A (rows [a_row0, a_row0 + 16) of
// a_tile over columns [0, 16 KS), read from shared memory one 16-column step
// at a time) times the transpose of the tile's first 8 N8 rows over the same
// columns: one warp's block of a Q.K^T-shaped product.
template <int KS, int N8>
__device__ __forceinline__ void mma_abt(float (&acc)[N8][4], const bf16* a_tile, int a_ld,
                                        int a_row0, const bf16* tile, int ld) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    load_a(a, a_tile, a_ld, a_row0, kk * 16);
#pragma unroll
    for (int np = 0; np < N8 / 2; ++np) {
      uint32_t b[4];
      load_b_rows_n(b, tile, ld, np * 16, kk * 16);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// out (16 x 8 NT) += bf16(p) (16 x 8 n8, the accumulators p[p0], ...,
// p[p0 + n8 - 1], rounded to bf16 here; n8 even) times the tile's first 8
// n8 rows over columns [0, 8 NT): one warp's block of a P.V-shaped product.
// kRn adds each 16-key step's product to out rounded to nearest (mma_rn).
// p0 and n8 are constants once the caller's loops are unrolled.
template <int NT, bool kRn = false, int N8>
__device__ __forceinline__ void mma_pv(float (&out)[NT][4], const float (&p)[N8][4],
                                       const bf16* tile, int ld, int p0 = 0, int n8 = N8) {
  constexpr int kSteps = (N8 < kTile / 8 ? N8 : kTile / 8) / 2;  // 16-key steps of a tile
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    if (2 * kk >= n8) break;
    const float(&lo)[4] = p[p0 + 2 * kk];
    const float(&hi)[4] = p[p0 + 2 * kk + 1];
    uint32_t a[4];
    a[0] = pack_bf16(lo[0], lo[1]);
    a[1] = pack_bf16(lo[2], lo[3]);
    a[2] = pack_bf16(hi[0], hi[1]);
    a[3] = pack_bf16(hi[2], hi[3]);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      load_b_rows_k(b, tile, ld, kk * 16, np * 16);
      mma_acc<kRn>(out[2 * np], a, b[0], b[1]);
      mma_acc<kRn>(out[2 * np + 1], a, b[2], b[3]);
    }
    if (NT & 1) {
      uint32_t b[2];
      load_b_rows_k_x2(b, tile, ld, kk * 16, (NT - 1) * 8);
      mma_acc<kRn>(out[NT - 1], a, b[0], b[1]);
    }
  }
}

// d += a b on the fp64 tensor cores (mma.m8n8k4): a 8x4, b 4x8, d 8x8; lane
// = 4 g + t holds a at (row g, k t), b at (k t, column g), d[0], d[1] at
// (row g, columns 2t, 2t + 1): the top half of an m16n8 accumulator.
__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

// d += a b on the fp64 tensor cores (mma.m16n8k8): a 16x8, b 8x8, d 16x8;
// lane = 4 g + t holds a as (row g, k t), (row g + 8, k t) in a01 and (row
// g, k t + 4), (row g + 8, k t + 4) in a23, b as (k t, column g), (k t + 4,
// column g), and d as an m16n8 fp32 accumulator holds c. Not volatile: the
// compiler may interleave independent products.
__device__ __forceinline__ void dmma_k8(double (&d)[4], double2 a01, double2 a23, double2 b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a01.x), "d"(a01.y), "d"(a23.x), "d"(a23.y), "d"(b.x), "d"(b.y));
}

__device__ __forceinline__ double2 lds_f64x2(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}

__device__ __forceinline__ double lo_bf16(uint32_t x) {
  return static_cast<double>(__uint_as_float(x << 16));
}

__device__ __forceinline__ double hi_bf16(uint32_t x) {
  return static_cast<double>(__uint_as_float(x & 0xffff0000u));
}

// An m16n8k16 bf16 A fragment's row (a[0], a[2] or a[1], a[3]; or the two B
// fragments b[0], b[1] of one 8-column tile) as the four k steps of fp64
// m8n8k4 products. In k step j lane 4 g + t takes column (2t, 2t + 1, 2t +
// 8, 2t + 9)[j] of the 16: the same column in A and B, so the four steps sum
// all 16 columns.
__device__ __forceinline__ void split_k4(double (&x)[4], uint32_t lo8, uint32_t hi8) {
  x[0] = lo_bf16(lo8);
  x[1] = hi_bf16(lo8);
  x[2] = lo_bf16(hi8);
  x[3] = hi_bf16(hi8);
}

// mma_pv with each 16-key step's product summed on the fp64 tensor cores
// (the bf16 products are exact in fp64, and so is their sum but for
// operands ~2^53 apart) and added to out rounded to nearest: no step
// carries the bf16 tensor cores' truncation toward zero.
template <int NT, int N8>
__device__ __forceinline__ void mma_pv_exact(float (&out)[NT][4], const float (&p)[N8][4],
                                             const bf16* tile, int ld) {
#pragma unroll
  for (int kk = 0; kk < N8 / 2; ++kk) {
    double top[4], bottom[4];  // rows g and g + 8
    split_k4(top, pack_bf16(p[2 * kk][0], p[2 * kk][1]),
             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]));
    split_k4(bottom, pack_bf16(p[2 * kk][2], p[2 * kk][3]),
             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]));
#pragma unroll
    for (int np = 0; np < (NT + 1) / 2; ++np) {
      uint32_t b[4];
      if (2 * np + 1 < NT) {
        load_b_rows_k(b, tile, ld, kk * 16, np * 16);
      } else {
        uint32_t b2[2];
        load_b_rows_k_x2(b2, tile, ld, kk * 16, np * 16);
        b[0] = b2[0];
        b[1] = b2[1];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (2 * np + i >= NT) break;
        double bk[4];
        split_k4(bk, b[2 * i], b[2 * i + 1]);
        double d[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dmma(d[0], d[1], top[j], bk[j]);
          dmma(d[2], d[3], bottom[j], bk[j]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) out[2 * np + i][e] += static_cast<float>(d[e]);
      }
    }
  }
}

// acc (16 x 64, as 8 accumulators, holding the additive mask or -inf) =
// fp32(q.k) * scale + acc, where q.k is one warp's Q.K^T-shaped product as
// in mma_abt, summed on the fp64 tensor cores: the bf16 products are exact
// in fp64 and each partial sum of up to 128 of them is rounded to 53 bits,
// so fp32(q.k) is the correctly rounded score unless the exact sum lies
// within ~2^-46 of its largest partial sum of a rounding boundary. Half of
// the tile (4 accumulators, 32 fp64 registers) at a time. Bit nt of `live`
// (the same in every lane) says whether 8-column tile nt has an entry of
// acc that is not -inf; the products of the others are skipped, since
// their scores stay -inf.
template <int KS>
__device__ __forceinline__ void mma_abt_exact(float (&acc)[8][4], const bf16* a_tile, int a_ld,
                                              int a_row0, const bf16* tile, int ld, float scale,
                                              unsigned live) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(live >> (4 * half) & 0xfu)) continue;
    double d[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[nt][e] = 0.0;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      load_a(a, a_tile, a_ld, a_row0, kk * 16);
      double top[4], bottom[4];  // rows g and g + 8
      split_k4(top, a[0], a[2]);
      split_k4(bottom, a[1], a[3]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int nt0 = 4 * half + 2 * np;
        if (!(live >> nt0 & 3u)) continue;
        uint32_t b[4];
        load_b_rows_n(b, tile, ld, (2 * half + np) * 16, kk * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!(live >> (nt0 + i) & 1u)) continue;
          double bk[4];
          split_k4(bk, b[2 * i], b[2 * i + 1]);
          double(&dt)[4] = d[2 * np + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dmma(dt[0], dt[1], top[j], bk[j]);
            dmma(dt[2], dt[3], bottom[j], bk[j]);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[4 * half + nt][e] = static_cast<float>(d[nt][e]) * scale + acc[4 * half + nt][e];
  }
}

// One warp's 16 x 8 N8 score tile (rows row0 + [0, 16), columns col0 + [0,
// 8 N8)) set to its additive mask divided by `scale`, the value its product
// accumulates onto, so that scale * acc is q.k * scale + mask (exactly so
// for masks of 0 and -inf). Entries whose row lies at or past T, or whose
// column lies at or past T or col_end (the forward's valid_T: keys past it
// take no part), are -inf: a key past the end gets probability 0, and a row
// past the end (a padded query, or in the dK/dV pass a padded key) is never
// written, so a warp whose 16 rows all lie past T skips every tile. kTrans
// reads the mask at [column][row] (the dK/dV pass, whose rows are keys);
// without kMasked there is no mask (the kernels are built both ways, so that
// the mask's loads cost the mask-free kernels no registers). Returns whether
// the whole warp tile is -inf: its probabilities are all exactly 0, so the
// caller may skip it.
template <bool kTrans, bool kMasked, int N8>
__device__ __forceinline__ bool mask_tile(float (&acc)[N8][4], const float* __restrict__ mask,
                                          int T, int row0, int col0, float inv_scale,
                                          int col_end = INT_MAX) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  if (kMasked) {
    // All 32 loads are started before any is used (entries out of range read
    // entry 0 and are dropped below), so that they overlap.
#pragma unroll
    for (int nt = 0; nt < N8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + 8 * (e >> 1);
        const int col = col0 + nt * 8 + 2 * t + (e & 1);
        const int at = kTrans ? col * T + row : row * T + col;
        acc[nt][e] = __ldg(mask + (row < T && col < T ? at : 0));
      }
    }
  }
  bool all_masked = true;
#pragma unroll
  for (int nt = 0; nt < N8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1);
      const int col = col0 + nt * 8 + 2 * t + (e & 1);
      float v = -CUDART_INF_F;
      if (row < T && col < T && col < col_end) v = kMasked ? acc[nt][e] * inv_scale : 0.f;
      acc[nt][e] = v;
      all_masked &= v == -CUDART_INF_F;
    }
  }
  return __all_sync(0xffffffffu, all_masked);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Online softmax statistics of a warp's two fragment rows (r = 0: row g,
// r = 1: row g + 8) over one 16 x 8 N8 tile of scores s: m[r] is the running
// row max (the same in the four lanes of a quad), l[r] this lane's running
// sum of exp(s - m) over its own columns and, with kDp, d[r] this lane's
// running sum of exp(s - m) * dp; the sums are rescaled when m moves. The
// caller sums l and d over the quad at the end. kExactExp takes expf, as
// PyTorch's softmax does, where the sum must match it to the last bits (the
// forward); else the faster __expf.
template <bool kDp, bool kExactExp = false, int N8>
__device__ __forceinline__ void online_softmax(const float (&s)[N8][4], const float (&dp)[N8][4],
                                               float (&m)[2], float (&l)[2], float (&d)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int nt = 0; nt < N8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
    mx = quad_max(mx);
    const float base = mx == -CUDART_INF_F ? 0.f : mx;  // a row with no finite score yet
    const float alpha = kExactExp ? expf(m[r] - base) : __expf(m[r] - base);
    l[r] *= alpha;
    if (kDp) d[r] *= alpha;
#pragma unroll
    for (int nt = 0; nt < N8; ++nt) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float p = kExactExp ? expf(s[nt][e] - base) : __expf(s[nt][e] - base);
        l[r] += p;
        if (kDp) d[r] = fmaf(p, dp[nt][e], d[r]);
      }
    }
    m[r] = mx;
  }
}

}  // namespace attn_mma

}  // namespace fmm
