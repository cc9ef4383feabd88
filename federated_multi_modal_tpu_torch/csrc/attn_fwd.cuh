// The attention forward on the tensor cores, shared by attention_core.cu
// (K1, K2 and the forward inside K3-K7 and K9), attention_split.cu (K8) and
// lnqkv_attention.cu (P1): softmax(q k^T * scale + mask) v for 16 query rows
// per warp on mma.sync (attn_mma.cuh), the scores in registers.
//
// Numerics are the TPU kernels' (_packed_fwd_body and _attn_body in
// federated_multi_modal_tpu/ops/pallas/attention.py): fp32 scores times the
// scale plus the fp32 mask, the fp32 softmax normalized and then rounded to
// bf16, P.V summed in fp32, bf16 output. Keys at or past n_keys (valid_T)
// are -inf. The softmax takes expf and a correctly rounded division, as
// PyTorch's does, not __expf and a reciprocal.
//
// kExact (attention_core.cu, P1) sums q.k on the fp64 tensor cores
// (mma.m8n8k4, am::mma_abt_exact, the bf16 fragments converted to fp64 in
// the product's loop), so each fp32 score is the correctly rounded one, and
// adds each 16-key step of P.V to the fp32 accumulators rounded to nearest
// (am::mma_rn); attention_core.cu's instances without a mask take
// attention_tile_f64 instead (the same numerics, its q.k on mma.m16n8k8
// fp64 from tiles converted once a block). With a mask (K1: the text tower,
// whose features reach the logits at CLIP's logit scale of 100) each step is
// summed on the fp64 tensor cores first (am::mma_pv_exact), since the bf16
// tensor cores' truncation within a step moved a trained 16-image step's
// vision gradients 2.5x past their limit against an exact forward
// (chip_smoke.py on an H100; a P.V in fp32 rounded to nearest read 0.36 of
// it). attention_tile's two passes (rows past 256 keys, and wider heads)
// sum P.V on the fp64 tensor cores with or without a mask: through
// ViT-L/14's 24 vision blocks the truncation put a trained 16-image step's
// vision gradients 1.57x past their limit (0.80 for the fully plain path,
// 0.38-0.45 with the forward's P.V summed exactly or in fp32; chip_smoke.py
// on an H100); ViT-L/14's 259 and 260 vision rows now take
// attention_tile_f64's one pass, each 16-key step rounded to nearest. p is
// rounded to bf16 right after the softmax, and a score's last fp32 bit flips
// that rounding often enough to move a 16-image train step's gradients past
// their limit against a plain path with an exact forward (chip_smoke.py):
// the bf16 tensor cores' sums truncate, and fp32 sums in cuBLAS's order (the
// plain version's) read past that limit too.
// Without kExact (K8, which no train step reaches) both products run on the
// bf16 tensor cores, each accumulator chained through the steps.
//
// Rounding p after the normalization needs each row's max and sum before
// any P.V. attention_tile does it two ways:
// * two passes (kKt = 0, any T): the K tiles stream through the ring once
//   for the online row max and sum, then K and V again for p and P.V; it
//   costs a second Q.K^T;
// * one pass (kKt > 0, at most kKt key tiles): all of a warp's scores stay
//   in registers (kKt x 32 fp32 a thread), so the max and sum are exact
//   before p is formed; Q.K^T runs once and the ring carries each K and V
//   tile once.
// attend_resident is the two-pass loop for one warp over K and V already
// in shared memory (P1, which computes them there).
//
// attention_tile serves one head per block (kGroup = 1: K1, K2, K8) or a
// group of kGroup heads side by side in the columns (P3, a 128-lane head
// group): the block is 4 kGroup warps, four to each head, and one ring of
// kGroup-head-wide K and V tiles feeds them all.
#pragma once

#include "attn_mma.cuh"

namespace fmm {

namespace attn_fwd {

namespace am = attn_mma;

using am::Shape;

// The tiles of a block that serves kGroup heads of width HD side by side:
// kCols columns (the heads' columns, zero-padded to kHdp for one head),
// row stride kLd, 4 kGroup warps.
template <int HD, int kGroup>
struct Group {
  static_assert(kGroup == 1 || HD % 16 == 0, "grouped heads take no column padding");
  static constexpr int kCols = kGroup * HD;
  static constexpr int kLd = kGroup == 1 ? Shape<HD>::kLd : kCols + 8;
  static constexpr int kTileElems = am::kTile * kLd;
  static constexpr int kThreads = am::kThreads * kGroup;
};

// Shared memory of attention_tile: a Q tile and two ring stages, each of K
// and V for two passes, of K or V for one pass; and the blocks an SM holds
// by it (232,448 bytes, 1 KB reserved a block).
template <int HD, int kKt, int kGroup = 1>
struct Smem {
  static constexpr int kTiles = kKt == 0 ? 5 : 3;
  static constexpr size_t kBytes = kTiles * Group<HD, kGroup>::kTileElems * sizeof(bf16);
  static constexpr int kFit = static_cast<int>(232448 / (kBytes + 1024));
  // The blocks per SM the compiler's register budget is set for: up to 4
  // for two passes; one pass holds kKt x 32 fp32 scores a thread.
  static constexpr int kMinBlocks =
      kKt == 0 ? (kFit < 4 ? kFit : 4) : (kKt <= 2 ? 3 : 2);
};

// One (b, h) (or head group) and its 64-query tile. Row t of q, k and v
// starts at q + t * q_stride (and so on), bf16, 16-byte aligned; the mask
// is (T, T) fp32 or null; out row t at out + t * out_stride. Rows at or past
// T read as zeros; keys at or past n_keys take no part (n_keys past T only
// for P3's planted fault, where the zero rows in [T, n_keys) take part).
struct Tile {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  int q_stride, k_stride, v_stride;
  const float* mask;
  bf16* out;
  int out_stride;
  int T;       // queries, and the mask's side
  int n_keys;  // keys [0, n_keys) take part
  int q0;      // first query of the tile
  float scale;
};

// One warp's 16 x 64 scores s = q.k * scale + mask for query rows row0 + [0,
// 16) (q_row in the Q tile) against the key tile at `kt` (keys col0 + [0,
// 64)). Returns false, with s all -inf, if the mask leaves the whole warp
// tile -inf (its probabilities are exactly 0 and the caller skips it).
template <int HD, bool kMasked, bool kExact>
__device__ __forceinline__ bool score_tile(float (&s)[8][4], const float* __restrict__ mask,
                                           int T, int n_keys, int row0, int col0,
                                           const bf16* qs, int q_row, const bf16* kt,
                                           float scale, int ld = Shape<HD>::kLd) {
  using S = Shape<HD>;
  if constexpr (kExact) {
    if (am::mask_tile<false, kMasked>(s, mask, T, row0, col0, 1.f, n_keys)) return false;
    unsigned live = 0;  // 8-key tiles with a finite score in some row of the warp
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      bool any = false;
#pragma unroll
      for (int e = 0; e < 4; ++e) any |= s[nt][e] != -CUDART_INF_F;
      live |= (__any_sync(0xffffffffu, any) ? 1u : 0u) << nt;
    }
    am::mma_abt_exact<S::kKSteps>(s, qs, ld, q_row, kt, ld, scale, live);
  } else {
    if (am::mask_tile<false, kMasked>(s, mask, T, row0, col0, 1.f / scale, n_keys))
      return false;
    am::mma_abt<S::kKSteps>(s, qs, ld, q_row, kt, ld);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
  }
  return true;
}

// x / l as the IEEE division rounds it (but in rare ties), given r = 1 / l:
// a product and one fma correction instead of a division per element.
__device__ __forceinline__ float div_by(float x, float l, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, l, x), r, q);
}

// p = exp(s - m) / l over one tile of scores, in place; r = 1 / l.
__device__ __forceinline__ void normalize(float (&s)[8][4], const float (&m)[2],
                                          const float (&l)[2], const float (&r)[2]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[nt][e] = div_by(expf(s[nt][e] - m[e >> 1]), l[e >> 1], r[e >> 1]);
}

// o += bf16(p) times the 64 rows of v_tile; with kExact each 16-key step's
// product is added to o rounded to nearest (am::mma_rn), with kExactPv
// summed on the fp64 tensor cores first (am::mma_pv_exact).
template <int HD, bool kExact, bool kExactPv = false>
__device__ __forceinline__ void pv(float (&o)[Shape<HD>::kNt][4], const float (&p)[8][4],
                                   const bf16* v_tile, int ld = Shape<HD>::kLd) {
  if constexpr (kExactPv) {
    am::mma_pv_exact<Shape<HD>::kNt>(o, p, v_tile, ld);
  } else {
    am::mma_pv<Shape<HD>::kNt, kExact>(o, p, v_tile, ld);
  }
}

// Rows row0 + [0, 16) of the bf16 output from the fp32 accumulators; rows at
// or past T are not written.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&o)[Shape<HD>::kNt][4], bf16* out,
                                           int out_stride, int row0, int T) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
    bf16* dst = out + static_cast<size_t>(row) * out_stride + 2 * t;
#pragma unroll
    for (int nt = 0; nt < Shape<HD>::kNt; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8) =
          __floats2bfloat162_rn(o[nt][2 * r], o[nt][2 * r + 1]);
  }
}

// One block of 4 kGroup warps: the tile's 64 query rows of each of the
// kGroup heads, 16 per warp, over key tiles streamed through a two-stage
// cp.async ring in `smem` (Smem<HD, kKt, kGroup>::kBytes). kKt = 0: two
// passes; else one pass, for at most kKt key tiles (n_keys <= 64 kKt).
template <int HD, bool kMasked, int kKt, bool kExact, int kGroup = 1>
__device__ __forceinline__ void attention_tile(const Tile& a, bf16* smem) {
  using S = Shape<HD>;
  using G = Group<HD, kGroup>;
  constexpr int E = G::kTileElems;
  constexpr int ld = G::kLd;
  bf16* qs = smem;
  bf16* ring = qs + E;  // stages of K (and V: two passes, at ring + 2E)
  const int warp = threadIdx.x >> 5;
  // this warp's head within the group (its columns) and its query rows
  const int col = kGroup == 1 ? 0 : (warp >> 2) * HD;
  const int q_row = (kGroup == 1 ? warp : warp & 3) * 16;
  const int row0 = a.q0 + q_row;
  if constexpr (kGroup == 1) am::zero_pad_columns<HD, am::kThreads>(qs, 3 * am::kTile);  // Q, 2 K
  // K and V rows at or past T read as zeros; the scores are masked to keys
  // below n_keys (T_mask is T unless n_keys runs past it, which only P3's
  // planted fault asks for: with one head a block, n_keys <= T).
  const int key_rows = kGroup == 1 || a.n_keys < a.T ? a.n_keys : a.T;
  const int T_mask = kGroup == 1 || a.n_keys <= a.T ? a.T : a.n_keys;

  // Two passes: iterations [0, n_kt) bring K tiles, [n_kt, 2 n_kt) K and V
  // tiles. One pass: [0, n_kt) K tiles, [n_kt, 2 n_kt) V tiles into the same
  // stages. Iteration it uses stage it & 1.
  const int n_kt = (a.n_keys + am::kTile - 1) / am::kTile;
  const int n_it = 2 * n_kt;
  auto prefetch = [&](int it) {
    const bool second = it >= n_kt;
    const int j = second ? it - n_kt : it;
    bf16* stage = ring + (it & 1) * E;
    if (kKt == 0 || !second)
      am::load_tile<G::kCols, G::kThreads>(stage, ld, a.k, a.k_stride, j * am::kTile, key_rows);
    if (second) {
      bf16* vstage = kKt == 0 ? stage + 2 * E : stage;
      am::load_tile<G::kCols, G::kThreads>(vstage, ld, a.v, a.v_stride, j * am::kTile,
                                           key_rows);
    }
  };
  // Wait for iteration it's stage, with the next one's copies in flight.
  auto arrive = [&](int it) {
    if (it + 1 < n_it) prefetch(it + 1);
    am::cp_async_commit();
    am::cp_async_wait<1>();
    __syncthreads();
  };
  am::load_tile<G::kCols, G::kThreads>(qs, ld, a.q, a.q_stride, a.q0, a.T);
  prefetch(0);
  am::cp_async_commit();

  float o[S::kNt][4];
#pragma unroll
  for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  if constexpr (kKt == 0) {
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l[2] = {0.f, 0.f};
    float r[2], unused[2];
    for (int it = 0; it < n_it; ++it) {
      arrive(it);
      const bool pass2 = it >= n_kt;
      const int j = pass2 ? it - n_kt : it;
      const bf16* kt = ring + (it & 1) * E;
      float s[8][4];
      if (score_tile<HD, kMasked, kExact>(s, a.mask, T_mask, a.n_keys, row0, j * am::kTile,
                                          qs + col, q_row, kt + col, a.scale, ld)) {
        if (!pass2) {
          am::online_softmax<false, true>(s, s, m, l, unused);
        } else {
          normalize(s, m, l, r);
          pv<HD, kExact, kExact>(o, s, kt + 2 * E + col, ld);
        }
      }
      if (it == n_kt - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[i] = am::quad_sum(l[i]);
          r[i] = 1.f / l[i];
        }
      }
      __syncthreads();  // the stage is consumed before the next copy into it
    }
  } else {
    float s[kKt][8][4];
    unsigned live = 0;  // key tiles not wholly masked for this warp
#pragma unroll
    for (int j = 0; j < kKt; ++j) {
      if (j < n_kt) {
        arrive(j);
        if (score_tile<HD, kMasked, kExact>(s[j], a.mask, T_mask, a.n_keys, row0, j * am::kTile,
                                            qs + col, q_row, ring + (j & 1) * E + col, a.scale,
                                            ld))
          live |= 1u << j;
        __syncthreads();
      }
    }
    // The row max and sum over every key, then p = bf16(exp(s - m) / l).
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kKt; ++j)
      if (j < n_kt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][nt][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = am::quad_max(m[r]);
      if (m[r] == -CUDART_INF_F) m[r] = 0.f;  // a row with no finite score
    }
#pragma unroll
    for (int j = 0; j < kKt; ++j)
      if (j < n_kt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][nt][e] = expf(s[j][nt][e] - m[e >> 1]);
            l[e >> 1] += s[j][nt][e];
          }
    float r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = am::quad_sum(l[i]);
      r[i] = 1.f / l[i];
    }
#pragma unroll
    for (int j = 0; j < kKt; ++j) {
      if (j < n_kt) {
        arrive(n_kt + j);
        if (live >> j & 1) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][nt][e] = div_by(s[j][nt][e], l[e >> 1], r[e >> 1]);
          pv<HD, kExact, kExact && kMasked>(o, s[j], ring + ((n_kt + j) & 1) * E + col, ld);
        }
        __syncthreads();
      }
    }
  }
  store_rows<HD>(o, a.out + col, a.out_stride, row0, a.T);
}

// A K tile of head width HD in fp64 in shared memory: kLd doubles a row,
// so that the 16-byte loads of a quarter warp (lanes 4 g + t, g of two
// adjacent rows, 2t + [0, 2) of an 8-column chunk) fall on all 32 banks.
template <int HD>
struct F64Tile {
  static constexpr int kLd = HD % 16 == 8 ? HD : HD + 8;
  static constexpr int kElems = am::kTile * kLd;
};

// The Q tile in fp64 with rows g and g + 8 of each warp's 16 side by side:
// (16 w + 8 h + g, column c) at (8 w + g) kLd + 2 c + h, so that a lane's
// m16n8k8 A operand (rows g and g + 8 at columns 2t and 2t + 1 of a chunk) is
// one 32-byte run that two 16-byte loads bring in the instruction's order.
// kLd = 2 HD + 2: the two adjacent double rows of a quarter warp start 16
// bytes apart modulo 128 and interleave on the banks.
template <int HD, int kWarps = am::kWarps>
struct F64QTile {
  static constexpr int kLd = 2 * HD + 2;
  static constexpr int kElems = 8 * kWarps * kLd;
};

// The shape of attention_tile_f64's instance for rows of up to 8 kN8 keys.
// Up to 208 keys (ViT-B/16's 200) the scores take 104 registers a thread or
// fewer, and three blocks share an SM (12 warps; the registers capped at
// 168, some scores spill to L1): the fp64 K tile holds half a key tile at a
// time and the bf16 ring two stages (70,144 bytes at HD = 64). Past that
// (ViT-L/14's 260 keys, 136 registers of scores) two blocks share it: a
// whole fp64 key tile and four stages (107,008 bytes). On an H100 three
// blocks an SM took ViT-B/16's launch from 1.89 to 1.73 ms, one block an SM
// to 3.07. Blocks of one warp (kWarps = 1, a last tile of at most 16
// queries) hold half a key tile and two stages, with up to 255 registers.
template <int HD, int kN8, int kWarps = am::kWarps>
struct F64Plan {
  static constexpr int kThreads = 32 * kWarps;
  static constexpr bool kThree = kN8 <= 26 || kWarps == 1;
  static constexpr int kMinBlocks = kWarps == 1 ? 1 : kThree ? 3 : 2;
  static constexpr int kKdRows = kThree ? am::kTile / 2 : am::kTile;
  static constexpr int kStages = kThree ? 2 : 4;
  static constexpr size_t kBytes =
      (F64QTile<HD, kWarps>::kElems + kKdRows * F64Tile<HD>::kLd) * sizeof(double) +
      kStages * Shape<HD>::kTileElems * sizeof(bf16);
};

// kRows rows of a bf16 ring stage (Shape<HD>::kLd a row) converted to an
// fp64 K tile, by the block: each thread a bf16 pair into a 16-byte store, a
// warp one run of consecutive pairs.
template <int HD, int kRows, int kThreads>
__device__ __forceinline__ void tile_to_f64(double* dst, const bf16* src) {
  constexpr int kPairs = HD / 2;
#pragma unroll 4
  for (int i = threadIdx.x; i < kRows * kPairs; i += kThreads) {
    const int r = i / kPairs;
    const int c = 2 * (i - r * kPairs);
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src + r * Shape<HD>::kLd + c));
    *reinterpret_cast<double2*>(dst + r * F64Tile<HD>::kLd + c) = make_double2(v.x, v.y);
  }
}

// The Q tile of a bf16 ring stage converted into the F64QTile layout, by
// the block: each thread a column pair of rows r and r + 8 into two 16-byte
// stores.
template <int HD, int kWarps>
__device__ __forceinline__ void q_to_f64(double* dst, const bf16* src) {
  constexpr int kPairs = HD / 2;
  for (int i = threadIdx.x; i < 8 * kWarps * kPairs; i += 32 * kWarps) {
    const int p = i / kPairs;  // 8 w + g
    const int c = 2 * (i - p * kPairs);
    const int r = (p >> 3) * 16 + (p & 7);
    const float2 top = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src + r * Shape<HD>::kLd + c));
    const float2 bottom = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src + (r + 8) * Shape<HD>::kLd + c));
    double2* out = reinterpret_cast<double2*>(dst + p * F64QTile<HD>::kLd + 2 * c);
    out[0] = make_double2(top.x, bottom.x);
    out[1] = make_double2(top.y, bottom.y);
  }
}

// One warp's exact scores against kN 8-key tiles of an fp64 K tile: out[nt]
// = fp32(q.k) * scale for rows row0 + [0, 16) (A operands at qa: this
// lane's F64QTile run) and keys col0 + 8 nt + [0, 8) (B operands at kb: the
// tile's row of key col0 + g, column 2t); -inf past T, past n_keys and for
// nt >= n_live. Every product on the fp64 tensor cores (am::dmma_k8): the
// bf16 products are exact in fp64 and each sum of up to 128 of them is
// rounded to 53 bits, so fp32(q.k) is the correctly rounded score unless
// the exact sum lies within ~2^-46 of its largest partial sum of a rounding
// boundary.
template <int HD, int kN>
__device__ __forceinline__ void f64_scores(float (&out)[kN][4], const double* qa,
                                           const double* kb, int row0, int col0, int T,
                                           int n_keys, float scale, int n_live) {
  const int lane = threadIdx.x & 31;
  double d[kN][4];
#pragma unroll
  for (int nt = 0; nt < kN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[nt][e] = 0.0;
#pragma unroll 1
  for (int c = 0; c < HD / 8; ++c) {
    const double2 a01 = am::lds_f64x2(qa + 16 * c);
    const double2 a23 = am::lds_f64x2(qa + 16 * c + 2);
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
      if (nt < n_live)
        am::dmma_k8(d[nt], a01, a23, am::lds_f64x2(kb + nt * 8 * F64Tile<HD>::kLd + 8 * c));
  }
#pragma unroll
  for (int nt = 0; nt < kN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + (lane >> 2) + 8 * (e >> 1);
      const int col = col0 + nt * 8 + 2 * (lane & 3) + (e & 1);
      out[nt][e] = nt < n_live && row < T && col < n_keys
                       ? static_cast<float>(d[nt][e]) * scale
                       : -CUDART_INF_F;
    }
}

// The exact forward without a mask in one pass (attention_core.cu's vision
// instances): one block of 4 warps per 64-query tile, each warp 16 rows;
// its scores of up to 8 kN8 keys (n_keys <= 8 kN8) stay in registers,
// s[i] the 8-key tile i. The block converts the Q tile to fp64 once and
// each K tile once, into shared memory, and every warp feeds the fp64
// tensor cores (f64_scores) from those tiles with 16-byte loads: no
// conversion in the product's loop. Then the row max and sum over every
// key, p = bf16(expf(s - m) / l), and P.V on the bf16 tensor cores with
// each 16-key step added rounded to nearest. The K tiles and then the V
// tiles stream through a ring of kStages bf16 stages, kStages - 1 tiles
// ahead of the one in use. Rows at or past T are not written; keys at or
// past n_keys are -inf (K and V rows past n_keys read as zeros).
template <int HD, int kN8, int kWarps = am::kWarps>
__device__ __forceinline__ void attention_tile_f64(const Tile& a, unsigned char* smem) {
  static_assert(kN8 % 2 == 0 && HD <= 64, "16-key steps of P.V; Q.K^T unpadded");
  using S = Shape<HD>;
  using F = F64Tile<HD>;
  constexpr int E = S::kTileElems;
  using P = F64Plan<HD, kN8, kWarps>;
  constexpr int kThreads = P::kThreads;
  constexpr int kStages = P::kStages;
  constexpr int kKt = (kN8 + 7) / 8;  // key tiles the registers hold
  double* qd = reinterpret_cast<double*>(smem);
  double* kd = qd + F64QTile<HD, kWarps>::kElems;
  bf16* ring = reinterpret_cast<bf16*>(kd + P::kKdRows * F::kLd);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int n_kt = (a.n_keys + am::kTile - 1) / am::kTile;
  const int q_row = warp * 16;
  const int row0 = a.q0 + q_row;
  const bool rows_live = row0 < a.T;  // a warp wholly past T only copies

  // Tile it of [0, 2 n_kt) (K tiles, then V tiles) goes to stage it %
  // kStages; one copy group each, empty past the last tile.
  auto issue = [&](int it) {
    if (it < 2 * n_kt) {
      const bool v = it >= n_kt;
      am::load_tile<HD, kThreads>(ring + (it % kStages) * E, S::kLd, v ? a.v : a.k,
                        v ? a.v_stride : a.k_stride, (v ? it - n_kt : it) * am::kTile,
                        a.n_keys);
    }
    am::cp_async_commit();
  };
  // Wait for tile it (the kStages - 2 after it may be in flight), with every
  // warp past its use of tile it - 1, then put tile it + kStages - 1 into
  // that tile's stage.
  auto arrive = [&](int it) {
    am::cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(it + kStages - 1);
  };
  // Q into the last stage, tiles [0, kStages - 1) into the others; Q
  // converted once.
  am::load_tile<HD, kThreads>(ring + (kStages - 1) * E, S::kLd, a.q, a.q_stride, a.q0, a.T,
                              16 * kWarps);
  am::cp_async_commit();
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) issue(it);
  am::cp_async_wait<kStages - 1>();
  __syncthreads();
  q_to_f64<HD, kWarps>(qd, ring + (kStages - 1) * E);
  const double* qa = qd + (q_row / 2 + g) * F64QTile<HD>::kLd + 4 * t;

  float s[kN8][4];
#pragma unroll
  for (int j = 0; j < kKt; ++j) {
    if (j < n_kt) {
      arrive(j);
      const bf16* stage = ring + (j % kStages) * E;
      if (P::kKdRows == am::kTile) {
        tile_to_f64<HD, am::kTile, kThreads>(kd, stage);
        __syncthreads();
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (8 * j + 4 * half >= kN8) break;
        const double* kb = kd + (32 * half + g) * F::kLd + 2 * t;
        if (P::kKdRows < am::kTile) {  // this half of the tile alone
          if (half) __syncthreads();   // every warp is past the first half
          tile_to_f64<HD, am::kTile / 2, kThreads>(kd, stage + 32 * half * S::kLd);
          __syncthreads();
          kb = kd + g * F::kLd + 2 * t;
        }
        const int i0 = 8 * j + 4 * half;
        if (rows_live) {
          float h[4][4];
          f64_scores<HD, 4>(h, qa, kb, row0, 8 * i0, a.T, a.n_keys, a.scale,
                            i0 * 8 < a.n_keys ? kN8 - i0 : 0);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            if (i0 + nt < kN8)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[i0 + nt][e] = h[nt][e];
        }
      }
    }
  }
  // The row max and sum over every key, then p = bf16(exp(s - m) / l).
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float r[2];
  if (rows_live) {
#pragma unroll
    for (int i = 0; i < kN8; ++i)
      if (i < 8 * n_kt)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[i][e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = am::quad_max(m[h]);
      if (m[h] == -CUDART_INF_F) m[h] = 0.f;  // a row with no finite score
    }
#pragma unroll
    for (int i = 0; i < kN8; ++i)
      if (i < 8 * n_kt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][e] = expf(s[i][e] - m[e >> 1]);
          l[e >> 1] += s[i][e];
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = am::quad_sum(l[h]);
      r[h] = 1.f / l[h];
    }
  }
  float o[S::kNt][4];
#pragma unroll
  for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kKt; ++j) {
    if (j < n_kt) {
      arrive(n_kt + j);
      if (rows_live) {
        constexpr int kLast = kN8 - 8 * (kKt - 1);  // 8-key tiles of the last key tile
        const int n8 = j < kKt - 1 ? 8 : kLast;
#pragma unroll
        for (int i = 8 * j; i < 8 * j + 8; ++i)
          if (i < kN8)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[i][e] = div_by(s[i][e], l[e >> 1], r[e >> 1]);
        am::mma_pv<S::kNt, true>(o, s, ring + ((n_kt + j) % kStages) * E, S::kLd, 8 * j, n8);
      }
    }
  }
  if (rows_live) store_rows<HD>(o, a.out, a.out_stride, row0, a.T);
}

// One warp's query rows [row0, row0 + 16) (the same rows of qs) against
// keys [0, n_keys), whose K and V rows lie in shared memory at ks and vs
// (row stride Shape<HD>::kLd, rows up to n_keys rounded up to 64, all
// finite): two passes over the key tiles, no barrier; rows below T written
// to out.
template <int HD, bool kMasked, bool kExact>
__device__ __forceinline__ void attend_resident(const bf16* qs, const bf16* ks, const bf16* vs,
                                                const float* __restrict__ mask, int T,
                                                int n_keys, int row0, float scale, bf16* out,
                                                int out_stride) {
  using S = Shape<HD>;
  const int n_kt = (n_keys + am::kTile - 1) / am::kTile;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float r[2], unused[2];
  for (int j = 0; j < n_kt; ++j) {
    float s[8][4];
    if (score_tile<HD, kMasked, kExact>(s, mask, T, n_keys, row0, j * am::kTile, qs, row0,
                                        ks + j * S::kTileElems, scale))
      am::online_softmax<false, true>(s, s, m, l, unused);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = am::quad_sum(l[i]);
    r[i] = 1.f / l[i];
  }
  float o[S::kNt][4];
#pragma unroll
  for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  for (int j = 0; j < n_kt; ++j) {
    float s[8][4];
    if (score_tile<HD, kMasked, kExact>(s, mask, T, n_keys, row0, j * am::kTile, qs, row0,
                                        ks + j * S::kTileElems, scale)) {
      normalize(s, m, l, r);
      pv<HD, kExact, kExact && kMasked>(o, s, vs + j * S::kTileElems);
    }
  }
  store_rows<HD>(o, out, out_stride, row0, T);
}

}  // namespace attn_fwd

}  // namespace fmm
