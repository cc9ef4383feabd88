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
// (mma.m8n8k4, am::mma_abt_exact), so each fp32 score is the correctly
// rounded one, and adds each 16-key step of P.V to the fp32 accumulators
// rounded to nearest (am::mma_rn); with a mask (K1: the text tower, whose
// features reach the logits at CLIP's logit scale of 100) each step is
// summed on the fp64 tensor cores first (am::mma_pv_exact), since the bf16
// tensor cores' truncation within a step moved a trained 16-image step's
// vision gradients 2.5x past their limit against an exact forward
// (chip_smoke.py on an H100; a P.V in fp32 rounded to nearest read 0.36 of
// it). attention_tile's two passes (rows past 256 keys at head widths up to
// 64: ViT-L/14's 259 and 260 vision rows) sum P.V on the fp64 tensor cores
// with or without a mask: through ViT-L/14's 24 vision blocks the truncation
// put a trained 16-image step's vision gradients 1.57x past their limit
// (0.80 for the fully plain path, 0.38-0.45 with the forward's P.V summed
// exactly or in fp32; chip_smoke.py on an H100). p is rounded to bf16 right
// after the softmax, and a score's last fp32 bit flips that rounding often
// enough to move a 16-image train step's gradients past their limit against
// a plain path with an exact forward (chip_smoke.py): the bf16 tensor cores'
// sums truncate, and fp32 sums in cuBLAS's order (the plain version's) read
// past that limit too.
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
