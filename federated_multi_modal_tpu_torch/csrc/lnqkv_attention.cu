// lnqkv_attention: LN1 -> QKV product -> attention in one kernel, QKV never
// written to device memory. out (B, T, D) = per head h
//   softmax(q_h k_h^T * scale) v_h,  [q | k | v] = bf16(bf16(LN(x)) . W + b)
// (the out-projection is not part of it).
//
// Replaces the prototype TPU kernel
// tools/attn_microbench.py::fused_lnqkv_attention (pallas_call at :110), with
// its numerics: LN in fp32 (eps 1e-5), the normalized x rounded to bf16, the
// QKV product in fp32 sums with the (bf16) bias added in fp32 before one
// rounding, fp32 scores and softmax, p normalized and then rounded to bf16
// before P.V.
//
// Bound on the H100: operations. At x (512, 200, 768) bf16 and W (768, 2304)
// the QKV product is 362 GFLOP and the attention 63 GFLOP: 0.430 ms at
// 989 TFLOP/s, against 0.095 ms to read x and W and write out (318 MB).
// Design: the TPU kernel keeps a (GB, T, D) block of x and all of W (3.4 MB)
// in VMEM; an SM has 227 KB, and a head's q, k and v at T = 256 take 108 KB.
// So one block of 16 warps per (b, head h):
// * the LN moments of each row come once per row, not once per head, from a
//   small first launch into a (B, T, 2) fp32 scratch (one warp a row);
// * the head's 192 QKV columns are one tiled mma.sync GEMM (m16n8k16, bf16
//   in, fp32 accumulate): the contraction over D streams in 64-deep steps
//   through a two-stage cp.async ring of x rows and W's 64 x 192 head
//   columns, each thread normalizing in place the x chunks it copied; warp w
//   owns rows [32 (w / 2), + 32) and 96 of the 192 columns, 96 fp32
//   accumulators a thread, so x is read and normalized once per head and
//   there are two barriers per 64-deep step;
// * the bias is added in fp32 and q, k and v are rounded once into shared
//   memory, over the ring (which they outlive);
// * the attention runs from there through attn_fwd.cuh's tile routine (two
//   passes over the resident key tiles, no barrier; the scores correctly
//   rounded from the fp64 tensor cores, as attention_core.cu's), warp w
//   taking query rows [16 w, 16 w + 16).
// T is bounded by the 16 warps x 16 query rows (and 8 x 32 GEMM rows): T <=
// 256, where shared memory is 122 KB; registers (512 threads, at most 128
// each) hold one block an SM. That is what holds it back: with no second
// block to switch to, each 64-deep step's copies, normalization and two
// barriers stall the SM beside its MMAs, and the attention's two passes
// (there is no register room for one) run its fp64 q.k and expf twice.
#include "attn_fwd.cuh"

namespace {

using fmm::bf16;
namespace am = fmm::attn_mma;
namespace af = fmm::attn_fwd;

constexpr int kHd = 64;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = kWarps * 16;
constexpr int kCols = 3 * kHd;        // q, k and v of one head
constexpr int kBk = 64;               // contraction step
constexpr int kXLd = kBk + 8;         // x stage row stride (bf16)
constexpr int kWLd = kCols + 8;       // W stage row stride (bf16)
constexpr int kLd = af::Shape<kHd>::kLd;
constexpr int kMomentWarps = 8;

// Shared memory at T: the ring (two stages of round32(T) x rows and kBk W
// rows), then, over it once the GEMM is done, q, k and v of round64(T) rows.
struct Layout {
  int Tx, Tp;
  size_t stage_elems, bytes;
  __host__ __device__ explicit Layout(int T)
      : Tx((T + 31) / 32 * 32),
        Tp((T + am::kTile - 1) / am::kTile * am::kTile),
        stage_elems(static_cast<size_t>(Tx) * kXLd + kBk * kWLd) {
    const size_t ring = 2 * stage_elems;
    const size_t qkv = 3 * static_cast<size_t>(Tp) * kLd;
    bytes = (ring > qkv ? ring : qkv) * sizeof(bf16);
  }
};

// Row mean and 1/sqrt(var + eps) of x (rows, D) bf16, one warp a row, the
// variance as the mean of squared deviations (fp32, two passes).
__global__ void __launch_bounds__(kMomentWarps * 32)
    lnqkv_moments_kernel(const bf16* __restrict__ x, float2* __restrict__ stats, int rows, int D,
                         float eps) {
  const int row = blockIdx.x * kMomentWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const uint4* r = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * D);
  const int n = D / 8;
  float s = 0.f;
  for (int c = lane; c < n; c += 32) {
    const uint4 raw = r[c];
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += __bfloat162float(e[i]);
  }
  const float m = fmm::warp_sum(s) / D;
  float v = 0.f;
  for (int c = lane; c < n; c += 32) {
    const uint4 raw = r[c];
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = __bfloat162float(e[i]) - m;
      v += d * d;
    }
  }
  v = fmm::warp_sum(v) / D;
  if (lane == 0) stats[row] = make_float2(m, rsqrtf(v + eps));
}

__global__ void __launch_bounds__(kThreads, 1)
    lnqkv_attention_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W,
                           const bf16* __restrict__ bias, const float* __restrict__ gamma,
                           const float* __restrict__ beta, const float2* __restrict__ stats,
                           bf16* __restrict__ out, int T, int D, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(T);
  bf16* region = reinterpret_cast<bf16*>(smem);
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const bf16* xb = x + static_cast<size_t>(b) * T * D;
  const float2* sb = stats + static_cast<size_t>(b) * T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // The GEMM: warp w owns rows [32 rg, 32 rg + 32) and columns [96 ch, 96 ch
  // + 96) of the head's q | k | v; a row group past T only takes the bias.
  const int rg = warp >> 1;
  const int ch = warp & 1;
  const bool busy = rg * 32 < T;
  auto xs_of = [&](int step) { return region + (step & 1) * L.stage_elems; };
  auto ws_of = [&](int step) { return xs_of(step) + static_cast<size_t>(L.Tx) * kXLd; };
  // x rows [0, Tx) (zeros at or past T) and W's head columns, rows [k0, k0 +
  // kBk); the same thread normalizes the x chunks it copies.
  auto prefetch = [&](int step) {
    const int k0 = step * kBk;
    bf16* xs = xs_of(step);
    bf16* ws = ws_of(step);
    for (int idx = threadIdx.x; idx < L.Tx * (kBk / 8); idx += kThreads) {
      const int r = idx >> 3;
      const int c = idx & 7;
      const bool valid = r < T;
      am::cp_async16(xs + r * kXLd + c * 8,
                     valid ? xb + static_cast<size_t>(r) * D + k0 + c * 8 : xb, valid);
    }
    for (int idx = threadIdx.x; idx < kBk * (kCols / 8); idx += kThreads) {
      const int r = idx / (kCols / 8);
      const int c = idx - r * (kCols / 8);
      const int col = (c >> 3) * D + h * kHd + (c & 7) * 8;  // part c / 8 of q | k | v
      am::cp_async16(ws + r * kWLd + c * 8, W + static_cast<size_t>(k0 + r) * 3 * D + col, true);
    }
  };
  auto normalize = [&](int step) {
    const int k0 = step * kBk;
    bf16* xs = xs_of(step);
    for (int idx = threadIdx.x; idx < L.Tx * (kBk / 8); idx += kThreads) {
      const int r = idx >> 3;
      const int c = idx & 7;
      if (r >= T) continue;
      uint4* chunk = reinterpret_cast<uint4*>(xs + r * kXLd + c * 8);
      const uint4 raw = *chunk;
      const bf16* xv = reinterpret_cast<const bf16*>(&raw);
      const float2 ms = __ldg(sb + r);
      const int d0 = k0 + c * 8;
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(gamma + d0));
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(gamma + d0 + 4));
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(beta + d0));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(beta + d0 + 4));
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint4 packed;
      __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lo = (__bfloat162float(xv[2 * e]) - ms.x) * ms.y * g[2 * e] + bt[2 * e];
        const float hi =
            (__bfloat162float(xv[2 * e + 1]) - ms.x) * ms.y * g[2 * e + 1] + bt[2 * e + 1];
        pv[e] = __floats2bfloat162_rn(lo, hi);
      }
      *chunk = packed;
    }
  };

  float acc[2][12][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 12; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int n_steps = D / kBk;
  prefetch(0);
  am::cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) prefetch(step + 1);
    am::cp_async_commit();
    am::cp_async_wait<1>();
    normalize(step);
    __syncthreads();
    if (busy) {
      const bf16* xs = xs_of(step);
      const bf16* ws = ws_of(step);
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        uint32_t a0[4], a1[4];
        am::load_a(a0, xs, kXLd, rg * 32, kk * 16);
        am::load_a(a1, xs, kXLd, rg * 32 + 16, kk * 16);
#pragma unroll
        for (int np = 0; np < 6; ++np) {
          uint32_t bw[4];
          am::load_b_rows_k(bw, ws, kWLd, kk * 16, ch * 96 + np * 16);
          am::mma(acc[0][2 * np], a0, bw[0], bw[1]);
          am::mma(acc[0][2 * np + 1], a0, bw[2], bw[3]);
          am::mma(acc[1][2 * np], a1, bw[0], bw[1]);
          am::mma(acc[1][2 * np + 1], a1, bw[2], bw[3]);
        }
      }
    }
    __syncthreads();  // the stage is consumed (the last one before q, k, v land)
  }

  // q, k and v = bf16(acc + bias) over the ring, rows [0, Tp) (rows at or
  // past T take the bias only: finite keys and values, which the mask drops).
  bf16* qs = region;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 12; ++nt) {
    const int col = ch * 96 + nt * 8 + 2 * t;
    const int part = col >> 6;
    const int c = col & 63;
    const float2 bb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + part * D + h * kHd + c));
    bf16* dst = qs + static_cast<size_t>(part) * L.Tp * kLd + c;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rg * 32 + mt * 16 + g + 8 * r;
        if (row < L.Tp)
          *reinterpret_cast<__nv_bfloat162*>(dst + row * kLd) = __floats2bfloat162_rn(
              acc[mt][nt][2 * r] + bb.x, acc[mt][nt][2 * r + 1] + bb.y);
      }
  }
  __syncthreads();

  const int row0 = warp * 16;
  if (row0 < T) {
    const bf16* ks = qs + static_cast<size_t>(L.Tp) * kLd;
    af::attend_resident<kHd, false, true>(qs, ks, ks + static_cast<size_t>(L.Tp) * kLd, nullptr,
                                          T, T, row0, scale,
                                          out + static_cast<size_t>(b) * T * D + h * kHd, D);
  }
}

cudaError_t allow_smem(size_t bytes) {
  return cudaFuncSetAttribute(lnqkv_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// x (B, T, D) bf16, W (D, 3D) bf16, bias (3D,) bf16, gamma and beta (D,)
// fp32, stats a (B, T, 2) fp32 scratch for the LN moments, out (B, T, D)
// bf16; contiguous and 16-byte aligned; D = 64 H; T <= 256.
FMM_EXPORT int fmm_lnqkv_attention(const void* x, const void* W, const void* bias,
                                   const void* gamma, const void* beta, void* stats, void* out,
                                   int B, int T, int D, int H, float scale, void* stream) {
  if (T < 1 || T > kMaxT || B < 1 || H < 1 || D != H * kHd) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * T;
  lnqkv_moments_kernel<<<(rows + kMomentWarps - 1) / kMomentWarps, kMomentWarps * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<float2*>(stats), rows, D, 1e-5f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = Layout(T).bytes;
  err = allow_smem(smem);
  if (err != cudaSuccess) return err;
  lnqkv_attention_kernel<<<B * H, kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(W), static_cast<const bf16*>(bias),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float2*>(stats), static_cast<bf16*>(out), T, D, H, scale);
  return cudaGetLastError();
}

// Resident blocks per SM of the main kernel at T tokens (registers and
// shared memory as built) into *blocks, its dynamic shared memory into
// *smem_bytes; `masked` is unused (the kernel has no mask).
FMM_EXPORT int fmm_lnqkv_attention_blocks_per_sm(int T, int masked, int* blocks,
                                                 int* smem_bytes) {
  (void)masked;
  if (T < 1 || T > kMaxT) return cudaErrorInvalidValue;
  const size_t smem = Layout(T).bytes;
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lnqkv_attention_kernel, kThreads,
                                                       smem);
}
