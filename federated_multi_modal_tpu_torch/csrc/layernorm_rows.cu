// layernorm_rows: LayerNorm over the last axis of a (rows, D) matrix, bf16
// or fp32 in, bf16 out, with fp32 mean, variance, gamma and beta.
//
// Replaces the two LayerNorms inside the TPU whole-block kernel
// (federated_multi_modal_tpu/ops/pallas/fused_block.py, _block_body32: LN1
// of the bf16 block input x, LN2 of the fp32 attention-half output y).
// Bound on the H100: bytes. At the vision shape (101,888 rows of 768) LN1
// reads 156 MB and writes 156 MB, ~0.09 ms at 3.35 TB/s; LN2 reads 313 MB
// of fp32 y, ~0.14 ms.
// Design: one warp per row, lanes striding the row so that each load is
// coalesced; the two-pass mean/variance (as the TPU kernel computes it)
// re-reads the row from L1, so device memory sees each byte once.
#include "fmm_common.cuh"

namespace {

using fmm::bf16;

constexpr int kWarps = 8;

template <typename Tin>
__global__ void __launch_bounds__(kWarps * 32)
    layernorm_rows_kernel(const Tin* __restrict__ x, const float* __restrict__ gamma,
                          const float* __restrict__ beta, bf16* __restrict__ out, int rows,
                          int D, float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;
  const Tin* xr = x + row * D;
  bf16* orow = out + row * D;

  float sum = 0.f;
  for (int j = lane; j < D; j += 32) sum += fmm::to_f32(xr[j]);
  const float mean = fmm::warp_sum(sum) / D;
  float sq = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float d = fmm::to_f32(xr[j]) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(fmm::warp_sum(sq) / D + eps);
  for (int j = lane; j < D; j += 32) {
    const float y = (fmm::to_f32(xr[j]) - mean) * rstd;
    orow[j] = __float2bfloat16(y * gamma[j] + beta[j]);
  }
}

}  // namespace

// x (rows, D) bf16 (x_f32 = 0) or fp32 (x_f32 = 1); gamma, beta (D,) fp32;
// out (rows, D) bf16; all contiguous.
FMM_EXPORT int fmm_layernorm_rows(const void* x, int x_f32, const void* gamma, const void* beta,
                                  void* out, int rows, int D, float eps, void* stream) {
  if (rows < 1 || D < 1) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    layernorm_rows_kernel<float><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<bf16*>(out), rows, D, eps);
  } else {
    layernorm_rows_kernel<bf16><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<bf16*>(out), rows, D, eps);
  }
  return cudaGetLastError();
}
