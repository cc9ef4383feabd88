// inject_rows: write a batch-shared prompt and per-sample extra rows into the
// trailing rows of an fp32 (B, T, D) residual stream, in place.
//
// Replaces the deep-prompt injection inside the TPU block-group kernel
// (federated_multi_modal_tpu/ops/pallas/fused_block.py, _group_kernel): before
// each flagged block, rows [T - n_ctx - n_extra, T) of the fp32 activation
// take the block's (n_ctx, D) prompt, broadcast over the batch, then the
// (B, n_extra, D) extra rows (MaPLe's caption token). Both come in the storage
// dtype (bf16) and are widened to fp32, as the TPU kernel does.
// Bound on the H100: bytes. At B = 512, D = 768 with two prompt rows and one
// extra row a launch writes 4.7 MB of fp32 and reads 0.8 MB of bf16, ~1.6 us
// at 3.35 TB/s; with no extra rows ~3.1 MB, ~0.9 us.
// Design: one thread per 8 elements of a written row (one 16-byte bf16 read,
// two 16-byte fp32 writes), a grid-stride loop over every written element, so
// each byte is moved once. At these sizes the launch itself costs more than
// the bound; fusing the injection into LN1's row read is the step past that.
#include <stdint.h>

#include "fmm_common.cuh"

namespace {

using fmm::bf16;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    inject_rows_kernel(float* __restrict__ x, const bf16* __restrict__ prompt,
                       const bf16* __restrict__ extra, int B, int T, int D, int n_ctx,
                       int n_extra) {
  const int n_tail = n_ctx + n_extra;
  const int chunks = D / 8;
  const long long total = static_cast<long long>(B) * n_tail * chunks;
  for (long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(idx % chunks);
    const long long row = idx / chunks;
    const int r = static_cast<int>(row % n_tail);
    const long long b = row / n_tail;
    const bf16* src = r < n_ctx ? prompt + static_cast<size_t>(r) * D
                                : extra + (b * n_extra + (r - n_ctx)) * static_cast<size_t>(D);
    const uint4 raw = *reinterpret_cast<const uint4*>(src + c * 8);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 f0 = __bfloat1622float2(h[0]);
    const float2 f1 = __bfloat1622float2(h[1]);
    const float2 f2 = __bfloat1622float2(h[2]);
    const float2 f3 = __bfloat1622float2(h[3]);
    float4* dst = reinterpret_cast<float4*>(
        x + (b * T + (T - n_tail + r)) * static_cast<size_t>(D) + c * 8);
    dst[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
    dst[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
}

}  // namespace

// x (B, T, D) fp32, prompt (n_ctx, D) bf16, extra (B, n_extra, D) bf16 or
// null when n_extra = 0; all contiguous and 16-byte aligned, D % 8 == 0.
FMM_EXPORT int fmm_inject_rows(void* x, const void* prompt, const void* extra, int B, int T,
                               int D, int n_ctx, int n_extra, void* stream) {
  if (B < 1 || D < 8 || D % 8 || n_ctx < 0 || n_extra < 0 || n_ctx + n_extra < 1 ||
      n_ctx + n_extra > T || (n_extra > 0 && extra == nullptr) ||
      (n_ctx > 0 && prompt == nullptr))
    return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(B) * (n_ctx + n_extra) * (D / 8);
  const long long want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
  inject_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<const bf16*>(prompt), static_cast<const bf16*>(extra),
      B, T, D, n_ctx, n_extra);
  return cudaGetLastError();
}
