// Error text for the codes the kernel entry points return.
#include "fmm_common.cuh"

FMM_EXPORT const char* fmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
