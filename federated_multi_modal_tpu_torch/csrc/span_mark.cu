// span_mark: the device-side boundaries of the program's spans
// (utils/profiling.py: SPANS, span, span_boundary).
//
// Each boundary launches one empty <<<1, 1>>> kernel on the caller's stream:
// span_marker<id, true> where span `id` opens, span_marker<id, false> where
// it closes. A marker launched while the stream is captured is a node of the
// CUDA graph, so every replay puts the span's boundaries on the device
// timeline, in the same profiler record as the kernels between them; the
// demangled name ("void span_marker<3, true>()") gives the id and the side.
// There is one instance per id: kSpans is the length of SPANS (ids are
// appended there, never reordered).
// Cost: a launch and an empty block, a few microseconds of the stream.
#include <utility>

#include "fmm_common.cuh"

constexpr int kSpans = 15;

template <int Id, bool Open>
__global__ void span_marker() {}

namespace {

template <int... Ids>
const void* marker_of(int id, bool open, std::integer_sequence<int, Ids...>) {
  static const void* const opens[] = {reinterpret_cast<const void*>(&span_marker<Ids, true>)...};
  static const void* const closes[] = {
      reinterpret_cast<const void*>(&span_marker<Ids, false>)...};
  return open ? opens[id] : closes[id];
}

const void* marker_of(int id, bool open) {
  return marker_of(id, open, std::make_integer_sequence<int, kSpans>{});
}

}  // namespace

// id in [0, kSpans), open 1 or 0.
FMM_EXPORT int fmm_span_mark(int id, int open, void* stream) {
  if (id < 0 || id >= kSpans) return cudaErrorInvalidValue;
  return static_cast<int>(cudaLaunchKernel(marker_of(id, open != 0), dim3(1), dim3(1), nullptr,
                                           0, static_cast<cudaStream_t>(stream)));
}

// Loads every marker (a lazily loaded module would otherwise load each at its
// first launch, which may fall inside a stream capture). Launches nothing.
FMM_EXPORT int fmm_span_prepare() {
  for (int id = 0; id < kSpans; ++id) {
    for (int open = 0; open < 2; ++open) {
      cudaFuncAttributes attr;
      const cudaError_t err = cudaFuncGetAttributes(&attr, marker_of(id, open != 0));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}
