// Stage marks: empty one-thread kernels whose launches, captured inside a
// CUDA graph, mark the boundaries of the step's stages on the device
// (utils/profiling.py; no TPU kernel: the JAX package's stages show on its
// own profiler).  Kernel `lvk_stage_mark<ID>` marks stage ID / 2 of
// `profiling.STAGES`, its start for an even ID and its end for an odd one.
// A mark costs one launch and no memory traffic.
#include <cuda_runtime.h>

#include <utility>

template <int ID>
__global__ void lvk_stage_mark() {}

namespace {

constexpr int kMaxMarks = 64;  // profiling.MAX_MARKS

using Mark = void (*)();

template <int... I>
const Mark* mark_table(std::integer_sequence<int, I...>) {
  static const Mark table[] = {lvk_stage_mark<I>...};
  return table;
}

const Mark* marks() { return mark_table(std::make_integer_sequence<int, kMaxMarks>{}); }

}  // namespace

// Load every marker kernel on the current device (a kernel may not be
// loaded inside a stream capture).  Returns the first CUDA error, or 0.
extern "C" int lvk_load_stage_marks() {
  cudaFuncAttributes attr;
  for (int i = 0; i < kMaxMarks; ++i) {
    cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(marks()[i]));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// One launch of marker `id` on `stream`.  Returns the launch's error, else
// cudaGetLastError() (cudaErrorInvalidValue for an id out of range).
extern "C" int lvk_mark_stage(int id, void* stream) {
  if (id < 0 || id >= kMaxMarks) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(marks()[id]), dim3(1), dim3(1),
                                     nullptr, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
