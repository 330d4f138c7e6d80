// Shared C entry points of liblvk_cuda.so.
#include <cuda_runtime.h>

namespace {

__global__ void noop_kernel() {}

}  // namespace

extern "C" const char* lvk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// One launch of an empty one-warp kernel: the floor under which no kernel
// of the library can be timed (chip_smoke.py reads the LK kernel against
// it).  Returns cudaGetLastError() after the launch.
extern "C" int lvk_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
