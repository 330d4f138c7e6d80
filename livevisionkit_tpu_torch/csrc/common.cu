// Shared C entry points of liblvk_cuda.so.
#include <cuda_runtime.h>

extern "C" const char* lvk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
