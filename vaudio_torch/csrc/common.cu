// Shared C entry point of the vaudio_torch kernel library: the text of a
// CUDA error code returned by one of the launch functions.
#include <cuda_runtime.h>

extern "C" const char* vaudio_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
