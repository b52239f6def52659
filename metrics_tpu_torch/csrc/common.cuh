// Shared by the kernel libraries under csrc/: each library is built on its own
// with nvcc into a shared object with a plain C interface (see ops/_native.py).
#pragma once

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
