// The CUDA runtime calls a kernel's C entry makes, on the host (simt.h): no
// device, an SM count the caller sets (brdf_host_set_sms) and two resident
// blocks an SM, so the entry's persistent grid can be made smaller than its
// work and its groups refill.
#pragma once

#include <cstddef>

#include "simt.h"

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorLaunchFailure = 719,
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

struct cudaFuncAttributes {
  int numRegs = 0;
  size_t localSizeBytes = 0;
};

inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}

inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = brdf_host::g_sms;
  return cudaSuccess;
}

template <class Kernel>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, Kernel, int, size_t) {
  *blocks = 2;
  return cudaSuccess;
}

template <class Kernel>
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* attr, Kernel) {
  *attr = cudaFuncAttributes{};
  return cudaSuccess;
}

inline cudaError_t cudaGetLastError() {
  return brdf_host::g_error == nullptr ? cudaSuccess : cudaErrorLaunchFailure;
}

extern "C" void brdf_host_set_sms(int sms) { brdf_host::g_sms = sms; }
extern "C" const char* brdf_host_error() { return brdf_host::g_error; }
