// Shared helpers for the package's CUDA kernels. Each kernel file exposes a
// plain C entry point (loaded with ctypes) that launches on the caller's
// stream and returns the launch status as an int (cudaError_t).
#pragma once

#include <cuda_runtime.h>

#define SCENERF_API extern "C" __attribute__((visibility("default")))

namespace scenerf {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpSize = 32;

}  // namespace scenerf
