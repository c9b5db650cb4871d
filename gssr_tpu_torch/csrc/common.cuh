// Shared by the blend kernels of csrc/: the tile and chunk geometry, the
// alpha and transmittance thresholds of every blend, the staging of one
// chunk's attribute rows in shared memory, and the error string of the C
// interface. Each source includes it once and builds into its own library.
#pragma once

#include <cuda_runtime.h>

namespace gssr {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int WARPS = PIX / 32;
constexpr int CHUNK = 128;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

// stage rows [0, ROWS) of one chunk of attrs [*, n_inst] in shared memory
template <int ROWS>
__device__ __forceinline__ void load_chunk(float (*s)[CHUNK],
                                           const float* __restrict__ attrs,
                                           long long n_inst, long long base) {
  for (int j = threadIdx.x; j < ROWS * CHUNK; j += PIX) {
    const int r = j / CHUNK, c = j % CHUNK;
    s[r][c] = attrs[r * n_inst + base + c];
  }
}

}  // namespace gssr

extern "C" const char* gssr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
