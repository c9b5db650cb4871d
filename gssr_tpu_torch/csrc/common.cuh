// Shared by the blend kernels of csrc/: the tile and chunk geometry, the
// alpha and transmittance thresholds of every blend, the staging of one
// chunk's attribute rows in shared memory, the gaussian alpha of the
// vanilla and planar blends, and the error string of the C interface. Each
// source includes it once and builds into its own library.
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

// rows 0-5 of the vanilla (blend.cu) and planar (blend_pgsr.cu) layouts:
// mean2d x, y, conic xx, xy, yy, opacity
constexpr int GEOM_ROWS = 6;
enum { MX, MY, CXX, CXY, CYY, OP };

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

struct Alpha {
  float a, dx, dy, g, raw;
};

// alpha of instance i at pixel (px, py), zero wherever the blend skips
// (power > 0 or alpha < 1/255); filler columns are all zero -> alpha 0.
// power is rounded after every operation (the _rn intrinsics are never
// fused into FMAs), as blend_fwd_plain computes it, so the kernels and
// their plain versions take the same alpha and T_EPS decisions.
__device__ __forceinline__ Alpha chunk_alpha(const float (*s)[CHUNK], int i,
                                             float px, float py) {
  Alpha o;
  o.dx = s[MX][i] - px;
  o.dy = s[MY][i] - py;
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(s[CXX][i], o.dx), o.dx),
                            __fmul_rn(__fmul_rn(s[CYY][i], o.dy), o.dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, q),
                                __fmul_rn(__fmul_rn(s[CXY][i], o.dx), o.dy));
  o.g = expf(power);
  o.raw = s[OP][i] * o.g;
  const float alpha = fminf(ALPHA_MAX, o.raw);
  o.a = (power <= 0.f && alpha >= ALPHA_MIN) ? alpha : 0.f;
  return o;
}

}  // namespace gssr

extern "C" const char* gssr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
