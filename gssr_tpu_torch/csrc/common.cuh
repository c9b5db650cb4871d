// Shared by the blend kernels of csrc/: the tile and chunk geometry, the
// alpha and transmittance thresholds of every blend, the staging of one
// chunk's attribute rows in shared memory, the gaussian alpha of the
// vanilla and planar blends, the warp reduce-scatter of the backwards, the
// occupancy report, and the error string of the C interface. Each source
// includes it once and builds into its own library.
#pragma once

#include <cuda_runtime.h>

namespace gssr {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int WARPS = PIX / 32;
constexpr int CHUNK = 128;
constexpr unsigned FULL = 0xffffffffu;
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

// One step of warp_reduce_scatter at lane offset H: each lane keeps the
// half of v[0, 2H) that its lane bit H selects, sends the other half to
// lane ^ H and adds what it receives into v[0, H). The halves are picked
// by selects with constant indices, never by a dynamic register index, so
// v stays in registers. Entries from LIVE on are zero on every lane: where
// the upper entry k + H is one of them, every lane adds its partner's v[k]
// with no select, which is the sum of entry k on the lanes that keep the
// lower half and stands in for the zero entry on the others.
template <int H, int LIVE>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32],
                                                    int lane) {
  const bool hi = (lane & H) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    if (k + H >= LIVE) {
      v[k] += __shfl_xor_sync(FULL, v[k], H);
    } else {
      const float keep = hi ? v[k + H] : v[k];
      const float send = hi ? v[k] : v[k + H];
      v[k] = keep + __shfl_xor_sync(FULL, send, H);
    }
  }
  // below offset 16 a slot's entry depends on lane bit 4: no shortcut
  if constexpr (H > 1) reduce_scatter_step<H / 2, 32>(v, lane);
}

// The warp's sum of v[k] over its 32 lanes, returned on lane k, for every
// k < LIVE, where v[LIVE, 32) is zero on every lane (lanes LIVE-31 return
// an unspecified value): recursive halving at offsets 16, 8, 4, 2 and 1,
// 31 shuffles in all where an xor butterfly per entry takes 5 x 32. Each
// sum adds the same pairs of lanes in the same order as that butterfly, so
// the result is bitwise reproducible and equal to it. Clobbers v.
template <int LIVE>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32],
                                                     int lane) {
  static_assert(LIVE > 0 && LIVE <= 32, "a 32-vector");
  reduce_scatter_step<16, LIVE>(v, lane);
  return v[0];
}

// Let `kernel` take `smem` bytes of dynamic shared memory (above 48 KB it
// has to be asked for) and the carveout that leaves the most of it.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// out[4]: registers and local (spill) bytes per thread, dynamic shared
// bytes, and resident blocks per SM of `kernel` at PIX threads a block.
// A kernel with dynamic shared memory is given what its entry point asks
// for (allow_smem); one with static shared memory only is left as its
// launches find it.
template <typename K>
cudaError_t occupancy(K kernel, int smem, int* out) {
  cudaError_t e = smem > 0 ? allow_smem(kernel, smem) : cudaSuccess;
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, PIX,
                                                       smem);
}

}  // namespace gssr

extern "C" const char* gssr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
