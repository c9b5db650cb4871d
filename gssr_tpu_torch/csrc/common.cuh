// Shared by the blend kernels of csrc/: the tile and chunk geometry, the
// alpha and transmittance thresholds of every blend, the staging of one
// chunk's attribute rows in shared memory, the gaussian alpha of the
// vanilla and planar blends, the staging and per-warp instance lists of
// their alpha cull, the forward of both (gauss_fwd_tile), the warp
// reduce-scatter of the backwards, the occupancy report, and the error
// string of the C interface. Each source includes it once and builds into
// its own library.
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
// a warp of the culling forwards covers an 8 x 4 pixel block of its tile
constexpr int BLOCK_W = 8, BLOCK_H = 4;

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

// the gaussian's exponent at pixel (px, py), dx = mx - px, dy = my - py:
// power = -0.5 (cxx dx^2 + cyy dy^2) - cxy dx dy, rounded after every
// operation (the _rn intrinsics are never fused into FMAs), as
// blend_fwd_plain computes it, so the kernels and their plain versions
// take the same alpha and T_EPS decisions
__device__ __forceinline__ float gauss_power(float mx, float my, float cxx,
                                             float cxy, float cyy, float px,
                                             float py, float& dx,
                                             float& dy) {
  dx = __fsub_rn(mx, px);
  dy = __fsub_rn(my, py);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(cxx, dx), dx),
                            __fmul_rn(__fmul_rn(cyy, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(cxy, dx), dy));
}

// alpha of instance i at pixel (px, py), zero wherever the blend skips
// (power > 0 or alpha < 1/255); filler columns are all zero -> alpha 0.
__device__ __forceinline__ Alpha chunk_alpha(const float (*s)[CHUNK], int i,
                                             float px, float py) {
  Alpha o;
  const float power = gauss_power(s[MX][i], s[MY][i], s[CXX][i], s[CXY][i],
                                  s[CYY][i], px, py, o.dx, o.dy);
  o.g = expf(power);
  o.raw = s[OP][i] * o.g;
  const float alpha = fminf(ALPHA_MAX, o.raw);
  o.a = (power <= 0.f && alpha >= ALPHA_MIN) ? alpha : 0.f;
  return o;
}

// ---------------------------------------------------------------------------
// The alpha cull of the vanilla and planar forwards
// ---------------------------------------------------------------------------
//
// Per pair, the proof the warp's test rests on (the walk itself does not
// run it: a lane's skip saves nothing while its warp walks the step, and
// the test cost the kernels 3-4 % on the card). alpha = min(0.99, op
// expf(power)) passes the 1/255 gate only
// where power >= L = -ln(255 op). lim moves L down by 2^-10 (|L| + 1),
// and a pair with power < lim has exact alpha 0: then exp(power) <
// exp(-2^-11) / (255 op), with room for lim's own roundings (255 op
// rounded, logf's 1 ulp, the product and difference: < 2^-21 (|L| + 1)),
// expf's 2 ulp (2^-22) and the product op g (2^-24), so op g rounds below
// 1/255 (1 - 2^-12) < ALPHA_MIN. The test reads the very float power the
// exact path feeds to expf. Where op = 0 (every filler column) or 255 op
// underflows, L = lim = +inf, and op g is 0 or below ALPHA_MIN at every
// pixel. A negative or NaN op gives lim NaN, and a NaN power fails the
// test: neither is culled, and the exact path takes them. op = +inf gives
// lim = -inf: nothing is culled.
//
// Per (warp, instance). A warp culls an instance for its whole 8 x 4
// pixel block where Qmin - 2^-10 Emax > -lim: Qmin is the minimum of the
// convex Q = 0.5 (cxx dx^2 + cyy dy^2) + cxy dx dy over the block's
// pixel-centre rectangle (0 where the mean lies in it, else the least of
// the four closed-form edge minima, as ops/projection.py's
// tile_intersect_mask computes it), and Emax = 0.5 (|cxx| X^2 + |cyy|
// Y^2) + |cxy| X Y, with X, Y the largest |dx|, |dy| in the rectangle,
// bounds every term of Q there. The float power of any pixel of the block
// is within 2^-20 E of -Q, and the computed Qmin within 2^-15 Emax of the
// exact one (its rounded edge points cost 0.5 c delta^2, small while the
// mean lies within 2^14 of the origin), so every pixel's power is below
// lim and its alpha is 0 by the per-pair argument. Only robust conics
// take the test: cxx and cyy in [2^-40, 2^40], cxy^2 < (1 - 2^-10) cxx
// cyy (strictly convex; every value finite) and |mean| < 2^14; for the
// others qcut is +inf (or NaN) and they are never culled whole, except
// where lim = +inf (qcut = -inf), where every pair is zero anyway.
constexpr float CULL_REL = 0x1p-10f;
constexpr float CULL_CONIC_MIN = 0x1p-40f;
constexpr float CULL_CONIC_MAX = 0x1p40f;
constexpr float CULL_MEAN_MAX = 0x1p14f;

// the per-pair limit on power (above)
__device__ __forceinline__ float alpha_cull_limit(float op) {
  const float L = -logf(__fmul_rn(255.f, op));
  return __fsub_rn(
      __fmul_rn(L, L >= 0.f ? 1.f - CULL_REL : 1.f + CULL_REL), CULL_REL);
}

// what a chunk's instance gives the culling forward, staged once per
// chunk: (mx, my, cxx, cxy), (cyy, op, qcut, 0) and the slopes (cxy /
// cxx, cxy / cyy) of the edge minima; qcut = -lim for a robust conic,
// -inf where lim = +inf, else +inf
struct CullGauss {
  float4 a, b;
  float2 r;
};

__device__ __forceinline__ CullGauss cull_gauss(float mx, float my,
                                                float cxx, float cxy,
                                                float cyy, float op) {
  const float lim = alpha_cull_limit(op);
  const bool robust =
      cxx >= CULL_CONIC_MIN && cxx <= CULL_CONIC_MAX &&
      cyy >= CULL_CONIC_MIN && cyy <= CULL_CONIC_MAX &&
      __fmul_rn(cxy, cxy) < __fmul_rn(__fmul_rn(1.f - CULL_REL, cxx), cyy) &&
      fabsf(mx) < CULL_MEAN_MAX && fabsf(my) < CULL_MEAN_MAX;
  const float qcut = lim == INFINITY ? -INFINITY : robust ? -lim : INFINITY;
  CullGauss g;
  g.a = make_float4(mx, my, cxx, cxy);
  g.b = make_float4(cyy, op, qcut, 0.f);
  g.r = robust ? make_float2(cxy / cxx, cxy / cyy) : make_float2(0.f, 0.f);
  return g;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// whether instance (a, b, r) has alpha 0 at every pixel of the 8 x 4
// block at (bx0, by0) (above); bitwise | evaluates both sides, no branch
__device__ __forceinline__ bool block_culled(float4 a, float4 b, float2 r,
                                             float bx0, float by0) {
  const float mx = a.x, my = a.y, cxx = a.z, cxy = a.w, cyy = b.x;
  const float bx1 = bx0 + (BLOCK_W - 1), by1 = by0 + (BLOCK_H - 1);
  auto Q = [&](float x, float y) {
    const float dx = x - mx, dy = y - my;
    return 0.5f * (cxx * dx * dx + cyy * dy * dy) + cxy * dx * dy;
  };
  float q = fminf(
      fminf(Q(bx0, clampf(my - r.y * (bx0 - mx), by0, by1)),
            Q(bx1, clampf(my - r.y * (bx1 - mx), by0, by1))),
      fminf(Q(clampf(mx - r.x * (by0 - my), bx0, bx1), by0),
            Q(clampf(mx - r.x * (by1 - my), bx0, bx1), by1)));
  const bool inside = mx >= bx0 && mx <= bx1 && my >= by0 && my <= by1;
  q = inside ? 0.f : q;
  const float X = fmaxf(fabsf(bx0 - mx), fabsf(bx1 - mx));
  const float Y = fmaxf(fabsf(by0 - my), fabsf(by1 - my));
  const float E =
      0.5f * (fabsf(cxx) * X * X + fabsf(cyy) * Y * Y) + fabsf(cxy) * X * Y;
  return (b.z == -INFINITY) | (q - CULL_REL * E > b.z);
}

// Stage instance j of the chunk at `base` for the culling walks: its
// geometry and cull inputs (cull_gauss) as float4s, its edge slopes as a
// float2. One thread per instance.
__device__ __forceinline__ void stage_cull(float4 (*geo)[CHUNK],
                                           float2* slope,
                                           const float* __restrict__ attrs,
                                           long long n_inst, long long base,
                                           int j) {
  const float* a = attrs + base + j;
  const CullGauss g = cull_gauss(a[MX * n_inst], a[MY * n_inst],
                                 a[CXX * n_inst], a[CXY * n_inst],
                                 a[CYY * n_inst], a[OP * n_inst]);
  geo[0][j] = g.a;
  geo[1][j] = g.b;
  slope[j] = g.r;
}

// The warp's list of the staged chunk: bit j of seen[k] is set where
// instance 32 k + j is not culled whole for the 8 x 4 block at (bx, by)
// (block_culled). Each lane tests 4 instances; 4 ballots.
__device__ __forceinline__ void warp_list(const float4 (*geo)[CHUNK],
                                          const float2* slope, float bx,
                                          float by, int lane,
                                          unsigned (&seen)[4]) {
  static_assert(CHUNK == 4 * 32, "a lane tests 4 instances");
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 32 * k + lane;
    seen[k] = __ballot_sync(FULL, !block_culled(geo[0][i], geo[1][i],
                                                slope[i], bx, by));
  }
}

// whether a staged instance (geo a, b) passes the blend's gates at pixel
// (px, py), power <= 0 and alpha >= 1/255, with its alpha there in
// `alpha`: chunk_alpha's roundings on the staged floats. (The gate stays
// a branch for the caller: a select of alpha or 0 adds two instructions
// to the forwards' walk.)
__device__ __forceinline__ bool staged_alpha(float4 a, float4 b, float px,
                                             float py, float& alpha) {
  float dx, dy;
  const float power = gauss_power(a.x, a.y, a.z, a.w, b.x, px, py, dx, dy);
  alpha = fminf(ALPHA_MAX, b.y * expf(power));
  return power <= 0.f && alpha >= ALPHA_MIN;
}

// The forward of the vanilla (NCH = 3: rgb) and planar (NCH = 7: rgb,
// normal, distance) blends for one 16 x 16 tile: per pixel the NCH
// channel sums of rows GEOM_ROWS.. and final_T, written as NCH + 1
// floats. Warp w covers the 8 x 4 block (w % 2, w / 2) of the tile. Per
// chunk, threads 0-127 stage instance p's geometry and cull inputs
// (stage_cull) and threads 128-255 its channels, as float4; then each
// lane tests 4 instances against its warp's block and 4 ballots give the
// warp its list of instances that some pixel of the block may see
// (warp_list). The warp walks only those, in ascending order (depth
// order), with __ffs, each lane until its D < T_EPS. A skipped pair has
// alpha 0 and changes nothing, so the result is that of the walk over
// every instance, bit for bit.
template <int NCH>
__device__ __forceinline__ void gauss_fwd_tile(
    const float* __restrict__ attrs, long long n_inst,
    const int* __restrict__ ranges, int tiles_x, float* __restrict__ out) {
  static_assert(2 * CHUNK == PIX, "two threads stage one instance");
  static_assert((NCH + 1) % 4 == 0, "the channels and T fill float4s");
  constexpr int NC4 = (NCH + 1) / 4;
  __shared__ float4 geo[2][CHUNK];
  __shared__ float2 slope[CHUNK];
  __shared__ float4 chan[NC4][CHUNK];
  const int t = blockIdx.x, p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const int bx = (t % tiles_x) * TILE + (warp % 2) * BLOCK_W;
  const int by = (t / tiles_x) * TILE + (warp / 2) * BLOCK_H;
  const int gx = bx + lane % BLOCK_W, gy = by + lane / BLOCK_W;
  const float px = (float)gx, py = (float)gy;
  const long long end = ranges[t + 1];
  float D = 1.f, acc[4 * NC4];
#pragma unroll
  for (int c = 0; c < 4 * NC4; ++c) acc[c] = 0.f;
  float Tb = 1.f;

  for (long long base = ranges[t]; base < end; base += CHUNK) {
    // also the barrier before the staging buffers are overwritten
    if (!__syncthreads_or(D >= T_EPS)) break;
    if (p < CHUNK) {
      stage_cull(geo, slope, attrs, n_inst, base, p);
    } else {
      const float* a = attrs + base + (p - CHUNK);
      float c[4 * NC4];
#pragma unroll
      for (int j = 0; j < 4 * NC4; ++j)
        c[j] = j < NCH ? a[(GEOM_ROWS + j) * n_inst] : 0.f;
#pragma unroll
      for (int k = 0; k < NC4; ++k)
        chan[k][p - CHUNK] =
            make_float4(c[4 * k], c[4 * k + 1], c[4 * k + 2], c[4 * k + 3]);
    }
    __syncthreads();
    unsigned seen[4];
    warp_list(geo, slope, (float)bx, (float)by, lane, seen);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned bits = seen[k];
      while (bits != 0u && D >= T_EPS) {
        const int i = 32 * k + __ffs(bits) - 1;
        bits &= bits - 1u;
        float alpha;
        if (!staged_alpha(geo[0][i], geo[1][i], px, py, alpha)) continue;
        const float one_m = 1.f - alpha;
        const float Dn = D * one_m;
        if (Dn >= T_EPS) {
          const float w = alpha * D;
          float cv[4 * NC4];
#pragma unroll
          for (int k4 = 0; k4 < NC4; ++k4) {
            const float4 ch = chan[k4][i];
            cv[4 * k4] = ch.x;
            cv[4 * k4 + 1] = ch.y;
            cv[4 * k4 + 2] = ch.z;
            cv[4 * k4 + 3] = ch.w;
          }
#pragma unroll
          for (int c = 0; c < NCH; ++c) acc[c] += w * cv[c];
          Tb *= one_m;
        }
        D = Dn;
      }
    }
  }
  acc[NCH] = Tb;
  float4* q = reinterpret_cast<float4*>(out)
              + ((long long)gy * (tiles_x * TILE) + gx) * NC4;
#pragma unroll
  for (int k = 0; k < NC4; ++k)
    q[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2],
                       acc[4 * k + 3]);
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
