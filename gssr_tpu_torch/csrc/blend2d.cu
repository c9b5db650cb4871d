// Surfel (2DGS) blend, forward and analytic backward, for Hopper (sm_90a).
// Plain C interface, loaded through ctypes by gssr_tpu_torch/ops/_kernels.py;
// the plain PyTorch versions are blend2d_fwd_plain / blend2d_bwd_plain in
// gssr_tpu_torch/ops/blend2d.py, which also documents the layouts.
//
// Replaces gssr_tpu/ops/blend2d_pallas.py::_fwd2_kernel and ::_bwd2_kernel.
// The Pallas forward evaluates a whole (256 pixels x 128 instances) chunk at
// once, with prefix products over lanes and MXU products for the colour and
// median sums; its backward walks a flat chunk grid carrying per-tile state
// from one grid step to the next and contracts all 21 gradient rows with
// one MXU product of tile-local pixel moments. Here, as for the vanilla
// blend (blend.cu), one block per 16x16 tile walks its own chunks in depth
// order with one thread per pixel; the per-pixel recurrence runs one
// instance at a time and each gradient row's term is formed directly per
// (pixel, instance), e.g. d CB = -sum_p px * gp.
//
// Inputs: attrs [24, I] attribute-major, 21 live rows (mean2d xy, CA, CB,
// CC, Tw, opacity, rgb, normal); ranges [T+1] int32 chunk-aligned per-tile
// starts; maps [H, W, 16] over the tile-padded image (rows O_* below).
//
// What bounds them on the H100: per (pixel, instance) pair up to the tile's
// saturation the forward does one reciprocal, one expf and ~45 FP32
// operations; the backward redoes those and adds ~75 operations of gradient
// terms and the sum of 21 rows over the tile's pixels. Attribute bytes (84
// per instance, read once per tile) are small beside that, so both are
// bound by FP32 and MUFU work, not by memory. The design stages each
// chunk's 21 live rows (10.75 KB) in shared memory for all 256 pixels of
// the tile, stops a tile's walk once no pixel has D >= 1e-4, and skips a
// warp's reduction for an instance that touches none of its pixels.
//
// The forward's evaluation: two IEEE divisions (1 / pz, and the
// distortion's NEAR_N / depth) and an accurate expf run on every walked
// pair, though most pairs have alpha below 1/255 and change nothing (62.5 %
// of the walked pairs at chip_smoke.py's 2dgs inputs: 32 steps on its
// random synthetic scene, camera 0, on an H100). blend2d_fwd_kernel culls
// those first. Per
// chunk it stages, beside the rows, each instance's cull inputs as three
// float4 (CA, CB, CC, the centre and lim), read by a warp with three
// broadcast loads; lim is the largest rho at which alpha = op *
// exp(-rho / 2) can reach 1/255, 2 ln(255 op), widened to lim (1 + 2^-10)
// + 2^-10 (-1 where op < 1/255, fillers included). Per pair, from the
// intersection p that the exact path needs anyway, it skips the pair where
// pz = 0, or where rho2d > lim and p0^2 + p1^2 > max(lim pz^2, 2^-100), the
// 3D test without the division. The margin is about 2^-10 of rho where
// every rounding on the way (the reciprocal, the products, expf's 2 ulp,
// logf's 1 ulp) is below 2^-20; the floor keeps the 3D test to normal
// numbers, where each product is exact to 2^-24; the +-1e4 clamp, a
// reciprocal that overflows and NaN only make rho3d larger. So a skipped
// pair is one whose exact alpha is 0, and the outputs do not change. A pair
// that is not skipped runs the exact code, with the distortion's division
// only where it contributes. A lane's skip saves issue slots only where all
// 32 lanes of its warp skip, so a warp covers an 8 x 4 block of its tile,
// which lies outside a small splat more often than a 16 x 2 strip does.
// The first design (no cull, a 16 x 2 strip per warp) lost to this one at
// every input measured and is gone; PERF.md section 6 keeps its figures.
//
// The backward's sum over pixels: an xor butterfly per row would take 5
// shuffles and 5 adds a row and lane, 105 shuffles per warp and instance,
// and an SM retires one warp shuffle per clock. blend2d_bwd_kernel pads the
// 21 terms to 32 and sums them with one warp reduce-scatter (common.cuh:
// 31 shuffles, 31 adds and 40 selects, the 11 zero pad rows needing none),
// after which lane k holds row k: 21 lanes store the warp's partials with
// one coalesced shared-memory write. The partials of a whole chunk
// ([warp][instance][row], 84 KB of dynamic shared memory) are summed over
// the 8 warps once per chunk, so a chunk costs three barriers (summing
// every 32 instances would cost ten); at
// <= 128 registers two blocks stay resident per SM. What is left bounds it
// by instruction dispatch: the surfel evaluation on every walked instance and
// the gradient terms where it contributes. The first design (a butterfly
// per row, lane 0 writing the partials, the warps summed every 32
// instances) lost to this one at every input measured and is gone; PERF.md
// section 6 keeps its figures.
//
// Agreement with the plain version: every operation on the path to an
// alpha, depth, D or median decision is rounded once (the _rn intrinsics
// are never fused into FMAs), as PyTorch computes it, so both take the
// same decisions.
//
// Determinism: exactly one block writes each instance's gradient slot, and
// every sum over pixels runs in a fixed order (within a warp, then the 8
// warp partials in warp order): no atomics.

#include "common.cuh"

namespace {

using namespace gssr;

constexpr int LIVE2 = 21;
constexpr int OUT2 = 16;
constexpr float NEAR_N = 0.2f;
constexpr float M_COEF = static_cast<float>(100.0 / (100.0 - 0.2));
// the forward's cull (see the note above)
constexpr float CULL_WIDEN = 1.f + 0x1p-10f;
constexpr float CULL_PAD = 0x1p-10f;
constexpr float CULL_FLOOR = 0x1p-100f;
enum { XY = 0, CA = 2, CB = 5, CC = 8, TW = 11, OPC = 14, RGB = 15,
       NRM = 18 };
enum { O_RGB = 0, O_NRM = 3, O_D = 6, O_DIST = 7, O_T = 8, O_MED = 9,
       O_SEL = 10, O_MEDNRM = 11, O_S1 = 14, O_S2 = 15 };
// dynamic shared memory of blend2d_bwd_kernel: the staged chunk and the
// warp partials of all its instances, [warp][instance][row]. The row
// stride, 21, is odd, so the cross-warp pass's reads down an instance
// column hit 32 banks, as do the lanes' stores along a row.
constexpr int BWD2_SMEM =
    (LIVE2 * CHUNK + WARPS * CHUNK * LIVE2) * static_cast<int>(sizeof(float));

struct Surfel {
  float a, rpz, s0, s1, dx, dy, depth, safe_depth, m, g, raw;
  bool is3d;
};

// what the cull reads of an instance: the intersection invariants and the
// low-pass centre
struct RayAttrs {
  float ca[3], cb[3], cc[3], x, y;
};

__device__ __forceinline__ RayAttrs ray_attrs(const float (*s)[CHUNK],
                                              int i) {
  RayAttrs a;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a.ca[j] = s[CA + j][i];
    a.cb[j] = s[CB + j][i];
    a.cc[j] = s[CC + j][i];
  }
  a.x = s[XY][i];
  a.y = s[XY + 1][i];
  return a;
}

// an instance at pixel (px, py) up to what the cull reads: the ray-splat
// intersection p = CA - px CB - py CC and the low-pass distance rho2d
struct SurfelRay {
  float p[3], dx, dy, rho2d;
};

__device__ __forceinline__ SurfelRay surfel_ray(const RayAttrs& a, float px,
                                                float py) {
  SurfelRay r;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    r.p[j] = __fsub_rn(__fsub_rn(a.ca[j], __fmul_rn(px, a.cb[j])),
                       __fmul_rn(py, a.cc[j]));
  r.dx = __fsub_rn(a.x, px);
  r.dy = __fsub_rn(a.y, py);
  r.rho2d = __fmul_rn(
      2.f, __fadd_rn(__fmul_rn(r.dx, r.dx), __fmul_rn(r.dy, r.dy)));
  return r;
}

// the rest of the evaluation: the min(rho3d, rho2d) low-pass and the
// gates pz != 0, depth >= 0.2 and alpha >= 1/255. Filler columns are all
// zero: pz = 0 -> alpha 0. safe_depth and m are left to surfel_alpha.
__device__ __forceinline__ Surfel surfel_eval(const float (*s)[CHUNK], int i,
                                              const SurfelRay& r) {
  Surfel o;
  const bool pz_ok = r.p[2] != 0.f;
  o.rpz = __fdiv_rn(1.f, pz_ok ? r.p[2] : 1.f);
  o.s0 = fminf(fmaxf(__fmul_rn(r.p[0], o.rpz), -1e4f), 1e4f);
  o.s1 = fminf(fmaxf(__fmul_rn(r.p[1], o.rpz), -1e4f), 1e4f);
  const float rho3d = __fadd_rn(__fmul_rn(o.s0, o.s0), __fmul_rn(o.s1, o.s1));
  o.dx = r.dx;
  o.dy = r.dy;
  o.is3d = rho3d <= r.rho2d;
  const float rho = fminf(rho3d, r.rho2d);
  o.depth = o.is3d ? __fadd_rn(__fadd_rn(__fmul_rn(o.s0, s[TW][i]),
                                         __fmul_rn(o.s1, s[TW + 1][i])),
                               s[TW + 2][i])
                   : s[TW + 2][i];
  o.g = expf(__fmul_rn(-0.5f, rho));
  o.raw = __fmul_rn(s[OPC][i], o.g);
  const float alpha = fminf(ALPHA_MAX, o.raw);
  const bool ok = pz_ok && o.depth >= NEAR_N && alpha >= ALPHA_MIN;
  o.a = ok ? alpha : 0.f;
  return o;
}

__device__ __forceinline__ float distortion_m(float safe_depth) {
  return M_COEF * (1.f - NEAR_N / safe_depth);
}

// the whole evaluation, as the backwards use it
__device__ __forceinline__ Surfel surfel_alpha(const float (*s)[CHUNK],
                                               int i, float px, float py) {
  Surfel o = surfel_eval(s, i, surfel_ray(ray_attrs(s, i), px, py));
  o.safe_depth = fmaxf(o.depth, 1e-6f);
  o.m = distortion_m(o.safe_depth);
  return o;
}

// the forward's cull: per instance, the widened largest rho at which its
// alpha can reach 1/255 (-1 where it cannot; a NaN opacity gives NaN, which
// culls only the pairs with pz = 0), and per pair whether its alpha is
// provably 0
__device__ __forceinline__ float cull_limit(float op) {
  if (op < ALPHA_MIN) return -1.f;
  return __fadd_rn(
      __fmul_rn(__fmul_rn(2.f, logf(__fmul_rn(255.f, op))), CULL_WIDEN),
      CULL_PAD);
}

// (bitwise | and & evaluate both sides, so the predicate takes no branch)
__device__ __forceinline__ bool culled(const SurfelRay& r, float lim) {
  const float q = __fadd_rn(__fmul_rn(r.p[0], r.p[0]),
                            __fmul_rn(r.p[1], r.p[1]));
  const float bound =
      fmaxf(__fmul_rn(lim, __fmul_rn(r.p[2], r.p[2])), CULL_FLOOR);
  return (r.p[2] == 0.f) | ((r.rho2d > lim) & (q > bound));
}

// The cull's inputs of instance i of a chunk, staged as three float4 (CA,
// CB, CC, the centre and lim, in that order) so that a warp reads them with
// three broadcast loads; the exact path reads the rest from the rows.
__device__ __forceinline__ void stage_ray(float4 (*ray)[CHUNK],
                                          const float* __restrict__ attrs,
                                          long long n_inst, long long base,
                                          int i) {
  const float* a = attrs + base + i;
  float v[12];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    v[j] = a[(CA + j) * n_inst];
    v[3 + j] = a[(CB + j) * n_inst];
    v[6 + j] = a[(CC + j) * n_inst];
  }
  v[9] = a[XY * n_inst];
  v[10] = a[(XY + 1) * n_inst];
  v[11] = cull_limit(a[OPC * n_inst]);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    ray[k][i] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                            v[4 * k + 3]);
}

__device__ __forceinline__ RayAttrs unstage_ray(const float4 (*ray)[CHUNK],
                                                int i, float* lim) {
  const float4 a = ray[0][i], b = ray[1][i], c = ray[2][i];
  *lim = c.w;
  return {{a.x, a.y, a.z}, {a.w, b.x, b.y}, {b.z, b.w, c.x}, c.y, c.z};
}

__device__ __forceinline__ void load_px16(const float* __restrict__ src,
                                          long long pix, float* v) {
  const float4* q = reinterpret_cast<const float4*>(src) + pix * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 x = q[j];
    v[4 * j] = x.x;
    v[4 * j + 1] = x.y;
    v[4 * j + 2] = x.z;
    v[4 * j + 3] = x.w;
  }
}

// One pixel's side of the surfel forward: its 16 output channels and the
// running D, T and distortion sums of its walk.
struct SurfelFwdPixel {
  float px, py, o[OUT2];
  float D = 1.f, Tb = 1.f, M1 = 0.f, M2 = 0.f;

  __device__ __forceinline__ SurfelFwdPixel(float x, float y) : px(x), py(y) {
#pragma unroll
    for (int c = 0; c < OUT2; ++c) o[c] = 0.f;
    o[O_SEL] = -1.f;
  }

  // instance i of the staged chunk, at sorted position k0 + i of its tile,
  // evaluated in full from its ray and blended where alpha > 0
  __device__ __forceinline__ void step(const float (*s)[CHUNK], int i,
                                       float k0, const SurfelRay& r) {
    const Surfel sf = surfel_eval(s, i, r);
    if (!(sf.a > 0.f)) return;
    const float one_m = __fsub_rn(1.f, sf.a);
    const float Dn = __fmul_rn(D, one_m);
    if (Dn >= T_EPS) {
      const float w = sf.a * D;
      const float m = distortion_m(fmaxf(sf.depth, 1e-6f));
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o[O_RGB + c] += w * s[RGB + c][i];
        o[O_NRM + c] += w * s[NRM + c][i];
      }
      o[O_D] += w * sf.depth;
      // exclusive running sums M1, M2 before this instance
      o[O_DIST] += (m * m * (1.f - D) + M2 - 2.f * m * M1) * w;
      const float wm = w * m;
      M1 += wm;
      M2 += wm * m;
      if (D > 0.5f) {            // the last such contributor wins
        o[O_MED] = sf.depth;
        o[O_SEL] = k0 + (float)i;
#pragma unroll
        for (int c = 0; c < 3; ++c) o[O_MEDNRM + c] = s[NRM + c][i];
      }
      Tb = __fmul_rn(Tb, one_m);
    }
    D = Dn;
  }

  __device__ __forceinline__ void store(float* __restrict__ out,
                                        long long pix) {
    o[O_T] = Tb;
    o[O_S1] = M1;
    o[O_S2] = M2;
    float4* q = reinterpret_cast<float4*>(out) + pix * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = make_float4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
  }
};

__global__ void __launch_bounds__(PIX, 3)
blend2d_fwd_kernel(const float* __restrict__ attrs, long long n_inst,
                   const int* __restrict__ ranges, int tiles_x,
                   float* __restrict__ out) {
  static_assert(CHUNK <= PIX, "a thread stages an instance");
  __shared__ float s[LIVE2][CHUNK];
  __shared__ float4 ray[3][CHUNK];
  const int t = blockIdx.x, p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  // warp w covers the 8 x 4 block (w % 2, w / 2) of its tile
  const int gx = (t % tiles_x) * TILE + (warp % 2) * BLOCK_W + lane % BLOCK_W;
  const int gy = (t / tiles_x) * TILE + (warp / 2) * BLOCK_H + lane / BLOCK_W;
  SurfelFwdPixel pixel((float)gx, (float)gy);
  const long long start = ranges[t], end = ranges[t + 1];

  for (long long base = start; base < end; base += CHUNK) {
    // also the barrier before the staging buffers are overwritten
    if (!__syncthreads_or(pixel.D >= T_EPS)) break;
    load_chunk<LIVE2>(s, attrs, n_inst, base);
    if (p < CHUNK) stage_ray(ray, attrs, n_inst, base, p);
    __syncthreads();
    const float k0 = (float)(base - start);
    for (int i = 0; i < CHUNK && pixel.D >= T_EPS; ++i) {
      float lim;
      const SurfelRay r =
          surfel_ray(unstage_ray(ray, i, &lim), pixel.px, pixel.py);
      if (!culled(r, lim)) pixel.step(s, i, k0, r);
    }
  }
  pixel.store(out, (long long)gy * (tiles_x * TILE) + gx);
}

// One pixel's side of the surfel backward: its cotangents, the totals a
// first pass would rebuild, and the running D and prefix of its walk.
struct SurfelBwdPixel {
  float px, py, c[OUT2], S0, S1, S2, sel, total_wb, bgterm;
  float D = 1.f, prefix = 0.f;

  // the totals are read from the forward: each base channel is linear in
  // w, so its total is the forward's map contracted with its cotangent;
  // S0 = 1 - final_T telescopes
  __device__ __forceinline__ SurfelBwdPixel(const float* __restrict__ fwd_out,
                                            const float* __restrict__ cot,
                                            long long pix, float x, float y)
      : px(x), py(y) {
    float f[OUT2];
    load_px16(fwd_out, pix, f);
    load_px16(cot, pix, c);
    S0 = 1.f - f[O_T];
    S1 = f[O_S1];
    S2 = f[O_S2];
    sel = f[O_SEL];
    total_wb = c[O_D] * f[O_D];
#pragma unroll
    for (int k = 0; k < 6; ++k) total_wb += c[O_RGB + k] * f[O_RGB + k];
    total_wb += c[O_DIST] * 2.f * (S0 * S2 - S1 * S1);
    bgterm = f[O_T] * c[O_T];
  }

  // instance i of the staged chunk, at sorted position k0 + i of its tile:
  // where it contributes at this pixel, its 21 gradient terms go to
  // v[0, LIVE2) and the result is true; elsewhere v is left as it is
  __device__ __forceinline__ bool step(const float (*s)[CHUNK], int i,
                                       float k0, float* v) {
    if (!(D >= T_EPS)) return false;
    const Surfel sf = surfel_alpha(s, i, px, py);
    if (!(sf.a > 0.f)) return false;
    const float one_m = __fsub_rn(1.f, sf.a);
    const float Dn = __fmul_rn(D, one_m);
    bool hit = false;
    if (Dn >= T_EPS) {
      const float dD = c[O_D], ddist = c[O_DIST];
      const float w = sf.a * D;
      const float m = sf.m;
      float base_c = sf.depth * dD;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        base_c += c[O_RGB + k] * s[RGB + k][i] + c[O_NRM + k] * s[NRM + k][i];
      const float beta = base_c + ddist * (m * m * S0 + S2 - 2.f * m * S1);
      prefix += w * beta;
      const float da = D * beta - (total_wb - prefix + bgterm) / one_m;
      // alpha = min(0.99, op * g): no gradient through the clamp
      const float da_eff = sf.raw < ALPHA_MAX ? da : 0.f;
      const bool onehot = sel >= 0.f && k0 + (float)i == sel;
      const float dm_dd = M_COEF * NEAR_N / (sf.safe_depth * sf.safe_depth);
      const float gdepth = w * dD
          + ddist * 2.f * w * (m * S0 - S1) * dm_dd
          + (onehot ? c[O_MED] : 0.f);
      const float grho = da_eff * -0.5f * sf.raw;
      const float g2d = sf.is3d ? 0.f : grho;
      const float g3d = sf.is3d ? grho : 0.f;
      const float gs0 =
          g3d * 2.f * sf.s0 + (sf.is3d ? gdepth * s[TW][i] : 0.f);
      const float gs1 =
          g3d * 2.f * sf.s1 + (sf.is3d ? gdepth * s[TW + 1][i] : 0.f);
      const float gp[3] = {gs0 * sf.rpz, gs1 * sf.rpz,
                           -(sf.s0 * gs0 + sf.s1 * gs1) * sf.rpz};
      v[0] = g2d * 4.f * sf.dx;
      v[1] = g2d * 4.f * sf.dy;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        v[CA + k] = gp[k];
        v[CB + k] = -px * gp[k];
        v[CC + k] = -py * gp[k];
        v[RGB + k] = w * c[O_RGB + k];
        v[NRM + k] = w * c[O_NRM + k] + (onehot ? c[O_MEDNRM + k] : 0.f);
      }
      v[TW] = sf.is3d ? gdepth * sf.s0 : 0.f;
      v[TW + 1] = sf.is3d ? gdepth * sf.s1 : 0.f;
      v[TW + 2] = gdepth;
      v[OPC] = da_eff * sf.g;
      hit = true;
    }
    D = Dn;
    return hit;
  }
};

__global__ void __launch_bounds__(PIX, 2)
blend2d_bwd_kernel(const float* __restrict__ attrs, long long n_inst,
                   const int* __restrict__ ranges, int tiles_x,
                   const float* __restrict__ fwd_out,
                   const float* __restrict__ cot,
                   float* __restrict__ dattrs) {
  extern __shared__ float smem[];
  auto s = reinterpret_cast<float (*)[CHUNK]>(smem);
  auto part = reinterpret_cast<float (*)[CHUNK][LIVE2]>(smem + LIVE2 * CHUNK);
  const int t = blockIdx.x, p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const int gx = (t % tiles_x) * TILE + p % TILE;
  const int gy = (t / tiles_x) * TILE + p / TILE;
  SurfelBwdPixel pixel(fwd_out, cot, (long long)gy * (tiles_x * TILE) + gx,
                     (float)gx, (float)gy);
  const long long start = ranges[t], end = ranges[t + 1];

  for (long long base = start; base < end; base += CHUNK) {
    // chunks after the tile saturates keep their zero gradient; also the
    // barrier before the staged chunk and the partials are overwritten
    if (!__syncthreads_or(pixel.D >= T_EPS)) break;
    load_chunk<LIVE2>(s, attrs, n_inst, base);
    __syncthreads();
    const float k0 = (float)(base - start);
    for (int i = 0; i < CHUNK; ++i) {
      float v[32] = {};               // rows 21-31 stay zero
      const bool hit = pixel.step(s, i, k0, v);
      float sum = 0.f;
      if (__any_sync(FULL, hit)) sum = warp_reduce_scatter<LIVE2>(v, lane);
      if (lane < LIVE2) part[warp][i][lane] = sum;
    }
    __syncthreads();
    for (int q = p; q < LIVE2 * CHUNK; q += PIX) {
      const int r = q / CHUNK, i = q % CHUNK;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) acc += part[w][i][r];
      dattrs[r * n_inst + base + i] = acc;
    }
  }
}

}  // namespace

extern "C" {

// out [H, W, 16]; one block per tile
int gssr_blend2d_fwd(const float* attrs, long long n_inst, const int* ranges,
                     int tiles_x, int tiles_y, float* out, void* stream) {
  blend2d_fwd_kernel<<<tiles_x * tiles_y, PIX, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      attrs, n_inst, ranges, tiles_x, out);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: blend2d_fwd_kernel's registers, local bytes, dynamic shared bytes
// (none) and resident blocks per SM (common.cuh::occupancy); the stream is
// not used
int gssr_blend2d_fwd_occupancy(int* out, void* stream) {
  return static_cast<int>(occupancy(blend2d_fwd_kernel, 0, out));
}

// dattrs [24, I], zero-filled by the caller; one block per tile
int gssr_blend2d_bwd(const float* attrs, long long n_inst, const int* ranges,
                     int tiles_x, int tiles_y, const float* fwd_out,
                     const float* cot, float* dattrs, void* stream) {
  const cudaError_t e = allow_smem(blend2d_bwd_kernel, BWD2_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  blend2d_bwd_kernel<<<tiles_x * tiles_y, PIX, BWD2_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      attrs, n_inst, ranges, tiles_x, fwd_out, cot, dattrs);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: blend2d_bwd_kernel's registers, local bytes, dynamic shared
// bytes and resident blocks per SM (common.cuh::occupancy); the stream,
// which every entry point takes, is not used
int gssr_blend2d_bwd_occupancy(int* out, void* stream) {
  return static_cast<int>(occupancy(blend2d_bwd_kernel, BWD2_SMEM, out));
}

}  // extern "C"
