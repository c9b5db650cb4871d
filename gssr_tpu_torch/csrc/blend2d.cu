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
// terms and a 21-row warp reduction (5 shuffles a row). Attribute bytes (84
// per instance, read once per tile) are small beside that, so both are
// bound by FP32 and MUFU work, not by memory. The design stages each
// chunk's 21 live rows (10.75 KB) in shared memory for all 256 pixels of
// the tile, stops a tile's walk once no pixel has D >= 1e-4, skips a warp's
// reduction for an instance that touches none of its pixels, and reduces
// the backward's rows in groups of 32 instances so its shared memory stays
// under the 48 KB static limit.
//
// Agreement with the plain version: every operation on the path to an
// alpha, depth, D or median decision is rounded once (the _rn intrinsics
// are never fused into FMAs), as PyTorch computes it, so both take the
// same decisions.
//
// Determinism: exactly one block writes each instance's gradient slot, and
// every sum over pixels runs in a fixed order (xor-shuffle butterfly within
// a warp, then the 8 warp partials in warp order): no atomics.

#include "common.cuh"

namespace {

using namespace gssr;

constexpr int LIVE2 = 21;
constexpr int OUT2 = 16;
constexpr int GROUP = 32;         // instances per backward reduction
constexpr float NEAR_N = 0.2f;
constexpr float M_COEF = static_cast<float>(100.0 / (100.0 - 0.2));
enum { XY = 0, CA = 2, CB = 5, CC = 8, TW = 11, OPC = 14, RGB = 15,
       NRM = 18 };
enum { O_RGB = 0, O_NRM = 3, O_D = 6, O_DIST = 7, O_T = 8, O_MED = 9,
       O_SEL = 10, O_MEDNRM = 11, O_S1 = 14, O_S2 = 15 };

struct Surfel {
  float a, rpz, s0, s1, dx, dy, depth, safe_depth, m, g, raw;
  bool is3d;
};

// instance i of the staged chunk at pixel (px, py): the ray-splat
// intersection s = CA - px CB - py CC, the min(rho3d, rho2d) low-pass and
// the gates pz != 0, depth >= 0.2 and alpha >= 1/255. Filler columns are
// all zero: pz = 0 -> alpha 0.
__device__ __forceinline__ Surfel surfel_alpha(const float (*s)[CHUNK],
                                               int i, float px, float py) {
  Surfel o;
  float p[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    p[j] = __fsub_rn(__fsub_rn(s[CA + j][i], __fmul_rn(px, s[CB + j][i])),
                     __fmul_rn(py, s[CC + j][i]));
  const bool pz_ok = p[2] != 0.f;
  o.rpz = __fdiv_rn(1.f, pz_ok ? p[2] : 1.f);
  o.s0 = fminf(fmaxf(__fmul_rn(p[0], o.rpz), -1e4f), 1e4f);
  o.s1 = fminf(fmaxf(__fmul_rn(p[1], o.rpz), -1e4f), 1e4f);
  const float rho3d = __fadd_rn(__fmul_rn(o.s0, o.s0), __fmul_rn(o.s1, o.s1));
  o.dx = __fsub_rn(s[XY][i], px);
  o.dy = __fsub_rn(s[XY + 1][i], py);
  const float rho2d = __fmul_rn(
      2.f, __fadd_rn(__fmul_rn(o.dx, o.dx), __fmul_rn(o.dy, o.dy)));
  o.is3d = rho3d <= rho2d;
  const float rho = fminf(rho3d, rho2d);
  o.depth = o.is3d ? __fadd_rn(__fadd_rn(__fmul_rn(o.s0, s[TW][i]),
                                         __fmul_rn(o.s1, s[TW + 1][i])),
                               s[TW + 2][i])
                   : s[TW + 2][i];
  o.g = expf(__fmul_rn(-0.5f, rho));
  o.raw = __fmul_rn(s[OPC][i], o.g);
  const float alpha = fminf(ALPHA_MAX, o.raw);
  const bool ok = pz_ok && o.depth >= NEAR_N && alpha >= ALPHA_MIN;
  o.a = ok ? alpha : 0.f;
  o.safe_depth = fmaxf(o.depth, 1e-6f);
  o.m = M_COEF * (1.f - NEAR_N / o.safe_depth);
  return o;
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

__global__ void __launch_bounds__(PIX)
blend2d_fwd_kernel(const float* __restrict__ attrs, long long n_inst,
                   const int* __restrict__ ranges, int tiles_x,
                   float* __restrict__ out) {
  __shared__ float s[LIVE2][CHUNK];
  const int t = blockIdx.x, p = threadIdx.x;
  const int gx = (t % tiles_x) * TILE + p % TILE;
  const int gy = (t / tiles_x) * TILE + p / TILE;
  const float px = (float)gx, py = (float)gy;
  const long long start = ranges[t], end = ranges[t + 1];
  float o[OUT2];
#pragma unroll
  for (int c = 0; c < OUT2; ++c) o[c] = 0.f;
  o[O_SEL] = -1.f;
  float D = 1.f, Tb = 1.f, M1 = 0.f, M2 = 0.f;

  for (long long base = start; base < end; base += CHUNK) {
    // also the barrier before the staging buffer is overwritten
    if (!__syncthreads_or(D >= T_EPS)) break;
    load_chunk<LIVE2>(s, attrs, n_inst, base);
    __syncthreads();
    const float k0 = (float)(base - start);
    for (int i = 0; i < CHUNK && D >= T_EPS; ++i) {
      const Surfel sf = surfel_alpha(s, i, px, py);
      if (sf.a > 0.f) {
        const float one_m = __fsub_rn(1.f, sf.a);
        const float Dn = __fmul_rn(D, one_m);
        if (Dn >= T_EPS) {
          const float w = sf.a * D;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            o[O_RGB + c] += w * s[RGB + c][i];
            o[O_NRM + c] += w * s[NRM + c][i];
          }
          o[O_D] += w * sf.depth;
          // exclusive running sums M1, M2 before this instance
          o[O_DIST] += (sf.m * sf.m * (1.f - D) + M2 - 2.f * sf.m * M1) * w;
          const float wm = w * sf.m;
          M1 += wm;
          M2 += wm * sf.m;
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
    }
  }
  o[O_T] = Tb;
  o[O_S1] = M1;
  o[O_S2] = M2;
  const long long pix = (long long)gy * (tiles_x * TILE) + gx;
  float4* q = reinterpret_cast<float4*>(out) + pix * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    q[j] = make_float4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
}

__global__ void __launch_bounds__(PIX)
blend2d_bwd_kernel(const float* __restrict__ attrs, long long n_inst,
                   const int* __restrict__ ranges, int tiles_x,
                   const float* __restrict__ fwd_out,
                   const float* __restrict__ cot,
                   float* __restrict__ dattrs) {
  __shared__ float s[LIVE2][CHUNK];
  __shared__ float part[WARPS][LIVE2][GROUP];
  const int t = blockIdx.x, p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const int gx = (t % tiles_x) * TILE + p % TILE;
  const int gy = (t / tiles_x) * TILE + p / TILE;
  const float px = (float)gx, py = (float)gy;
  const long long pix = (long long)gy * (tiles_x * TILE) + gx;
  float f[OUT2], c[OUT2];
  load_px16(fwd_out, pix, f);
  load_px16(cot, pix, c);
  // the totals a first pass would rebuild, read from the forward: each
  // base channel is linear in w, so its total is the forward's map
  // contracted with its cotangent; S0 = 1 - final_T telescopes
  const float S0 = 1.f - f[O_T], S1 = f[O_S1], S2 = f[O_S2];
  const float dD = c[O_D], ddist = c[O_DIST], dmed = c[O_MED];
  const float sel = f[O_SEL];
  float total_wb = dD * f[O_D];
#pragma unroll
  for (int k = 0; k < 6; ++k) total_wb += c[O_RGB + k] * f[O_RGB + k];
  total_wb += ddist * 2.f * (S0 * S2 - S1 * S1);
  const float bgterm = f[O_T] * c[O_T];
  const long long start = ranges[t], end = ranges[t + 1];
  float D = 1.f, prefix = 0.f;

  for (long long base = start; base < end; base += CHUNK) {
    // chunks after the tile saturates keep their zero gradient
    if (!__syncthreads_or(D >= T_EPS)) break;
    load_chunk<LIVE2>(s, attrs, n_inst, base);
    __syncthreads();
    const float k0 = (float)(base - start);
    for (int g0 = 0; g0 < CHUNK; g0 += GROUP) {
      for (int j = 0; j < GROUP; ++j) {
        const int i = g0 + j;
        float v[LIVE2];
#pragma unroll
        for (int k = 0; k < LIVE2; ++k) v[k] = 0.f;
        bool hit = false;
        if (D >= T_EPS) {
          const Surfel sf = surfel_alpha(s, i, px, py);
          if (sf.a > 0.f) {
            const float one_m = __fsub_rn(1.f, sf.a);
            const float Dn = __fmul_rn(D, one_m);
            if (Dn >= T_EPS) {
              const float w = sf.a * D;
              const float m = sf.m;
              float base_c = sf.depth * dD;
#pragma unroll
              for (int k = 0; k < 3; ++k)
                base_c += c[O_RGB + k] * s[RGB + k][i]
                          + c[O_NRM + k] * s[NRM + k][i];
              const float beta =
                  base_c + ddist * (m * m * S0 + S2 - 2.f * m * S1);
              prefix += w * beta;
              const float da = D * beta - (total_wb - prefix + bgterm) / one_m;
              // alpha = min(0.99, op * g): no gradient through the clamp
              const float da_eff = sf.raw < ALPHA_MAX ? da : 0.f;
              const bool onehot = sel >= 0.f && k0 + (float)i == sel;
              const float dm_dd =
                  M_COEF * NEAR_N / (sf.safe_depth * sf.safe_depth);
              const float gdepth = w * dD
                  + ddist * 2.f * w * (m * S0 - S1) * dm_dd
                  + (onehot ? dmed : 0.f);
              const float grho = da_eff * -0.5f * sf.raw;
              const float g2d = sf.is3d ? 0.f : grho;
              const float g3d = sf.is3d ? grho : 0.f;
              const float gs0 = g3d * 2.f * sf.s0
                  + (sf.is3d ? gdepth * s[TW][i] : 0.f);
              const float gs1 = g3d * 2.f * sf.s1
                  + (sf.is3d ? gdepth * s[TW + 1][i] : 0.f);
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
                v[NRM + k] = w * c[O_NRM + k]
                    + (onehot ? c[O_MEDNRM + k] : 0.f);
              }
              v[TW] = sf.is3d ? gdepth * sf.s0 : 0.f;
              v[TW + 1] = sf.is3d ? gdepth * sf.s1 : 0.f;
              v[TW + 2] = gdepth;
              v[OPC] = da_eff * sf.g;
              hit = true;
            }
            D = Dn;
          }
        }
        if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
          for (int k = 0; k < LIVE2; ++k) {
            float x = v[k];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              x += __shfl_xor_sync(0xffffffffu, x, off);
            v[k] = x;
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < LIVE2; ++k) part[warp][k][j] = v[k];
        }
      }
      __syncthreads();
      for (int q = p; q < LIVE2 * GROUP; q += PIX) {
        const int r = q / GROUP, col = q % GROUP;
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) acc += part[w][r][col];
        dattrs[r * n_inst + base + g0 + col] = acc;
      }
      // the partials are read before the next group overwrites them
      __syncthreads();
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

// dattrs [24, I], zero-filled by the caller; one block per tile
int gssr_blend2d_bwd(const float* attrs, long long n_inst, const int* ranges,
                     int tiles_x, int tiles_y, const float* fwd_out,
                     const float* cot, float* dattrs, void* stream) {
  blend2d_bwd_kernel<<<tiles_x * tiles_y, PIX, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      attrs, n_inst, ranges, tiles_x, fwd_out, cot, dattrs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
