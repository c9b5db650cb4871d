// Tile blend of vanilla 3DGS, forward and analytic backward, for Hopper
// (sm_90a). Plain C interface, loaded through ctypes by
// gssr_tpu_torch/ops/_kernels.py; the plain PyTorch versions are
// blend_fwd_plain / blend_bwd_plain in gssr_tpu_torch/ops/blend.py.
//
// Replaces gssr_tpu/ops/blend_pallas.py::_fwd_kernel and ::_bwd_kernel.
// Those rest on the TPU grid running in order on one core: the forward
// hands a prefetched head buffer to the NEXT tile, and the backward walks
// a flat chunk grid carrying per-tile state from one grid step to the
// next. Hopper runs blocks in parallel in no order, so both become one
// block per 16x16 tile that walks its own chunks in depth order.
//
// Inputs (see ops/blend.py): attrs [16, I] attribute-major, 9 live rows
// (mx, my, cxx, cxy, cyy, op, r, g, b); ranges [T+1] int32 chunk-aligned
// per-tile starts; maps [H, W, 4] (colour, final_T) over the tile-padded
// image.
//
// What bounds them on the H100: per (pixel, instance) pair up to the
// tile's saturation the forward does one expf and ~20 FP32 operations;
// the backward redoes that and adds ~40 operations of gradient terms and
// a 9-row warp reduction. Attribute bytes (36 per instance, read once per
// tile) are small beside that, so both are bound by FP32/MUFU work, not
// by memory. The design keeps each chunk's 9 attribute rows (4.5 KB) in
// shared memory, read by all 256 pixels of the tile, stops a tile's walk
// once no pixel has T >= 1e-4, and skips a warp's reduction for an
// instance that touches none of its 32 pixels. More pixels per thread
// and TMA double buffering are later work.
//
// Determinism: exactly one block writes each instance's gradient slot,
// and every sum over pixels runs in a fixed order (xor-shuffle butterfly
// within a warp, then the 8 warp partials in warp order): no atomics.

#include "common.cuh"

namespace {

using namespace gssr;

// rows 0-5 (mean2d, conic, opacity; common.cuh), then the colour
constexpr int LIVE = 9;
enum { CR = GEOM_ROWS, CG, CB };

__global__ void __launch_bounds__(PIX)
blend_fwd_kernel(const float* __restrict__ attrs, long long n_inst,
                 const int* __restrict__ ranges, int tiles_x,
                 float* __restrict__ out) {
  __shared__ float s[LIVE][CHUNK];
  const int t = blockIdx.x, p = threadIdx.x;
  const int gx = (t % tiles_x) * TILE + p % TILE;
  const int gy = (t / tiles_x) * TILE + p / TILE;
  const float px = (float)gx, py = (float)gy;
  const long long end = ranges[t + 1];
  float D = 1.f, Tb = 1.f, r = 0.f, g = 0.f, b = 0.f;

  for (long long base = ranges[t]; base < end; base += CHUNK) {
    // also the barrier before the staging buffer is overwritten
    if (!__syncthreads_or(D >= T_EPS)) break;
    load_chunk<LIVE>(s, attrs, n_inst, base);
    __syncthreads();
    for (int i = 0; i < CHUNK && D >= T_EPS; ++i) {
      const Alpha al = chunk_alpha(s, i, px, py);
      if (al.a > 0.f) {
        const float one_m = 1.f - al.a;
        const float Dn = D * one_m;
        if (Dn >= T_EPS) {
          const float w = al.a * D;
          r += w * s[CR][i];
          g += w * s[CG][i];
          b += w * s[CB][i];
          Tb *= one_m;
        }
        D = Dn;
      }
    }
  }
  const int width = tiles_x * TILE;
  reinterpret_cast<float4*>(out)[(long long)gy * width + gx] =
      make_float4(r, g, b, Tb);
}

__global__ void __launch_bounds__(PIX)
blend_bwd_kernel(const float* __restrict__ attrs, long long n_inst,
                 const int* __restrict__ ranges, int tiles_x,
                 const float* __restrict__ fwd_out,
                 const float* __restrict__ cot, float* __restrict__ dattrs) {
  __shared__ float s[LIVE][CHUNK];
  __shared__ float part[WARPS][LIVE][CHUNK];
  const int t = blockIdx.x, p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const int gx = (t % tiles_x) * TILE + p % TILE;
  const int gy = (t / tiles_x) * TILE + p / TILE;
  const float px = (float)gx, py = (float)gy;
  const long long pix = (long long)gy * (tiles_x * TILE) + gx;
  const float4 f = reinterpret_cast<const float4*>(fwd_out)[pix];
  const float4 c = reinterpret_cast<const float4*>(cot)[pix];
  // sum_i w_i (colour_i . dacc) is the forward colour contracted with
  // its cotangent; the suffix sums are this total minus the running prefix
  const float total = f.x * c.x + f.y * c.y + f.z * c.z;
  const float bgterm = f.w * c.w;
  const long long end = ranges[t + 1];
  float D = 1.f, prefix = 0.f;

  for (long long base = ranges[t]; base < end; base += CHUNK) {
    // chunks after the tile saturates keep their zero gradient
    if (!__syncthreads_or(D >= T_EPS)) break;
    load_chunk<LIVE>(s, attrs, n_inst, base);
    __syncthreads();
    for (int i = 0; i < CHUNK; ++i) {
      float v[LIVE];
#pragma unroll
      for (int k = 0; k < LIVE; ++k) v[k] = 0.f;
      bool hit = false;
      if (D >= T_EPS) {
        const Alpha al = chunk_alpha(s, i, px, py);
        if (al.a > 0.f) {
          const float one_m = 1.f - al.a;
          const float Dn = D * one_m;
          if (Dn >= T_EPS) {
            const float w = al.a * D;
            const float u = s[CR][i] * c.x + s[CG][i] * c.y + s[CB][i] * c.z;
            prefix += w * u;
            const float da = D * u - (total - prefix + bgterm) / one_m;
            if (al.raw < ALPHA_MAX) {     // alpha = min(0.99, op * g)
              const float dpower = da * al.raw;
              const float cxx = s[CXX][i], cxy = s[CXY][i], cyy = s[CYY][i];
              v[0] = dpower * -(cxx * al.dx + cxy * al.dy);
              v[1] = dpower * -(cyy * al.dy + cxy * al.dx);
              v[2] = dpower * (-0.5f * al.dx * al.dx);
              v[3] = dpower * (-al.dx * al.dy);
              v[4] = dpower * (-0.5f * al.dy * al.dy);
              v[5] = da * al.g;
            }
            v[6] = w * c.x;
            v[7] = w * c.y;
            v[8] = w * c.z;
            hit = true;
          }
          D = Dn;
        }
      }
      if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
        for (int k = 0; k < LIVE; ++k) {
          float x = v[k];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, off);
          v[k] = x;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < LIVE; ++k) part[warp][k][i] = v[k];
      }
    }
    __syncthreads();
    for (int j = p; j < LIVE * CHUNK; j += PIX) {
      const int r = j / CHUNK, col = j % CHUNK;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) acc += part[w][r][col];
      dattrs[r * n_inst + base + col] = acc;
    }
  }
}

}  // namespace

extern "C" {

// out [H, W, 4]; one block per tile
int gssr_blend_fwd(const float* attrs, long long n_inst, const int* ranges,
                   int tiles_x, int tiles_y, float* out, void* stream) {
  blend_fwd_kernel<<<tiles_x * tiles_y, PIX, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      attrs, n_inst, ranges, tiles_x, out);
  return static_cast<int>(cudaGetLastError());
}

// dattrs [16, I], zero-filled by the caller; one block per tile
int gssr_blend_bwd(const float* attrs, long long n_inst, const int* ranges,
                   int tiles_x, int tiles_y, const float* fwd_out,
                   const float* cot, float* dattrs, void* stream) {
  blend_bwd_kernel<<<tiles_x * tiles_y, PIX, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      attrs, n_inst, ranges, tiles_x, fwd_out, cot, dattrs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
