// Planar (PGSR) blend for Hopper (sm_90a): forward, forward-only observe
// count and analytic backward. Plain C interface, loaded through ctypes by
// gssr_tpu_torch/ops/_kernels.py; the plain PyTorch versions are
// blend_pgsr_fwd_plain / blend_pgsr_obs_plain / blend_pgsr_bwd_plain in
// gssr_tpu_torch/ops/blend_pgsr.py, which also documents the layouts.
//
// Replaces gssr_tpu/ops/blend_pgsr_pallas.py::_fwdp_kernel, ::_obsp_kernel
// and ::_bwdp_kernel. The Pallas forward evaluates a whole (256 pixels x
// 128 instances) chunk at once with lane prefix products and one MXU
// product for the 7 channels; its observe and backward kernels walk a flat
// chunk grid carrying per-tile state from one grid step to the next, and
// the backward contracts the geometry rows with one MXU product of
// tile-local pixel moments. Here, as for the vanilla blend (blend.cu), one
// block per 16x16 tile walks its own chunks in depth order with one thread
// per pixel, multiplying T one instance at a time.
//
// Inputs: attrs [16, I] attribute-major, 13 live rows (mean2d xy, conic
// xx/xy/yy, opacity, rgb, camera-space normal, plane distance) and three
// rows the backward writes (observe count, |d mean2d x|, |d mean2d y|);
// ranges [T+1] int32 chunk-aligned per-tile starts; maps [H, W, 8] (rgb,
// normal, distance, final_T) over the tile-padded image.
//
// What bounds them on the H100: per (pixel, instance) pair up to the tile's
// saturation each kernel evaluates the gaussian (one expf, ~20 FP32
// operations); per contributing pair the forward adds 7 channel sums, the
// backward ~45 operations of gradient terms and a reduction over the
// tile's pixels of 16 rows. Attribute bytes (52 per instance, read once per
// tile) are small beside that, so all three are bound by FP32 and MUFU
// work, not by memory. The design stages each chunk's live rows (6.5 KB)
// in shared memory for all 256 pixels, stops a tile's walk once no pixel
// has D >= 1e-4, and skips a warp's reduction for an instance that touches
// none of its pixels. The backward sums its 15 gradient rows over the
// pixels in groups of 32 instances (16 KB of partials, 16 rows), under the
// 48 KB static shared-memory limit; the observe counts go through a warp
// ballot instead of a sum.
//
// Determinism: exactly one block writes each instance's slot, and every
// sum over pixels runs in a fixed order (xor-shuffle butterfly within a
// warp, then the 8 warp partials in warp order): no atomics.

#include "common.cuh"

namespace {

using namespace gssr;

constexpr int LIVEP = 13;         // rows read: geometry + 7 channels
constexpr int NCH = 7;            // rgb, normal, distance
constexpr int ROWSP = 16;         // rows the backward writes
constexpr int GROUP = 32;         // instances per backward reduction
constexpr unsigned FULL = 0xffffffffu;
enum { P_CH = GEOM_ROWS, P_OBS = 13, P_ABSX = 14, P_ABSY = 15 };

__global__ void __launch_bounds__(PIX)
blend_pgsr_fwd_kernel(const float* __restrict__ attrs, long long n_inst,
                      const int* __restrict__ ranges, int tiles_x,
                      float* __restrict__ out) {
  __shared__ float s[LIVEP][CHUNK];
  const int t = blockIdx.x, p = threadIdx.x;
  const int gx = (t % tiles_x) * TILE + p % TILE;
  const int gy = (t / tiles_x) * TILE + p / TILE;
  const float px = (float)gx, py = (float)gy;
  const long long end = ranges[t + 1];
  float D = 1.f, Tb = 1.f;
  float acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.f;

  for (long long base = ranges[t]; base < end; base += CHUNK) {
    // also the barrier before the staging buffer is overwritten
    if (!__syncthreads_or(D >= T_EPS)) break;
    load_chunk<LIVEP>(s, attrs, n_inst, base);
    __syncthreads();
    for (int i = 0; i < CHUNK && D >= T_EPS; ++i) {
      const Alpha al = chunk_alpha(s, i, px, py);
      if (al.a > 0.f) {
        const float one_m = 1.f - al.a;
        const float Dn = D * one_m;
        if (Dn >= T_EPS) {
          const float w = al.a * D;
#pragma unroll
          for (int c = 0; c < NCH; ++c) acc[c] += w * s[P_CH + c][i];
          Tb *= one_m;
        }
        D = Dn;
      }
    }
  }
  const long long pix = (long long)gy * (tiles_x * TILE) + gx;
  float4* q = reinterpret_cast<float4*>(out) + pix * 2;
  q[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  q[1] = make_float4(acc[4], acc[5], acc[6], Tb);
}

// per instance: the pixels where it contributes while D > 0.5
__global__ void __launch_bounds__(PIX)
blend_pgsr_obs_kernel(const float* __restrict__ attrs, long long n_inst,
                      const int* __restrict__ ranges, int tiles_x,
                      float* __restrict__ obs) {
  __shared__ float s[GEOM_ROWS][CHUNK];
  __shared__ int cnt[WARPS][CHUNK];
  const int t = blockIdx.x, p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const float px = (float)((t % tiles_x) * TILE + p % TILE);
  const float py = (float)((t / tiles_x) * TILE + p / TILE);
  const long long end = ranges[t + 1];
  float D = 1.f;

  for (long long base = ranges[t]; base < end; base += CHUNK) {
    // also the barrier before the staging buffers are overwritten;
    // chunks after the tile saturates keep their zero count
    if (!__syncthreads_or(D >= T_EPS)) break;
    load_chunk<GEOM_ROWS>(s, attrs, n_inst, base);
    __syncthreads();
    for (int i = 0; i < CHUNK; ++i) {
      bool seen = false;
      if (D >= T_EPS) {
        const Alpha al = chunk_alpha(s, i, px, py);
        if (al.a > 0.f) {
          const float Dn = D * (1.f - al.a);
          seen = Dn >= T_EPS && D > 0.5f;
          D = Dn;
        }
      }
      const unsigned bits = __ballot_sync(FULL, seen);
      if (lane == 0) cnt[warp][i] = __popc(bits);
    }
    __syncthreads();
    if (p < CHUNK) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) c += cnt[w][p];
      obs[base + p] = (float)c;
    }
  }
}

__global__ void __launch_bounds__(PIX)
blend_pgsr_bwd_kernel(const float* __restrict__ attrs, long long n_inst,
                      const int* __restrict__ ranges, int tiles_x,
                      const float* __restrict__ fwd_out,
                      const float* __restrict__ cot,
                      float* __restrict__ dattrs) {
  __shared__ float s[LIVEP][CHUNK];
  __shared__ float part[WARPS][ROWSP][GROUP];
  const int t = blockIdx.x, p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const int gx = (t % tiles_x) * TILE + p % TILE;
  const int gy = (t / tiles_x) * TILE + p / TILE;
  const float px = (float)gx, py = (float)gy;
  const long long pix = (long long)gy * (tiles_x * TILE) + gx;
  float dch[NCH];
  float total, bgterm;
  {
    const float4* fq = reinterpret_cast<const float4*>(fwd_out) + pix * 2;
    const float4* cq = reinterpret_cast<const float4*>(cot) + pix * 2;
    const float4 f0 = fq[0], f1 = fq[1], c0 = cq[0], c1 = cq[1];
    dch[0] = c0.x; dch[1] = c0.y; dch[2] = c0.z; dch[3] = c0.w;
    dch[4] = c1.x; dch[5] = c1.y; dch[6] = c1.z;
    // sum_i w_i (payload_i . dch): every channel is linear in w, so this
    // is the forward's channels contracted with their cotangents; the
    // suffix sums are this total minus the running prefix
    total = f0.x * c0.x + f0.y * c0.y + f0.z * c0.z + f0.w * c0.w
            + f1.x * c1.x + f1.y * c1.y + f1.z * c1.z;
    bgterm = f1.w * c1.w;
  }
  const long long end = ranges[t + 1];
  float D = 1.f, prefix = 0.f;

  for (long long base = ranges[t]; base < end; base += CHUNK) {
    // chunks after the tile saturates keep their zero gradient
    if (!__syncthreads_or(D >= T_EPS)) break;
    load_chunk<LIVEP>(s, attrs, n_inst, base);
    __syncthreads();
    for (int g0 = 0; g0 < CHUNK; g0 += GROUP) {
      for (int j = 0; j < GROUP; ++j) {
        const int i = g0 + j;
        float v[ROWSP];
#pragma unroll
        for (int k = 0; k < ROWSP; ++k) v[k] = 0.f;
        bool hit = false, seen = false;
        if (D >= T_EPS) {
          const Alpha al = chunk_alpha(s, i, px, py);
          if (al.a > 0.f) {
            const float one_m = 1.f - al.a;
            const float Dn = D * one_m;
            if (Dn >= T_EPS) {
              const float w = al.a * D;
              float u = 0.f;
#pragma unroll
              for (int c = 0; c < NCH; ++c) u += s[P_CH + c][i] * dch[c];
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
                // the abs screen gradients: |.| per pixel, then the sum
                v[P_ABSX] = fabsf(v[0]);
                v[P_ABSY] = fabsf(v[1]);
              }
#pragma unroll
              for (int c = 0; c < NCH; ++c) v[P_CH + c] = w * dch[c];
              seen = D > 0.5f;
              hit = true;
            }
            D = Dn;
          }
        }
        // the observe count takes no cotangent: a ballot, not a sum
        const unsigned bits = __ballot_sync(FULL, seen);
        if (__any_sync(FULL, hit)) {
#pragma unroll
          for (int k = 0; k < ROWSP; ++k) {
            if (k == P_OBS) continue;
            float x = v[k];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              x += __shfl_xor_sync(FULL, x, off);
            v[k] = x;
          }
        }
        if (lane == 0) {
          v[P_OBS] = (float)__popc(bits);
#pragma unroll
          for (int k = 0; k < ROWSP; ++k) part[warp][k][j] = v[k];
        }
      }
      __syncthreads();
      for (int q = p; q < ROWSP * GROUP; q += PIX) {
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

// out [H, W, 8]; one block per tile
int gssr_blend_pgsr_fwd(const float* attrs, long long n_inst,
                        const int* ranges, int tiles_x, int tiles_y,
                        float* out, void* stream) {
  blend_pgsr_fwd_kernel<<<tiles_x * tiles_y, PIX, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      attrs, n_inst, ranges, tiles_x, out);
  return static_cast<int>(cudaGetLastError());
}

// obs [I], zero-filled by the caller; one block per tile
int gssr_blend_pgsr_obs(const float* attrs, long long n_inst,
                        const int* ranges, int tiles_x, int tiles_y,
                        float* obs, void* stream) {
  blend_pgsr_obs_kernel<<<tiles_x * tiles_y, PIX, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      attrs, n_inst, ranges, tiles_x, obs);
  return static_cast<int>(cudaGetLastError());
}

// dattrs [16, I], zero-filled by the caller; one block per tile
int gssr_blend_pgsr_bwd(const float* attrs, long long n_inst,
                        const int* ranges, int tiles_x, int tiles_y,
                        const float* fwd_out, const float* cot,
                        float* dattrs, void* stream) {
  blend_pgsr_bwd_kernel<<<tiles_x * tiles_y, PIX, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      attrs, n_inst, ranges, tiles_x, fwd_out, cot, dattrs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
