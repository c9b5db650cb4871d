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
// has D >= 1e-4, and skips a warp's reduction for instances that touch
// none of its pixels. The observe counts go through a warp ballot instead
// of a sum.
//
// The observe count needs less: a pixel's count can only grow while its
// D > 0.5, so blend_pgsr_obs_kernel stops each pixel, warp and tile at
// that point rather than at 1e-4, and each warp walks only the instances
// of the forward's per-warp list (common.cuh::warp_list) with one ballot
// each; its least work is the pairs up to every pixel's 0.5 point, and
// the block test once for a (warp, instance) step it skips whole.
//
// The forward is the vanilla blend's (blend.cu) with 7 channels in place
// of 3: common.cuh::gauss_fwd_tile, whose alpha cull lets a warp walk only
// the instances some pixel of its 8 x 4 block may see, bit for bit equal
// to the walk over every instance.
//
// The backward's sum over pixels: an xor butterfly per row would take 5
// shuffles and 5 adds a row and lane, 75 shuffles per warp and instance for
// 15 rows, and an SM retires one warp shuffle per clock.
// blend_pgsr_bwd_kernel puts two consecutive instances' 16 rows into one
// 32-vector and sums it with one warp reduce-scatter (common.cuh, 31
// shuffles a pair), after which lane k holds row k % 16 of instance k / 16
// and all 32 lanes store the warp's partials with one shared-memory write.
// The partials of a whole chunk ([warp][row][instance], 65 KB of dynamic
// shared memory) are summed over the 8 warps once per chunk, so a chunk
// costs three barriers (summing every 32 instances would cost ten); at <=
// 80 registers three blocks stay resident per SM. What is left bounds it
// by instruction dispatch: the gaussian on every walked instance, the
// gradient terms where it contributes and the reduce-scatter's selects.
// The first design (a butterfly per row, lane 0 writing the partials, the
// warps summed every 32 instances) lost to this one at every input
// measured and is gone; PERF.md section 6 keeps its figures.
//
// Determinism: exactly one block writes each instance's slot, and every
// sum over pixels runs in a fixed order (within a warp, then the 8 warp
// partials in warp order): no atomics.

#include "common.cuh"

namespace {

using namespace gssr;

constexpr int LIVEP = 13;         // rows read: geometry + 7 channels
constexpr int NCH = 7;            // rgb, normal, distance
constexpr int ROWSP = 16;         // rows the backward writes
enum { P_CH = GEOM_ROWS, P_OBS = 13, P_ABSX = 14, P_ABSY = 15 };
// dynamic shared memory of blend_pgsr_bwd_kernel: the staged chunk and the
// warp partials of all its instances, [warp][row][instance] with a row
// stride of CHUNK + 2. Lane k stores row k % 16 of instance i + k / 16 at
// bank (2 (k % 16) + k / 16 + i) % 32, and the cross-warp pass reads
// consecutive instances of a row: both hit 32 banks. ([warp][instance][16]
// would put 16 lanes of that pass on one bank.)
constexpr int PSTRIDE = CHUNK + 2;
constexpr int BWDP_SMEM = (LIVEP * CHUNK + WARPS * ROWSP * PSTRIDE)
                          * static_cast<int>(sizeof(float));

// the forward with its alpha cull (common.cuh::gauss_fwd_tile): the 7
// channels and final_T per pixel
__global__ void __launch_bounds__(PIX, 3)
blend_pgsr_fwd_kernel(const float* __restrict__ attrs, long long n_inst,
                      const int* __restrict__ ranges, int tiles_x,
                      float* __restrict__ out) {
  gauss_fwd_tile<NCH>(attrs, n_inst, ranges, tiles_x, out);
}

// Per instance: the pixels where it contributes while D > 0.5, D the
// transmittance before it over every alpha > 0. A count can only grow
// while D > 0.5, and D never rises, so a pixel is done once D <= 0.5, a
// warp once its 32 pixels are, and the tile once all of them are: the
// walk stops there, after the instance that took D to <= 0.5. (Where D >
// 0.5 and alpha <= 0.99, the new D is above 0.004, so the T_EPS test of
// the count never fails before that point.) Warp w covers the 8 x 4 block
// (w % 2, w / 2) of the tile and walks, as the forward does, only the
// instances of its list (common.cuh::warp_list): a culled instance has
// alpha 0 at every pixel of the block, so it leaves D as it is and
// counts 0 there. A walked instance takes one ballot; lane j keeps the
// count of instances j, 32 + j, 64 + j and 96 + j in registers, so the
// rest of the chunk stays zero, and the 8 warps' counts are summed in
// warp order once per chunk. Every count equals that of the walk over
// every instance to T_EPS (blend_pgsr_obs_plain), integer for integer.
__global__ void __launch_bounds__(PIX, 4)
blend_pgsr_obs_kernel(const float* __restrict__ attrs, long long n_inst,
                      const int* __restrict__ ranges, int tiles_x,
                      float* __restrict__ obs) {
  __shared__ float4 geo[2][CHUNK];
  __shared__ float2 slope[CHUNK];
  __shared__ int cnt[WARPS][CHUNK];
  const int t = blockIdx.x, p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const int bx = (t % tiles_x) * TILE + (warp % 2) * BLOCK_W;
  const int by = (t / tiles_x) * TILE + (warp / 2) * BLOCK_H;
  const float px = (float)(bx + lane % BLOCK_W);
  const float py = (float)(by + lane / BLOCK_W);
  const long long end = ranges[t + 1];
  float D = 1.f;

  for (long long base = ranges[t]; base < end; base += CHUNK) {
    // also the barrier before the staging buffers and counts are
    // overwritten; chunks after the tile is done keep their zero count
    if (!__syncthreads_or(D > 0.5f)) break;
    if (p < CHUNK) stage_cull(geo, slope, attrs, n_inst, base, p);
    __syncthreads();
    int c[4] = {0, 0, 0, 0};        // this lane's instances 32 k + lane
    if (__any_sync(FULL, D > 0.5f)) {
      unsigned seen[4];
      warp_list(geo, slope, (float)bx, (float)by, lane, seen);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        unsigned bits = seen[k];
        // warp-uniform: bits comes from ballots, the test is a vote
        while (bits != 0u && __any_sync(FULL, D > 0.5f)) {
          const int j = __ffs(bits) - 1;
          bits &= bits - 1u;
          bool counted = false;
          if (D > 0.5f) {
            const int i = 32 * k + j;
            float alpha;
            if (staged_alpha(geo[0][i], geo[1][i], px, py, alpha)) {
              const float Dn = D * (1.f - alpha);
              counted = Dn >= T_EPS;
              D = Dn;
            }
          }
          const int n = __popc(__ballot_sync(FULL, counted));
          if (lane == j) c[k] = n;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) cnt[warp][32 * k + lane] = c[k];
    __syncthreads();
    if (p < CHUNK) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += cnt[w][p];
      if (s != 0) obs[base + p] = (float)s;
    }
  }
}

// One pixel's side of the planar backward: its channel cotangents, the
// total and background terms, and the running D and prefix of its walk.
struct PlanarBwdPixel {
  float px, py, dch[NCH], total, bgterm;
  float D = 1.f, prefix = 0.f;

  __device__ __forceinline__ PlanarBwdPixel(const float* __restrict__ fwd_out,
                                            const float* __restrict__ cot,
                                            long long pix, float x, float y)
      : px(x), py(y) {
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

  // instance i of the staged chunk: where it contributes at this pixel,
  // its 15 gradient terms go to v[0, ROWSP) (row P_OBS left as it is),
  // `seen` says whether D was still > 0.5, and the result is true;
  // elsewhere v and seen are left as they are
  __device__ __forceinline__ bool step(const float (*s)[CHUNK], int i,
                                       float* v, bool& seen) {
    if (!(D >= T_EPS)) return false;
    const Alpha al = chunk_alpha(s, i, px, py);
    if (!(al.a > 0.f)) return false;
    const float one_m = 1.f - al.a;
    const float Dn = D * one_m;
    bool hit = false;
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
    return hit;
  }
};

__global__ void __launch_bounds__(PIX, 3)
blend_pgsr_bwd_kernel(const float* __restrict__ attrs, long long n_inst,
                      const int* __restrict__ ranges, int tiles_x,
                      const float* __restrict__ fwd_out,
                      const float* __restrict__ cot,
                      float* __restrict__ dattrs) {
  extern __shared__ float smem[];
  auto s = reinterpret_cast<float (*)[CHUNK]>(smem);
  auto part = reinterpret_cast<float (*)[ROWSP][PSTRIDE]>(smem
                                                          + LIVEP * CHUNK);
  const int t = blockIdx.x, p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  // after the reduce-scatter of a pair, this lane's row and instance
  const int row = lane % ROWSP, half = lane / ROWSP;
  const int gx = (t % tiles_x) * TILE + p % TILE;
  const int gy = (t / tiles_x) * TILE + p / TILE;
  PlanarBwdPixel pixel(fwd_out, cot, (long long)gy * (tiles_x * TILE) + gx,
                       (float)gx, (float)gy);
  const long long end = ranges[t + 1];

  for (long long base = ranges[t]; base < end; base += CHUNK) {
    // chunks after the tile saturates keep their zero gradient; also the
    // barrier before the staged chunk and the partials are overwritten
    if (!__syncthreads_or(pixel.D >= T_EPS)) break;
    load_chunk<LIVEP>(s, attrs, n_inst, base);
    __syncthreads();
    for (int i = 0; i < CHUNK; i += 2) {
      float v[2 * ROWSP] = {};        // instance i in 0-15, i + 1 in 16-31
      bool hit = false;
      unsigned seen_bits[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bool seen = false;
        hit |= pixel.step(s, i + h, v + h * ROWSP, seen);
        seen_bits[h] = __ballot_sync(FULL, seen);
      }
      float sum = 0.f;
      if (__any_sync(FULL, hit))
        sum = warp_reduce_scatter<2 * ROWSP>(v, lane);
      // the observe count takes no cotangent: a ballot, not a sum
      if (row == P_OBS)
        sum = (float)__popc(half ? seen_bits[1] : seen_bits[0]);
      part[warp][row][i + half] = sum;
    }
    __syncthreads();
    for (int q = p; q < ROWSP * CHUNK; q += PIX) {
      const int r = q / CHUNK, col = q % CHUNK;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) acc += part[w][r][col];
      dattrs[r * n_inst + base + col] = acc;
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
  const cudaError_t e = allow_smem(blend_pgsr_bwd_kernel, BWDP_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  blend_pgsr_bwd_kernel<<<tiles_x * tiles_y, PIX, BWDP_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      attrs, n_inst, ranges, tiles_x, fwd_out, cot, dattrs);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: blend_pgsr_fwd_kernel's registers, local bytes, dynamic shared
// bytes (none) and resident blocks per SM
int gssr_blend_pgsr_fwd_occupancy(int* out, void* stream) {
  return static_cast<int>(occupancy(blend_pgsr_fwd_kernel, 0, out));
}

// out[4]: blend_pgsr_obs_kernel's registers, local bytes, dynamic shared
// bytes (none) and resident blocks per SM
int gssr_blend_pgsr_obs_occupancy(int* out, void* stream) {
  return static_cast<int>(occupancy(blend_pgsr_obs_kernel, 0, out));
}

// out[4]: blend_pgsr_bwd_kernel's registers, local bytes, dynamic shared
// bytes and resident blocks per SM (common.cuh::occupancy); the stream,
// which every entry point takes, is not used
int gssr_blend_pgsr_bwd_occupancy(int* out, void* stream) {
  return static_cast<int>(occupancy(blend_pgsr_bwd_kernel, BWDP_SMEM, out));
}

}  // extern "C"
