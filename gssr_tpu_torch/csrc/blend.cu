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
// tile's saturation the forward does one expf and ~20 FP32 operations
// (where the cull proves alpha 0, the least work is its test: the warp
// test, 85, once per warp step it skips whole, else the power and its
// test, 12); the backward redoes that and adds ~25 operations of gradient
// terms and the sum of 9 rows over the tile's pixels. Attribute bytes (36 per
// instance, read once per tile) are small beside that, so both are bound
// by FP32/MUFU work and instruction issue, not by memory. The design keeps
// each chunk's 9 attribute rows (4.5 KB) in shared memory, read by all 256
// pixels of the tile, stops a tile's walk once no pixel has T >= 1e-4, and
// skips a warp's reduction where no lane touches the instances it sums.
//
// The forward: its first design (a thread per pixel, every walked pair's
// alpha from chunk_alpha) issued ~45 instructions per (pixel, instance)
// pair, and most pairs change nothing: the tile mask admits a gaussian to
// a whole tile where its alpha >= 1/255 ellipse touches the tile, and
// chunk-aligned ranges pad every tile's list with filler columns (opacity
// 0). So it was bound by instruction issue on pairs whose alpha is 0.
// blend_fwd_kernel runs common.cuh::gauss_fwd_tile: a conservative cull
// proves alpha = 0 for a warp's whole 8 x 4 pixel block, so the warp walks
// only the instances some pixel of its block may see (from 4 ballots a
// chunk), and each chunk is staged as float4 (geometry and cull inputs,
// two broadcast loads a step; the colour, one). Every skipped pair has
// alpha 0, so the outputs are those of the walk over every instance, bit
// for bit. At chip_smoke.py's 3dgs inputs (32 steps of its random
// synthetic scene, camera 0, an H100) the warps skip 47 % of their
// (warp, instance) steps, and a walked step issues about what one of the
// first design did: the skipped steps are the gain.
//
// The backward's sum over pixels: blend_bwd_kernel packs three
// consecutive instances' 9 rows into one 32-vector (entry 9j + r; 27-31
// zero) and sums it with one warp reduce-scatter (common.cuh: 31 shuffles
// per three instances, ~10 per instance, where an xor butterfly per row
// would take 5 a row and lane, 45 per instance), after which lane k holds
// row k % 9 of instance i0 + k / 9: 27 lanes store the warp's partials
// with one write each. A chunk is 42 groups of three and one of two. The
// partials of a whole chunk ([warp][instance][row], row stride 9, odd, so
// lanes and the cross-warp pass hit 32 banks; 36 KB) are summed over the
// 8 warps once per chunk. At <= 80 registers three blocks stay resident
// per SM. What is left bounds it by instruction issue: the per-pixel step
// on every walked instance (~120 instructions where the pixel
// contributes, with an IEEE division and an accurate expf, whose rounding
// the results depend on), and ~38 per instance (31 shuffles, 31 adds, 52
// selects per three) for the sum where one contributes. The first design
// (a butterfly per row, lane 0 writing the 9 partials) lost to this one
// at every input measured and is gone; PERF.md section 6 keeps its
// figures.
//
// Determinism: exactly one block writes each instance's gradient slot,
// and every sum over pixels runs in a fixed order (within a warp, adding
// the same lane pairs in the same order every run, then the 8 warp
// partials in warp order): no atomics.

#include "common.cuh"

namespace {

using namespace gssr;

// rows 0-5 (mean2d, conic, opacity; common.cuh), then the colour
constexpr int LIVE = 9;
enum { CR = GEOM_ROWS, CG, CB };
// instances whose 27 gradient rows blend_bwd_kernel sums in one 32-vector
constexpr int GROUP = 3;

// the forward with its alpha cull (common.cuh::gauss_fwd_tile): rgb and
// final_T per pixel
__global__ void __launch_bounds__(PIX, 3)
blend_fwd_kernel(const float* __restrict__ attrs, long long n_inst,
                 const int* __restrict__ ranges, int tiles_x,
                 float* __restrict__ out) {
  gauss_fwd_tile<3>(attrs, n_inst, ranges, tiles_x, out);
}

// One pixel's side of the vanilla backward: its cotangent, the totals a
// first pass would rebuild, and the running D and prefix of its walk.
struct VanillaBwdPixel {
  float px, py, cr, cg, cb, total, bgterm;
  float D = 1.f, prefix = 0.f;

  // sum_i w_i (colour_i . dacc) is the forward colour contracted with its
  // cotangent; the suffix sums are this total minus the running prefix
  __device__ __forceinline__ VanillaBwdPixel(const float* __restrict__ fwd_out,
                                             const float* __restrict__ cot,
                                             long long pix, float x, float y)
      : px(x), py(y) {
    const float4 f = reinterpret_cast<const float4*>(fwd_out)[pix];
    const float4 c = reinterpret_cast<const float4*>(cot)[pix];
    cr = c.x;
    cg = c.y;
    cb = c.z;
    total = f.x * c.x + f.y * c.y + f.z * c.z;
    bgterm = f.w * c.w;
  }

  // instance i of the staged chunk: where it contributes at this pixel,
  // its 9 gradient terms go to v[0, LIVE) and the result is true;
  // elsewhere v is left as it is
  __device__ __forceinline__ bool step(const float (*s)[CHUNK], int i,
                                       float* v) {
    if (!(D >= T_EPS)) return false;
    const Alpha al = chunk_alpha(s, i, px, py);
    if (!(al.a > 0.f)) return false;
    const float one_m = 1.f - al.a;
    const float Dn = D * one_m;
    bool hit = false;
    if (Dn >= T_EPS) {
      const float w = al.a * D;
      const float u = s[CR][i] * cr + s[CG][i] * cg + s[CB][i] * cb;
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
      v[6] = w * cr;
      v[7] = w * cg;
      v[8] = w * cb;
      hit = true;
    }
    D = Dn;
    return hit;
  }
};

__global__ void __launch_bounds__(PIX, 3)
blend_bwd_kernel(const float* __restrict__ attrs, long long n_inst,
                 const int* __restrict__ ranges, int tiles_x,
                 const float* __restrict__ fwd_out,
                 const float* __restrict__ cot, float* __restrict__ dattrs) {
  __shared__ float s[LIVE][CHUNK];
  __shared__ float part[WARPS][CHUNK][LIVE];
  const int t = blockIdx.x, p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const int gx = (t % tiles_x) * TILE + p % TILE;
  const int gy = (t / tiles_x) * TILE + p / TILE;
  VanillaBwdPixel pixel(fwd_out, cot, (long long)gy * (tiles_x * TILE) + gx,
                        (float)gx, (float)gy);
  const long long end = ranges[t + 1];

  for (long long base = ranges[t]; base < end; base += CHUNK) {
    // chunks after the tile saturates keep their zero gradient; also the
    // barrier before the staged chunk and the partials are overwritten
    if (!__syncthreads_or(pixel.D >= T_EPS)) break;
    load_chunk<LIVE>(s, attrs, n_inst, base);
    __syncthreads();
    for (int i0 = 0; i0 < CHUNK; i0 += GROUP) {
      float v[32] = {};               // entries 27-31 stay zero
      bool hit = false;
#pragma unroll
      for (int j = 0; j < GROUP; ++j)
        if (i0 + j < CHUNK) hit |= pixel.step(s, i0 + j, v + LIVE * j);
      float sum = 0.f;
      if (__any_sync(FULL, hit))
        sum = warp_reduce_scatter<GROUP * LIVE>(v, lane);
      const int i = i0 + lane / LIVE;
      if (lane < GROUP * LIVE && i < CHUNK) part[warp][i][lane % LIVE] = sum;
    }
    __syncthreads();
    for (int q = p; q < LIVE * CHUNK; q += PIX) {
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

// out[4]: blend_fwd_kernel's registers, local bytes, dynamic shared bytes
// (none: its shared memory is static) and resident blocks per SM
int gssr_blend_fwd_occupancy(int* out, void* stream) {
  return static_cast<int>(occupancy(blend_fwd_kernel, 0, out));
}

// out[4]: blend_bwd_kernel's registers, local bytes, dynamic shared bytes
// (none: its 41,472 B are static) and resident blocks per SM
// (common.cuh::occupancy); the stream, which every entry point takes, is
// not used
int gssr_blend_bwd_occupancy(int* out, void* stream) {
  return static_cast<int>(occupancy(blend_bwd_kernel, 0, out));
}

}  // extern "C"
