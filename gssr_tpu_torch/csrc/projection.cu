// Tile intersect mask of the vanilla preprocess, for Hopper (sm_90a). Plain
// C interface, loaded through ctypes by gssr_tpu_torch/ops/_kernels.py; the
// plain PyTorch version is tile_intersect_mask_plain in
// gssr_tpu_torch/ops/projection.py, which this kernel equals bit for bit.
//
// Replaces no TPU kernel: gssr_tpu/ops/projection.py::tile_intersect_mask
// is plain jnp, which XLA fuses into one pass over the gaussians. Run
// eagerly, its 32-pass loop over the first 32 rect tiles dispatches ~2,950
// elementwise ops over every capacity slot each render; this kernel is one
// launch.
//
// Per slot it reads mean2d [N,2], conic [N,3], rect [N,4] int32, cutoff [N]
// and visible [N] bool (41 bytes) and writes mask and count [N] int32 (8
// bytes). A slot that is not visible, or whose rect is empty, writes 0 / 0
// after reading 1 byte (with its rect when visible); in a model before
// densification most slots are such. A slot with work tests min(area, 32)
// tiles at 76 FP32 operations each. So the least time is that of the bytes
// (6-23 us at the benchmark's inputs on the H100), and the arithmetic,
// a few hundred MFLOP, stays below it.
//
// The design: one thread per slot, which walks only its own min(area, 32)
// tiles, its loads coalesced with its warp's neighbours; a warp takes as
// long as its largest rect. The other design, a warp per slot (a warp
// walks its 32 slots in turn, lane p tests tile p, one ballot forms the
// mask), was timed against it at the benchmark's three inputs and was
// 1.1-3.2x slower (PERF.md, kernel table): most rects hold a few tiles, so
// most lanes idle, and each slot costs the warp 12 shuffles.
//
// Bit for bit: every float operation rounds as the eager ops do, in their
// order. The _rn intrinsics keep nvcc from contracting a product and a sum
// into an FMA; the division is IEEE; torch.clamp and torch.minimum give NaN
// for a NaN operand, where fminf / fmaxf would return the other one; the
// int32 products wrap as the tensors' do.

#include "common.cuh"

namespace {

using namespace gssr;

constexpr int MASK_TILES = 32;
constexpr int THREADS = 256;

// torch.clamp(v, min=lo) and torch.clamp(v, lo, hi) with bounds that are
// no NaN: a NaN v stays NaN
__device__ __forceinline__ float clamp_nan(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}

// one slot's ellipse: mean, conic, and the slopes of the edge minima
struct Ellipse {
  float mx, my, cxx, cxy, cyy, rx, ry;

  // 0.5 (cxx dx dx + cyy dy dy) + cxy dx dy, left to right
  __device__ __forceinline__ float q(float px, float py) const {
    const float dx = __fsub_rn(px, mx), dy = __fsub_rn(py, my);
    const float s = __fadd_rn(__fmul_rn(__fmul_rn(cxx, dx), dx),
                              __fmul_rn(__fmul_rn(cyy, dy), dy));
    return __fadd_rn(__fmul_rn(0.5f, s), __fmul_rn(__fmul_rn(cxy, dx), dy));
  }

  // whether the quadratic's minimum over the pixel-centre box of the tile
  // at (tx, ty) is <= cutoff: zero where the mean lies in the box, else the
  // least of the four closed-form edge minima
  __device__ __forceinline__ bool hits(int tx, int ty, float cutoff) const {
    const float bx0 = __int2float_rn(static_cast<int>(
        static_cast<unsigned>(tx) * TILE));
    const float by0 = __int2float_rn(static_cast<int>(
        static_cast<unsigned>(ty) * TILE));
    const float bx1 = __fadd_rn(bx0, static_cast<float>(TILE - 1));
    const float by1 = __fadd_rn(by0, static_cast<float>(TILE - 1));
    auto edge_y = [&](float bx) {
      return clamp_nan(__fsub_rn(my, __fmul_rn(ry, __fsub_rn(bx, mx))), by0,
                       by1);
    };
    auto edge_x = [&](float by) {
      return clamp_nan(__fsub_rn(mx, __fmul_rn(rx, __fsub_rn(by, my))), bx0,
                       bx1);
    };
    const float qmin =
        min_nan(min_nan(q(bx0, edge_y(bx0)), q(bx1, edge_y(bx1))),
                min_nan(q(edge_x(by0), by0), q(edge_x(by1), by1)));
    const bool inside = mx >= bx0 && mx <= bx1 && my >= by0 && my <= by1;
    return (inside ? 0.f : qmin) <= cutoff;
  }
};

// mask: bit p set where the ellipse touches rect tile p (row-major in the
// rect, p < min(area, 32)); count: the mask's bits plus the rect tiles past
// the 32nd, which count as hits
__global__ void __launch_bounds__(THREADS)
tile_mask_kernel(const float* __restrict__ mean2d,
                 const float* __restrict__ conic,
                 const int* __restrict__ rect,
                 const float* __restrict__ cutoff,
                 const bool* __restrict__ visible, long long n,
                 int* __restrict__ mask, int* __restrict__ count) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i >= n) return;
  unsigned bits = 0u;
  int extra = 0;
  if (visible[i]) {
    const int x0 = rect[4 * i], y0 = rect[4 * i + 1];
    const int dx = static_cast<int>(static_cast<unsigned>(rect[4 * i + 2]) -
                                    static_cast<unsigned>(x0));
    const int dy = static_cast<int>(static_cast<unsigned>(rect[4 * i + 3]) -
                                    static_cast<unsigned>(y0));
    const int area = static_cast<int>(static_cast<unsigned>(dx) *
                                      static_cast<unsigned>(dy));
    if (area > 0) {
      Ellipse e;
      e.mx = mean2d[2 * i];
      e.my = mean2d[2 * i + 1];
      e.cxx = conic[3 * i];
      e.cxy = conic[3 * i + 1];
      e.cyy = conic[3 * i + 2];
      const float lo = static_cast<float>(1e-12);
      e.rx = __fdiv_rn(e.cxy, clamp_nan(e.cxx, lo));
      e.ry = __fdiv_rn(e.cxy, clamp_nan(e.cyy, lo));
      const float cut = cutoff[i];
      const int w = max(dx, 1);
      const int n_hit = min(area, MASK_TILES);
      // tile p is (x0 + p % w, y0 + p / w), stepped without a division
      for (int p = 0, col = 0, row = 0; p < n_hit; ++p) {
        if (e.hits(x0 + col, y0 + row, cut)) bits |= 1u << p;
        if (++col == w) {
          col = 0;
          ++row;
        }
      }
      extra = max(area - MASK_TILES, 0);
    }
  }
  mask[i] = static_cast<int>(bits);
  count[i] = __popc(bits) + extra;
}

}  // namespace

extern "C" {

// mask, count [n] int32; one thread per slot, none launched for n <= 0
int gssr_tile_mask(const float* mean2d, const float* conic, const int* rect,
                   const float* cutoff, const bool* visible, long long n,
                   int* mask, int* count, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + THREADS - 1) / THREADS;
  tile_mask_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      mean2d, conic, rect, cutoff, visible, n, mask, count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
