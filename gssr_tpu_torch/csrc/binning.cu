// Instance expansion of tile binning, for Hopper (sm_90a). Plain C
// interface, loaded through ctypes by gssr_tpu_torch/ops/_kernels.py; the
// plain PyTorch version is expand_instances_plain in
// gssr_tpu_torch/ops/binning.py, which this kernel equals bit for bit.
//
// Replaces no TPU kernel: gssr_tpu/ops/binning.py::_expand_keys is plain
// jnp. For the TPU, whose random gathers are slow, it finds each instance
// slot's gaussian by a scatter of segment-start marks and one running max
// over the whole buffer. Run eagerly on the card, the running max
// (torch.cummax) is one thread block walking every slot, and the ~70 ops
// around it each pass over every slot; this kernel is one launch.
//
// Per slot it writes the sort key and the payload (8 bytes); per visible
// gaussian it reads its rect, its depth, its intersect mask and its
// segment start (28 bytes; 24 without a mask), per gaussian its offset and
// per tile its filler start. It does a few integer operations a slot, so
// the least time is that of the bytes: ~0.03 ms for ~8M slots at 3.35
// TB/s.
//
// The design: each block owns SLOTS contiguous slots, so the stores are
// coalesced and the work per block is the same whatever the splat sizes.
// Four warps find, by a 32-way search over the offsets and the filler
// starts, the gaussians and the filler tiles whose runs cover the block's
// range; the block marks each run's first slot in shared memory and fills
// the marks forward with a block-wide running max, the same forward fill
// as the plain version's, over SLOTS slots instead of the buffer. Each
// slot then reads its gaussian's record, which its neighbours share
// through L1. bin_expand_v1_kernel is the other design, kept as the
// yardstick (chip_smoke.py times both; PERF.md, kernel table): one thread
// per gaussian writes its own run of slots (duplicateWithKeys of the
// original CUDA rasterizer) and one thread per tile its filler run, so its
// stores scatter across a warp and a large splat's run is one thread's
// serial tail.
//
// Bit for bit: the tile of a slot comes from the integer quotient and
// remainder of its rank in the rect by the rect's width, which is what the
// plain version's f32 reciprocal with its +-1 fix-up gives for every rank
// below 2^22; the rect is unpacked from the plain version's 10-bit fields;
// the depth key shifts the depth's float bits arithmetically; the int32
// products and shifts wrap as the tensors' do.
//
// The inputs hold what bin_gaussians makes of them: tiles_touched is the
// rect area of each visible gaussian, so the filler runs start at
// num_rendered and the slots past the padded total exist only when nothing
// is rendered (then every slot is a filler of tile 0).

#include "common.cuh"

namespace {

using namespace gssr;

constexpr int THREADS = 256;
constexpr int SLOTS = 2048;        // contiguous slots a block owns
constexpr int PER_THREAD = SLOTS / THREADS;
constexpr int FILLER = 1 << 30;    // a filler tile's mark, above every gaussian
constexpr int NONE = -1;           // no mark
static_assert(PER_THREAD == 8, "the forward fill reads two int4 a thread");

// the first index in [lo, hi) whose a[] is above x, or hi if none; a is
// non-decreasing. Called by a whole warp: each round samples 32 positions
// and keeps the gap between the last sample at most x and the next.
__device__ int warp_upper_bound(const int* __restrict__ a, int lo, int hi,
                                int x) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    const int c = __popc(__ballot_sync(FULL, i < hi && a[i] <= x));
    if (c == 0) return lo;
    const int next = lo + c * step;
    lo += (c - 1) * step + 1;
    hi = min(hi, next);
  }
  const int i = lo + lane;
  return lo + __popc(__ballot_sync(FULL, i < hi && a[i] <= x));
}

__global__ void __launch_bounds__(THREADS)
bin_expand_kernel(const int* __restrict__ rect,
                  const float* __restrict__ depth,
                  const int* __restrict__ tile_mask,
                  const int* __restrict__ offsets,
                  const int* __restrict__ fill_starts,
                  const int* __restrict__ num_rendered, int n, int cap,
                  int tiles_x, int num_tiles, int depth_bits,
                  int* __restrict__ key, int* __restrict__ payload) {
  __shared__ __align__(16) int own[SLOTS];
  __shared__ int range[4];
  __shared__ int warp_max[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * SLOTS;
  const int b1 = min(b0 + SLOTS, cap);
  const int nr = *num_rendered;
  const int real_end = min(b1, nr);  // real slots [b0, real_end)
  const int fill_begin = max(b0, nr);  // filler slots [fill_begin, b1)

  // the candidates: gaussians [range[0], range[1]) (the owners of the
  // first and the last real slot, and every culled one between), filler
  // tiles [range[2], range[3])
  if (warp < 4) {
    const bool real = warp < 2;
    int v = 0;
    if (real ? b0 < real_end : fill_begin < b1) {
      switch (warp) {
        case 0: v = warp_upper_bound(offsets, 0, n, b0); break;
        case 1: v = warp_upper_bound(offsets, 0, n, real_end - 1) + 1; break;
        case 2:
          v = max(warp_upper_bound(fill_starts, 0, num_tiles, fill_begin) - 1,
                  0);
          break;
        default: v = warp_upper_bound(fill_starts, 0, num_tiles, b1 - 1);
      }
    }
    if (lane == 0) range[warp] = v;
  }
  for (int i = tid; i < SLOTS; i += THREADS) own[i] = NONE;
  __syncthreads();

  // mark the first slot of each run in the block (a run begun before the
  // block at its first slot): a gaussian with its index, a filler tile
  // with FILLER | tile. Runs that hold a slot begin at distinct slots.
  for (int g = range[0] + tid; g < range[1]; g += THREADS) {
    const int start = g > 0 ? offsets[g - 1] : 0;
    if (offsets[g] > start) own[max(start, b0) - b0] = g;
  }
  for (int t = range[2] + tid; t < range[3]; t += THREADS) {
    const int start = fill_starts[t];
    if (fill_starts[t + 1] > start)
      own[max(start, fill_begin) - b0] = FILLER | t;
  }
  __syncthreads();

  // fill the marks forward: a running max within each thread's
  // PER_THREAD slots, then across the threads
  int v[PER_THREAD];
  int run = NONE;
  const int4* own4 = reinterpret_cast<const int4*>(own) + tid * 2;
  const int4 lo4 = own4[0], hi4 = own4[1];
  const int got[PER_THREAD] = {lo4.x, lo4.y, lo4.z, lo4.w,
                               hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) v[k] = run = max(run, got[k]);
  int inclusive = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, inclusive, d);
    if (lane >= d) inclusive = max(inclusive, o);
  }
  int before = __shfl_up_sync(FULL, inclusive, 1);
  if (lane == 0) before = NONE;
  if (lane == 31) warp_max[warp] = inclusive;
  __syncthreads();
  for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
  int4* out4 = reinterpret_cast<int4*>(own) + tid * 2;
  out4[0] = make_int4(max(before, v[0]), max(before, v[1]),
                      max(before, v[2]), max(before, v[3]));
  out4[1] = make_int4(max(before, v[4]), max(before, v[5]),
                      max(before, v[6]), max(before, v[7]));
  __syncthreads();

  const unsigned depth_mask = (1u << depth_bits) - 1u;
  const unsigned sign = 1u << 31;
#pragma unroll 2
  for (int k = 0; k < PER_THREAD; ++k) {
    const int s = b0 + tid + k * THREADS;
    if (s >= b1) break;
    const int o = own[s - b0];
    unsigned kv, pv;
    if (s < nr) {
      // a real slot of gaussian o
      const int g = o;
      const int start = g > 0 ? offsets[g - 1] : 0;
      const int local = s - start;
      const int x0 = rect[4 * g], y0 = rect[4 * g + 1];
      const int rw = max(rect[4 * g + 2] - x0, 1);
      const unsigned pack = static_cast<unsigned>(x0) |
                            (static_cast<unsigned>(y0) << 10) |
                            (static_cast<unsigned>(rw - 1) << 20);
      const int px = static_cast<int>(pack & 0x3FFu);
      const int py = static_cast<int>((pack >> 10) & 0x3FFu);
      const int pw = static_cast<int>((pack >> 20) & 0x3FFu) + 1;
      const int row = local / pw, col = local - row * pw;
      const unsigned tile = static_cast<unsigned>(py + row) *
                                static_cast<unsigned>(tiles_x) +
                            static_cast<unsigned>(px + col);
      const int bits = __float_as_int(depth[g]);
      const unsigned dq =
          static_cast<unsigned>(bits >> (31 - depth_bits)) & depth_mask;
      unsigned hit = 1u;
      if (tile_mask != nullptr && local < 32)
        hit = (static_cast<unsigned>(tile_mask[g]) >> local) & 1u;
      kv = (tile << depth_bits) | dq;
      pv = static_cast<unsigned>(g) | (hit << 30) | (1u << 29);
    } else {
      // a filler slot: its tile's key with an all-ones depth, after every
      // real instance of the tile; tile 0 where no filler run began
      const unsigned tile =
          o >= FILLER ? static_cast<unsigned>(min(o - FILLER, num_tiles))
                      : 0u;
      kv = (tile << depth_bits) | depth_mask;
      pv = 0u;
    }
    key[s] = static_cast<int>(kv ^ sign);
    payload[s] = static_cast<int>(pv);
  }
}

__global__ void __launch_bounds__(THREADS)
bin_expand_v1_kernel(const int* __restrict__ rect,
                     const float* __restrict__ depth,
                     const int* __restrict__ tile_mask,
                     const int* __restrict__ offsets,
                     const int* __restrict__ fill_starts, int n, int cap,
                     int tiles_x, int num_tiles, int depth_bits,
                     int* __restrict__ key, int* __restrict__ payload) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  const unsigned depth_mask = (1u << depth_bits) - 1u;
  const unsigned sign = 1u << 31;
  if (i < n) {
    const int g = static_cast<int>(i);
    const int start = g > 0 ? offsets[g - 1] : 0, end = offsets[g];
    if (end <= start) return;
    const int x0 = rect[4 * g], y0 = rect[4 * g + 1];
    const int rw = max(rect[4 * g + 2] - x0, 1);
    const unsigned pack = static_cast<unsigned>(x0) |
                          (static_cast<unsigned>(y0) << 10) |
                          (static_cast<unsigned>(rw - 1) << 20);
    const int px = static_cast<int>(pack & 0x3FFu);
    const int py = static_cast<int>((pack >> 10) & 0x3FFu);
    const int pw = static_cast<int>((pack >> 20) & 0x3FFu) + 1;
    const int bits = __float_as_int(depth[g]);
    const unsigned dq =
        static_cast<unsigned>(bits >> (31 - depth_bits)) & depth_mask;
    const unsigned m = tile_mask != nullptr
                           ? static_cast<unsigned>(tile_mask[g]) : ~0u;
    const unsigned real = static_cast<unsigned>(g) | (1u << 29);
    int row = 0, col = 0;
    for (int local = 0; local < end - start; ++local) {
      const unsigned tile = static_cast<unsigned>(py + row) *
                                static_cast<unsigned>(tiles_x) +
                            static_cast<unsigned>(px + col);
      const unsigned hit = local < 32 ? (m >> local) & 1u : 1u;
      key[start + local] = static_cast<int>(((tile << depth_bits) | dq) ^
                                            sign);
      payload[start + local] = static_cast<int>(real | (hit << 30));
      if (++col == pw) {
        col = 0;
        ++row;
      }
    }
  } else if (i < static_cast<long long>(n) + num_tiles) {
    // a tile's filler run; the last tile's thread also writes the slots
    // past the padded total (fillers of tile 0)
    const int t = static_cast<int>(i - n);
    const int kv = static_cast<int>(
        ((static_cast<unsigned>(t) << depth_bits) | depth_mask) ^ sign);
    for (int s = fill_starts[t]; s < fill_starts[t + 1]; ++s) {
      key[s] = kv;
      payload[s] = 0;
    }
    if (t == num_tiles - 1) {
      const int k0 = static_cast<int>(depth_mask ^ sign);
      for (int s = fill_starts[num_tiles]; s < cap; ++s) {
        key[s] = k0;
        payload[s] = 0;
      }
    }
  }
}

}  // namespace

extern "C" {

// key, payload [instance_cap] int32 of the instance slots, in slot order:
// rect [n, 4], depth [n], tile_mask [n] or null (every real slot a hit),
// offsets [n] the inclusive sum of the rect areas, fill_starts
// [num_tiles + 1] the filler runs' starts and their end, num_rendered one
// int32 on the device; one block per SLOTS slots
int gssr_bin_expand(const int* rect, const float* depth, const int* tile_mask,
                    const int* offsets, const int* fill_starts,
                    const int* num_rendered, long long n,
                    long long instance_cap, int tiles_x, int num_tiles,
                    int depth_bits, int* key, int* payload, void* stream) {
  if (instance_cap <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (instance_cap + SLOTS - 1) / SLOTS;
  bin_expand_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rect, depth, tile_mask, offsets, fill_starts, num_rendered,
      static_cast<int>(n), static_cast<int>(instance_cap), tiles_x,
      num_tiles, depth_bits, key, payload);
  return static_cast<int>(cudaGetLastError());
}

// the same integers from the yardstick design, one thread per gaussian and
// per tile; num_rendered is not read
int gssr_bin_expand_v1(const int* rect, const float* depth,
                       const int* tile_mask, const int* offsets,
                       const int* fill_starts, const int* num_rendered,
                       long long n, long long instance_cap, int tiles_x,
                       int num_tiles, int depth_bits, int* key, int* payload,
                       void* stream) {
  (void)num_rendered;
  const long long blocks = (n + num_tiles + THREADS - 1) / THREADS;
  if (instance_cap <= 0 || blocks <= 0)
    return static_cast<int>(cudaSuccess);
  bin_expand_v1_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      rect, depth, tile_mask, offsets, fill_starts, static_cast<int>(n),
      static_cast<int>(instance_cap), tiles_x, num_tiles, depth_bits, key,
      payload);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
