// Spherical-harmonics colour of the vanilla, surfel and planar renders,
// forward and backward, for Hopper (sm_90a). Plain C interface, loaded
// through ctypes by gssr_tpu_torch/ops/_kernels.py; the plain versions are
// sh_to_color_plain (the eager chain) and sh_bwd_plain (autograd's
// gradients of it) in gssr_tpu_torch/ops/sh.py.
//
// Replaces no TPU kernel: gssr_tpu/ops/sh.py is plain jnp, which XLA fuses
// into one pass over the gaussians. Run eagerly, the chain reads each of
// the 16 coefficients from the concatenated [C, 16, 3] features with its
// own select, and autograd's backward of each select zero-fills and adds a
// full [C, 16, 3] gradient (~18.7 GB a render at 1.6M slots) besides ~250
// small kernels; these two kernels are one launch each.
//
// Per slot the forward reads its mean, the camera centre (cached), f_dc
// and the first (deg+1)^2 - 1 rows of f_rest where they lie, and writes
// the colour; the backward reads the same and the colour's cotangent, and
// writes dense d_means, d_f_dc and d_f_rest (zero past the degree). So
// both are bound by bytes: at degree 3, (3 + 48) + 3 floats forward and
// (3 + 48 + 3) + (3 + 48) backward, ~0.10 and ~0.20 ms at 1.6M slots on
// the H100; a few hundred FP32 operations a slot stay far below that.
//
// The design: one thread per slot, which keeps its coefficients in
// registers, one instantiation per degree; each warp stages its 32 slots'
// f_rest rows (one contiguous run) in shared memory with 16-byte loads,
// and writes d_f_rest, d_means, d_f_dc and the colour back the same way.
// Stored in place, a warp's 32 rows 180 bytes apart touch 32 sectors a
// store instruction; that took the backward to 1.33 ms at 1.6M slots
// (3dgs.full) and, writing 45 zeros a slot, to 1.50 ms at degree 0
// (PERF.md, kernel table row 11).
//
// Bit for bit: the forward rounds every float operation as the eager chain
// does, in its order. The _rn intrinsics keep nvcc from contracting a
// product and a sum into an FMA; the square root and the divisions are
// IEEE; the direction's norm adds the squares as torch.linalg.norm's CUDA
// reduction over a row of three does (lanes (0, 2) and 1, then the two
// lanes); torch.clamp keeps a NaN. The backward recomputes the colour the
// same way, so it passes the gradient exactly where the forward's clamp
// did (rgb >= 0, torch.clamp's rule), and sums each slot's terms in one
// thread in a fixed order: no atomics, the same bits run to run.

#include "common.cuh"

namespace {

using namespace gssr;

constexpr int THREADS = 128;
// the most f_rest rows a slot has: degree 3
constexpr int MAX_REST = 15;

// the eager chain's Python floats, as its float32 tensors take them
constexpr float SH_C0 = static_cast<float>(0.28209479177387814);
constexpr float SH_C1 = static_cast<float>(0.4886025119029199);
constexpr float SH_C2_0 = static_cast<float>(1.0925484305920792);
constexpr float SH_C2_1 = static_cast<float>(-1.0925484305920792);
constexpr float SH_C2_2 = static_cast<float>(0.31539156525252005);
constexpr float SH_C2_3 = static_cast<float>(-1.0925484305920792);
constexpr float SH_C2_4 = static_cast<float>(0.5462742152960396);
constexpr float SH_C3_0 = static_cast<float>(-0.5900435899266435);
constexpr float SH_C3_1 = static_cast<float>(2.890611442640554);
constexpr float SH_C3_2 = static_cast<float>(-0.4570457994644658);
constexpr float SH_C3_3 = static_cast<float>(0.3731763325901154);
constexpr float SH_C3_4 = static_cast<float>(-0.4570457994644658);
constexpr float SH_C3_5 = static_cast<float>(1.445305721320277);
constexpr float SH_C3_6 = static_cast<float>(-0.5900435899266435);

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// the unit direction from the camera centre to a mean, as sh_to_color_plain
// computes it: v = mean - campos, s = |v| + 1e-12, (x, y, z) = v / s
struct Dir {
  float vx, vy, vz, n, s, x, y, z;
};

__device__ __forceinline__ Dir direction(const float* m,
                                         const float* __restrict__ campos) {
  Dir d;
  d.vx = sub(m[0], __ldg(campos));
  d.vy = sub(m[1], __ldg(campos + 1));
  d.vz = sub(m[2], __ldg(campos + 2));
  d.n = __fsqrt_rn(add(add(mul(d.vx, d.vx), mul(d.vz, d.vz)),
                       mul(d.vy, d.vy)));
  d.s = add(d.n, static_cast<float>(1e-12));
  d.x = __fdiv_rn(d.vx, d.s);
  d.y = __fdiv_rn(d.vy, d.s);
  d.z = __fdiv_rn(d.vz, d.s);
  return d;
}

// f[k], k in [1, B): the factor the eager chain multiplies coefficient k
// by, rounded as it rounds it; coefficients 1 and 3 are subtracted, the
// others added, so the basis function is -f[1], f[2], -f[3], f[4], ...
template <int DEG>
__device__ __forceinline__ void factors(const Dir& d, float* f) {
  if constexpr (DEG > 0) {
    const float x = d.x, y = d.y, z = d.z;
    f[1] = mul(SH_C1, y);
    f[2] = mul(SH_C1, z);
    f[3] = mul(SH_C1, x);
    if constexpr (DEG > 1) {
      const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
      const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
      f[4] = mul(SH_C2_0, xy);
      f[5] = mul(SH_C2_1, yz);
      f[6] = mul(SH_C2_2, sub(sub(mul(2.0f, zz), xx), yy));
      f[7] = mul(SH_C2_3, xz);
      f[8] = mul(SH_C2_4, sub(xx, yy));
      if constexpr (DEG > 2) {
        f[9] = mul(mul(SH_C3_0, y), sub(mul(3.0f, xx), yy));
        f[10] = mul(mul(SH_C3_1, xy), z);
        f[11] = mul(mul(SH_C3_2, y), sub(sub(mul(4.0f, zz), xx), yy));
        f[12] = mul(mul(SH_C3_3, z),
                    sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
        f[13] = mul(mul(SH_C3_4, x), sub(sub(mul(4.0f, zz), xx), yy));
        f[14] = mul(mul(SH_C3_5, z), sub(xx, yy));
        f[15] = mul(mul(SH_C3_6, x), sub(xx, mul(3.0f, yy)));
      }
    }
  }
}

// channel c of rgb = eval_sh + 0.5 before the clamp; co [B][3] the slot's
// coefficients, DC first, summed in the eager chain's order
template <int DEG>
__device__ __forceinline__ float eval_rgb(const float* f, const float* co,
                                          int c) {
  constexpr int B = (DEG + 1) * (DEG + 1);
  float r = mul(SH_C0, co[c]);
  if constexpr (DEG > 0) {
    r = sub(r, mul(f[1], co[3 + c]));
    r = add(r, mul(f[2], co[6 + c]));
    r = sub(r, mul(f[3], co[9 + c]));
#pragma unroll
    for (int k = 4; k < B; ++k) r = add(r, mul(f[k], co[3 * k + c]));
  }
  return add(r, 0.5f);
}

// torch.clamp(rgb, min=0): a NaN stays NaN
__device__ __forceinline__ float clamp0(float v) {
  return v != v ? v : fmaxf(v, 0.0f);
}

// d rgb_c / d (x, y, z) for channel c of the coefficients co
template <int DEG>
__device__ __forceinline__ void dir_grad(const Dir& d, const float* co,
                                         int c, float& gx, float& gy,
                                         float& gz) {
  const float x = d.x, y = d.y, z = d.z;
  gx = -SH_C1 * co[9 + c];
  gy = -SH_C1 * co[3 + c];
  gz = SH_C1 * co[6 + c];
  if constexpr (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    const float s4 = co[12 + c], s5 = co[15 + c], s6 = co[18 + c],
                s7 = co[21 + c], s8 = co[24 + c];
    gx += SH_C2_0 * y * s4 - 2.0f * SH_C2_2 * x * s6 +
          SH_C2_3 * z * s7 + 2.0f * SH_C2_4 * x * s8;
    gy += SH_C2_0 * x * s4 + SH_C2_1 * z * s5 -
          2.0f * SH_C2_2 * y * s6 - 2.0f * SH_C2_4 * y * s8;
    gz += SH_C2_1 * y * s5 + 4.0f * SH_C2_2 * z * s6 + SH_C2_3 * x * s7;
    if constexpr (DEG > 2) {
      const float s9 = co[27 + c], s10 = co[30 + c], s11 = co[33 + c],
                  s12 = co[36 + c], s13 = co[39 + c], s14 = co[42 + c],
                  s15 = co[45 + c];
      gx += SH_C3_0 * 6.0f * xy * s9 + SH_C3_1 * yz * s10 -
            SH_C3_2 * 2.0f * xy * s11 - SH_C3_3 * 6.0f * xz * s12 +
            SH_C3_4 * (4.0f * zz - 3.0f * xx - yy) * s13 +
            SH_C3_5 * 2.0f * xz * s14 +
            SH_C3_6 * 3.0f * (xx - yy) * s15;
      gy += SH_C3_0 * 3.0f * (xx - yy) * s9 + SH_C3_1 * xz * s10 +
            SH_C3_2 * (4.0f * zz - xx - 3.0f * yy) * s11 -
            SH_C3_3 * 6.0f * yz * s12 - SH_C3_4 * 2.0f * xy * s13 -
            SH_C3_5 * 2.0f * yz * s14 - SH_C3_6 * 6.0f * xy * s15;
      gz += SH_C3_1 * xy * s10 + SH_C3_2 * 8.0f * yz * s11 +
            SH_C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * s12 +
            SH_C3_4 * 8.0f * xz * s13 + SH_C3_5 * (xx - yy) * s14;
    }
  }
}

// One slot's colour from its mean m [3] and coefficients co [B][3].
template <int DEG>
__device__ __forceinline__ void slot_fwd(const float* m, const float* co,
                                         const float* __restrict__ campos,
                                         float* out) {
  constexpr int B = (DEG + 1) * (DEG + 1);
  const Dir d = direction(m, campos);
  float f[B];
  factors<DEG>(d, f);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = clamp0(eval_rgb<DEG>(f, co, c));
}

// One slot's backward: from its mean m, coefficients co [B][3] and the
// colour's cotangent g [3], the coefficients' cotangents dco [B][3] and the
// mean's dm [3].
template <int DEG>
__device__ __forceinline__ void slot_bwd(const float* m, const float* co,
                                         const float* g_in,
                                         const float* __restrict__ campos,
                                         float* dco, float* dm) {
  constexpr int B = (DEG + 1) * (DEG + 1);
  const Dir d = direction(m, campos);
  float f[B];
  factors<DEG>(d, f);
  float gdx = 0.0f, gdy = 0.0f, gdz = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float g = eval_rgb<DEG>(f, co, c) >= 0.0f ? g_in[c] : 0.0f;
    dco[c] = SH_C0 * g;
    if constexpr (DEG > 0) {
      dco[3 + c] = -f[1] * g;
      dco[6 + c] = f[2] * g;
      dco[9 + c] = -f[3] * g;
#pragma unroll
      for (int k = 4; k < B; ++k) dco[3 * k + c] = f[k] * g;
      float gx, gy, gz;
      dir_grad<DEG>(d, co, c, gx, gy, gz);
      gdx += g * gx;
      gdy += g * gy;
      gdz += g * gz;
    }
  }
  // through (x, y, z) = v / s, s = |v| + 1e-12; at v = 0 the norm's
  // gradient is zero, as autograd's
  const float inv = 1.0f / d.s;
  const float dot = gdx * d.vx + gdy * d.vy + gdz * d.vz;
  const float k = d.n > 0.0f ? -dot * inv * inv / d.n : 0.0f;
  dm[0] = gdx * inv + d.vx * k;
  dm[1] = gdy * inv + d.vy * k;
  dm[2] = gdz * inv + d.vz * k;
}

// A warp's slots [base, base + slots) move their rows of [*, count]
// float arrays between global memory and the warp's shared buffer as one
// contiguous run of slots * count floats: 16 bytes a lane where the global
// pointer allows it (each warp's run starts on a multiple of 32 * count
// floats), so every store fills whole sectors.
__device__ __forceinline__ void warp_load(float* s, const float* g, int len,
                                          int lane) {
  int j = 0;
  if ((reinterpret_cast<unsigned long long>(g) & 15) == 0) {
    const int n4 = len / 4;
    for (int q = lane; q < n4; q += 32)
      reinterpret_cast<float4*>(s)[q] =
          __ldg(reinterpret_cast<const float4*>(g) + q);
    j = 4 * n4;
  }
  for (j += lane; j < len; j += 32) s[j] = __ldg(g + j);
}

__device__ __forceinline__ void warp_store(float* g, const float* s, int len,
                                           int lane) {
  int j = 0;
  if ((reinterpret_cast<unsigned long long>(g) & 15) == 0) {
    const int n4 = len / 4;
    for (int q = lane; q < n4; q += 32)
      reinterpret_cast<float4*>(g)[q] = reinterpret_cast<const float4*>(s)[q];
    j = 4 * n4;
  }
  for (j += lane; j < len; j += 32) g[j] = s[j];
}

// Per warp: the f_rest / d_f_rest rows of its 32 slots, then two [32, 3]
// blocks (the colour, or d_means and d_f_dc). A lane reads and writes its
// own row in shared memory, 3 * rest floats from its neighbour's: 45 at
// degree 3, odd, so the warp's lanes fall on 32 banks.
constexpr int STAGE = 32 * 3 * MAX_REST + 2 * 32 * 3;

template <int DEG>
__global__ void __launch_bounds__(THREADS)
sh_fwd_kernel(const float* __restrict__ means,
              const float* __restrict__ campos,
              const float* __restrict__ f_dc,
              const float* __restrict__ f_rest, long long n, int rest,
              float* __restrict__ color) {
  constexpr int B = (DEG + 1) * (DEG + 1);
  __shared__ __align__(16) float stage[THREADS / 32][STAGE];
  const int lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * THREADS +
                         (threadIdx.x & ~31);
  if (base >= n) return;
  const int slots = static_cast<int>(min(32LL, n - base));
  const int row = 3 * rest;
  float* s_rest = stage[threadIdx.x >> 5];
  float* s_out = s_rest + 32 * 3 * MAX_REST;
  if constexpr (DEG > 0) warp_load(s_rest, f_rest + base * row, slots * row,
                                   lane);
  __syncwarp();
  if (lane < slots) {
    const long long i = base + lane;
    float m[3], co[3 * B], out[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      m[c] = means[3 * i + c];
      co[c] = f_dc[3 * i + c];
    }
#pragma unroll
    for (int j = 0; j < 3 * (B - 1); ++j) co[3 + j] = s_rest[lane * row + j];
    slot_fwd<DEG>(m, co, campos, out);
#pragma unroll
    for (int c = 0; c < 3; ++c) s_out[3 * lane + c] = out[c];
  }
  __syncwarp();
  warp_store(color + 3 * base, s_out, 3 * slots, lane);
}

template <int DEG>
__global__ void __launch_bounds__(THREADS)
sh_bwd_kernel(const float* __restrict__ means,
              const float* __restrict__ campos,
              const float* __restrict__ f_dc,
              const float* __restrict__ f_rest,
              const float* __restrict__ d_color, long long n, int rest,
              float* __restrict__ d_means, float* __restrict__ d_dc,
              float* __restrict__ d_rest) {
  constexpr int B = (DEG + 1) * (DEG + 1);
  __shared__ __align__(16) float stage[THREADS / 32][STAGE];
  const int lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * THREADS +
                         (threadIdx.x & ~31);
  if (base >= n) return;
  const int slots = static_cast<int>(min(32LL, n - base));
  const int row = 3 * rest;
  float* s_rest = stage[threadIdx.x >> 5];
  float* s_dm = s_rest + 32 * 3 * MAX_REST;
  float* s_dc = s_dm + 32 * 3;
  if constexpr (DEG > 0) warp_load(s_rest, f_rest + base * row, slots * row,
                                   lane);
  __syncwarp();
  if (lane < slots) {
    const long long i = base + lane;
    float m[3], co[3 * B], g[3], dco[3 * B], dm[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      m[c] = means[3 * i + c];
      co[c] = f_dc[3 * i + c];
      g[c] = d_color[3 * i + c];
    }
    float* r = s_rest + lane * row;
#pragma unroll
    for (int j = 0; j < 3 * (B - 1); ++j) co[3 + j] = r[j];
    slot_bwd<DEG>(m, co, g, campos, dco, dm);
    // the lane's own row, read whole above: no other lane touches it
#pragma unroll
    for (int j = 0; j < 3 * (B - 1); ++j) r[j] = dco[3 + j];
    for (int j = 3 * (B - 1); j < row; ++j) r[j] = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s_dm[3 * lane + c] = dm[c];
      s_dc[3 * lane + c] = dco[c];
    }
  }
  __syncwarp();
  warp_store(d_rest + base * row, s_rest, slots * row, lane);
  warp_store(d_means + 3 * base, s_dm, 3 * slots, lane);
  warp_store(d_dc + 3 * base, s_dc, 3 * slots, lane);
}

template <int DEG>
cudaError_t fwd(const float* means, const float* campos, const float* f_dc,
                const float* f_rest, long long n, int rest, float* color,
                cudaStream_t stream) {
  sh_fwd_kernel<DEG><<<static_cast<unsigned>((n + THREADS - 1) / THREADS),
                       THREADS, 0, stream>>>(means, campos, f_dc, f_rest,
                                             n, rest, color);
  return cudaGetLastError();
}

template <int DEG>
cudaError_t bwd(const float* means, const float* campos, const float* f_dc,
                const float* f_rest, const float* d_color, long long n,
                int rest, float* d_means, float* d_dc, float* d_rest,
                cudaStream_t stream) {
  sh_bwd_kernel<DEG><<<static_cast<unsigned>((n + THREADS - 1) / THREADS),
                       THREADS, 0, stream>>>(means, campos, f_dc, f_rest,
                                             d_color, n, rest, d_means, d_dc,
                                             d_rest);
  return cudaGetLastError();
}

int sh_fwd(const float* means, const float* campos, const float* f_dc,
           const float* f_rest, long long n, int rest, int degree,
           float* color, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (degree < 0 || degree > 3 || rest > MAX_REST ||
      rest < (degree + 1) * (degree + 1) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (degree) {
    case 0: e = fwd<0>(means, campos, f_dc, f_rest, n, rest, color, s); break;
    case 1: e = fwd<1>(means, campos, f_dc, f_rest, n, rest, color, s); break;
    case 2: e = fwd<2>(means, campos, f_dc, f_rest, n, rest, color, s); break;
    default: e = fwd<3>(means, campos, f_dc, f_rest, n, rest, color, s);
  }
  return static_cast<int>(e);
}

int sh_bwd(const float* means, const float* campos, const float* f_dc,
           const float* f_rest, const float* d_color, long long n, int rest,
           int degree, float* d_means, float* d_dc, float* d_rest,
           void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (degree < 0 || degree > 3 || rest > MAX_REST ||
      rest < (degree + 1) * (degree + 1) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (degree) {
    case 0: e = bwd<0>(means, campos, f_dc, f_rest, d_color, n, rest,
                       d_means, d_dc, d_rest, s); break;
    case 1: e = bwd<1>(means, campos, f_dc, f_rest, d_color, n, rest,
                       d_means, d_dc, d_rest, s); break;
    case 2: e = bwd<2>(means, campos, f_dc, f_rest, d_color, n, rest,
                       d_means, d_dc, d_rest, s); break;
    default: e = bwd<3>(means, campos, f_dc, f_rest, d_color, n, rest,
                        d_means, d_dc, d_rest, s);
  }
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// color [n, 3] from means [n, 3], campos [3], f_dc [n, 1, 3] and f_rest
// [n, rest, 3], all float32 and contiguous, at SH degree `degree` (0-3,
// rest >= (degree + 1)^2 - 1); none launched for n <= 0
int gssr_sh_fwd(const float* means, const float* campos, const float* f_dc,
                const float* f_rest, long long n, int rest, int degree,
                float* color, void* stream) {
  return sh_fwd(means, campos, f_dc, f_rest, n, rest, degree, color, stream);
}

// d_means [n, 3], d_dc [n, 1, 3] and d_rest [n, rest, 3] (zero past the
// degree) from the same inputs and the colour's cotangent d_color [n, 3]
int gssr_sh_bwd(const float* means, const float* campos, const float* f_dc,
                const float* f_rest, const float* d_color, long long n,
                int rest, int degree, float* d_means, float* d_dc,
                float* d_rest, void* stream) {
  return sh_bwd(means, campos, f_dc, f_rest, d_color, n, rest, degree,
                d_means, d_dc, d_rest, stream);
}

}  // extern "C"
