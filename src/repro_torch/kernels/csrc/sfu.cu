// SFU row kernels: DORA's special-function unit (paper §3.5) on Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/sfu.py:
//   softmax_rows   <- `_softmax_kernel`   (max-subtracted, fp32)
//   layernorm_rows <- `_layernorm_kernel` (population variance, optional
//                                           gamma and/or beta; fp32 or
//                                           bf16 rows, fp32 gamma and
//                                           beta, fp32 arithmetic, output
//                                           in x's type)
//   act_rows       <- `_gelu_kernel`, and the element-wise SFU_RELU /
//                     SFU_RELU2 / SFU_SILU ops of the runtime
//   rmsnorm_rows   <- `_rmsnorm_kernel` (src/repro/kernels/sfu.py:56;
//                     x * rsqrt(sum(x^2)/N + eps) * gamma, fp32 or bf16
//                     rows, fp32 gamma, fp32 arithmetic, output in x's
//                     type)
//
// Bound on the H100: device-memory bytes (a few FLOP per element), one
// read and one write of the row.  The TPU kernels hold `block_rows` whole
// rows in VMEM and mask the lanes past the true width; here a row lives in
// the registers of one warp or one block, and nothing reads past N.
//
// Softmax and layernorm rows of at most WARP_ROW_MAX (the DORA path's
// 512- to 1024-wide rows, DeiT's 197) get one warp each, ROW_WARPS rows a
// block: lane l holds slots l + 32 s (s < SLOTS) of the row in registers,
// a slot being one 16-byte vector where the row is a whole number of them
// with aligned operands, else one element (scalar loads, DeiT's 788-byte
// rows).  SLOTS is a template argument, a power of two chosen by the
// wrapper's plan (`warp_plan`): at most 32 fp32 values a lane, and loops
// the compiler unrolls, where a run-time count became predicated code.
// The reductions are warp shuffles only; x is read from memory once.
// Softmax keeps expf (the accurate one: no --use_fast_math) and divides
// once a row.
//
// Both norms' rows wider than WARP_ROW_MAX whose x, y, gamma and beta are
// 16-byte aligned, with a row of a whole number of 16-byte vectors, take
// the one-pass kernel `norm_vec_kernel`: a block a row, each thread loads
// its ROW_VPT vectors of the row (uint4: 8 bf16 or 4 fp32) into registers;
// layernorm reduces the row's sum, then sum((x - mean)^2) over the
// registers (the reference's two-pass population variance, not E[x^2] -
// mean^2), rmsnorm sum(x^2); each reduction in a fixed order (warp
// shuffles, then the row's warps' partials by the same shuffles, so a
// repeated call gives the same bits); then each thread scales its
// registers, applies gamma and beta (float4 loads) and writes 16-byte
// stores: x is read from memory once.  Two vectors a thread cover every
// served width (2560 to 6144, bf16 or fp32) with at most 768 threads.
// Wider, unaligned or ragged rows take the block kernels (a block a row,
// two or three reads of the row, which hit L1/L2): the kernels before the
// redesign.  rmsnorm's rows of at most WARP_ROW_MAX (the q/k-norm rows of
// head_dim) keep a warp-a-row kernel of strided scalar loads.
//
// The activation kernel is element-wise over fp32: one 16-byte float4 load
// and store a thread (four times fewer blocks than one element a thread;
// two or four float4 a thread measured slower on the H100, PERF.md), the
// activation a template argument, the n % 4 tail in the last block; an
// unaligned x or y takes the scalar kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "act.cuh"

namespace {

constexpr int ROW_THREADS = 256;
constexpr int ACT_THREADS = 256;
constexpr int WARP_ROW_MAX = 1024;
constexpr int WARP_ROWS = 8;   // rows (warps) per block, rmsnorm's warp kernel
constexpr int ROW_WARPS = 4;   // rows (warps) per block, the softmax and
                               // layernorm warp kernels
constexpr int LANE_MAX = 32;   // fp32 values a lane of those holds at most
constexpr int MAX_THREADS = 1024;
constexpr int ROW_VPT = 2;     // 16-byte vectors a thread, one-pass kernel
constexpr int BWD_VEC_THREADS = 640;  // the norms' backward vector kernels'
                                      // largest block (96 registers a thread)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool IS_MAX>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = IS_MAX ? fmaxf(v, w) : v + w;
  }
  return v;
}

// Reduce over the block of ROW_THREADS; every thread gets the result.
template <bool IS_MAX>
__device__ float block_reduce(float v) {
  __shared__ float part[ROW_THREADS / 32];
  __shared__ float result;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_reduce<IS_MAX>(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < ROW_THREADS / 32 ? part[lane] : (IS_MAX ? -INFINITY : 0.0f);
    v = warp_reduce<IS_MAX>(v);
    if (lane == 0) result = v;
  }
  __syncthreads();
  return result;
}

// The sum over a block of blockDim.x threads (whole warps), every thread
// gets it, in a fixed order: warp shuffles, then the warps' partials by
// the same shuffles in every warp, so a repeated call gives the same
// bits.  `part` holds one float a warp; a second call needs another
// `part` (or a barrier between).
__device__ __forceinline__ float row_sum(float v, float* part) {
  v = warp_reduce<false>(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return warp_reduce<false>(lane < (int)(blockDim.x >> 5) ? part[lane] : 0.0f);
}

// 16 bytes of T as E fp32 values, and back (round to nearest even).
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

// p[j, j + U) into v (fp32 gamma or beta), float4 loads where U is a
// whole number of them (j is then a multiple of 4 and p 16-byte aligned).
template <int U>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, int j,
                                          float* v) {
  if constexpr (U % 4 == 0) {
#pragma unroll
    for (int q = 0; q < U / 4; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + j) + q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = __ldg(p + j + u);
  }
}

// The normalised row's U values: (f - mu) * r, times gamma and plus beta
// where given (g and b hold them, from load_cols).
template <int U>
__device__ __forceinline__ void normalise(float* f, float mu, float r,
                                          const float* g, const float* b,
                                          bool has_g, bool has_b) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float v = (f[u] - mu) * r;
    if (has_g) v *= g[u];
    if (has_b) v += b[u];
    f[u] = v;
  }
}

// ------------------------------------------------ warp-a-row row kernels
// A lane's share of a row of N elements: SLOTS slots of U elements (U = 1,
// or a 16-byte vector of Vec16<T>::E with VEC), slot s at column
// (lane + 32 s) * U.  With VEC, N is a whole number of vectors, so a slot
// is wholly inside the row or wholly past it.
template <typename T, bool VEC>
struct Slot {
  static constexpr int U = VEC ? Vec16<T>::E : 1;
  static __device__ __forceinline__ int col(int lane, int s) {
    return (lane + 32 * s) * U;
  }
};

template <typename T, int SLOTS, bool VEC>
__device__ __forceinline__ void load_lane(const T* __restrict__ xr, int N,
                                          int lane, float* f) {
  using S = Slot<T, VEC>;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int j = S::col(lane, s);
    if (j < N) {
      if constexpr (VEC) {
        Vec16<T>::unpack(__ldg(reinterpret_cast<const uint4*>(xr + j)),
                         f + s * S::U);
      } else {
        f[s] = to_f32(xr[j]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < S::U; ++u) f[s * S::U + u] = 0.0f;
    }
  }
}

template <typename T, int SLOTS, bool VEC>
__device__ __forceinline__ void store_lane(T* __restrict__ yr, int N,
                                           int lane, const float* f) {
  using S = Slot<T, VEC>;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int j = S::col(lane, s);
    if (j < N) {
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(yr + j) = Vec16<T>::pack(f + s * S::U);
      } else {
        store(yr + j, f[s]);
      }
    }
  }
}

template <int SLOTS, bool VEC>
__global__ void __launch_bounds__(ROW_WARPS * 32)
softmax_warp_kernel(const float* __restrict__ x, float* __restrict__ y,
                    int R, int N) {
  using S = Slot<float, VEC>;
  const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;   // whole warps leave together: no shuffle is cut
  float f[SLOTS * S::U];
  load_lane<float, SLOTS, VEC>(x + (size_t)row * N, N, lane, f);
  float m = -INFINITY;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
    if (S::col(lane, s) < N)
#pragma unroll
      for (int u = 0; u < S::U; ++u) m = fmaxf(m, f[s * S::U + u]);
  m = warp_reduce<true>(m);
  float sum = 0.0f;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
    if (S::col(lane, s) < N)
#pragma unroll
      for (int u = 0; u < S::U; ++u) {
        f[s * S::U + u] = expf(f[s * S::U + u] - m);
        sum += f[s * S::U + u];
      }
  // one division a row, then products, within an ulp of dividing each
  // value (a division a value measured slower on the H100)
  const float inv = 1.0f / warp_reduce<false>(sum);
#pragma unroll
  for (int i = 0; i < SLOTS * S::U; ++i) f[i] *= inv;
  store_lane<float, SLOTS, VEC>(y + (size_t)row * N, N, lane, f);
}

template <typename T, int SLOTS, bool VEC>
__global__ void __launch_bounds__(ROW_WARPS * 32)
layernorm_warp_kernel(const T* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      int R, int N, float eps) {
  using S = Slot<T, VEC>;
  const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;   // whole warps leave together: no shuffle is cut
  // gamma and beta are loaded with the row, before the reductions, so
  // their latency hides behind the row's (loaded after them, the warp
  // kernel ran slower than the block kernel at 512 x 768, PERF.md)
  float f[SLOTS * S::U], g[SLOTS * S::U], b[SLOTS * S::U];
  load_lane<T, SLOTS, VEC>(x + (size_t)row * N, N, lane, f);
  const bool has_g = gamma != nullptr, has_b = beta != nullptr;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int j = S::col(lane, s);
    if (j < N) {
      if (has_g) load_cols<S::U>(gamma, j, g + s * S::U);
      if (has_b) load_cols<S::U>(beta, j, b + s * S::U);
    }
  }
  const float n = static_cast<float>(N);
  float sum = 0.0f;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
    if (S::col(lane, s) < N)
#pragma unroll
      for (int u = 0; u < S::U; ++u) sum += f[s * S::U + u];
  const float mu = warp_reduce<false>(sum) / n;
  float ss = 0.0f;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
    if (S::col(lane, s) < N)
#pragma unroll
      for (int u = 0; u < S::U; ++u) {
        const float d = f[s * S::U + u] - mu;
        ss += d * d;
      }
  const float r = rsqrtf(warp_reduce<false>(ss) / n + eps);
  if (mean != nullptr && lane == 0) {
    mean[row] = mu;
    rstd[row] = r;
  }
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
    if (S::col(lane, s) < N)
      normalise<S::U>(f + s * S::U, mu, r, g + s * S::U, b + s * S::U,
                      has_g, has_b);
  store_lane<T, SLOTS, VEC>(y + (size_t)row * N, N, lane, f);
}

// --------------------------------------------------- block-a-row kernels
// The kernels before the redesign: a block of ROW_THREADS a row, strided
// over its true width, two or three reads of the row.  Softmax rows wider
// than WARP_ROW_MAX; layernorm rows wider than WARP_ROW_MAX that the
// one-pass kernel does not take.
__global__ void __launch_bounds__(ROW_THREADS)
softmax_rows_kernel(const float* __restrict__ x, float* __restrict__ y,
                    int N) {
  const float* xr = x + (size_t)blockIdx.x * N;
  float* yr = y + (size_t)blockIdx.x * N;
  float m = -INFINITY;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) m = fmaxf(m, xr[j]);
  m = block_reduce<true>(m);
  float s = 0.0f;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) s += expf(xr[j] - m);
  s = block_reduce<false>(s);
  for (int j = threadIdx.x; j < N; j += ROW_THREADS)
    yr[j] = expf(xr[j] - m) / s;
}

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
layernorm_rows_kernel(const T* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ rstd_out,
                      int N, float eps) {
  const T* xr = x + (size_t)blockIdx.x * N;
  T* yr = y + (size_t)blockIdx.x * N;
  const float n = static_cast<float>(N);
  float s = 0.0f;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) s += to_f32(xr[j]);
  const float mu = block_reduce<false>(s) / n;
  float ss = 0.0f;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) {
    const float d = to_f32(xr[j]) - mu;
    ss += d * d;
  }
  const float rstd = rsqrtf(block_reduce<false>(ss) / n + eps);
  if (mean != nullptr && threadIdx.x == 0) {
    mean[blockIdx.x] = mu;
    rstd_out[blockIdx.x] = rstd;
  }
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) {
    float v = (to_f32(xr[j]) - mu) * rstd;
    if (gamma != nullptr) v *= gamma[j];
    if (beta != nullptr) v += beta[j];
    store(yr + j, v);
  }
}

// One element a thread: the path for an unaligned x or y.
__global__ void __launch_bounds__(ACT_THREADS)
act_kernel(const float* __restrict__ x, float* __restrict__ y, size_t n,
           int act) {
  const size_t i = (size_t)blockIdx.x * ACT_THREADS + threadIdx.x;
  if (i < n) y[i] = activate(x[i], act);
}

// One float4 a thread, ACT a compile-time code (the switch of `activate`
// folds away); the last block also does the n % 4 tail.  x and y 16-byte
// aligned.
template <int ACT>
__global__ void __launch_bounds__(ACT_THREADS)
act_vec_kernel(const float* __restrict__ x, float* __restrict__ y,
               size_t n) {
  const size_t nv = n / 4;
  const size_t i = (size_t)blockIdx.x * ACT_THREADS + threadIdx.x;
  if (i < nv) {
    float4 v = __ldg(reinterpret_cast<const float4*>(x) + i);
    v.x = activate(v.x, ACT);
    v.y = activate(v.y, ACT);
    v.z = activate(v.z, ACT);
    v.w = activate(v.w, ACT);
    reinterpret_cast<float4*>(y)[i] = v;
  }
  if (blockIdx.x == gridDim.x - 1) {
    const size_t j = nv * 4 + threadIdx.x;
    if (j < n) y[j] = activate(x[j], ACT);
  }
}

// One warp per row, for rows of at most WARP_ROW_MAX elements.
template <typename T>
__global__ void __launch_bounds__(WARP_ROWS * 32)
rmsnorm_warp_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    T* __restrict__ y, float* __restrict__ rstd, int R, int N,
                    float eps) {
  const int row = blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;   // whole warps leave together: no shuffle is cut
  const T* xr = x + (size_t)row * N;
  T* yr = y + (size_t)row * N;
  float ss = 0.0f;
  for (int j = lane; j < N; j += 32) {
    const float v = to_f32(xr[j]);
    ss += v * v;
  }
  const float r = rsqrtf(warp_reduce<false>(ss) / static_cast<float>(N) + eps);
  if (rstd != nullptr && lane == 0) rstd[row] = r;
  for (int j = lane; j < N; j += 32) {
    float v = to_f32(xr[j]) * r;
    if (gamma != nullptr) v *= gamma[j];
    store(yr + j, v);
  }
}

// One block per row, two passes over it: wider rows that are not 16-byte
// aligned, not a whole number of 16-byte vectors, or wider than the
// one-pass kernel's ROW_VPT * MAX_THREADS vectors.
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
rmsnorm_block_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     T* __restrict__ y, float* __restrict__ rstd, int N,
                     float eps) {
  const T* xr = x + (size_t)blockIdx.x * N;
  T* yr = y + (size_t)blockIdx.x * N;
  float ss = 0.0f;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) {
    const float v = to_f32(xr[j]);
    ss += v * v;
  }
  const float r =
      rsqrtf(block_reduce<false>(ss) / static_cast<float>(N) + eps);
  if (rstd != nullptr && threadIdx.x == 0) rstd[blockIdx.x] = r;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) {
    float v = to_f32(xr[j]) * r;
    if (gamma != nullptr) v *= gamma[j];
    store(yr + j, v);
  }
}

// ------------------------------------------------------ one-pass kernel
// One pass over rows of V 16-byte vectors, a block a row of blockDim.x
// threads (whole warps); thread t holds the row's vectors t and
// t + blockDim.x in registers, packed (8 bf16 or 4 fp32 in a uint4,
// unpacked at each use), between the reductions and the write; gamma and
// beta are loaded at the write, a float4 of each at a time, which keeps
// the kernel at 30-35 registers (more, loading them before the
// reductions, cost blocks an SM and ran slower at 2048 x 6144).  The
// launch bound names one block an SM: with the bound alone ptxas held bf16
// layernorm to 32 registers and spilled.  CENTER: layernorm (mean, then
// the population variance over the registers, gamma and beta); else
// rmsnorm (the mean square, gamma; beta is null).  rstd, where not null,
// takes each row's 1 / sqrt(variance or mean square + eps), and mean, where
// not null, layernorm's row mean (the forwards under autograd, for their
// backwards).
template <typename T, bool CENTER>
__global__ void __launch_bounds__(MAX_THREADS, 1)
norm_vec_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, T* __restrict__ y,
                float* __restrict__ mean, float* __restrict__ rstd, int V,
                float eps) {
  using P = Vec16<T>;
  __shared__ float part[2][MAX_THREADS / 32];   // one sum per warp of the row
  const uint4* xr = reinterpret_cast<const uint4*>(x) + (size_t)blockIdx.x * V;
  uint4 u[ROW_VPT];
#pragma unroll
  for (int k = 0; k < ROW_VPT; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < V) u[k] = __ldg(xr + j);
  }
  const float n = static_cast<float>(V * P::E);
  float mu = 0.0f;
  if constexpr (CENTER) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < ROW_VPT; ++k) {
      if (threadIdx.x + k * blockDim.x < V) {
        float f[P::E];
        P::unpack(u[k], f);
#pragma unroll
        for (int e = 0; e < P::E; ++e) s += f[e];
      }
    }
    mu = row_sum(s, part[0]) / n;
  }
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < ROW_VPT; ++k) {
    if (threadIdx.x + k * blockDim.x < V) {
      float f[P::E];
      P::unpack(u[k], f);
#pragma unroll
      for (int e = 0; e < P::E; ++e) {
        const float d = f[e] - mu;
        ss += d * d;
      }
    }
  }
  const float r = rsqrtf(row_sum(ss, part[1]) / n + eps);
  if (rstd != nullptr && threadIdx.x == 0) rstd[blockIdx.x] = r;
  if (mean != nullptr && threadIdx.x == 0) mean[blockIdx.x] = mu;
  uint4* yr = reinterpret_cast<uint4*>(y) + (size_t)blockIdx.x * V;
#pragma unroll
  for (int k = 0; k < ROW_VPT; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < V) {
      float f[P::E];
      P::unpack(u[k], f);
#pragma unroll
      for (int q = 0; q < P::E; q += 4) {   // a float4 of gamma and beta
        float g[4], b[4];
        if (gamma != nullptr) load_cols<4>(gamma, j * P::E + q, g);
        if (beta != nullptr) load_cols<4>(beta, j * P::E + q, b);
        normalise<4>(f + q, mu, r, g, b, gamma != nullptr, beta != nullptr);
      }
      yr[j] = P::pack(f);
    }
  }
}

// --------------------------------------------------------------- launch
// Checks the one-pass plan: `threads` threads of ROW_VPT vectors cover a
// row of N elements of T, whole 16-byte vectors, every operand aligned.
template <typename T>
bool vec_plan_ok(int N, int threads, const void* x, const void* gamma,
                 const void* beta, const void* y) {
  const long long V = (long long)N * sizeof(T) / 16;
  return (N * sizeof(T)) % 16 == 0 && threads % 32 == 0 &&
         threads <= MAX_THREADS && (long long)threads * ROW_VPT >= V &&
         aligned16(x) && aligned16(y) && aligned16(gamma) && aligned16(beta);
}

// Checks a warp plan: `slots` slots a lane cover a row of N <=
// WARP_ROW_MAX, whole 16-byte vectors with aligned operands if `vec`.
template <typename T>
bool warp_plan_ok(int N, int slots, bool vec, const void* x,
                  const void* gamma, const void* beta, const void* y) {
  const int unit = vec ? 16 / static_cast<int>(sizeof(T)) : 1;
  return N <= WARP_ROW_MAX && 32LL * slots * unit >= N &&
         (!vec || ((N * sizeof(T)) % 16 == 0 && aligned16(x) &&
                   aligned16(y) && aligned16(gamma) && aligned16(beta)));
}

// Calls launch(slots, vec) with both as compile-time constants
// (std::integral_constant) for slots a power of two up to 32 whose lane
// holds at most LANE_MAX values of T; returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for any other plan.
template <typename T, typename Launch>
int with_slots(int slots, bool vec, Launch&& launch) {
  bool launched = false;
  auto go = [&](auto s, auto v) {
    constexpr int S = decltype(s)::value;
    constexpr bool VEC = decltype(v)::value;
    if constexpr (S * Slot<T, VEC>::U <= LANE_MAX) {
      launch(s, v);
      launched = true;
    }
  };
  auto pick = [&](auto s) {
    if (vec) go(s, std::true_type{}); else go(s, std::false_type{});
  };
  switch (slots) {
    case 1: pick(std::integral_constant<int, 1>{}); break;
    case 2: pick(std::integral_constant<int, 2>{}); break;
    case 4: pick(std::integral_constant<int, 4>{}); break;
    case 8: pick(std::integral_constant<int, 8>{}); break;
    case 16: pick(std::integral_constant<int, 16>{}); break;
    case 32: pick(std::integral_constant<int, 32>{}); break;
    default: break;
  }
  return launched ? static_cast<int>(cudaGetLastError())
                  : static_cast<int>(cudaErrorInvalidValue);
}

unsigned warp_blocks(int R) { return (R + ROW_WARPS - 1) / ROW_WARPS; }

// threads > 0: the one-pass kernel with `threads` threads a row; else
// slots > 0: the warp kernel with `slots` slots a lane (16-byte vectors
// if vec); else the block kernel (see norm_plan / warp_plan).
template <typename T>
int launch_layernorm(const void* x, const void* gamma, const void* beta,
                     void* y, void* mean, void* rstd, int R, int N, float eps,
                     int threads, int slots, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  T* yt = static_cast<T*>(y);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  if ((mean == nullptr) != (rstd == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (threads > 0) {
    if (!vec_plan_ok<T>(N, threads, x, gamma, beta, y))
      return static_cast<int>(cudaErrorInvalidValue);
    norm_vec_kernel<T, true><<<R, threads, 0, st>>>(
        xt, g, b, yt, mu, rs, static_cast<int>(N * sizeof(T) / 16), eps);
    return static_cast<int>(cudaGetLastError());
  }
  if (slots > 0) {
    if (!warp_plan_ok<T>(N, slots, vec, x, gamma, beta, y))
      return static_cast<int>(cudaErrorInvalidValue);
    return with_slots<T>(slots, vec, [&](auto s, auto v) {
      layernorm_warp_kernel<T, decltype(s)::value, decltype(v)::value>
          <<<warp_blocks(R), ROW_WARPS * 32, 0, st>>>(xt, g, b, yt, mu, rs, R,
                                                       N, eps);
    });
  }
  layernorm_rows_kernel<T><<<R, ROW_THREADS, 0, st>>>(xt, g, b, yt, mu, rs, N,
                                                      eps);
  return static_cast<int>(cudaGetLastError());
}

// threads 0: the scalar kernels (a warp a row up to WARP_ROW_MAX wide, else
// a block a row); else the one-pass kernel with `threads` threads a row of
// N * sizeof(T) / 16 vectors.  rstd (R floats) may be null.
template <typename T>
int launch_rmsnorm(const void* x, const void* gamma, void* y, void* rstd,
                   int R, int N, float eps, int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  T* yt = static_cast<T*>(y);
  float* rs = static_cast<float*>(rstd);
  if (threads == 0) {
    if (N <= WARP_ROW_MAX) {
      rmsnorm_warp_kernel<T><<<(R + WARP_ROWS - 1) / WARP_ROWS,
                               WARP_ROWS * 32, 0, s>>>(xt, g, yt, rs, R, N,
                                                       eps);
    } else {
      rmsnorm_block_kernel<T><<<R, ROW_THREADS, 0, s>>>(xt, g, yt, rs, N,
                                                        eps);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (!vec_plan_ok<T>(N, threads, x, gamma, nullptr, y))
    return static_cast<int>(cudaErrorInvalidValue);
  norm_vec_kernel<T, false><<<R, threads, 0, s>>>(
      xt, g, nullptr, yt, nullptr, rs, static_cast<int>(N * sizeof(T) / 16),
      eps);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- rmsnorm and layernorm backward
// y = x * r * gamma with r = 1 / sqrt(mean(x^2) + eps) gives, over a row of
// N, with xh = x * r (r the forward's, saved as rstd):
//   dx = r * (gamma * dy - xh * mean(gamma * dy * xh)),
// and dgamma = sum over rows of dy * xh.  Layernorm's y = xh * gamma + beta
// with xh = (x - mu) * r (mu and r the forward's, saved as mean and rstd)
// gives
//   dx = r * (gamma * dy - mean(gamma * dy) - xh * mean(gamma * dy * xh)),
// dgamma = sum over rows of dy * xh and dbeta = sum over rows of dy (CENTER
// below).  No Pallas kernel differentiates (the reference differentiates
// its jnp norms).  Bound: device-memory bytes (x and dy read, dx written
// once).  Rows of a whole number of 16-byte vectors with aligned operands,
// at least 64 of them, take the vector kernel (`threads` threads a row,
// ROW_VPT vectors a thread, up to BWD_VEC_THREADS threads a block): the
// forward's wide rows, and rows of 512 to 1,024 bf16 (256 fp32) too, which
// the warp kernel reads by 2-byte loads (whisper-medium's 1,024: 64
// threads a row, 10 rows a block; on the H100 0.0131 against 0.0254 ms on
// the warp kernel, PERF.md).  Each thread loads the next row's vectors
// before the current row's reduction, so two rows a row group are in
// flight.  Other rows of at most WARP_ROW_MAX take a warp a row (rmsnorm's
// q/k-norm rows of 128, where it measured faster), wider ones the block
// kernel.  The kernels walk rows cyclically over a fixed grid of `blocks`
// (the wrapper's plan, norm_bwd_plan), `rows` rows of a block at once.  dgamma's and dbeta's
// column sums run over a row group's rows in registers (or a warp's shared
// row), then over the block's row groups in a fixed order into one partial
// row a block (part, partb), then over the blocks in a fixed order (one
// column_sum_kernel launch for both): no atomics, the same bits every run.
// A grid of one or two wide blocks an SM keeps part small: 1.35 MB at 2048
// x 2560, where 528 one-row blocks wrote 5.4 MB and read it back after a
// zero fill of dgamma.  The kernels of both norms share one body each
// (CENTER), and the __global__ functions below keep a name for each norm,
// so that ptxas and the profiles tell them apart.

// A warp a row of N <= WARP_ROW_MAX, blockDim.x / 32 rows a block; warp w
// of block b takes rows (b + k * gridDim.x) * rows + w.  Each warp sums its
// rows' dy * xh (with gamma) and dy (with beta) in its own shared rows of N
// floats (lane l owns columns l + 32 i), and the block writes the sums of
// its warps' rows, in warp order, to part[blockIdx.x] and partb[blockIdx.x].
template <typename T, bool CENTER>
__device__ __forceinline__ void norm_bwd_warp(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
    float* __restrict__ partb, int R, int N) {
  extern __shared__ float acc[];   // rows x N with gamma, then with beta
  const int rows = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool has_g = gamma != nullptr, has_b = CENTER && partb != nullptr;
  float* mine = acc + warp * N;
  float* mineb = acc + ((has_g ? rows : 0) + warp) * N;
  for (int j = lane; j < N; j += 32) {
    if (has_g) mine[j] = 0.0f;
    if (has_b) mineb[j] = 0.0f;
  }
  const float inv_n = 1.0f / static_cast<float>(N);
  for (int row = blockIdx.x * rows + warp; row < R;
       row += gridDim.x * rows) {   // whole warps: no shuffle is cut
    const T* xr = x + (size_t)row * N;
    const T* dr = dy + (size_t)row * N;
    const float r = rstd[row];
    const float mu = CENTER ? mean[row] : 0.0f;
    float s = 0.0f, s1 = 0.0f;
    for (int j = lane; j < N; j += 32) {
      const float xh = (to_f32(xr[j]) - mu) * r, d = to_f32(dr[j]);
      const float gd = has_g ? gamma[j] * d : d;
      s += gd * xh;
      if (CENTER) s1 += gd;
      if (has_g) mine[j] += d * xh;
      if (has_b) mineb[j] += d;
    }
    const float c = warp_reduce<false>(s) * inv_n;
    const float c1 = CENTER ? warp_reduce<false>(s1) * inv_n : 0.0f;
    T* out = dx + (size_t)row * N;
    for (int j = lane; j < N; j += 32) {
      const float xh = (to_f32(xr[j]) - mu) * r, d = to_f32(dr[j]);
      const float gd = has_g ? gamma[j] * d : d;
      store(out + j, CENTER ? r * (gd - c1 - xh * c) : r * (gd - xh * c));
    }
  }
  if (!has_g && !has_b) return;
  __syncthreads();
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    if (has_g) {
      float t = 0.0f;
      for (int w = 0; w < rows; ++w) t += acc[w * N + j];
      part[(size_t)blockIdx.x * N + j] = t;
    }
    if (has_b) {
      const float* b0 = acc + (has_g ? rows : 0) * N;
      float t = 0.0f;
      for (int w = 0; w < rows; ++w) t += b0[w * N + j];
      partb[(size_t)blockIdx.x * N + j] = t;
    }
  }
}

// The vector rows (norm_bwd_plan): `threads` threads a row, thread t of a
// row group holding the row's 16-byte vectors t and t + threads; a block of
// blockDim.x = rows x threads works on `rows` rows at once, row group q of
// block b taking rows (i * gridDim.x + b) * rows + q, i = 0, 1, ...  The
// next row's vectors (and its mean and rstd) are loaded before this row's
// sums are reduced.  Each thread sums dy * xh (and dy) of its own columns
// in registers over its group's rows; with rows > 1 the groups write
// theirs to shared rows (rows x parts x N floats) and the block adds them
// up a column a thread, in group order, into part[blockIdx.x] (and
// partb[blockIdx.x]).
template <typename T, bool CENTER>
__device__ __forceinline__ void norm_bwd_vec(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
    float* __restrict__ partb, int R, int V, int threads) {
  using P = Vec16<T>;
  extern __shared__ float cols[];   // rows > 1: each group's dgamma and
                                    // dbeta sums
  // the groups' warp sums, alternating between row steps: [it & 1][sum]
  __shared__ float red[2][CENTER ? 2 : 1][BWD_VEC_THREADS / 32];
  const int rows = blockDim.x / threads, grp = threadIdx.x / threads;
  const int tl = threadIdx.x % threads, lane = threadIdx.x & 31;
  const int wpr = threads / 32;                // warps a row group
  const bool has_g = gamma != nullptr, has_b = CENTER && partb != nullptr;
  float acc[ROW_VPT][P::E];
  float accb[CENTER ? ROW_VPT : 1][P::E];
#pragma unroll
  for (int k = 0; k < ROW_VPT; ++k)
#pragma unroll
    for (int e = 0; e < P::E; ++e) acc[k][e] = 0.0f;
  if constexpr (CENTER) {
#pragma unroll
    for (int k = 0; k < ROW_VPT; ++k)
#pragma unroll
      for (int e = 0; e < P::E; ++e) accb[k][e] = 0.0f;
  }
  const float inv_n = 1.0f / static_cast<float>(V * P::E);
  const int step = gridDim.x * rows;
  const int iters = (R + step - 1) / step;     // the same in every thread
  // row `it` of this row group: its vectors, rstd and mean (zero past R)
  uint4 ux[ROW_VPT], ud[ROW_VPT];
  float r = 0.0f, mu = 0.0f;
  auto fetch = [&](int it, uint4 (&vx)[ROW_VPT], uint4 (&vd)[ROW_VPT],
                   float& vr, float& vm) {
    const int row = (it * gridDim.x + blockIdx.x) * rows + grp;
    const uint4* xr = reinterpret_cast<const uint4*>(x) + (size_t)row * V;
    const uint4* dr = reinterpret_cast<const uint4*>(dy) + (size_t)row * V;
    const bool valid = row < R;
#pragma unroll
    for (int k = 0; k < ROW_VPT; ++k) {
      const int j = tl + k * threads;
      vx[k] = vd[k] = make_uint4(0u, 0u, 0u, 0u);
      if (valid && j < V) {
        vx[k] = __ldg(xr + j);
        vd[k] = __ldg(dr + j);
      }
    }
    vr = valid ? rstd[row] : 0.0f;
    vm = CENTER && valid ? mean[row] : 0.0f;
  };
  if (iters > 0) fetch(0, ux, ud, r, mu);
  for (int it = 0; it < iters; ++it) {
    const int row = (it * gridDim.x + blockIdx.x) * rows + grp;
    const bool valid = row < R;
    float s = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int k = 0; k < ROW_VPT; ++k) {
      const int j = tl + k * threads;
      if (valid && j < V) {
        float f[P::E], d[P::E];
        P::unpack(ux[k], f);
        P::unpack(ud[k], d);
#pragma unroll
        for (int q = 0; q < P::E; q += 4) {
          float g[4] = {1.0f, 1.0f, 1.0f, 1.0f};
          if (has_g) load_cols<4>(gamma, j * P::E + q, g);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xh = (f[q + e] - mu) * r;
            s += g[e] * d[q + e] * xh;
            acc[k][q + e] += d[q + e] * xh;
            if constexpr (CENTER) {
              s1 += g[e] * d[q + e];
              accb[k][q + e] += d[q + e];
            }
          }
        }
      }
    }
    uint4 nx[ROW_VPT], nd[ROW_VPT];
    float nr = 0.0f, nmu = 0.0f;
    if (it + 1 < iters) fetch(it + 1, nx, nd, nr, nmu);
    // the row's sums over its group's warps, in a fixed order (warp
    // shuffles, then the warps' partials by the same shuffles)
    s = warp_reduce<false>(s);
    if (lane == 0) red[it & 1][0][threadIdx.x >> 5] = s;
    if constexpr (CENTER) {
      s1 = warp_reduce<false>(s1);
      if (lane == 0) red[it & 1][1][threadIdx.x >> 5] = s1;
    }
    __syncthreads();
    const float c = warp_reduce<false>(
        lane < wpr ? red[it & 1][0][grp * wpr + lane] : 0.0f) * inv_n;
    float c1 = 0.0f;
    if constexpr (CENTER)
      c1 = warp_reduce<false>(
          lane < wpr ? red[it & 1][1][grp * wpr + lane] : 0.0f) * inv_n;
    if (valid) {
      uint4* out = reinterpret_cast<uint4*>(dx) + (size_t)row * V;
#pragma unroll
      for (int k = 0; k < ROW_VPT; ++k) {
        const int j = tl + k * threads;
        if (j < V) {
          float f[P::E], d[P::E];
          P::unpack(ux[k], f);
          P::unpack(ud[k], d);
#pragma unroll
          for (int q = 0; q < P::E; q += 4) {
            float g[4] = {1.0f, 1.0f, 1.0f, 1.0f};
            if (has_g) load_cols<4>(gamma, j * P::E + q, g);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if constexpr (CENTER)
                f[q + e] =
                    r * (g[e] * d[q + e] - c1 - (f[q + e] - mu) * r * c);
              else
                f[q + e] = r * (g[e] * d[q + e] - f[q + e] * r * c);
            }
          }
          out[j] = P::pack(f);
        }
      }
    }
    if (it + 1 < iters) {
#pragma unroll
      for (int k = 0; k < ROW_VPT; ++k) {
        ux[k] = nx[k];
        ud[k] = nd[k];
      }
      r = nr;
      mu = nmu;
    }
  }
  if (!has_g && !has_b) return;
  const int N = V * P::E, parts = has_g + has_b;
  // with one row group the sums go straight to part and partb; else each
  // group's into its own shared rows, then every column over the groups
  // in group order
  float* mine = rows == 1 ? part + (size_t)blockIdx.x * N
                          : cols + (size_t)grp * parts * N;
  float* mineb = rows > 1 ? mine + (has_g ? N : 0)
                          : has_b ? partb + (size_t)blockIdx.x * N : nullptr;
#pragma unroll
  for (int k = 0; k < ROW_VPT; ++k) {
    const int j = tl + k * threads;
    if (j >= V) continue;
#pragma unroll
    for (int q = 0; q < P::E; q += 4) {
      if (has_g)
        *reinterpret_cast<float4*>(mine + j * P::E + q) = make_float4(
            acc[k][q], acc[k][q + 1], acc[k][q + 2], acc[k][q + 3]);
      if constexpr (CENTER) {
        if (has_b)
          *reinterpret_cast<float4*>(mineb + j * P::E + q) = make_float4(
              accb[k][q], accb[k][q + 1], accb[k][q + 2], accb[k][q + 3]);
      }
    }
  }
  if (rows == 1) return;
  __syncthreads();
  for (int col = threadIdx.x; col < parts * N; col += blockDim.x) {
    float t = 0.0f;
    for (int q = 0; q < rows; ++q) t += cols[(size_t)q * parts * N + col];
    if (has_g && col < N) part[(size_t)blockIdx.x * N + col] = t;
    else partb[(size_t)blockIdx.x * N + col - (has_g ? N : 0)] = t;
  }
}

// Any other row (wider, unaligned or ragged): ROW_THREADS threads a row,
// thread t on columns t + ROW_THREADS i; block b takes rows b + k *
// gridDim.x.  Thread t adds its columns' dy * xh (with gamma) and dy (with
// beta) into part[blockIdx.x] and partb[blockIdx.x] in device memory (each
// column is one thread's).
template <typename T, bool CENTER>
__device__ __forceinline__ void norm_bwd_block(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
    float* __restrict__ partb, int R, int N) {
  const bool has_g = gamma != nullptr, has_b = CENTER && partb != nullptr;
  float* mine = has_g ? part + (size_t)blockIdx.x * N : nullptr;
  float* mineb = has_b ? partb + (size_t)blockIdx.x * N : nullptr;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) {
    if (has_g) mine[j] = 0.0f;
    if (has_b) mineb[j] = 0.0f;
  }
  const float inv_n = 1.0f / static_cast<float>(N);
  for (int row = blockIdx.x; row < R; row += gridDim.x) {
    const T* xr = x + (size_t)row * N;
    const T* dr = dy + (size_t)row * N;
    const float r = rstd[row];
    const float mu = CENTER ? mean[row] : 0.0f;
    float s = 0.0f, s1 = 0.0f;
    for (int j = threadIdx.x; j < N; j += ROW_THREADS) {
      const float xh = (to_f32(xr[j]) - mu) * r, d = to_f32(dr[j]);
      const float gd = has_g ? gamma[j] * d : d;
      s += gd * xh;
      if (CENTER) s1 += gd;
      if (has_g) mine[j] += d * xh;
      if (has_b) mineb[j] += d;
    }
    const float c = block_reduce<false>(s) * inv_n;
    const float c1 = CENTER ? block_reduce<false>(s1) * inv_n : 0.0f;
    T* out = dx + (size_t)row * N;
    for (int j = threadIdx.x; j < N; j += ROW_THREADS) {
      const float xh = (to_f32(xr[j]) - mu) * r, d = to_f32(dr[j]);
      const float gd = has_g ? gamma[j] * d : d;
      store(out + j, CENTER ? r * (gd - c1 - xh * c) : r * (gd - xh * c));
    }
  }
}

#define NORM_BWD_ARGS                                                      \
  const T *__restrict__ x, const float *__restrict__ gamma,                \
      const float *__restrict__ mean, const float *__restrict__ rstd,      \
      const T *__restrict__ dy, T *__restrict__ dx,                        \
      float *__restrict__ part, float *__restrict__ partb, int R

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_bwd_warp_kernel(NORM_BWD_ARGS, int N) {
  norm_bwd_warp<T, false>(x, gamma, mean, rstd, dy, dx, part, partb, R, N);
}
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
layernorm_bwd_warp_kernel(NORM_BWD_ARGS, int N) {
  norm_bwd_warp<T, true>(x, gamma, mean, rstd, dy, dx, part, partb, R, N);
}
template <typename T>
__global__ void __launch_bounds__(BWD_VEC_THREADS, 1)
rmsnorm_bwd_vec_kernel(NORM_BWD_ARGS, int V, int threads) {
  norm_bwd_vec<T, false>(x, gamma, mean, rstd, dy, dx, part, partb, R, V,
                         threads);
}
template <typename T>
__global__ void __launch_bounds__(BWD_VEC_THREADS, 1)
layernorm_bwd_vec_kernel(NORM_BWD_ARGS, int V, int threads) {
  norm_bwd_vec<T, true>(x, gamma, mean, rstd, dy, dx, part, partb, R, V,
                        threads);
}
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
rmsnorm_bwd_block_kernel(NORM_BWD_ARGS, int N) {
  norm_bwd_block<T, false>(x, gamma, mean, rstd, dy, dx, part, partb, R, N);
}
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
layernorm_bwd_block_kernel(NORM_BWD_ARGS, int N) {
  norm_bwd_block<T, true>(x, gamma, mean, rstd, dy, dx, part, partb, R, N);
}
#undef NORM_BWD_ARGS

// out[j] = sum over b < G of part[b][j], in a fixed order: lane l of block
// (c, y) owns the VEC columns (32 c + l) VEC (one 16-byte vector for VEC 4)
// of the y-th partial array (part, then partb for dbeta's, each into its
// own out), warp w of the block's warps sums rows w, w + warps, ..., then
// warp 0 adds the warps' sums in warp order.  A block a 32 VEC columns, up
// to 32 warps of a few rows each (the wrapper's plan), so the loads of
// part are in flight at once rather than in a chain down each column.
constexpr int CS_MAX_WARPS = 32;
template <int VEC>
__global__ void __launch_bounds__(CS_MAX_WARPS * 32)
column_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                  const float* __restrict__ partb, float* __restrict__ outb,
                  int G, int N) {
  __shared__ float sums[CS_MAX_WARPS][32 * VEC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int j = (blockIdx.x * 32 + lane) * VEC;   // N % VEC == 0
  const float* src = blockIdx.y == 0 ? part : partb;
  float* dst = blockIdx.y == 0 ? out : outb;
  float t[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) t[e] = 0.0f;
  if (j < N) {
#pragma unroll 4
    for (int b = warp; b < G; b += warps) {
      const float* p = src + (size_t)b * N + j;
      if constexpr (VEC == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        t[0] += v.x;
        t[1] += v.y;
        t[2] += v.z;
        t[3] += v.w;
      } else {
        t[0] += *p;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) sums[warp][lane * VEC + e] = t[e];
  __syncthreads();
  if (warp == 0 && j < N) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float u = 0.0f;
      for (int w = 0; w < warps; ++w) u += sums[w][lane * VEC + e];
      dst[j + e] = u;
    }
  }
}

constexpr size_t SMEM_DEFAULT = 48 * 1024;   // without an opt-in
constexpr size_t SMEM_VEC_MAX = 128 * 1024;  // the vector kernels' groups'
                                             // shared rows, at most

// The column sums of part into out and, where partb is given, of partb
// into outb: one launch, blockIdx.y picking the array.
int column_sum(const float* part, float* out, const float* partb,
               float* outb, int blocks, int N, int sum_warps, int sum_vec,
               cudaStream_t s) {
  const dim3 grid((N + 32 * sum_vec - 1) / (32 * sum_vec),
                  partb != nullptr ? 2 : 1);
  if (sum_vec == 4)
    column_sum_kernel<4><<<grid, sum_warps * 32, 0, s>>>(part, out, partb,
                                                         outb, blocks, N);
  else
    column_sum_kernel<1><<<grid, sum_warps * 32, 0, s>>>(part, out, partb,
                                                         outb, blocks, N);
  return static_cast<int>(cudaGetLastError());
}

// threads > 0: the vector kernel with `threads` threads a row
// (norm_bwd_plan's, x, dy and dx 16-byte aligned, rows x threads at most
// BWD_VEC_THREADS); else a warp a row up to WARP_ROW_MAX wide,
// else the block kernel (rows 1); `rows` rows of a block at once over
// `blocks` blocks, then, with gamma (and with beta), the column sum with
// `sum_warps` warps a block over `sum_vec` columns a lane (4: N % 4 == 0).
// CENTER: layernorm (mean given; partb and dbeta with beta), else rmsnorm
// (mean, partb and dbeta null).
// Raises Kernel's limit of dynamic shared memory to SMEM_VEC_MAX, the most
// a plan gives it, once a device (a flag bit a device; the first 64).
template <auto Kernel>
cudaError_t allow_vec_smem() {
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit & raised.load(std::memory_order_relaxed)) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(SMEM_VEC_MAX));
  if (e == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <typename T, bool CENTER>
int launch_norm_bwd(const void* x, const void* gamma, const void* mean,
                    const void* rstd, const void* dy, void* dx, void* part,
                    void* partb, void* dgamma, void* dbeta, int R, int N,
                    int threads, int rows, int blocks, int sum_warps,
                    int sum_vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* g = static_cast<const float*>(gamma);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  T* dxt = static_cast<T*>(dx);
  float* pt = static_cast<float*>(part);
  float* pb = static_cast<float*>(partb);
  const bool has_g = gamma != nullptr, has_b = partb != nullptr;
  const int parts = has_g + has_b;
  auto sums_ok = [&](const void* p, const void* out) {
    return p != nullptr && out != nullptr && aligned16(p) && aligned16(out);
  };
  if (blocks < 1 || rows < 1 || (CENTER != (mean != nullptr)) ||
      (!CENTER && (has_b || dbeta != nullptr)) ||
      (has_b != (dbeta != nullptr)) || (has_g && !sums_ok(part, dgamma)) ||
      (has_b && !sums_ok(partb, dbeta)) ||
      (parts && (sum_warps < 1 || sum_warps > CS_MAX_WARPS ||
                 (sum_vec != 1 && sum_vec != 4) || N % sum_vec != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (threads > 0) {
    const size_t smem = rows > 1 ? sizeof(float) * rows * parts * N : 0;
    if (!vec_plan_ok<T>(N, threads, x, gamma, dy, dx) ||
        rows * threads > BWD_VEC_THREADS || smem > SMEM_VEC_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    const int V = static_cast<int>(N * sizeof(T) / 16);
    auto kernel = CENTER ? layernorm_bwd_vec_kernel<T>
                         : rmsnorm_bwd_vec_kernel<T>;
    if (smem > SMEM_DEFAULT) {
      const cudaError_t e =
          CENTER ? allow_vec_smem<layernorm_bwd_vec_kernel<T>>()
                 : allow_vec_smem<rmsnorm_bwd_vec_kernel<T>>();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<blocks, rows * threads, smem, s>>>(xt, g, mu, rs, dyt, dxt, pt,
                                                pb, R, V, threads);
  } else if (N <= WARP_ROW_MAX) {
    const size_t smem = sizeof(float) * parts * rows * N;
    if (rows * 32 > MAX_THREADS || smem > SMEM_DEFAULT)
      return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (CENTER)
      layernorm_bwd_warp_kernel<T><<<blocks, rows * 32, smem, s>>>(
          xt, g, mu, rs, dyt, dxt, pt, pb, R, N);
    else
      rmsnorm_bwd_warp_kernel<T><<<blocks, rows * 32, smem, s>>>(
          xt, g, mu, rs, dyt, dxt, pt, pb, R, N);
  } else {
    if (rows != 1) return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (CENTER)
      layernorm_bwd_block_kernel<T><<<blocks, ROW_THREADS, 0, s>>>(
          xt, g, mu, rs, dyt, dxt, pt, pb, R, N);
    else
      rmsnorm_bwd_block_kernel<T><<<blocks, ROW_THREADS, 0, s>>>(
          xt, g, mu, rs, dyt, dxt, pt, pb, R, N);
  }
  int e = static_cast<int>(cudaGetLastError());
  if (e == 0 && parts) {   // dgamma's and dbeta's sums in one launch
    const float* p0 = has_g ? pt : pb;
    float* o0 = static_cast<float*>(has_g ? dgamma : dbeta);
    e = column_sum(p0, o0, has_g && has_b ? pb : nullptr,
                   has_g && has_b ? static_cast<float*>(dbeta) : nullptr,
                   blocks, N, sum_warps, sum_vec, s);
  }
  return e;
}

}  // namespace

// Plain C entry points for ctypes, on contiguous operands.  Each returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a plan the kernels do not take.

// slots > 0: the warp kernel (see warp_plan); 0: the block kernel.
extern "C" int sfu_softmax_f32(const void* x, void* y, int R, int N,
                               int slots, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  if (slots > 0) {
    if (!warp_plan_ok<float>(N, slots, vec, x, nullptr, nullptr, y))
      return static_cast<int>(cudaErrorInvalidValue);
    return with_slots<float>(slots, vec, [&](auto s, auto v) {
      softmax_warp_kernel<decltype(s)::value, decltype(v)::value>
          <<<warp_blocks(R), ROW_WARPS * 32, 0, st>>>(xf, yf, R, N);
    });
  }
  softmax_rows_kernel<<<R, ROW_THREADS, 0, st>>>(xf, yf, N);
  return static_cast<int>(cudaGetLastError());
}

// gamma and beta may be null; x and y are fp32 (f32) or bf16 (bf16),
// gamma and beta fp32; mean and rstd (R floats each, both or neither)
// take each row's mean and 1 / sqrt(variance + eps) for the backward.
// threads, slots, vec: the wrapper's plan (see launch_layernorm).
extern "C" int sfu_layernorm_f32(const void* x, const void* gamma,
                                 const void* beta, void* y, void* mean,
                                 void* rstd, int R, int N, float eps,
                                 int threads, int slots, int vec,
                                 void* stream) {
  return launch_layernorm<float>(x, gamma, beta, y, mean, rstd, R, N, eps,
                                 threads, slots, vec, stream);
}

extern "C" int sfu_layernorm_bf16(const void* x, const void* gamma,
                                  const void* beta, void* y, void* mean,
                                  void* rstd, int R, int N, float eps,
                                  int threads, int slots, int vec,
                                  void* stream) {
  return launch_layernorm<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, R, N,
                                         eps, threads, slots, vec, stream);
}

// vector 0: one element a thread (x or y not 16-byte aligned); else the
// float4 kernel.
extern "C" int sfu_act_f32(const void* x, void* y, long long n, int act,
                           int vector, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const size_t nz = static_cast<size_t>(n);
  if (!vector) {
    const unsigned blocks =
        static_cast<unsigned>((nz + ACT_THREADS - 1) / ACT_THREADS);
    act_kernel<<<blocks, ACT_THREADS, 0, s>>>(xf, yf, nz, act);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t nv = nz / 4;
  const unsigned blocks = static_cast<unsigned>(
      nv == 0 ? 1 : (nv + ACT_THREADS - 1) / ACT_THREADS);
  switch (act) {
    case ACT_GELU: act_vec_kernel<ACT_GELU><<<blocks, ACT_THREADS, 0, s>>>(xf, yf, nz); break;
    case ACT_RELU: act_vec_kernel<ACT_RELU><<<blocks, ACT_THREADS, 0, s>>>(xf, yf, nz); break;
    case ACT_RELU2: act_vec_kernel<ACT_RELU2><<<blocks, ACT_THREADS, 0, s>>>(xf, yf, nz); break;
    case ACT_SILU: act_vec_kernel<ACT_SILU><<<blocks, ACT_THREADS, 0, s>>>(xf, yf, nz); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// gamma and rstd may be null; x and y are fp32 (f32) or bf16 (bf16),
// gamma fp32; rstd, where given, takes each row's 1 / sqrt(mean square +
// eps) in fp32.  threads: the wrapper's plan (see launch_rmsnorm).
extern "C" int sfu_rmsnorm_f32(const void* x, const void* gamma, void* y,
                               void* rstd, int R, int N, float eps,
                               int threads, void* stream) {
  return launch_rmsnorm<float>(x, gamma, y, rstd, R, N, eps, threads,
                               stream);
}

extern "C" int sfu_rmsnorm_bf16(const void* x, const void* gamma, void* y,
                                void* rstd, int R, int N, float eps,
                                int threads, void* stream) {
  return launch_rmsnorm<__nv_bfloat16>(x, gamma, y, rstd, R, N, eps,
                                       threads, stream);
}

// rmsnorm's backward: dx (x's type) from x, gamma (may be null), the
// forward's rstd and dy (x's type); with gamma, part (blocks x N fp32
// scratch, 16-byte aligned) takes each block's column sums of dy * x *
// rstd and dgamma (N fp32, 16-byte aligned) their sum over the blocks;
// every column of dgamma is written.  threads, rows, blocks, sum_warps,
// sum_vec: the wrapper's plan (see launch_norm_bwd).
extern "C" int sfu_rmsnorm_bwd_f32(const void* x, const void* gamma,
                                   const void* rstd, const void* dy,
                                   void* dx, void* part, void* dgamma, int R,
                                   int N, int threads, int rows, int blocks,
                                   int sum_warps, int sum_vec, void* stream) {
  return launch_norm_bwd<float, false>(x, gamma, nullptr, rstd, dy, dx, part,
                                       nullptr, dgamma, nullptr, R, N,
                                       threads, rows, blocks, sum_warps,
                                       sum_vec, stream);
}

extern "C" int sfu_rmsnorm_bwd_bf16(const void* x, const void* gamma,
                                    const void* rstd, const void* dy,
                                    void* dx, void* part, void* dgamma,
                                    int R, int N, int threads, int rows,
                                    int blocks, int sum_warps, int sum_vec,
                                    void* stream) {
  return launch_norm_bwd<__nv_bfloat16, false>(
      x, gamma, nullptr, rstd, dy, dx, part, nullptr, dgamma, nullptr, R, N,
      threads, rows, blocks, sum_warps, sum_vec, stream);
}

// layernorm's backward: dx (x's type) from x, gamma and beta (each may be
// null), the forward's mean and rstd and dy (x's type); with gamma, part
// (blocks x N fp32 scratch, 16-byte aligned) takes each block's column sums
// of dy * (x - mean) * rstd and dgamma (N fp32, 16-byte aligned) their sum
// over the blocks; with beta, partb and dbeta the same for dy (beta itself
// is not read: pass partb and dbeta, or null for neither).  Every column of
// dgamma and dbeta is written.  threads, rows, blocks, sum_warps, sum_vec:
// the wrapper's plan (see launch_norm_bwd).
extern "C" int sfu_layernorm_bwd_f32(const void* x, const void* gamma,
                                     const void* mean, const void* rstd,
                                     const void* dy, void* dx, void* part,
                                     void* partb, void* dgamma, void* dbeta,
                                     int R, int N, int threads, int rows,
                                     int blocks, int sum_warps, int sum_vec,
                                     void* stream) {
  return launch_norm_bwd<float, true>(x, gamma, mean, rstd, dy, dx, part,
                                      partb, dgamma, dbeta, R, N, threads,
                                      rows, blocks, sum_warps, sum_vec,
                                      stream);
}

extern "C" int sfu_layernorm_bwd_bf16(const void* x, const void* gamma,
                                      const void* mean, const void* rstd,
                                      const void* dy, void* dx, void* part,
                                      void* partb, void* dgamma, void* dbeta,
                                      int R, int N, int threads, int rows,
                                      int blocks, int sum_warps, int sum_vec,
                                      void* stream) {
  return launch_norm_bwd<__nv_bfloat16, true>(
      x, gamma, mean, rstd, dy, dx, part, partb, dgamma, dbeta, R, N,
      threads, rows, blocks, sum_warps, sum_vec, stream);
}
