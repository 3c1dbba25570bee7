// SFU row kernels: DORA's special-function unit (paper §3.5) on Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/sfu.py:
//   softmax_rows   <- `_softmax_kernel`   (max-subtracted, fp32)
//   layernorm_rows <- `_layernorm_kernel` (population variance, optional
//                                           gamma and/or beta)
//   act_rows       <- `_gelu_kernel`, and the element-wise SFU_RELU /
//                     SFU_RELU2 / SFU_SILU ops of the runtime
//   rmsnorm_rows   <- `_rmsnorm_kernel` (src/repro/kernels/sfu.py:56;
//                     x * rsqrt(sum(x^2)/N + eps) * gamma, fp32 or bf16
//                     rows, fp32 gamma, fp32 arithmetic, output in x's
//                     type)
//
// Bound on the H100: device-memory bytes (a few FLOP per element).  The
// TPU kernels hold `block_rows` whole rows in VMEM and mask the lanes past
// the true width; here one 256-thread block owns one row, strides over its
// true width N (nothing to mask: no thread reads past N), and reduces with
// warp shuffles and one shared-memory exchange.  A row is read three times
// (max/sum/write or mean/var/write); rows of the paper workloads are at
// most a few KB, so the re-reads hit L1/L2 and device memory sees about
// one read and one write per element.
//
// rmsnorm serves the decoder's norms: rows of d_model (2560 for qwen3-4b
// and mamba2-2.7b, 6144 for internlm2-20b), mamba2's gated-norm rows (5120)
// and the q/k-norm rows of head_dim (128), 40 of them per token and layer.
// Bound: bytes, one read and one write of the row.  Rows up to
// WARP_ROW_MAX wide get one warp each (8 rows per block, shuffles only).
// Wider rows whose x, y and gamma are 16-byte aligned, with a row of a
// whole number of 16-byte vectors, take the one-pass kernel: a block a
// row, each thread loads its ROW_VPT vectors of the row (uint4: 8 bf16 or
// 4 fp32) into registers, the row's sum of squares is reduced in a fixed
// order (warp shuffles, then the row's warps in order, so a repeated call
// gives the same bits), and the thread scales its registers by gamma
// (float4 loads) and writes 16-byte stores: x is read from memory once.
// Two vectors a thread cover every served width (2560 to 6144, bf16 or
// fp32) with at most 768 threads; rows wider than ROW_VPT * 1,024 vectors,
// unaligned or ragged rows take the scalar two-pass block kernel.
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

#include "act.cuh"

namespace {

constexpr int ROW_THREADS = 256;
constexpr int ACT_THREADS = 256;
constexpr int WARP_ROW_MAX = 1024;
constexpr int WARP_ROWS = 8;   // rows (warps) per block of the warp kernel
constexpr int MAX_THREADS = 1024;
constexpr int ROW_VPT = 2;     // 16-byte vectors a thread, one-pass kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

// Reduce over the block; every thread gets the result.
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

__global__ void __launch_bounds__(ROW_THREADS)
layernorm_rows_kernel(const float* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* __restrict__ y,
                      int N, float eps) {
  const float* xr = x + (size_t)blockIdx.x * N;
  float* yr = y + (size_t)blockIdx.x * N;
  const float n = static_cast<float>(N);
  float s = 0.0f;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) s += xr[j];
  const float mu = block_reduce<false>(s) / n;
  float ss = 0.0f;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) {
    const float d = xr[j] - mu;
    ss += d * d;
  }
  const float rstd = rsqrtf(block_reduce<false>(ss) / n + eps);
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) {
    float v = (xr[j] - mu) * rstd;
    if (gamma != nullptr) v *= gamma[j];
    if (beta != nullptr) v += beta[j];
    yr[j] = v;
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
                    T* __restrict__ y, int R, int N, float eps) {
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
                     T* __restrict__ y, int N, float eps) {
  const T* xr = x + (size_t)blockIdx.x * N;
  T* yr = y + (size_t)blockIdx.x * N;
  float ss = 0.0f;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) {
    const float v = to_f32(xr[j]);
    ss += v * v;
  }
  const float r =
      rsqrtf(block_reduce<false>(ss) / static_cast<float>(N) + eps);
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) {
    float v = to_f32(xr[j]) * r;
    if (gamma != nullptr) v *= gamma[j];
    store(yr + j, v);
  }
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

// One pass over rows of V 16-byte vectors, a block a row of blockDim.x
// threads (whole warps); thread t holds the row's vectors t and
// t + blockDim.x in registers between the reduction and the write.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_vec_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   T* __restrict__ y, int V, float eps) {
  using P = Vec16<T>;
  __shared__ float part[MAX_THREADS / 32];   // one sum per warp of the row
  const uint4* xr = reinterpret_cast<const uint4*>(x) + (size_t)blockIdx.x * V;
  uint4 u[ROW_VPT];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < ROW_VPT; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < V) u[k] = __ldg(xr + j);
  }
#pragma unroll
  for (int k = 0; k < ROW_VPT; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < V) {
      float f[P::E];
      P::unpack(u[k], f);
#pragma unroll
      for (int e = 0; e < P::E; ++e) ss += f[e] * f[e];
    }
  }
  // the row's warps sum their partials in warp order: the same bits on
  // every call
  ss = warp_reduce<false>(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += part[w];
  const float r = rsqrtf(total / static_cast<float>(V * P::E) + eps);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  uint4* yr = reinterpret_cast<uint4*>(y) + (size_t)blockIdx.x * V;
#pragma unroll
  for (int k = 0; k < ROW_VPT; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < V) {
      float f[P::E];
      P::unpack(u[k], f);
#pragma unroll
      for (int e = 0; e < P::E; ++e) f[e] *= r;
      if (gamma != nullptr) {
#pragma unroll
        for (int q = 0; q < P::E / 4; ++q) {
          const float4 g = __ldg(g4 + j * (P::E / 4) + q);
          f[4 * q] *= g.x;
          f[4 * q + 1] *= g.y;
          f[4 * q + 2] *= g.z;
          f[4 * q + 3] *= g.w;
        }
      }
      yr[j] = P::pack(f);
    }
  }
}

// threads 0: the scalar kernels (a warp a row up to WARP_ROW_MAX wide, else
// a block a row); else the one-pass kernel with `threads` threads a row of
// N * sizeof(T) / 16 vectors.
template <typename T>
int launch_rmsnorm(const void* x, const void* gamma, void* y, int R, int N,
                   float eps, int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  T* yt = static_cast<T*>(y);
  if (threads == 0) {
    if (N <= WARP_ROW_MAX) {
      rmsnorm_warp_kernel<T><<<(R + WARP_ROWS - 1) / WARP_ROWS,
                               WARP_ROWS * 32, 0, s>>>(xt, g, yt, R, N, eps);
    } else {
      rmsnorm_block_kernel<T><<<R, ROW_THREADS, 0, s>>>(xt, g, yt, N, eps);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int V = static_cast<int>(N * sizeof(T) / 16);
  if ((N * sizeof(T)) % 16 != 0 || threads % 32 != 0 ||
      threads > MAX_THREADS || (long long)threads * ROW_VPT < V) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rmsnorm_vec_kernel<T><<<R, threads, 0, s>>>(xt, g, yt, V, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes, all fp32 and contiguous.  Each returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int sfu_softmax_f32(const void* x, void* y, int R, int N,
                               void* stream) {
  softmax_rows_kernel<<<R, ROW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sfu_layernorm_f32(const void* x, const void* gamma,
                                 const void* beta, void* y, int R, int N,
                                 float eps, void* stream) {
  layernorm_rows_kernel<<<R, ROW_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(y), N, eps);
  return static_cast<int>(cudaGetLastError());
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

// gamma may be null; x and y are fp32 (f32) or bf16 (bf16), gamma fp32.
// threads: the wrapper's plan (see launch_rmsnorm).
extern "C" int sfu_rmsnorm_f32(const void* x, const void* gamma, void* y,
                               int R, int N, float eps, int threads,
                               void* stream) {
  return launch_rmsnorm<float>(x, gamma, y, R, N, eps, threads, stream);
}

extern "C" int sfu_rmsnorm_bf16(const void* x, const void* gamma, void* y,
                                int R, int N, float eps, int threads,
                                void* stream) {
  return launch_rmsnorm<__nv_bfloat16>(x, gamma, y, R, N, eps, threads,
                                       stream);
}
