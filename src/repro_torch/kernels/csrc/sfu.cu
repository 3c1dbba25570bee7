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
// rmsnorm serves the decoder's norms: rows of d_model (2560 for
// qwen3-4b) and the q/k-norm rows of head_dim (128), 40 of them per
// token and layer.  A 256-thread block on a 128-wide row would leave half
// its threads idle and cost a block per row, so rows up to WARP_ROW_MAX
// wide get one warp each (8 rows per block, shuffles only, no shared
// memory); wider rows get the block-per-row kernel.  Bound: bytes, one
// read and one write of the row (the second pass over the row hits L1).

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

__global__ void __launch_bounds__(ACT_THREADS)
act_kernel(const float* __restrict__ x, float* __restrict__ y, size_t n,
           int act) {
  const size_t i = (size_t)blockIdx.x * ACT_THREADS + threadIdx.x;
  if (i < n) y[i] = activate(x[i], act);
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

// One block per row, for wider rows.
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

template <typename T>
int launch_rmsnorm(const void* x, const void* gamma, void* y, int R, int N,
                   float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  T* yt = static_cast<T*>(y);
  if (N <= WARP_ROW_MAX) {
    rmsnorm_warp_kernel<T><<<(R + WARP_ROWS - 1) / WARP_ROWS,
                             WARP_ROWS * 32, 0, s>>>(xt, g, yt, R, N, eps);
  } else {
    rmsnorm_block_kernel<T><<<R, ROW_THREADS, 0, s>>>(xt, g, yt, N, eps);
  }
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

extern "C" int sfu_act_f32(const void* x, void* y, long long n, int act,
                           void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + ACT_THREADS - 1) / ACT_THREADS);
  act_kernel<<<blocks, ACT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<size_t>(n), act);
  return static_cast<int>(cudaGetLastError());
}

// gamma may be null; x and y are fp32 (f32) or bf16 (bf16), gamma fp32.
extern "C" int sfu_rmsnorm_f32(const void* x, const void* gamma, void* y,
                               int R, int N, float eps, void* stream) {
  return launch_rmsnorm<float>(x, gamma, y, R, N, eps, stream);
}

extern "C" int sfu_rmsnorm_bf16(const void* x, const void* gamma, void* y,
                                int R, int N, float eps, void* stream) {
  return launch_rmsnorm<__nv_bfloat16>(x, gamma, y, R, N, eps, stream);
}
