// flex_gemm: DORA's MMU (paper §3.3) as a hand-written Hopper kernel.
//
// Replaces the Pallas TPU kernel `_flex_gemm_kernel`
// (src/repro/kernels/flex_gemm.py): C = epi(A @ B + c_in + bias), fp32
// accumulation, output in A's dtype.
//
// Dynamic bounds: M, K and N are kernel arguments, so one compiled program
// serves every MMU_GEMM instruction of a DORA binary (the paper's resident
// kernel with run-time loop bounds).  The ragged edges of every tile are
// masked at the global loads (zero fill) and at the store, never padded in
// device memory.
//
// Arithmetic: fp32 FMA on the CUDA cores with an fp32 accumulator, not
// TF32: the reference holds fp32 products to 2e-5*sqrt(K).  bf16 operands
// are widened to fp32 when staged into shared memory.
//
// Bound on the H100: fp32 FMA throughput (67 TFLOP/s) for the large tiles
// of the paper workloads (BERT-L's tiles do 40-200 FLOP per byte moved).
// Design: a 64x64 output block per 256 threads, each thread owning a 4x4
// register tile; a BK=16 slab of A (stored transposed) and B sits in shared
// memory and every thread reads one float4 of each per k step, so each
// shared load feeds 4 FMAs.  The small block keeps enough blocks in flight
// for BERT-L's 256..768-wide tiles (a 512x768 tile is 96 blocks).  No
// software pipeline, wgmma or TMA yet: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "act.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flex_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 const T* __restrict__ c_in, const T* __restrict__ bias,
                 T* __restrict__ C, int M, int K, int N, int act) {
  // A is kept transposed ([k][m]) so a thread's 4 rows are one float4;
  // the +4 pad keeps rows 16-byte aligned and halves store conflicts.
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int m = idx / BK, kk = idx % BK;
      const int gm = row0 + m, gk = k0 + kk;
      As[kk][m] = (gm < M && gk < K) ? to_f32(A[(size_t)gm * K + gk]) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int kk = idx / BN, n = idx % BN;
      const int gk = k0 + kk, gn = col0 + n;
      Bs[kk][n] = (gk < K && gn < N) ? to_f32(B[(size_t)gk * N + gn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: accumulate-then-activate, as runtime.py applies it.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx * TN + j;
      if (gn >= N) continue;
      const size_t o = (size_t)gm * N + gn;
      float v = acc[i][j];
      if (c_in != nullptr) v = to_f32(c_in[o]) + v;
      if (bias != nullptr) v += to_f32(bias[gn]);
      store(&C[o], activate(v, act));
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* c_in, const void* bias,
           void* out, int M, int K, int N, int act, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  flex_gemm_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c_in), static_cast<const T*>(bias),
      static_cast<T*>(out), M, K, N, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  `c_in` and `bias` may be null.  Each
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flex_gemm_f32(const void* a, const void* b, const void* c_in,
                             const void* bias, void* out, int M, int K, int N,
                             int act, void* stream) {
  return launch<float>(a, b, c_in, bias, out, M, K, N, act, stream);
}

extern "C" int flex_gemm_bf16(const void* a, const void* b, const void* c_in,
                              const void* bias, void* out, int M, int K, int N,
                              int act, void* stream) {
  return launch<__nv_bfloat16>(a, b, c_in, bias, out, M, K, N, act, stream);
}
