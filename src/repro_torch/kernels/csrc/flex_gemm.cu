// flex_gemm: DORA's MMU (paper §3.3) as a hand-written Hopper kernel.
//
// Replaces the Pallas TPU kernel `_flex_gemm_kernel`
// (src/repro/kernels/flex_gemm.py:58): C = epi(A @ B + c_in + bias), fp32
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
// Bound on the H100: fp32 FMA throughput (67 TFLOP/s) for the paper
// workloads' tiles (BERT-L's do 40-200 FLOP per byte moved).  What held
// the first kernel back was the grid, not the arithmetic: BERT-L's
// compiler emits tiles of 256..512 x 192..768 outputs, 16-96 blocks of
// 64 x 64 on 132 SMs, each block loading and computing in turn.  So:
//
// - Blocks: 64 x 64 outputs, 128 threads, each thread an 8 x 4 register
//   tile; a thread reads 4 k-steps of its 8 A rows as one float4 each and
//   one float4 of B per k-step, 12 shared loads for 128 FMAs.
// - Pipeline: 16-deep K tiles of A and B go through a 3-stage ring in
//   shared memory by 16-byte cp.async copies, two tiles in flight while
//   one computes, one __syncthreads a tile.  The copies need K and N to be
//   multiples of 4 and 16-byte aligned fp32 operands; other shapes and
//   bf16 take a variant that stages by scalar loads (widening bf16),
//   chosen by shape and type in the C dispatch.
// - Split-K: where the output has too few blocks to fill the card,
//   gemm_plan (kernels/flex_gemm.py) cuts K into slabs of whole tiles,
//   as many as its cost model (waves of blocks on 132 SMs times the slab
//   depth, plus the reduce) prices lowest; one block per (output block,
//   slab), each writing its fp32 partial sum to a workspace (splits, M,
//   N).  A second kernel adds the slabs in slab order (no atomics: the
//   same result every run) and only then applies the epilogue, c_in +
//   acc, + bias, activation, cast, as runtime.py does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "act.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 8;
constexpr int TN = 4;
constexpr int STAGES = 3;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128
constexpr int LDA = BK + 4;  // As row: 16-byte aligned, rows 80 bytes apart

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float epilogue(float acc, const float* c_in,
                                          const float* bias, size_t o,
                                          int gn, int act) {
  float v = acc;
  if (c_in != nullptr) v = c_in[o] + v;
  if (bias != nullptr) v += bias[gn];
  return activate(v, act);
}
__device__ __forceinline__ float epilogue(float acc,
                                          const __nv_bfloat16* c_in,
                                          const __nv_bfloat16* bias, size_t o,
                                          int gn, int act) {
  float v = acc;
  if (c_in != nullptr) v = __bfloat162float(c_in[o]) + v;
  if (bias != nullptr) v += __bfloat162float(bias[gn]);
  return activate(v, act);
}

// Stages K tile `kt` of A (rows row0.., as [m][k]) and B (columns col0..,
// as [k][n]) into one stage of the ring; out-of-range elements are zero.
// VEC: 16-byte cp.async copies (fp32, K and N multiples of 4); else scalar
// loads, widened to fp32.
template <bool VEC, typename T>
__device__ __forceinline__ void stage_tile(float (*As)[LDA], float (*Bs)[BN],
                                           const T* A, const T* B, int M,
                                           int K, int N, int row0, int col0,
                                           int kt) {
  const int tid = threadIdx.x, k0 = kt * BK;
  if constexpr (VEC) {
#pragma unroll
    for (int it = 0; it < BM * BK / 4 / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      const bool in = row0 + r < M && k0 + c < K;
      cp_async16(&As[r][c], in ? A + (size_t)(row0 + r) * K + k0 + c : A, in);
    }
#pragma unroll
    for (int it = 0; it < BK * BN / 4 / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const bool in = k0 + r < K && col0 + c < N;
      cp_async16(&Bs[r][c], in ? B + (size_t)(k0 + r) * N + col0 + c : B, in);
    }
  } else {
#pragma unroll
    for (int it = 0; it < BM * BK / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / BK, c = i % BK;
      const bool in = row0 + r < M && k0 + c < K;
      As[r][c] = in ? to_f32(A[(size_t)(row0 + r) * K + k0 + c]) : 0.0f;
    }
#pragma unroll
    for (int it = 0; it < BK * BN / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / BN, c = i % BN;
      const bool in = k0 + r < K && col0 + c < N;
      Bs[r][c] = in ? to_f32(B[(size_t)(k0 + r) * N + col0 + c]) : 0.0f;
    }
  }
}

// One block per (64-column block, 64-row block, K slab).  ws == nullptr:
// the whole K in one slab, epilogue here; else the slab's fp32 partial
// goes to ws[blockIdx.z] (M x N) and split_k_reduce applies the epilogue.
template <bool VEC, typename T>
__global__ void __launch_bounds__(THREADS)
flex_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 const T* __restrict__ c_in, const T* __restrict__ bias,
                 T* __restrict__ C, float* __restrict__ ws, int M, int K,
                 int N, int act, int tiles_per_split) {
  __shared__ __align__(16) float As[STAGES][BM][LDA];
  __shared__ __align__(16) float Bs[STAGES][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // columns tx * 4 .. + 3
  const int ty = tid / (BN / TN);  // rows ty * 8 .. + 7
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int n_kt = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int nt = max(0, min(n_kt, kt0 + tiles_per_split) - kt0);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt)
      stage_tile<VEC>(As[s], Bs[s], A, B, M, K, N, row0, col0, kt0 + s);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; tile t - 1's stage is free
    const int next = t + STAGES - 1;
    if (next < nt)
      stage_tile<VEC>(As[next % STAGES], Bs[next % STAGES], A, B, M, K, N,
                      row0, col0, kt0 + next);
    cp_async_commit();
    const int s = t % STAGES;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(&As[s][ty * TM + i][k4]);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[s][k4 + kk][tx * TN]);
        const float b[TN] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  const int gn0 = col0 + tx * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
    if (gm >= M) continue;
    const size_t o = (size_t)gm * N + gn0;
    if (ws != nullptr) {
      float* part = ws + (size_t)blockIdx.z * M * N + o;
      if (VEC && gn0 < N) {
        *reinterpret_cast<float4*>(part) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (gn0 + j < N) part[j] = acc[i][j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (gn0 + j < N)
          store(&C[o + j], epilogue(acc[i][j], c_in, bias, o + j, gn0 + j, act));
    }
  }
}

// Sums the `splits` slabs of ws in slab order, then the epilogue.
template <typename T>
__global__ void __launch_bounds__(256)
split_k_reduce_kernel(const float* __restrict__ ws, const T* __restrict__ c_in,
                      const T* __restrict__ bias, T* __restrict__ C, int M,
                      int N, int splits, int act) {
  const size_t MN = (size_t)M * N;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < MN;
       o += (size_t)gridDim.x * blockDim.x) {
    float v = ws[o];
    for (int z = 1; z < splits; ++z) v += ws[z * MN + o];
    store(&C[o], epilogue(v, c_in, bias, o, static_cast<int>(o % N), act));
  }
}

template <bool VEC, typename T>
int launch(const void* a, const void* b, const void* c_in, const void* bias,
           void* out, void* ws, int M, int K, int N, int act,
           int tiles_per_split, int splits, cudaStream_t stream) {
  if (splits < 1 || tiles_per_split < 1 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  flex_gemm_kernel<VEC, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c_in), static_cast<const T*>(bias),
      static_cast<T*>(out), part, M, K, N, act, tiles_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t MN = (size_t)M * N;
  const int blocks = static_cast<int>(
      MN / 256 + 1 < 4096 ? MN / 256 + 1 : 4096);
  split_k_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      part, static_cast<const T*>(c_in), static_cast<const T*>(bias),
      static_cast<T*>(out), M, N, splits, act);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry points for ctypes.  `c_in` and `bias` may be null; `ws` is
// an fp32 workspace of splits * M * N floats, read only when splits > 1.
// K is cut into `splits` slabs of `tiles_per_split` 16-deep tiles
// (gemm_plan in kernels/flex_gemm.py).  fp32 operands with K and N
// multiples of 4 and A, B, out 16-byte aligned take the cp.async kernel,
// the rest the scalar-staged one.  Each returns cudaGetLastError() after
// its launches (0 = launched).
extern "C" int flex_gemm_f32(const void* a, const void* b, const void* c_in,
                             const void* bias, void* out, void* ws, int M,
                             int K, int N, int act, int tiles_per_split,
                             int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 4 == 0 && N % 4 == 0 && aligned16(a) && aligned16(b) &&
      aligned16(out) && aligned16(ws))
    return launch<true, float>(a, b, c_in, bias, out, ws, M, K, N, act,
                               tiles_per_split, splits, s);
  return launch<false, float>(a, b, c_in, bias, out, ws, M, K, N, act,
                              tiles_per_split, splits, s);
}

extern "C" int flex_gemm_bf16(const void* a, const void* b, const void* c_in,
                              const void* bias, void* out, void* ws, int M,
                              int K, int N, int act, int tiles_per_split,
                              int splits, void* stream) {
  return launch<false, __nv_bfloat16>(a, b, c_in, bias, out, ws, M, K, N,
                                      act, tiles_per_split, splits,
                                      static_cast<cudaStream_t>(stream));
}
