// flash_attention: grouped-query attention with an online softmax, as a
// hand-written Hopper kernel.
//
// Replaces the Pallas TPU kernel `_attn_kernel`
// (src/repro/kernels/flash_attention.py:28): o = softmax(q k^T / sqrt(D)) v
// for q (B, Hq, Sq, D), k and v (B, Hkv, *, D), query head h reading KV
// head h / (Hq / Hkv).  Query i sees key j when j < Skv and, if causal,
// j <= i + (Skv - Sq).  Masked scores are -1e30, masked probabilities
// 0, K/V rows past Skv are zeroed at the load (0 * NaN would poison
// p @ v), and a row with no visible key gives 0.  fp32 arithmetic, output
// in q's type (fp32 or bf16).
//
// The TPU kernel walks its KV blocks along a sequential fourth grid axis
// and carries the running max, sum and output accumulator in VMEM
// scratch.  Here blocks run in parallel and in no order, so one block owns
// one (batch, query head, BQ-row query tile) and loops over the KV tiles
// itself; the running max and sum of its rows and the fp32 (BQ, D)
// accumulator stay in registers for the whole loop.  K and V of a tile are
// staged in shared memory as fp32, read by every query row of the tile.
// GQA needs no copy: the block indexes KV head h / group directly.  Decode
// passes the cache (B, Hkv, max_len, D) with Skv = pos + 1 and a KV row
// stride of max_len, so it reads the first pos + 1 rows in place.
// Causal tiles stop at the last key the tile's last row can see.
//
// Loads: a thread stages its share of a Q, K or V tile with 16-byte
// loads, all issued before its first shared-memory store (the operands
// must be 16-byte aligned; the wrapper checks).  Rows past Skv are
// zero-filled, never read.
//
// Work split: 256 threads as a 16 x 16 grid; a thread owns rows
// ty + 16 i of the tile, score columns tx + 16 j and output columns
// tx + 16 j, so a row's 16 threads share a half warp and reduce its max
// and sum with four shuffles.  Shared rows are padded by one float so the
// column reads of K hit 16 different banks.  Prefill tiles are 64 query
// rows by 32 keys (74.5 KB of shared memory at D = 128, three blocks an
// SM); a query length of at most 16 (decode) takes 16-row tiles by 64
// keys, so a thread does one row's work, not four rows of padding.
//
// Bound on the H100: at the serving shapes, prefill is bound by its
// bf16 tensor-core operations or its bytes (whichever chip_smoke.py's
// count makes larger) and decode by the bytes of the KV cache it reads.
// This kernel computes with fp32 FMA on the CUDA cores (no mma, wgmma or
// TMA): it is the simple kernel that is right, and far from the prefill
// bound; tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of T at src (16-byte aligned) as VEC<T> floats.
template <typename T>
constexpr int VEC = 16 / sizeof(T);

__device__ __forceinline__ void load16(const float* src, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* v) {
  const uint4 t = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Stages rows [r0, r0 + ROWS) of the NM row-major (*, D) matrices src[m]
// into shared memory as fp32 rows of D + 1 floats, times `scale`; rows at
// or past `limit` are zero.  Each thread issues all its 16-byte loads
// before its first shared store, so a tile costs one memory latency, not
// one per element.
template <typename T, int D, int ROWS, int NM>
__device__ __forceinline__ void stage(const T* const (&src)[NM],
                                      float* const (&dst)[NM], int r0,
                                      int limit, float scale) {
  constexpr int V = VEC<T>, PER_ROW = D / V, N = ROWS * PER_ROW;
  constexpr int ITERS = (N + THREADS - 1) / THREADS;
  float v[NM][ITERS][V];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / PER_ROW, d = (i % PER_ROW) * V;
    const bool in = (N % THREADS == 0 || i < N) && r0 + r < limit;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      if (in) {
        load16(src[m] + (size_t)(r0 + r) * D + d, v[m][it]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[m][it][e] = 0.0f;
      }
    }
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (N % THREADS != 0 && i >= N) continue;
    const int r = i / PER_ROW, d = (i % PER_ROW) * V;
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int e = 0; e < V; ++e)
        dst[m][r * (D + 1) + d + e] = v[m][it][e] * scale;
  }
}

// Reduce over the 16 lanes of a half warp (the 16 threads of one row).
template <bool IS_MAX>
__device__ __forceinline__ float row_reduce(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = IS_MAX ? fmaxf(v, w) : v + w;
  }
  return v;
}

template <int D, int BQ, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int Hkv, int Sq, int Skv, int kv_stride, int causal,
                       float scale) {
  constexpr int RPT = BQ / 16;  // query rows per thread
  constexpr int CPT = BK / 16;  // key columns per thread
  constexpr int DPT = D / 16;   // output columns per thread
  constexpr int LD = D + 1;     // padded row of Qs / Ks / Vs
  constexpr int LP = BK + 1;    // padded row of Ps
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x LD, pre-scaled
  float* Ks = Qs + BQ * LD;     // BK x LD
  float* Vs = Ks + BK * LD;     // BK x LD
  float* Ps = Vs + BK * LD;     // BQ x LP, this tile's probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qh = q + ((size_t)b * Hq + h) * Sq * D;
  T* oh = o + ((size_t)b * Hq + h) * Sq * D;
  const T* kh = k + ((size_t)b * Hkv + hk) * kv_stride * D;
  const T* vh = v + ((size_t)b * Hkv + hk) * kv_stride * D;
  const int offset = Skv - Sq;  // causal: row i sees keys <= i + offset

  {
    const T* const src[1] = {qh};
    float* const dst[1] = {Qs};
    stage<T, D, BQ, 1>(src, dst, q0, Sq, scale);
  }
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + BQ, Sq) + offset);

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.0f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the last tile's Ks / Vs / Ps are read
    {
      const T* const src[2] = {kh, vh};
      float* const dst[2] = {Ks, Vs};
      stage<T, D, BK, 2>(src, dst, k0, Skv, 1.0f);
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[CPT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Skv && (!causal || kpos <= qpos + offset);
        if (!ok[j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_reduce<true>(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_reduce<false>(sum);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float vv[DPT];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) vv[jd] = Vs[c * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(ty + 16 * i) * LP + c];
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = fmaf(p, vv[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];  // empty row -> 0
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd)
      store(oh + (size_t)qpos * D + tx + 16 * jd, acc[i][jd] / denom);
  }
}

template <typename T, int D, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int kv_stride, int causal,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BQ, BK>();
  auto kernel = flash_attention_kernel<T, D, BQ, BK>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv,
      kv_stride, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_tiles(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, int kv_stride, int causal,
                 float scale, cudaStream_t stream) {
  if (Sq <= 16)
    return launch<T, D, 16, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, kv_stride,
                                causal, scale, stream);
  return launch<T, D, 64, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, kv_stride,
                              causal, scale, stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Skv, int kv_stride, int D,
             int causal, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_tiles<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, kv_stride,
                                 causal, scale, s);
    case 32:
      return launch_tiles<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, kv_stride,
                                 causal, scale, s);
    case 64:
      return launch_tiles<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, kv_stride,
                                 causal, scale, s);
    case 128:
      return launch_tiles<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, kv_stride,
                                  causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points for ctypes.  q, o: (B, Hq, Sq, D) contiguous;
// k, v: (B, Hkv, kv_stride, D) contiguous, of which rows [0, Skv) are
// read; q, k and v 16-byte aligned.  D is one of 16, 32, 64, 128.  Each returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int Hq,
                                   int Hkv, int Sq, int Skv, int kv_stride,
                                   int D, int causal, float scale,
                                   void* stream) {
  return dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, kv_stride, D,
                         causal, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int Sq, int Skv, int kv_stride,
                                    int D, int causal, float scale,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, kv_stride,
                                 D, causal, scale, stream);
}
