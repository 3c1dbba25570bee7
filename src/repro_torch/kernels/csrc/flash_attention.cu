// flash_attention: grouped-query attention with an online softmax, as
// hand-written Hopper kernels.
//
// Replaces the Pallas TPU kernel `_attn_kernel`
// (src/repro/kernels/flash_attention.py:28): o = softmax(q k^T / sqrt(D)) v
// for q (B, Hq, Sq, D), k and v (B, Hkv, *, D), query head h reading KV
// head h / (Hq / Hkv).  Query i sees key j when j < Skv and, if causal,
// j <= i + (Skv - Sq).  Masked scores are -1e30, masked probabilities are
// selected as 0 (never exp of a masked score), K/V rows past Skv are
// zero-filled at the load and never read (0 * NaN would poison p @ v),
// and a row with no visible key gives 0.  Output in q's type.
//
// The TPU kernel walks its KV blocks along a sequential grid axis and
// carries the running max, sum and accumulator in VMEM scratch.  Here
// blocks run in parallel and in no order, so a block loops over its KV
// tiles itself with the running max, sum and fp32 accumulator in
// registers.  GQA needs no copy: a block indexes its KV head directly.
// Decode passes the cache (B, Hkv, max_len, D) with Skv = pos + 1 and a
// KV row stride of max_len, so the first pos + 1 rows are read in place.
//
// Three kernels, chosen by shape and type in the C dispatch (never as a
// fallback):
//
// 1. Prefill, bf16 (flash_attention_bf16): FlashAttention-2 on the
//    tensor cores.  Bound: at qwen3-4b's prefill (4 x 32 x 512 over
//    4 x 8 x 512, causal) the bytes (0.0125 ms at 3.35 TB/s) outweigh
//    the bf16 operations (0.0087 ms at 989 TFLOP/s); the FMA kernel it
//    replaces reached 16 TFLOP/s of fp32 FMA.  One block of 4 warps per
//    (query head, batch, 64-row query tile); each warp owns 16 query
//    rows.  Q, K and V are staged in shared memory as bf16 by 16-byte
//    cp.async copies (rows past Sq / Skv zero-filled with src-size 0),
//    rows padded by 16 bytes so ldmatrix is free of bank conflicts; K/V
//    tiles of 32 keys are double-buffered, tile j + 1 in flight while
//    tile j computes, one __syncthreads a tile.  S = Q K^T and O += P V
//    run as mma.sync.m16n8k16 bf16 with fp32 accumulators; Q's A
//    fragments are loaded once, V's B fragments by ldmatrix.trans, and P
//    goes from the S accumulators to bf16 A fragments in registers (the
//    m16n8 layout of two adjacent n-tiles is the m16k16 A layout).  The
//    scale is applied to the fp32 scores inside the exponent (one FMA and
//    one ex2 a score); rounding P to bf16 is what the TPU's MXU does to
//    the Pallas kernel's fp32 p at default precision.  The row max and
//    sum are reduced inside the quad of 4 threads that holds a row.  Only
//    tiles that cross the diagonal or Skv are masked; tiles wholly above
//    the diagonal are skipped, and the grid puts the query tile on its
//    slowest axis, reversed, so that the heaviest causal tiles of every
//    head start first.  32-key tiles keep the kernel at 164 registers,
//    three blocks an SM: it is bound by latency, not by the tensor cores
//    or shared memory (PERF.md).
// 2. Prefill, fp32 (flash_attention_f32): fp32 FMA on the CUDA cores,
//    since the fp32 checks need fp32 products and the port uses no TF32.
//    256 threads as 16 x 16; K and V staged in shared memory as fp32 rows
//    of D + 1 floats; 64 query rows by 32 keys.
// 3. Decode, both types (flash_decode_*), when Sq * Hq / Hkv <= 16:
//    flash-decoding.  Bound by the bytes of the KV cache (0.0027 ms for
//    qwen3-4b's 540 rows at batch 4).  The FMA kernel it replaces ran one
//    block per query head, each reading its KV head's rows once more, in
//    16-row tiles of which one row was real.  Here one block per (KV
//    split, KV head, batch) holds every query row of the GQA group (at
//    most 4 or 16: two instantiations, so the loops over rows unroll), so
//    each cache row is read from memory once.  It streams its slice of
//    rows in chunks of 32 keys through a 3-stage cp.async ring (16-byte
//    copies, two chunks in flight; q comes with the first) and computes
//    fp32 dots on the CUDA cores: a thread scores one key against its
//    warp's rows with 8 partial sums, and owns one output column of its
//    rows, so each staged element is read once per use.  With one split
//    it writes the output; with more, each split writes its fp32
//    (m, l, acc[D]) to a workspace and a second kernel merges the splits
//    in a fixed order.  The split count comes from decode_plan
//    (kernels/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// 2^x by the special-function unit (ftz, about 2 ulp).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Lets `kernel` take `bytes` of dynamic shared memory (past 48 KB only on
// request).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ------------------------------------------- 1. bf16 prefill, tensor cores

constexpr int MMA_THREADS = 128;  // 4 warps, 16 query rows each
constexpr int MMA_BQ = 64;        // query rows a block
constexpr int MMA_BK = 32;        // keys a K/V tile
constexpr int MMA_STAGES = 2;     // K/V tiles in shared memory

template <int D>
constexpr size_t mma_smem_bytes() {  // Q + the K/V stages, padded rows
  return sizeof(bf16) * (MMA_BQ + 2 * MMA_STAGES * MMA_BK) * (D + 8);
}

// Issues the copies of rows [r0, r0 + ROWS) of src (rows of D, row-major)
// into dst (rows of D + 8); rows at or past `limit` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src,
                                           int r0, int limit) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  constexpr int N = ROWS * CPR;
#pragma unroll
  for (int it = 0; it < (N + MMA_THREADS - 1) / MMA_THREADS; ++it) {
    const int i = threadIdx.x + it * MMA_THREADS;
    if (N % MMA_THREADS != 0 && i >= N) break;
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool in = r0 + r < limit;
    cp_async16(dst + r * (D + 8) + c,
               in ? src + (size_t)(r0 + r) * D + c : src, in);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int Hq, int Hkv, int Sq,
                           int Skv, int kv_stride, int causal,
                           float scale_log2) {
  constexpr int LD = D + 8;         // padded smem row, in bf16
  constexpr int KD = D / 16;        // k-steps of Q K^T
  constexpr int NS = MMA_BK / 8;    // 8-key n-tiles of S
  constexpr int ND = D / 8;         // 8-column n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + MMA_BQ * LD;      // MMA_STAGES tiles of MMA_BK x LD
  bf16* Vs = Ks + MMA_STAGES * MMA_BK * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  // blocks start in grid order, x fastest: the query tile is the slowest
  // axis, reversed, so every head's heaviest causal tiles start first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * MMA_BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const bf16* qh = q + ((size_t)b * Hq + h) * Sq * D;
  bf16* oh = o + ((size_t)b * Hq + h) * Sq * D;
  const bf16* kh = k + ((size_t)b * Hkv + hk) * kv_stride * D;
  const bf16* vh = v + ((size_t)b * Hkv + hk) * kv_stride * D;
  const int offset = Skv - Sq;  // causal: row i sees keys <= i + offset
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + MMA_BQ, Sq) + offset);
  const int n_tiles = kv_end > 0 ? (kv_end + MMA_BK - 1) / MMA_BK : 0;
  // this thread's two query rows: fragment rows g and g + 8 of its warp
  const int row0 = q0 + warp * 16 + g;

  // K/V tile j goes to stage j % MMA_STAGES, one commit group a tile (Q
  // with tile 0); the next tile is in flight while one computes
  auto issue = [&](int j) {
    const int st = j % MMA_STAGES;
    stage_bf16<D, MMA_BK>(Ks + st * MMA_BK * LD, kh, j * MMA_BK, Skv);
    stage_bf16<D, MMA_BK>(Vs + st * MMA_BK * LD, vh, j * MMA_BK, Skv);
  };
  stage_bf16<D, MMA_BQ>(Qs, qh, q0, Sq);
#pragma unroll
  for (int j = 0; j < MMA_STAGES - 1; ++j) {
    if (j < n_tiles) issue(j);
    cp_async_commit();
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  unsigned qf[KD][4];

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<MMA_STAGES - 2>();  // tile j (and Q) have landed
    __syncthreads();                  // and tile j - 1's stage is free
    if (j + MMA_STAGES - 1 < n_tiles) issue(j + MMA_STAGES - 1);
    cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                (lane >> 4) * 8);
    }
    const bf16* Kt = Ks + (j % MMA_STAGES) * MMA_BK * LD;
    const bf16* Vt = Vs + (j % MMA_STAGES) * MMA_BK * LD;

    // S = Q K^T: 16 rows x MMA_BK keys a warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned kb[4];
        ldmatrix_x4(kb, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // mask where the tile crosses Skv or the diagonal; online softmax in
    // base 2, the scale applied to the fp32 scores inside the exponent:
    // p = 2^(s * scale log2 e - m * scale log2 e), one FMA and one ex2
    const int k0 = j * MMA_BK;
    const bool masked = k0 + MMA_BK > Skv ||
                        (causal && k0 + MMA_BK - 1 > q0 + offset);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int qi = row0 + (e >> 1) * 8;
          if (key >= Skv || (causal && key > qi + offset)) s[n][e] = NEG_INF;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], mscaled[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = ex2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      mscaled[r] = mx[r] * scale_log2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        bool ok = true;
        if (masked) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int qi = row0 + r * 8;
          ok = key < Skv && (!causal || key <= qi + offset);
        }
        const float p = ok ? ex2(fmaf(s[n][e], scale_log2, -mscaled[r])) : 0.0f;
        s[n][e] = p;
        l[r] += p;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P's accumulators of n-tiles 2kk, 2kk + 1 are the A
    // fragment of keys 16kk .. 16kk + 15
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        unsigned vb[4];
        ldmatrix_x4_trans(
            vb, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + r * 8;
    const float sum = quad_sum(l[r]);
    if (qi >= Sq) continue;
    if (lse != nullptr && t == 0)  // natural log-sum-exp of the scaled scores
      lse[((size_t)b * Hq + h) * Sq + qi] =
          sum > 0.0f ? (m[r] * scale_log2 + log2f(sum)) * LN2 : NEG_INF;
    const float inv = 1.0f / (sum == 0.0f ? 1.0f : sum);  // empty row -> 0
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const __nv_bfloat162 out = __floats2bfloat162_rn(
          acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)qi * D + n * 8 +
                                         2 * t) = out;
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Hq, int Hkv, int Sq, int Skv,
               int kv_stride, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  auto kernel = flash_attention_mma_kernel<D>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(Hq, B, (Sq + MMA_BQ - 1) / MMA_BQ);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), Hq, Hkv, Sq, Skv, kv_stride, causal,
      scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ 2. fp32 prefill, FMA

constexpr int THREADS = 256;

// 16 bytes of float at src (16-byte aligned).
__device__ __forceinline__ void load16(const float* src, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// Stages rows [r0, r0 + ROWS) of the NM row-major (*, D) fp32 matrices
// src[m] into shared memory as rows of D + 1 floats, times `scale`; rows at
// or past `limit` are zero.  Each thread issues all its 16-byte loads
// before its first shared store, so a tile costs one memory latency.
template <int D, int ROWS, int NM>
__device__ __forceinline__ void stage(const float* const (&src)[NM],
                                      float* const (&dst)[NM], int r0,
                                      int limit, float scale) {
  constexpr int V = 4, PER_ROW = D / V, N = ROWS * PER_ROW;
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

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int Hq, int Hkv, int Sq,
                       int Skv, int kv_stride, int causal, float scale) {
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
  const float* qh = q + ((size_t)b * Hq + h) * Sq * D;
  float* oh = o + ((size_t)b * Hq + h) * Sq * D;
  const float* kh = k + ((size_t)b * Hkv + hk) * kv_stride * D;
  const float* vh = v + ((size_t)b * Hkv + hk) * kv_stride * D;
  const int offset = Skv - Sq;  // causal: row i sees keys <= i + offset

  {
    const float* const src[1] = {qh};
    float* const dst[1] = {Qs};
    stage<D, BQ, 1>(src, dst, q0, Sq, scale);
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
      const float* const src[2] = {kh, vh};
      float* const dst[2] = {Ks, Vs};
      stage<D, BK, 2>(src, dst, k0, Skv, 1.0f);
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
    if (lse != nullptr && tx == 0)  // m and l are of the scaled scores
      lse[((size_t)b * Hq + h) * Sq + qpos] =
          l[i] > 0.0f ? m[i] + logf(l[i]) : NEG_INF;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];  // empty row -> 0
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd)
      oh[(size_t)qpos * D + tx + 16 * jd] = acc[i][jd] / denom;
  }
}

template <int D, int BQ, int BK>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Hq, int Hkv, int Sq, int Skv,
               int kv_stride, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BQ, BK>();
  auto kernel = flash_attention_kernel<D, BQ, BK>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Hq, Hkv, Sq, Skv, kv_stride, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The prefill kernel of each type: tensor cores for bf16, FMA for fp32.
template <typename T, int D>
struct Prefill;
template <int D>
struct Prefill<bf16, D> {
  static int run(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                 int kv_stride, int causal, float scale, cudaStream_t s) {
    return launch_mma<D>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, kv_stride,
                         causal, scale, s);
  }
};
template <int D>
struct Prefill<float, D> {
  static int run(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                 int kv_stride, int causal, float scale, cudaStream_t s) {
    return launch_fma<D, 64, 32>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv,
                                 kv_stride, causal, scale, s);
  }
};

// ----------------------------------------------- 3. decode, split KV

constexpr int DEC_THREADS = 128;
constexpr int DEC_ROWS = 16;    // most query rows (Sq * Hq / Hkv) a block holds
constexpr int DEC_KC = 32;      // keys a chunk stages
constexpr int DEC_STAGES = 3;

// 16 bytes at p (16-byte aligned) as floats.
__device__ __forceinline__ void widen16(const float* p, float* out) {
  load16(p, out);
}
__device__ __forceinline__ void widen16(const bf16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T, int D, int GR>
struct DecodeLayout {
  static constexpr int VEC = 16 / sizeof(T);     // elements in 16 bytes
  static constexpr int LD = D + VEC;             // padded row, elements
  static constexpr size_t kv_bytes = sizeof(T) * DEC_STAGES * 2 * DEC_KC * LD;
  static constexpr size_t q_bytes = sizeof(T) * GR * D;      // as copied
  static constexpr size_t bytes = kv_bytes + q_bytes + sizeof(float) *
      (GR * D + GR * DEC_KC + 3 * GR);   // q in fp32, p, alpha, m, l
};

// One block per (split, KV head, batch) holds the G <= GR query rows of
// the group, which lie contiguous in q and o at ((b * Hkv + hk) * G + r)
// * D.  Keys [k0, k1) of the split.  ws == nullptr: write o; else write
// (m, l, acc[D]) for the row at ws[(((b * Hkv + hk) * G + r) * splits +
// split) * (D + 2)].  A thread scores one key of the chunk (its lane)
// against the rows of its warp (warp, warp + 4, ...), so a K row is read
// once for all of them, and owns column tid % D of the output rows
// tid / D + i * (128 / D), so a V element is read once for all of its
// rows.  GR, the rows a block can hold, is a template argument so that
// the loops over rows unroll without runtime trip counts.
template <typename T, int D, int GR>
__global__ void __launch_bounds__(DEC_THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ ws, int Hkv, int Sq, int G, int Skv,
                    int kv_stride, int causal, float scale,
                    int rows_per_split) {
  using L = DecodeLayout<T, D, GR>;
  constexpr int VEC = L::VEC, LD = L::LD, CPR = D / VEC;
  constexpr int WARPS = DEC_THREADS / 32;
  constexpr int RW = (GR + WARPS - 1) / WARPS;       // rows a warp scores
  constexpr int ACC = (GR * D + DEC_THREADS - 1) / DEC_THREADS;  // outputs
  static_assert(DEC_KC == 32 && DEC_THREADS % D == 0, "key = lane");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv = reinterpret_cast<T*>(smem_raw);       // [stage][k or v][key][LD]
  T* q_raw = reinterpret_cast<T*>(smem_raw + L::kv_bytes);       // [G][D]
  float* qs = reinterpret_cast<float*>(smem_raw + L::kv_bytes + L::q_bytes);
  float* ps = qs + GR * D;                      // [G][DEC_KC]
  float* alpha_s = ps + GR * DEC_KC;            // [G]
  float* m_s = alpha_s + GR;
  float* l_s = m_s + GR;

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t rows0 = ((size_t)b * Hkv + hk) * G;   // first row of q / o
  const T* kh = k + ((size_t)b * Hkv + hk) * kv_stride * D;
  const T* vh = v + ((size_t)b * Hkv + hk) * kv_stride * D;
  const int k0 = split * rows_per_split;
  const int k1 = min(Skv, k0 + rows_per_split);
  const int n_chunks = k1 > k0 ? (k1 - k0 + DEC_KC - 1) / DEC_KC : 0;
  const int offset = Skv - Sq;

  // q rows go with the first chunk's copies
  for (int i = tid; i < G * CPR; i += DEC_THREADS)
    cp_async16(q_raw + i * VEC, q + rows0 * D + i * VEC, true);
  auto issue = [&](int c) {
    T* dst = kv + (c % DEC_STAGES) * 2 * DEC_KC * LD;
    const int kc0 = k0 + c * DEC_KC;
    for (int i = tid; i < 2 * DEC_KC * CPR; i += DEC_THREADS) {
      const int m = i / (DEC_KC * CPR), r = (i / CPR) % DEC_KC;
      const int e = (i % CPR) * VEC;
      const T* src = m ? vh : kh;
      const bool in = kc0 + r < k1;
      cp_async16(dst + (m * DEC_KC + r) * LD + e,
                 in ? src + (size_t)(kc0 + r) * D + e : src, in);
    }
  };
#pragma unroll
  for (int c = 0; c < DEC_STAGES - 1; ++c) {
    if (c < n_chunks) issue(c);
    cp_async_commit();
  }

  const int d_own = tid % D;  // this thread's output column
  float acc[ACC], m_r[RW], l_r[RW];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m_r[i] = NEG_INF;
    l_r[i] = 0.0f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();  // chunk c landed; chunk c - 1's stage is free
    if (c + DEC_STAGES - 1 < n_chunks) issue(c + DEC_STAGES - 1);
    cp_async_commit();
    if (c == 0) {     // q, landed with chunk 0, widened once
      for (int i = tid; i < G * D; i += DEC_THREADS)
        qs[i] = to_f32(q_raw[i]);
      __syncthreads();
    }
    const T* Kc = kv + (c % DEC_STAGES) * 2 * DEC_KC * LD;
    const T* Vc = Kc + DEC_KC * LD;
    const int key = k0 + c * DEC_KC + lane;

    // scores of key `lane` against rows warp + i * WARPS, VEC partial
    // sums a row
    float part[RW][VEC];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) part[i][e] = 0.0f;
#pragma unroll
    for (int d = 0; d < D; d += VEC) {
      float kf[VEC];
      widen16(Kc + lane * LD + d, kf);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int r = min(warp + i * WARPS, G - 1);  // rows past G: unused
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + r * D + d + e);
          part[i][e] = fmaf(qv.x, kf[e], part[i][e]);
          part[i][e + 1] = fmaf(qv.y, kf[e + 1], part[i][e + 1]);
          part[i][e + 2] = fmaf(qv.z, kf[e + 2], part[i][e + 2]);
          part[i][e + 3] = fmaf(qv.w, kf[e + 3], part[i][e + 3]);
        }
      }
    }

    // online softmax, a warp a row, lane = key
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + i * WARPS;
      if (r >= G) continue;  // warp-uniform
#pragma unroll
      for (int w = VEC / 2; w > 0; w >>= 1)
#pragma unroll
        for (int e = 0; e < w; ++e) part[i][e] += part[i][e + w];
      const int qi = r % Sq;
      const bool ok = key < k1 && (!causal || key <= qi + offset);
      const float x = ok ? part[i][0] * scale : NEG_INF;
      float mx = x;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m_r[i], mx);
      const float p = ok ? expf(x - m_new) : 0.0f;
      float sum = p;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      const float alpha = expf(m_r[i] - m_new);
      l_r[i] = alpha * l_r[i] + sum;
      m_r[i] = m_new;
      ps[r * DEC_KC + lane] = p;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // acc = alpha acc + P V over this chunk's keys; rows past G compute
    // on row G - 1 and are never written
    int rr[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      rr[i] = min(tid / D + i * (DEC_THREADS / D), G - 1);
      acc[i] *= alpha_s[rr[i]];
    }
#pragma unroll 8
    for (int jj = 0; jj < DEC_KC; ++jj) {
      const float vv = to_f32(Vc[jj * LD + d_own]);
#pragma unroll
      for (int i = 0; i < ACC; ++i)
        acc[i] = fmaf(ps[rr[i] * DEC_KC + jj], vv, acc[i]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + i * WARPS;
    if (r < G && lane == 0) {
      m_s[r] = m_r[i];
      l_s[r] = l_r[i];
    }
  }
  __syncthreads();
  const int splits = gridDim.x;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int r = tid / D + i * (DEC_THREADS / D);
    if (r >= G) continue;
    if (ws == nullptr) {
      const float den = l_s[r] == 0.0f ? 1.0f : l_s[r];  // empty row -> 0
      store(o + (rows0 + r) * D + d_own, acc[i] / den);
    } else {
      float* w = ws + ((rows0 + r) * splits + split) * (D + 2);
      if (d_own == 0) {
        w[0] = m_s[r];
        w[1] = l_s[r];
      }
      w[2 + d_own] = acc[i];
    }
  }
}

// Merges the splits of one row (blockIdx.x) in split order.
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ o,
                            int splits) {
  const size_t row = blockIdx.x;
  const float* w = ws + row * splits * (D + 2);
  float M = NEG_INF;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) M = fmaxf(M, w[s * (D + 2)]);
  float L = 0.0f, acc = 0.0f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const float* ws_s = w + s * (D + 2);
    const float f = expf(ws_s[0] - M);  // 0 for a split that saw no key
    L = fmaf(f, ws_s[1], L);
    acc = fmaf(f, ws_s[2 + threadIdx.x], acc);
  }
  store(o + row * D + threadIdx.x, acc / (L == 0.0f ? 1.0f : L));
}

template <typename T, int D, int GR>
int launch_decode_rows(const void* q, const void* k, const void* v, void* o,
                       float* part, int B, int Hkv, int Sq, int G, int Skv,
                       int kv_stride, int causal, float scale,
                       int rows_per_split, int splits, cudaStream_t stream) {
  constexpr size_t smem = DecodeLayout<T, D, GR>::bytes;
  auto kernel = flash_decode_kernel<T, D, GR>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(splits, Hkv, B), DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), part, Hkv, Sq, G, Skv,
      kv_stride, causal, scale, rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  void* ws, int B, int Hq, int Hkv, int Sq, int Skv,
                  int kv_stride, int causal, float scale, int rows_per_split,
                  int splits, cudaStream_t stream) {
  const int G = Sq * (Hq / Hkv);
  if (G < 1 || G > DEC_ROWS || splits < 1 || rows_per_split < 1 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const int err =
      G <= 4 ? launch_decode_rows<T, D, 4>(q, k, v, o, part, B, Hkv, Sq, G,
                                            Skv, kv_stride, causal, scale,
                                            rows_per_split, splits, stream)
             : launch_decode_rows<T, D, DEC_ROWS>(
                   q, k, v, o, part, B, Hkv, Sq, G, Skv, kv_stride, causal,
                   scale, rows_per_split, splits, stream);
  if (err != 0 || splits == 1) return err;
  flash_decode_combine_kernel<T, D><<<B * Hkv * G, D, 0, stream>>>(
      part, static_cast<T*>(o), splits);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------- 4. backward, fp32 FMA (prefill)
// FlashAttention-2's backward for the prefill kernels above, from the
// forward's output o and its log-sum-exp (lse).  With s = q k^T * scale
// and p = exp(s - lse) over the visible keys (0 elsewhere, never exp of a
// masked score, so a row with no visible key gets no gradient):
//   delta_i = dO_i . O_i               (flash_bwd_delta_kernel)
//   dp_ij = dO_i . V_j,  ds_ij = p_ij (dp_ij - delta_i)
//   dV_j = sum_i p_ij dO_i,  dK_j = scale sum_i ds_ij Q_i   (flash_bwd_kv)
//   dQ_i = scale sum_j ds_ij K_j                           (flash_bwd_q)
// No Pallas kernel differentiates (the reference differentiates its jnp
// attention).  dK/dV: a block per (KV head, batch, 64-key tile) loops over
// every query head of its GQA group and the 64-row query tiles that see
// its keys, with dK and dV in registers; dQ: a block per (query head,
// batch, 64-row tile) loops over the key tiles its rows see.  Each output
// element is one thread's sum in a fixed order: no atomics, the same bits
// every run.  Tiles wholly above the causal diagonal are skipped.  fp32
// operands compute in fp32 on the CUDA cores (FMA; no TF32; bf16 ones run
// on the tensor cores, section 5): staged in shared memory as fp32 rows
// of D + 1 floats (no bank conflicts), 256 threads as 16 x 16, each thread
// 4 x 4 scores of a tile and 4 x D/16 outputs, two FMAs a shared-memory
// load.

constexpr int BWD_THREADS = 256;
constexpr int BWD_BQ = 64;   // query rows a tile
constexpr int BWD_BK = 64;   // keys a tile
constexpr int BWD_LP = BWD_BK + 1;

template <int D>
constexpr size_t bwd_kv_smem() {   // K, V, Q, dO tiles, then p and ds
  return sizeof(float) * ((2 * BWD_BK + 2 * BWD_BQ) * (D + 1) +
                          2 * BWD_BQ * BWD_LP);
}
template <int D>
constexpr size_t bwd_q_smem() {    // Q, dO, K, V tiles, then ds
  return sizeof(float) * ((2 * BWD_BK + 2 * BWD_BQ) * (D + 1) +
                          BWD_BQ * BWD_LP);
}

// Rows [r0, r0 + ROWS) of src (rows of D elements of T) into dst as fp32
// rows of D + 1; rows at or past `limit` are zero.  16-byte loads.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage_f32(float* dst, const T* src, int r0,
                                          int limit) {
  constexpr int E = 16 / sizeof(T), PER_ROW = D / E, N = ROWS * PER_ROW;
  for (int i = threadIdx.x; i < N; i += BWD_THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * E;
    float v[E];
    if (r0 + r < limit) {
      widen16(src + (size_t)(r0 + r) * D + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) dst[r * (D + 1) + c + e] = v[e];
  }
}

// delta = rowsum(dO * O) over rows of D, a warp a row, 8 rows a block.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32)
    s += to_f32(o[(size_t)row * D + d]) * to_f32(dout[(size_t)row * D + d]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) delta[row] = s;
}

// s (scores) and dp of one tile pair from the staged rows: thread (ty, tx)
// takes query rows ty + 16 i and keys tx + 16 j.
template <int D>
__device__ __forceinline__ void bwd_scores(const float* Qs, const float* Ds,
                                           const float* Ks, const float* Vs,
                                           int ty, int tx, float (&s)[4][4],
                                           float (&dp)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * LD + d];
      dov[i] = Ds[(ty + 16 * i) * LD + d];
      kv[i] = Ks[(tx + 16 * i) * LD + d];
      vv[i] = Vs[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
}

// Whether query row qi sees key kj (rows past Sq see nothing).
__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Skv,
                                        int causal, int offset) {
  return qi < Sq && kj < Skv && (!causal || kj <= qi + offset);
}

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,
                    int causal, float scale) {
  constexpr int LD = D + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                  // BWD_BK x LD
  float* Vs = Ks + BWD_BK * LD;      // BWD_BK x LD
  float* Qs = Vs + BWD_BK * LD;      // BWD_BQ x LD
  float* Ds = Qs + BWD_BQ * LD;      // BWD_BQ x LD, dO
  float* Ps = Ds + BWD_BQ * LD;      // BWD_BQ x BWD_LP, p
  float* Ss = Ps + BWD_BQ * BWD_LP;  // BWD_BQ x BWD_LP, ds
  __shared__ float lse_s[BWD_BQ], delta_s[BWD_BQ];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BWD_BK;
  const int group = Hq / Hkv, offset = Skv - Sq;
  const size_t kv_base = ((size_t)b * Hkv + hk) * Skv * D;
  stage_f32<T, D, BWD_BK>(Ks, k + kv_base, k0, Skv);
  stage_f32<T, D, BWD_BK>(Vs, v + kv_base, k0, Skv);

  float dk_acc[4][DPT], dv_acc[4][DPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.0f;
  // the first query row that sees a key of this tile: qi + offset >= k0
  const int t_first = causal ? max(0, k0 - offset) / BWD_BQ : 0;
  const int n_qt = (Sq + BWD_BQ - 1) / BWD_BQ;
  for (int hi = 0; hi < group; ++hi) {
    const int h = hk * group + hi;
    const size_t q_base = ((size_t)b * Hq + h) * Sq;
    for (int qt = t_first; qt < n_qt; ++qt) {
      const int q0 = qt * BWD_BQ;
      __syncthreads();   // the last tile's Qs, Ds, Ps, Ss are read
      stage_f32<T, D, BWD_BQ>(Qs, q + q_base * D, q0, Sq);
      stage_f32<T, D, BWD_BQ>(Ds, dout + q_base * D, q0, Sq);
      if (tid < BWD_BQ) {
        const bool in = q0 + tid < Sq;
        lse_s[tid] = in ? lse[q_base + q0 + tid] : 0.0f;
        delta_s[tid] = in ? delta[q_base + q0 + tid] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      bwd_scores<D>(Qs, Ds, Ks, Vs, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = visible(q0 + r, k0 + c, Sq, Skv, causal, offset)
                              ? expf(s[i][j] * scale - lse_s[r])
                              : 0.0f;
          Ps[r * BWD_LP + c] = p;
          Ss[r * BWD_LP + c] = p * (dp[i][j] - delta_s[r]);
        }
      }
      __syncthreads();
      // dV += p^T dO and dK += ds^T Q: keys ty + 16 a, columns tx + 16 c
#pragma unroll 4
      for (int i = 0; i < BWD_BQ; ++i) {
        float pv[4], sv[4], dov[DPT], qv[DPT];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = Ps[i * BWD_LP + ty + 16 * a];
          sv[a] = Ss[i * BWD_LP + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          dov[c] = Ds[i * LD + tx + 16 * c];
          qv[c] = Qs[i * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < DPT; ++c) {
            dv_acc[a][c] = fmaf(pv[a], dov[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(sv[a], qv[c], dk_acc[a][c]);
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kj = k0 + ty + 16 * a;
    if (kj >= Skv) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const size_t at = kv_base + (size_t)kj * D + tx + 16 * c;
      store(dk + at, dk_acc[a][c] * scale);
      store(dv + at, dv_acc[a][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int Hq, int Hkv, int Sq, int Skv, int causal,
                   float scale) {
  constexpr int LD = D + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                  // BWD_BQ x LD
  float* Ds = Qs + BWD_BQ * LD;      // BWD_BQ x LD, dO
  float* Ks = Ds + BWD_BQ * LD;      // BWD_BK x LD
  float* Vs = Ks + BWD_BK * LD;      // BWD_BK x LD
  float* Ss = Vs + BWD_BK * LD;      // BWD_BQ x BWD_LP, ds
  __shared__ float lse_s[BWD_BQ], delta_s[BWD_BQ];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // the query tile is the slowest grid axis, reversed: the heaviest causal
  // tiles of every head start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BWD_BQ;
  const int hk = h / (Hq / Hkv), offset = Skv - Sq;
  const size_t q_base = ((size_t)b * Hq + h) * Sq;
  const size_t kv_base = ((size_t)b * Hkv + hk) * Skv * D;
  stage_f32<T, D, BWD_BQ>(Qs, q + q_base * D, q0, Sq);
  stage_f32<T, D, BWD_BQ>(Ds, dout + q_base * D, q0, Sq);
  if (tid < BWD_BQ) {
    const bool in = q0 + tid < Sq;
    lse_s[tid] = in ? lse[q_base + q0 + tid] : 0.0f;
    delta_s[tid] = in ? delta[q_base + q0 + tid] : 0.0f;
  }
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + BWD_BQ, Sq) + offset);

  float dq_acc[4][DPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dq_acc[a][c] = 0.0f;
  for (int k0 = 0; k0 < kv_end; k0 += BWD_BK) {
    __syncthreads();   // the last tile's Ks, Vs, Ss are read
    stage_f32<T, D, BWD_BK>(Ks, k + kv_base, k0, Skv);
    stage_f32<T, D, BWD_BK>(Vs, v + kv_base, k0, Skv);
    __syncthreads();
    float s[4][4], dp[4][4];
    bwd_scores<D>(Qs, Ds, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, Sq, Skv, causal, offset)
                            ? expf(s[i][j] * scale - lse_s[r])
                            : 0.0f;
        Ss[r * BWD_LP + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    // dQ += ds K: rows ty + 16 a, columns tx + 16 c
#pragma unroll 4
    for (int j = 0; j < BWD_BK; ++j) {
      float sv[4], kv[DPT];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = Ss[(ty + 16 * a) * BWD_LP + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) kv[c] = Ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < DPT; ++c)
          dq_acc[a][c] = fmaf(sv[a], kv[c], dq_acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c)
      store(dq + (q_base + qi) * D + tx + 16 * c, dq_acc[a][c] * scale);
  }
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
               int causal, float scale, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int rows = B * Hq * Sq;
  flash_bwd_delta_kernel<T, D><<<(rows + 7) / 8, 256, 0, s>>>(
      static_cast<const T*>(o), dot, dl, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kv_kernel = flash_bwd_kv_kernel<T, D>;
  e = allow_smem(kv_kernel, bwd_kv_smem<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  kv_kernel<<<dim3(Hkv, B, (Skv + BWD_BK - 1) / BWD_BK), BWD_THREADS,
              bwd_kv_smem<D>(), s>>>(qt, kt, vt, dot, ls, dl,
                                     static_cast<T*>(dk), static_cast<T*>(dv),
                                     Hq, Hkv, Sq, Skv, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto q_kernel = flash_bwd_q_kernel<T, D>;
  e = allow_smem(q_kernel, bwd_q_smem<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  q_kernel<<<dim3(Hq, B, (Sq + BWD_BQ - 1) / BWD_BQ), BWD_THREADS,
             bwd_q_smem<D>(), s>>>(qt, kt, vt, dot, ls, dl,
                                   static_cast<T*>(dq), Hq, Hkv, Sq, Skv,
                                   causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------- 5. backward, bf16 on the tensor cores
// The formulas of section 4 for bf16 operands, on the tensor cores
// (mma.sync.m16n8k16 bf16, fp32 accumulators).  Bound at qwen3-4b's
// training shape (4 x 32 x 512 over 4 x 8 x 512, causal, D 128): the
// bytes (0.0251 ms at 3.35 TB/s) before the five causal products (0.0218
// ms at 989 TFLOP/s); these kernels compute seven (S and dP in both), 0.0305
// ms.  Section 4's FMA kernels took 1.52 ms there, bound by fp32 FMA from
// shared memory.  Two kernels, 4 warps each:
//
// - dQ (flash_bwd_q_mma_kernel), first: a block per (query head, batch,
//   64-row query tile), each warp owning 16 rows.  It stages its Q and dO
//   rows once, forms delta = rowsum(dO o O) from the staged dO (and writes
//   it for the dK/dV kernel: no delta pass over dO and O of its own), then
//   streams the 32-key K/V tiles its rows see through a two-stage cp.async
//   ring, tile j + 1 in flight while tile j computes: S = Q K^T, dP = dO
//   V^T, dS in registers, repacked as A fragments, dQ += dS K with K as B
//   by ldmatrix.trans.  The query tile is the grid's slowest axis,
//   reversed, so the heaviest causal tiles start first.
// - dK/dV (flash_bwd_kv_mma_kernel): a block per (KV head, batch, 64-key
//   tile), each warp owning 16 keys, walks its GQA group's query heads and
//   the 32-row query tiles that see its keys, so dK and dV (16 keys x D a
//   warp, fp32) stay in registers and no block adds into another's rows.
//   With the keys as the M dimension, S^T = K Q^T and dP^T = V dO^T leave
//   P^T and dS^T = P^T o (dP^T - delta) in accumulator fragments that are
//   already the A fragments of dV += P^T dO and dK += dS^T Q (two adjacent
//   8-column n-tiles make one 16-wide k-step); dO and Q come in as B
//   fragments by ldmatrix.trans, as V does in the forward, so P and dS
//   never touch shared memory.  K and V are staged once; the Q/dO tiles
//   and their rows' lse and delta go through the same ring.  Under a causal
//   mask the first key tile sees every query tile and the last a few, and
//   two blocks share an SM (registers), so the blocks take the work
//   heaviest first up to one an SM, then lightest first: where the card
//   hands every SM one block before any a second, each SM's pair adds up
//   to about the same work.  CUDA does not promise that order; in any
//   other the bits are the same and only the balance is lost.  One block
//   of 8 warps running a heavy and a light item as two halves pairs them
//   whatever the order, but measured slower on the H100 (PERF.md).
//
// Operands are staged as bf16 rows padded by 16 bytes (ldmatrix without
// bank conflicts), rows past Sq / Skv zero-filled.  p = 2^(s scale log2 e
// - lse log2 e) by one FMA and one ex2; a masked score is selected as 0 and
// never exponentiated, so an empty row's lse of -1e30 gives p = 0.  Only
// tiles that cross the diagonal, Sq or Skv are masked; tiles wholly above
// the diagonal are skipped.  P is rounded to bf16 for dV and dS for dK and
// dQ, as FlashAttention-2 rounds them; dS is formed from the fp32 P; every
// sum is fp32, and dK and dQ are scaled in fp32 at the store.  Each output
// element is one thread's accumulator, summed in a fixed order: the same
// bits every run.

constexpr int KV_BK = 64;       // keys a dK/dV block (4 warps x 16)
constexpr int KV_BQ = 32;       // query rows a staged Q/dO tile
constexpr int Q_BQ = 64;        // query rows a dQ block (4 warps x 16)
constexpr int Q_BK = 32;        // keys a staged K/V tile
constexpr int BWD_STAGES = 2;   // tiles of the cp.async ring

template <int D>
constexpr size_t bwd_kv_mma_smem() {  // K, V, then the Q/dO ring, lse, delta
  return sizeof(bf16) * (2 * KV_BK + 2 * BWD_STAGES * KV_BQ) * (D + 8) +
         sizeof(float) * 2 * BWD_STAGES * KV_BQ;
}
template <int D>
constexpr size_t bwd_q_mma_smem() {   // Q, dO, then the K/V ring
  return sizeof(bf16) * (2 * Q_BQ + 2 * BWD_STAGES * Q_BK) * (D + 8);
}

// acc (16 rows x 8 NT columns) += A B^T over 16 KD: A's 16 rows at a, B's
// 8 NT rows (the product's columns) at b, both bf16 rows of LD in shared
// memory, by ldmatrix.
template <int KD, int NT, int LD>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a,
                                        const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    unsigned af[4];
    ldmatrix_x4(af, a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned bb[4];
      ldmatrix_x4(bb, b + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], af, bb[0], bb[1]);
      mma_bf16(acc[2 * np + 1], af, bb[2], bb[3]);
    }
  }
}

// acc (16 rows x 8 ND columns) += P Z over 16 KT: P the fp32 accumulators
// p (16 x 16 KT), rounded to bf16 A fragments in registers (n-tiles 2kk and
// 2kk + 1 are the A fragment of k-step kk); Z's 16 KT rows at z, bf16 rows
// of LD in shared memory, as B fragments by ldmatrix.trans.
template <int KT, int ND, int LD>
__device__ __forceinline__ void mma_pz(float (&acc)[ND][4],
                                       const float (&p)[2 * KT][4],
                                       const bf16* z, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const unsigned pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < ND / 2; ++dp) {
      unsigned zb[4];
      ldmatrix_x4_trans(zb, z + (kk * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * LD +
                                dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], pa, zb[0], zb[1]);
      mma_bf16(acc[2 * dp + 1], pa, zb[2], zb[3]);
    }
  }
}

// Stores rows g and g + 8 of a warp's 16 x D accumulators (times `scale`)
// as bf16 at out + row * D, rows at or past `limit` skipped.
template <int ND>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[ND][4],
                                           int row0, int limit, float scale,
                                           int t) {
  constexpr int D = ND * 8;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= limit) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + n * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] * scale,
                                acc[n][2 * r + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_kv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int B, int Hq, int Hkv, int Sq,
                        int Skv, int causal, float scale_log2, float scale,
                        int sms) {
  constexpr int LD = D + 8, KD = D / 16, ND = D / 8, NQ = KV_BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // KV_BK x LD
  bf16* Vs = Ks + KV_BK * LD;                     // KV_BK x LD
  bf16* Qs = Vs + KV_BK * LD;                     // BWD_STAGES x KV_BQ x LD
  bf16* Ds = Qs + BWD_STAGES * KV_BQ * LD;        // dO, the same
  float* Ls = reinterpret_cast<float*>(Ds + BWD_STAGES * KV_BQ * LD);
  float* Es = Ls + BWD_STAGES * KV_BQ;            // lse, delta of the rows

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // work items (KV head, batch, key tile), key tile slowest: under a causal
  // mask key tile 0 sees every query tile and the last the fewest.  Block
  // i < sms takes item i (the heaviest first) and block i >= sms item
  // total + sms - 1 - i (the lightest first)
  const int total = gridDim.x, i0 = blockIdx.x;
  const int item = i0 < sms ? i0 : total + sms - 1 - i0;
  const int pairs = B * Hkv;
  const int hk = item % Hkv, b = (item / Hkv) % B, k0 = item / pairs * KV_BK;
  const int group = Hq / Hkv, offset = Skv - Sq;
  const size_t kv_base = ((size_t)b * Hkv + hk) * Skv * D;
  // the query tiles that see a key of this block (row i sees key k0 when
  // i + offset >= k0), for each query head of the group
  const int t_first = causal ? max(0, k0 - offset) / KV_BQ : 0;
  const int per_head = max(0, (Sq + KV_BQ - 1) / KV_BQ - t_first);
  const int n_it = group * per_head;

  // Q/dO tile i (head i / per_head, query tile t_first + i % per_head) and
  // its rows' lse and delta go to stage i % BWD_STAGES, one commit group a
  // tile (K and V with tile 0)
  auto issue = [&](int i) {
    const int st = i % BWD_STAGES;
    const int h = hk * group + i / per_head;
    const int q0 = (t_first + i % per_head) * KV_BQ;
    const size_t qb = ((size_t)b * Hq + h) * Sq;
    stage_bf16<D, KV_BQ>(Qs + st * KV_BQ * LD, q + qb * D, q0, Sq);
    stage_bf16<D, KV_BQ>(Ds + st * KV_BQ * LD, dout + qb * D, q0, Sq);
    if (threadIdx.x < 2 * KV_BQ) {
      const int r = threadIdx.x % KV_BQ;
      const bool is_lse = threadIdx.x < KV_BQ, in = q0 + r < Sq;
      const float* src = is_lse ? lse : delta;
      cp_async4((is_lse ? Ls : Es) + st * KV_BQ + r,
                in ? src + qb + q0 + r : src, in);
    }
  };
  stage_bf16<D, KV_BK>(Ks, k + kv_base, k0, Skv);
  stage_bf16<D, KV_BK>(Vs, v + kv_base, k0, Skv);
  if (n_it > 0) issue(0);
  cp_async_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;
  const bf16* Kw = Ks + warp * 16 * LD;
  const bf16* Vw = Vs + warp * 16 * LD;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  for (int i = 0; i < n_it; ++i) {
    cp_async_wait<0>();   // tile i (and K, V) have landed
    __syncthreads();      // and tile i - 1's stage is free
    if (i + 1 < n_it) issue(i + 1);
    cp_async_commit();
    const int st = i % BWD_STAGES;
    const int q0 = (t_first + i % per_head) * KV_BQ;
    const bf16* Qt = Qs + st * KV_BQ * LD;
    const bf16* Dt = Ds + st * KV_BQ * LD;
    const float* Lt = Ls + st * KV_BQ;
    const float* Et = Es + st * KV_BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x KV_BQ query rows a warp
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    mma_abt<KD, NQ, LD>(s, Kw, Qt, lane);
    mma_abt<KD, NQ, LD>(dp, Vw, Dt, lane);

    // P^T and dS^T in place: element e of n-tile n is key key0 + (e >> 1)
    // 8, query row q0 + 8 n + 2 t + (e & 1)
    const bool masked = q0 + KV_BQ > Sq || k0 + KV_BK > Skv ||
                        (causal && k0 + KV_BK - 1 > q0 + offset);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const bool ok = !masked || visible(q0 + c, key0 + (e >> 1) * 8, Sq,
                                           Skv, causal, offset);
        const float p =
            ok ? ex2(fmaf(s[n][e], scale_log2, -Lt[c] * LOG2E)) : 0.0f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - Et[c]);
      }

    // dV += P^T dO and dK += dS^T Q
    mma_pz<NQ / 2, ND, LD>(dv_acc, s, Dt, lane);
    mma_pz<NQ / 2, ND, LD>(dk_acc, dp, Qt, lane);
  }
  cp_async_wait<0>();
  store_rows<ND>(dk + kv_base, dk_acc, key0, Skv, scale, t);
  store_rows<ND>(dv + kv_base, dv_acc, key0, Skv, 1.0f, t);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_q_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, bf16* __restrict__ dq,
                       int Hq, int Hkv, int Sq, int Skv, int causal,
                       float scale_log2, float scale) {
  constexpr int LD = D + 8, KD = D / 16, ND = D / 8, NK = Q_BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // Q_BQ x LD
  bf16* Ds = Qs + Q_BQ * LD;                      // dO, Q_BQ x LD
  bf16* Ks = Ds + Q_BQ * LD;                      // BWD_STAGES x Q_BK x LD
  bf16* Vs = Ks + BWD_STAGES * Q_BK * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * Q_BQ;
  const int hk = h / (Hq / Hkv), offset = Skv - Sq;
  const size_t qb = ((size_t)b * Hq + h) * Sq;
  const bf16* kh = k + ((size_t)b * Hkv + hk) * Skv * D;
  const bf16* vh = v + ((size_t)b * Hkv + hk) * Skv * D;
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + Q_BQ, Sq) + offset);
  const int n_tiles = kv_end > 0 ? (kv_end + Q_BK - 1) / Q_BK : 0;
  // this thread's query rows row0 and row0 + 8: -lse log2 e, and the
  // 8-column chunks t, t + 4, ... of their O rows, loaded while the
  // prologue's copies fly
  constexpr int CH = D / 8, CPT = (CH + 3) / 4;
  const int row0 = q0 + warp * 16 + g;
  float nl[2], dl[2];
  uint4 orow[2][CPT];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    nl[r] = row < Sq ? -lse[qb + row] * LOG2E : 0.0f;
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      if (row < Sq && t + 4 * i < CH)
        orow[r][i] = *reinterpret_cast<const uint4*>(
            o + (qb + row) * D + (t + 4 * i) * 8);
  }

  auto issue = [&](int j) {
    const int st = j % BWD_STAGES;
    stage_bf16<D, Q_BK>(Ks + st * Q_BK * LD, kh, j * Q_BK, Skv);
    stage_bf16<D, Q_BK>(Vs + st * Q_BK * LD, vh, j * Q_BK, Skv);
  };
  stage_bf16<D, Q_BQ>(Qs, q + qb * D, q0, Sq);
  stage_bf16<D, Q_BQ>(Ds, dout + qb * D, q0, Sq);
  if (n_tiles > 0) issue(0);
  cp_async_commit();

  // delta = rowsum(dO o O) of the block's rows from the staged dO, each
  // row's quad adding its chunks, then a quad sum in a fixed order;
  // written for the dK/dV kernel, which runs next (it reads the delta of
  // rows that see no key too, times p = 0).  Computed before the loop:
  // measured faster than in the first tile's step, where every warp waits
  // on its O loads at once (PERF.md)
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (row >= Sq || t + 4 * i >= CH) continue;
      const uint4 d4 = *reinterpret_cast<const uint4*>(
          Ds + (warp * 16 + g + r * 8) * LD + (t + 4 * i) * 8);
      const __nv_bfloat162* a =
          reinterpret_cast<const __nv_bfloat162*>(&orow[r][i]);
      const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&d4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a[e]);
        const float2 y = __bfloat1622float2(b[e]);
        sum = fmaf(x.x, y.x, fmaf(x.y, y.y, sum));
      }
    }
    dl[r] = quad_sum(sum);
    if (t == 0 && row < Sq) delta[qb + row] = dl[r];
  }

  float dq_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.0f;
  const bf16* Qw = Qs + warp * 16 * LD;
  const bf16* Dw = Ds + warp * 16 * LD;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();   // tile j has landed
    __syncthreads();      // and tile j - 1's stage is free
    if (j + 1 < n_tiles) issue(j + 1);
    cp_async_commit();
    const bf16* Kt = Ks + (j % BWD_STAGES) * Q_BK * LD;
    const bf16* Vt = Vs + (j % BWD_STAGES) * Q_BK * LD;

    // S = Q K^T and dP = dO V^T: 16 query rows x Q_BK keys a warp
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    mma_abt<KD, NK, LD>(s, Qw, Kt, lane);
    mma_abt<KD, NK, LD>(dp, Dw, Vt, lane);

    // dS in place of dP: element e of n-tile n is row row0 + (e >> 1) 8,
    // key j Q_BK + 8 n + 2 t + (e & 1)
    const int kt0 = j * Q_BK;
    const bool masked = kt0 + Q_BK > Skv || q0 + Q_BQ > Sq ||
                        (causal && kt0 + Q_BK - 1 > q0 + offset);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = !masked || visible(row0 + r * 8,
                                           kt0 + n * 8 + 2 * t + (e & 1), Sq,
                                           Skv, causal, offset);
        const float p = ok ? ex2(fmaf(s[n][e], scale_log2, nl[r])) : 0.0f;
        dp[n][e] = p * (dp[n][e] - dl[r]);
      }

    // dQ += dS K
    mma_pz<NK / 2, ND, LD>(dq_acc, dp, Kt, lane);
  }
  cp_async_wait<0>();
  store_rows<ND>(dq + qb * D, dq_acc, row0, Sq, scale, t);
}

template <int D>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* delta, void* dq,
                   void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
                   int Skv, int causal, float scale, cudaStream_t s) {
  static_assert(MMA_THREADS == 128, "stage_bf16 copies with 128 threads");
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // dQ first: it also writes delta, which the dK/dV kernel reads
  auto q_kernel = flash_bwd_q_mma_kernel<D>;
  e = allow_smem(q_kernel, bwd_q_mma_smem<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  q_kernel<<<dim3(Hq, B, (Sq + Q_BQ - 1) / Q_BQ), MMA_THREADS,
             bwd_q_mma_smem<D>(), s>>>(qt, kt, vt, static_cast<const bf16*>(o),
                                       dot, ls, dl, static_cast<bf16*>(dq),
                                       Hq, Hkv, Sq, Skv, causal,
                                       scale * LOG2E, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kv_kernel = flash_bwd_kv_mma_kernel<D>;
  e = allow_smem(kv_kernel, bwd_kv_mma_smem<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  kv_kernel<<<B * Hkv * ((Skv + KV_BK - 1) / KV_BK), MMA_THREADS,
              bwd_kv_mma_smem<D>(), s>>>(
      qt, kt, vt, dot, ls, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      B, Hq, Hkv, Sq, Skv, causal, scale * LOG2E, scale, sms);
  return static_cast<int>(cudaGetLastError());
}

// The backward of each type: tensor cores for bf16, FMA for fp32.
template <typename T, int D>
struct Backward;
template <int D>
struct Backward<bf16, D> {
  static int run(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* delta, void* dq,
                 void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
                 int causal, float scale, cudaStream_t s) {
    return launch_bwd_mma<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq,
                             Hkv, Sq, Skv, causal, scale, s);
  }
};
template <int D>
struct Backward<float, D> {
  static int run(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* delta, void* dq,
                 void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
                 int causal, float scale, cudaStream_t s) {
    return launch_bwd<float, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                Hq, Hkv, Sq, Skv, causal, scale, s);
  }
};

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* delta, void* dq,
                 void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
                 int D, int causal, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return Backward<T, 16>::run(q, k, v, o, dout, lse, delta, dq, dk,
                                  dv, B, Hq, Hkv, Sq, Skv, causal, scale, s);
    case 32:
      return Backward<T, 32>::run(q, k, v, o, dout, lse, delta, dq, dk,
                                  dv, B, Hq, Hkv, Sq, Skv, causal, scale, s);
    case 64:
      return Backward<T, 64>::run(q, k, v, o, dout, lse, delta, dq, dk,
                                  dv, B, Hq, Hkv, Sq, Skv, causal, scale, s);
    case 128:
      return Backward<T, 128>::run(q, k, v, o, dout, lse, delta, dq, dk,
                                   dv, B, Hq, Hkv, Sq, Skv, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------------- dispatch

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int Hq, int Hkv, int Sq, int Skv, int kv_stride, int D,
             int causal, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return Prefill<T, 16>::run(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv,
                                 kv_stride, causal, scale, s);
    case 32:
      return Prefill<T, 32>::run(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv,
                                 kv_stride, causal, scale, s);
    case 64:
      return Prefill<T, 64>::run(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv,
                                 kv_stride, causal, scale, s);
    case 128:
      return Prefill<T, 128>::run(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv,
                                  kv_stride, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_decode(const void* q, const void* k, const void* v, void* o,
                    void* ws, int B, int Hq, int Hkv, int Sq, int Skv,
                    int kv_stride, int D, int causal, float scale,
                    int rows_per_split, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_decode<T, 16>(q, k, v, o, ws, B, Hq, Hkv, Sq, Skv,
                                  kv_stride, causal, scale, rows_per_split,
                                  splits, s);
    case 32:
      return launch_decode<T, 32>(q, k, v, o, ws, B, Hq, Hkv, Sq, Skv,
                                  kv_stride, causal, scale, rows_per_split,
                                  splits, s);
    case 64:
      return launch_decode<T, 64>(q, k, v, o, ws, B, Hq, Hkv, Sq, Skv,
                                  kv_stride, causal, scale, rows_per_split,
                                  splits, s);
    case 128:
      return launch_decode<T, 128>(q, k, v, o, ws, B, Hq, Hkv, Sq, Skv,
                                   kv_stride, causal, scale, rows_per_split,
                                   splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points for ctypes.  q, o: (B, Hq, Sq, D) contiguous;
// k, v: (B, Hkv, kv_stride, D) contiguous, of which rows [0, Skv) are
// read; q, k and v 16-byte aligned.  D is one of 16, 32, 64, 128.  Each
// returns cudaGetLastError() after its launches (0 = launched).
// Prefill; lse, where not null, takes the fp32 natural log-sum-exp of
// each query row's scaled scores, (B, Hq, Sq) (-1e30 for a row with no
// visible key): the forward under autograd, for the backward.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int Hq, int Hkv, int Sq, int Skv,
                                   int kv_stride, int D, int causal,
                                   float scale, void* stream) {
  return dispatch<float>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, kv_stride, D,
                         causal, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int Hq, int Hkv, int Sq, int Skv,
                                    int kv_stride, int D, int causal,
                                    float scale, void* stream) {
  return dispatch<bf16>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, kv_stride, D,
                        causal, scale, stream);
}

// Split-KV decode for Sq * Hq / Hkv <= 16: `splits` blocks per (batch, KV
// head), each over `rows_per_split` keys; with splits > 1, ws is an fp32
// workspace of B * Hkv * Sq * (Hq / Hkv) * splits * (D + 2) floats and a
// second kernel merges the splits.
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                void* o, void* ws, int B, int Hq, int Hkv,
                                int Sq, int Skv, int kv_stride, int D,
                                int causal, float scale, int rows_per_split,
                                int splits, void* stream) {
  return dispatch_decode<float>(q, k, v, o, ws, B, Hq, Hkv, Sq, Skv,
                                kv_stride, D, causal, scale, rows_per_split,
                                splits, stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 void* o, void* ws, int B, int Hq, int Hkv,
                                 int Sq, int Skv, int kv_stride, int D,
                                 int causal, float scale, int rows_per_split,
                                 int splits, void* stream) {
  return dispatch_decode<bf16>(q, k, v, o, ws, B, Hq, Hkv, Sq, Skv,
                               kv_stride, D, causal, scale, rows_per_split,
                               splits, stream);
}

// Backward of the prefill kernels: q, dout, dq (B, Hq, Sq, D); k, v, dk, dv
// (B, Hkv, Skv, D); o the forward's output; lse its (B, Hq, Sq) fp32
// log-sum-exp; delta an fp32 workspace of B * Hq * Sq.  All contiguous and
// 16-byte aligned; dq, dk, dv in the operands' type.  fp32: the FMA
// kernels (section 4); bf16: the tensor-core kernels (section 5).
extern "C" int flash_attention_bwd_f32(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk,
                                       void* dv, int B, int Hq, int Hkv,
                                       int Sq, int Skv, int D, int causal,
                                       float scale, void* stream) {
  return dispatch_bwd<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq,
                             Hkv, Sq, Skv, D, causal, scale, stream);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk,
                                        void* dv, int B, int Hq, int Hkv,
                                        int Sq, int Skv, int D, int causal,
                                        float scale, void* stream) {
  return dispatch_bwd<bf16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq,
                            Hkv, Sq, Skv, D, causal, scale, stream);
}
