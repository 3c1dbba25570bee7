// ssd: the Mamba-2 chunked state-space-duality scan, as a hand-written
// Hopper kernel.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` (src/repro/kernels/ssd.py:31)
// and the head flatten / group repeat / padding that `ops.ssd` wraps around
// it (src/repro/kernels/ops.py:132-146).  For x (B, S, H, P), a (B, S, H)
// fp32, b and c (B, S, G, N) it computes, chunk by chunk of L positions,
//
//   acs    = cumsum(a)                              (within the chunk)
//   y      = ((C B^T) o tril(exp(acs_t - acs_s))) X  +  exp(acs) o (C S^T)
//   S      = exp(acs_last) S + X^T (B o exp(acs_last - acs))
//
// with the (P, N) fp32 state S carried from chunk to chunk, starting from
// the initial state (or zero) and written out after position S - 1.  Head
// h reads group h / (H / G).  Positions at or past the true length are
// staged as a = 0, x = b = c = 0, so the state passes them unchanged and
// nothing past the length is ever read.  fp32 arithmetic; y in x's type.
//
// The TPU kernel walks the chunks along a sequential ("arbitrary") grid
// axis with the state in VMEM scratch.  Here blocks run in parallel and
// in no order, so one block owns one (batch, head) row and loops over its
// chunks itself, with the state in registers for the whole loop: 256
// threads as a 16 x 16 grid, thread (tx, ty) holding state rows
// p = ty + 16 i and columns n = tx + 16 j.  The kernel reads x, b and c
// where they lie, through batch and position strides: no copy of the
// heads into rows, no repeat of B and C per head (80 copies for
// mamba2-2.7b) and no padded copy; the true S is an argument.
//
// Shared memory per block (fp32, rows padded by one float so that column
// walks hit distinct banks): C and B of the chunk (L x N each), X (L x P),
// acs (L), and one region R that holds first C B^T masked by the decay
// (L x L), then a copy of the state (P x N) for the readout C S^T.  At
// L = 128, N = 128, P = 64 that is 231,936 bytes of the 232,448 a block
// may have, so one block an SM.  Per chunk:
//   1. stage C, B, X (eight loads a thread in flight), cumsum of a by one
//      warp;
//   2. R = (C B^T) o L, the tiles above the diagonal skipped and written
//      as 0; the exponential is evaluated only where s <= t (above the
//      diagonal acs_t - acs_s is large and positive: exp * 0 would be
//      NaN);
//   3. y = R X, again only over the tiles at or below the diagonal;
//   4. R = S; y += (C o exp(acs)) S^T; store y;
//   5. S = exp(acs_last) S + X^T (B o exp(acs_last - acs)), in registers.
//
// Bound on the H100: at mamba2-2.7b's prefill (B 4, S 512, H 80, P 64,
// N 128, chunk 128) the function needs L^2 N + L^2 P + 2 L N P
// multiply-adds per (row, chunk), 13.4 GFLOP in all, against 54 MB of
// bytes: bound by operations (0.200 ms at the fp32 FMA peak).  This kernel
// computes with fp32 FMA on the CUDA cores (no mma, wgmma or TMA), one
// block an SM; tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_P = 64;    // head dim
constexpr int MAX_N = 128;   // state dim
constexpr int PI = MAX_P / 16;
constexpr int NJ = MAX_N / 16;
constexpr int UNROLL = 8;    // staging loads in flight per thread

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stages rows [0, rows) x cols of src (row stride `stride` elements,
// columns contiguous) into dst (row stride ld) as fp32; rows at or past
// `valid` are zero and never read.
template <typename T>
__device__ __forceinline__ void stage(const T* src, long long stride,
                                      int valid, int rows, int cols,
                                      float* dst, int ld) {
  const int total = rows * cols;
  for (int base = 0; base < total; base += THREADS * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS + threadIdx.x;
      const int r = i / cols;
      v[u] = (i < total && r < valid) ? load(src + r * stride + (i - r * cols))
                                      : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS + threadIdx.x;
      if (i < total) {
        const int r = i / cols;
        dst[r * ld + (i - r * cols)] = v[u];
      }
    }
  }
}

size_t smem_floats(int L, int P, int N) {
  const size_t r = (size_t)L * (L + 1) > (size_t)P * (N + 1)
                       ? (size_t)L * (L + 1)
                       : (size_t)P * (N + 1);
  return 2 * (size_t)L * (N + 1) + (size_t)L * (P + 1) + L + r;
}

// LI = 16-row tiles of a chunk (L <= 16 LI).
template <typename T, int LI>
__global__ void __launch_bounds__(THREADS, 1)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ a,
           const T* __restrict__ b, const T* __restrict__ c,
           const float* __restrict__ init, T* __restrict__ y,
           float* __restrict__ fin, int S, int H, int P, int G, int N, int L,
           long long xsb, long long xss, long long asb, long long ass,
           long long bsb, long long bss, long long csb, long long css) {
  extern __shared__ float smem[];
  const int LDN = N + 1, LDP = P + 1, LDL = L + 1;
  float* Cs = smem;              // L x LDN
  float* Bs = Cs + L * LDN;      // L x LDN
  float* Xs = Bs + L * LDN;      // L x LDP
  float* acs = Xs + L * LDP;     // L
  float* R = acs + L;            // L x LDL, then P x LDN

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int g = h / (H / G);
  const T* xh = x + bi * xsb + (long long)h * P;
  const float* ah = a + bi * asb + h;
  const T* bg = b + bi * bsb + (long long)g * N;
  const T* cg = c + bi * csb + (long long)g * N;
  T* yh = y + ((size_t)bi * S * H + h) * P;
  const size_t state_off = ((size_t)bi * H + h) * P * N;

  // clamped indices: rows and columns past L, P or N read valid shared
  // memory and are never stored
  int tl[LI], sl[LI], pj[PI], nj[NJ];  // rows t, s of a chunk; p; n
#pragma unroll
  for (int i = 0; i < LI; ++i) {
    tl[i] = min(ty + 16 * i, L - 1);
    sl[i] = min(tx + 16 * i, L - 1);
  }
#pragma unroll
  for (int j = 0; j < PI; ++j) pj[j] = min(tx + 16 * j, P - 1);
#pragma unroll
  for (int j = 0; j < NJ; ++j) nj[j] = min(tx + 16 * j, N - 1);

  float st[PI][NJ];   // state rows p = ty + 16 i, columns n = tx + 16 j
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int p = ty + 16 * i, n = tx + 16 * j;
      st[i][j] = (init != nullptr && p < P && n < N)
                     ? init[state_off + (size_t)p * N + n]
                     : 0.0f;
    }

  for (int c0 = 0; c0 < S; c0 += L) {
    const int len = min(L, S - c0);
    __syncthreads();  // the last chunk's shared tiles are read
    // 1. stage the chunk; cumsum of a by warp 0, four positions a lane
    stage<T>(cg + c0 * css, css, len, L, N, Cs, LDN);
    stage<T>(bg + c0 * bss, bss, len, L, N, Bs, LDN);
    stage<T>(xh + c0 * xss, xss, len, L, P, Xs, LDP);
    if (tid < 32) {
      float v[4], run = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * tid + k;
        run += t < len ? ah[(long long)(c0 + t) * ass] : 0.0f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += u;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * tid + k < L) acs[4 * tid + k] = excl + v[k];
    }
    __syncthreads();

    // 2. R[t][s] = exp(acs_t - acs_s) (C_t . B_s) for s <= t, else 0
    {
      float acc[LI][LI];
#pragma unroll
      for (int i = 0; i < LI; ++i)
#pragma unroll
        for (int j = 0; j < LI; ++j) acc[i][j] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[LI], bv[LI];
#pragma unroll
        for (int i = 0; i < LI; ++i) cv[i] = Cs[tl[i] * LDN + n];
#pragma unroll
        for (int j = 0; j < LI; ++j) bv[j] = Bs[sl[j] * LDN + n];
#pragma unroll
        for (int i = 0; i < LI; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < LI; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < LI; ++j) {
          const int s = tx + 16 * j;
          if (t < L && s < L)
            R[t * LDL + s] =
                (j <= i && s <= t) ? expf(acs[t] - acs[s]) * acc[i][j] : 0.0f;
        }
      }
    }
    __syncthreads();

    // 3. y[t][p] = sum_{s <= t} R[t][s] X[s][p]
    float yacc[LI][PI];
#pragma unroll
    for (int i = 0; i < LI; ++i)
#pragma unroll
      for (int j = 0; j < PI; ++j) yacc[i][j] = 0.0f;
#pragma unroll
    for (int sb = 0; sb < LI; ++sb) {
      const int send = min(16, L - 16 * sb);
      for (int ss = 0; ss < send; ++ss) {
        const int s = 16 * sb + ss;
        float xv[PI];
#pragma unroll
        for (int j = 0; j < PI; ++j) xv[j] = Xs[s * LDP + pj[j]];
#pragma unroll
        for (int i = sb; i < LI; ++i) {
          const float r = R[tl[i] * LDL + s];
#pragma unroll
          for (int j = 0; j < PI; ++j) yacc[i][j] = fmaf(r, xv[j], yacc[i][j]);
        }
      }
    }
    __syncthreads();  // R (C B^T) is read

    // 4. R = S; y[t][p] += exp(acs_t) sum_n C[t][n] S[p][n]
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int p = ty + 16 * i, n = tx + 16 * j;
        if (p < P && n < N) R[p * LDN + n] = st[i][j];
      }
    __syncthreads();
    {
      float et[LI];
#pragma unroll
      for (int i = 0; i < LI; ++i) et[i] = expf(acs[tl[i]]);
      for (int n = 0; n < N; ++n) {
        float cv[LI], sv[PI];
#pragma unroll
        for (int i = 0; i < LI; ++i) cv[i] = Cs[tl[i] * LDN + n] * et[i];
#pragma unroll
        for (int j = 0; j < PI; ++j) sv[j] = R[pj[j] * LDN + n];
#pragma unroll
        for (int i = 0; i < LI; ++i)
#pragma unroll
          for (int j = 0; j < PI; ++j) yacc[i][j] = fmaf(cv[i], sv[j], yacc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < LI; ++i) {
      const int t = ty + 16 * i;
      if (t >= len) continue;
#pragma unroll
      for (int j = 0; j < PI; ++j) {
        const int p = tx + 16 * j;
        if (p < P) store(yh + (size_t)(c0 + t) * H * P + p, yacc[i][j]);
      }
    }

    // 5. S = exp(acs_last) S + sum_s X[s]^T (B[s] exp(acs_last - acs_s))
    {
      const float last = acs[L - 1];  // = acs[len - 1]: the tail has a = 0
      const float decay = expf(last);
#pragma unroll
      for (int i = 0; i < PI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) st[i][j] *= decay;
      for (int s = 0; s < len; ++s) {
        const float w = expf(last - acs[s]);
        float xv[PI], bv[NJ];
#pragma unroll
        for (int i = 0; i < PI; ++i)
          xv[i] = Xs[s * LDP + min(ty + 16 * i, P - 1)] * w;
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = Bs[s * LDN + nj[j]];
#pragma unroll
        for (int i = 0; i < PI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) st[i][j] = fmaf(xv[i], bv[j], st[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int p = ty + 16 * i, n = tx + 16 * j;
      if (p < P && n < N) fin[state_off + (size_t)p * N + n] = st[i][j];
    }
}

template <typename T, int LI>
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* init, void* y, void* fin, int B, int S, int H, int P,
           int G, int N, int L, long long xsb, long long xss, long long asb,
           long long ass, long long bsb, long long bss, long long csb,
           long long css, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(L, P, N);
  auto kernel = ssd_kernel<T, LI>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(init), static_cast<T*>(y),
      static_cast<float*>(fin), S, H, P, G, N, L, xsb, xss, asb, ass, bsb,
      bss, csb, css);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* a, const void* b, const void* c,
             const void* init, void* y, void* fin, int B, int S, int H,
             int P, int G, int N, int L, long long xsb, long long xss,
             long long asb, long long ass, long long bsb, long long bss,
             long long csb, long long css, void* stream) {
  if (L < 1 || L > 128 || P < 1 || P > MAX_P || N < 1 || N > MAX_N ||
      G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_LAUNCH(LI)                                                      \
  launch<T, LI>(x, a, b, c, init, y, fin, B, S, H, P, G, N, L, xsb, xss,  \
                asb, ass, bsb, bss, csb, css, s)
  if (L <= 16) return SSD_LAUNCH(1);
  if (L <= 32) return SSD_LAUNCH(2);
  if (L <= 64) return SSD_LAUNCH(4);
  return SSD_LAUNCH(8);
#undef SSD_LAUNCH
}

}  // namespace

// Plain C entry points for ctypes.  x (B, S, H, P) and b, c (B, S, G, N)
// in the entry point's type, a (B, S, H) fp32, each with its batch and
// position strides in elements and its last dims contiguous (x: (H, P)
// with strides (P, 1); a: H with stride 1; b, c: (G, N) with strides
// (N, 1)); init (B, H, P, N) fp32 or null for zero; y (B, S, H, P) and
// fin (B, H, P, N) contiguous outputs.  L is the chunk (1..128), P <= 64,
// N <= 128.  Each returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int ssd_f32(const void* x, const void* a, const void* b,
                       const void* c, const void* init, void* y, void* fin,
                       int B, int S, int H, int P, int G, int N, int L,
                       long long xsb, long long xss, long long asb,
                       long long ass, long long bsb, long long bss,
                       long long csb, long long css, void* stream) {
  return dispatch<float>(x, a, b, c, init, y, fin, B, S, H, P, G, N, L, xsb,
                         xss, asb, ass, bsb, bss, csb, css, stream);
}

extern "C" int ssd_bf16(const void* x, const void* a, const void* b,
                        const void* c, const void* init, void* y, void* fin,
                        int B, int S, int H, int P, int G, int N, int L,
                        long long xsb, long long xss, long long asb,
                        long long ass, long long bsb, long long bss,
                        long long csb, long long css, void* stream) {
  return dispatch<__nv_bfloat16>(x, a, b, c, init, y, fin, B, S, H, P, G, N,
                                 L, xsb, xss, asb, ass, bsb, bss, csb, css,
                                 stream);
}
