// ssd: the Mamba-2 chunked state-space-duality scan, as hand-written
// Hopper kernels.
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
// nothing past the length is ever read.  y in x's type.
//
// The TPU kernel walks the chunks along a sequential ("arbitrary") grid
// axis with the state in VMEM scratch.  Here the work follows the SSD
// decomposition of Mamba-2 (chunk state, state passing, chunk scan) in two
// kernels on one stream, the first two phases fused: the state is carried
// through the chunks in registers, so no chunk's delta goes through
// memory and no third kernel passes the state.  At mamba2-2.7b's prefill
// that measured faster than three kernels (PERF.md); a single long prompt,
// where few blocks run many chunks in series, gains less from it:
//
//   A+B. ssd_state_*  grid (N / 32, head, batch): block q carries columns
//        [32 q, 32 q + 32) of the (P, N) state of (batch, head) through
//        the chunks in series, spread over its threads.  Per chunk: the
//        cumsum, D_c = X^T (B o exp(acs_last - acs)), the state entering
//        the chunk written to the chunk's scratch slot, and S =
//        exp(acs_last) S + D_c; the last state goes to `fin`.
//   C.   ssd_scan_*   grid (chunk, head, batch): y of the chunk from its
//        C, B, X and the state entering it; y is written once.
//
// Both grids are 1,280 blocks at mamba2-2.7b's prefill.  The scratch
// (B x chunks x H x P x N fp32, 42 MB there) comes from the wrapper
// (torch.empty); ssd_plan in kernels/ssd.py gives the grids.  x, b and c
// are read where they lie, through batch and position strides (b and c
// are views into the SSM block's xbc): no copy of the heads into rows, no
// repeat of B and C per head (80 copies for mamba2-2.7b), no padded copy.
//
// bf16 (the served path): every product on the tensor cores, as
// mma.sync.m16n8k16 bf16 with fp32 accumulators (mma.cuh).  C, B and X
// are staged in shared memory as bf16 by 16-byte cp.async copies when
// every base pointer and stride is 16-byte aligned (else by element loads
// in the same kernels), the 16-byte chunks of each row XOR-swizzled so
// that ldmatrix is free of bank conflicts without padding (which lets
// phase C fit two blocks an SM, 115,200 bytes each); a chunk whose
// length is not a multiple of 16 is padded with zero rows, and P and N
// with zero columns to 64 and 128.
// C, B and X are bf16 inputs, so they are exact operands.  Three operands
// are fp32 products, and one rounding of any of them to bf16 breaks the
// card checks (y within 2^-7 relative of the fp32 sums; the state within
// 1e-4; tests/test_torch_ssd.py emulates the kernel on the CPU and shows
// B o w rounded once failing the state check).  So each enters as a bf16
// high part plus a bf16 low part (lo = bf16(v - hi), about 16 bits of
// mantissa together), in two mma into one accumulator:
//   - B o w in phase A+B, w_s = exp(acs_last - acs_s) <= 1;
//   - R = (C B^T) o L in phase C, kept in registers from the C B^T
//     accumulators: masked and scaled there, split, and packed as the A
//     fragments of R X (the m16n8 layout of two n-tiles is the m16k16 A
//     layout), 16 positions s at a time;
//   - the carried state S in phase C.  exp(acs_t) is a row scale, so it
//     multiplies the fp32 accumulators of C S^T and C stays exact.
// exp(acs_t - acs_s) is selected only where s <= t: above the diagonal it
// overflows, and inf * 0 is NaN.  Phase C: one warp per 16 rows t of the
// chunk, 8 warps; warp w runs the 16-position tiles s <= its own (the
// tiles above the diagonal are skipped), C B^T over the even and the odd
// k-steps in separate accumulators (four mma chains).  Phase A+B: 4
// warps, each 16 rows p by the block's 32 columns, D_c and the state in
// the mma accumulator layout.
//
// fp32: the same grids and phases, every product on fp32 FMA (never
// TF32), threads as a 16 x 16 (scan) or 16 x 8 (state) grid; C, B, X
// staged as fp32 rows padded by one float, so that column walks hit
// distinct banks.
//
// Bound on the H100, at mamba2-2.7b's prefill (B 4, S 512, H 80, P 64,
// N 128, G 1, chunk 128): C B^T and its product with X over the causal
// pairs, L(L+1)/2 (N + P) multiply-adds per (row, chunk), plus 2 L N P for
// the readout of the state and its update, 9.427 GFLOP in all, against
// 54.13 MB of x, y, a, b, c and the final state read or written once
// (chip_smoke.py's ssd_work).  On the bf16 tensor cores the bytes bound it
// (0.0162 ms at 3.35 TB/s; the operations take 0.0095 ms at 989 TFLOP/s).
// The fp32 path is bound by the operations at the fp32 FMA peak (0.1407
// ms at 67 TFLOP/s for the same shape).  The design's own traffic, the
// states written by the state kernel and read by the scan, is not in
// the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LMAX = 128;    // chunk length
constexpr int PMAX = 64;     // head dim
constexpr int NMAX = 128;    // state dim
constexpr int QN = 32;       // state columns n a state block carries
constexpr int ST_THREADS = 128;  // a state block: 4 warps
constexpr int CN = NMAX / 8;   // 16-byte chunks of a bf16 row of C, B, S
constexpr int CP = PMAX / 8;   // of X
constexpr int CQ = QN / 8;     // of a state block's columns of B
constexpr int PI = PMAX / 16;  // fp32 scan: rows t and columns p of a
                               // thread in the 16 x 16 grid
constexpr int UNROLL = 8;      // fp32 staging loads in flight per thread

__device__ __forceinline__ size_t slot(int bi, int ci, int h, int nc, int H) {
  return ((size_t)bi * nc + ci) * H + h;
}

// acs[t] = a[0] + ... + a[t] over the chunk (a = 0 at or past `len`), for
// every t < LMAX, so acs[LMAX - 1] is the chunk's decay; by warp 0, four
// positions a lane.
__device__ __forceinline__ void chunk_cumsum(const float* ah, long long ass,
                                             int len, float* acs) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  float v[4], run = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = 4 * lane + k;
    run += t < len ? ah[(long long)t * ass] : 0.0f;
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) acs[4 * lane + k] = excl + v[k];
}

// ----------------------------------------------- bf16: tensor cores

// Element offset of 16-byte chunk k of row r in a shared bf16 tile of CH
// chunks a row (CH = 4, 8 or 16).  The chunk index is XOR-swizzled with
// the row, so that the 8 rows an ldmatrix reads at one column fall in
// distinct banks without padding the rows: rows of 8 or more chunks
// swizzle by the row's low three bits; rows of 4 chunks (64 bytes, two
// rows a bank cycle) by bits 1-2.
template <int CH>
__device__ __forceinline__ int swz(int r, int k) {
  return (r * CH + (k ^ (CH >= 8 ? r & 7 : (r >> 1) & 3))) * 8;
}

// Stages rows [0, rows) of a bf16 matrix (row stride `stride` elements,
// `cols` columns) into the swizzled tile dst of CH chunks a row: rows at or
// past `valid` and columns at or past `cols` are zero, and nothing there
// is read.  `vec`: 16-byte cp.async copies (cols, the stride and src
// 16-byte aligned); else element loads.
template <int CH, int NT>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src,
                                           long long stride, int valid,
                                           int rows, int cols, bool vec) {
  const int total = rows * CH;
  for (int i = threadIdx.x; i < total; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    bf16* d = dst + swz<CH>(r, i % CH);
    if (vec) {
      const bool in = r < valid && c < cols;
      cp_async16(d, in ? src + r * stride + c : src, in);
    } else {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (r < valid && c + e < cols) ? src[r * stride + c + e]
                                           : __float2bfloat16(0.0f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// v as hi + lo, both bf16: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split2(float v0, float v1, unsigned& hi,
                                       unsigned& lo) {
  hi = pack_bf16(v0, v1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

constexpr size_t state_mma_smem() {  // X, B (then hi(B o w)), lo(B o w), acs
  return sizeof(bf16) * (LMAX * PMAX + 2 * LMAX * QN) + sizeof(float) * LMAX;
}
// C, B, X, hi(S), lo(S), acs: 115,200 bytes, two blocks an SM
constexpr size_t scan_mma_smem() {
  return sizeof(bf16) * (2 * LMAX * NMAX + LMAX * PMAX + 2 * PMAX * NMAX) +
         sizeof(float) * LMAX;
}

// Phases A and B, bf16: block (q, h, b) carries columns [32 q, 32 q + 32)
// of the (P, N) state of (b, h) through the chunks in series, in the mma
// accumulator layout (warp w: rows p = 16 w + g (+ 8)), and computes each
// chunk's D_c = X^T (B o w) there on the tensor cores, B o w as hi + lo.
// It writes the state entering each chunk to the chunk's scratch slot
// (the first chunk's only from an initial state) and the last to `fin`.
// The next chunk's copies are issued as soon as this chunk's tiles are
// read, so they fly while the state is updated and stored.
__global__ void __launch_bounds__(ST_THREADS)
ssd_state_mma(const bf16* __restrict__ x, const float* __restrict__ a,
              const bf16* __restrict__ b, const float* __restrict__ init,
              float* __restrict__ states, float* __restrict__ fin, int S,
              int H, int P, int G, int N, int L, int nc, long long xsb,
              long long xss, long long asb, long long ass, long long bsb,
              long long bss, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // LMAX x PMAX
  bf16* Bh = Xs + LMAX * PMAX;                   // LMAX x QN
  bf16* Bl = Bh + LMAX * QN;                     // LMAX x QN
  float* acs = reinterpret_cast<float*>(Bl + LMAX * QN);

  const int q = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / G), n0 = q * QN, nq = min(QN, N - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const bf16* xh = x + bi * xsb + (long long)h * P;
  const bf16* bq = b + bi * bsb + (long long)g * N + n0;
  const float* ah = a + bi * asb + h;
  const size_t PN = (size_t)P * N, row = ((size_t)bi * H + h) * PN;
  // this thread's state: rows 16 warp + gq + 8 r, columns n0 + 8 nt + 2 tq
  // (+ 1), at st[nt][2 r] (and + 1)
  auto at = [&](int nt, int e) {
    return (16 * warp + gq + 8 * (e >> 1)) * N + n0 + 8 * nt + 2 * tq +
           (e & 1);
  };
  auto inside = [&](int nt, int e) {
    return 16 * warp + gq + 8 * (e >> 1) < P &&
           n0 + 8 * nt + 2 * tq + (e & 1) < N;
  };
  float st[QN / 8][4];
#pragma unroll
  for (int nt = 0; nt < QN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[nt][e] = init != nullptr && inside(nt, e) ? init[row + at(nt, e)]
                                                   : 0.0f;
  auto issue = [&](int ci) {
    const int c0 = ci * L, len = min(L, S - c0), rows = (len + 15) & ~15;
    stage_bf16<CP, ST_THREADS>(Xs, xh + c0 * xss, xss, len, rows, P, vec);
    stage_bf16<CQ, ST_THREADS>(Bh, bq + c0 * bss, bss, len, rows, nq, vec);
    cp_async_commit();
  };
  issue(0);
  for (int ci = 0; ci < nc; ++ci) {
    const int c0 = ci * L, len = min(L, S - c0), rows = (len + 15) & ~15;
    chunk_cumsum(ah + c0 * ass, ass, len, acs);
    cp_async_wait<0>();
    __syncthreads();

    // B o w in place as its high part, the low part beside it
    const float last = acs[LMAX - 1];
    for (int i = threadIdx.x; i < rows * CQ; i += ST_THREADS) {
      const int r = i / CQ, off = swz<CQ>(r, i % CQ);
      const float w = expf(last - acs[r]);
      uint4* hp = reinterpret_cast<uint4*>(Bh + off);
      const uint4 v = *hp;
      const unsigned* in = reinterpret_cast<const unsigned*>(&v);
      uint4 hi, lo;
      unsigned* ho = reinterpret_cast<unsigned*>(&hi);
      unsigned* lw = reinterpret_cast<unsigned*>(&lo);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 e =
            *reinterpret_cast<const __nv_bfloat162*>(in + k);
        split2(__low2float(e) * w, __high2float(e) * w, ho[k], lw[k]);
      }
      *hp = hi;
      *reinterpret_cast<uint4*>(Bl + off) = lo;
    }
    __syncthreads();

    float d[QN / 8][4];  // D_c: A = X^T (rows p, k = s), B = B o w
#pragma unroll
    for (int nt = 0; nt < QN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[nt][e] = 0.0f;
    if (16 * warp < P) {
      for (int kk = 0; kk < rows / 16; ++kk) {
        unsigned xa[4];
        ldmatrix_x4_trans(xa, Xs + swz<CP>(kk * 16 + (lane & 7) +
                                               (lane >> 4) * 8,
                                           warp * 2 + ((lane >> 3) & 1)));
#pragma unroll
        for (int np = 0; np < QN / 16; ++np) {
          const int off = swz<CQ>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  np * 2 + (lane >> 4));
          unsigned bh[4], bw[4];
          ldmatrix_x4_trans(bh, Bh + off);
          ldmatrix_x4_trans(bw, Bl + off);
          mma_bf16(d[2 * np], xa, bh[0], bh[1]);
          mma_bf16(d[2 * np + 1], xa, bh[2], bh[3]);
          mma_bf16(d[2 * np], xa, bw[0], bw[1]);
          mma_bf16(d[2 * np + 1], xa, bw[2], bw[3]);
        }
      }
    }
    __syncthreads();  // the chunk's tiles are read
    if (ci + 1 < nc) issue(ci + 1);

    // the state entering chunk ci, then the state after it
    const float decay = expf(last);
    float* out = states + slot(bi, ci, h, nc, H) * PN;
#pragma unroll
    for (int nt = 0; nt < QN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if ((ci > 0 || init != nullptr) && inside(nt, e))
          out[at(nt, e)] = st[nt][e];
        st[nt][e] = decay * st[nt][e] + d[nt][e];
      }
  }
#pragma unroll
  for (int nt = 0; nt < QN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (inside(nt, e)) fin[row + at(nt, e)] = st[nt][e];
}

// Phase C, bf16: y = exp(acs) o (C S^T) + ((C B^T) o L) X on the tensor
// cores, S and R as hi + lo.
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_mma(const bf16* __restrict__ x, const float* __restrict__ a,
             const bf16* __restrict__ b, const bf16* __restrict__ c,
             const float* __restrict__ states, bf16* __restrict__ y, int S,
             int H, int P, int G, int N, int L, int nc, long long xsb,
             long long xss, long long asb, long long ass, long long bsb,
             long long bss, long long csb, long long css, int has_init,
             int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // LMAX x NMAX
  bf16* Bs = Cs + LMAX * NMAX;                   // LMAX x NMAX
  bf16* Xs = Bs + LMAX * NMAX;                   // LMAX x PMAX
  bf16* Sh = Xs + LMAX * PMAX;                   // PMAX x NMAX
  bf16* Sl = Sh + PMAX * NMAX;                   // PMAX x NMAX
  float* acs = reinterpret_cast<float*>(Sl + PMAX * NMAX);

  const int ci = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / G);
  const int c0 = ci * L, len = min(L, S - c0), rows = (len + 15) & ~15;
  stage_bf16<CN, THREADS>(Cs, c + bi * csb + c0 * css + (long long)g * N,
                          css, len, rows, N, vec);
  stage_bf16<CN, THREADS>(Bs, b + bi * bsb + c0 * bss + (long long)g * N,
                          bss, len, rows, N, vec);
  stage_bf16<CP, THREADS>(Xs, x + bi * xsb + c0 * xss + (long long)h * P,
                          xss, len, rows, P, vec);
  cp_async_commit();
  // the state entering the chunk (zero, and not staged, for the first
  // chunk without an initial state), as hi + lo, zero past P and N
  const bool carry = has_init || ci > 0;
  if (carry) {
    const float* st = states + slot(bi, ci, h, nc, H) * P * N;
    if (N % 4 == 0) {
      constexpr int Q = PMAX * NMAX / 4 / THREADS;  // float4s a thread
      float4 v[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int i = threadIdx.x + q * THREADS;
        const int p = i / (NMAX / 4), n = (i % (NMAX / 4)) * 4;
        v[q] = (p < P && n < N)
                   ? *reinterpret_cast<const float4*>(st + p * N + n)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int i = threadIdx.x + q * THREADS;
        const int p = i / (NMAX / 4), n = (i % (NMAX / 4)) * 4;
        uint2 hi, lo;
        split2(v[q].x, v[q].y, hi.x, lo.x);
        split2(v[q].z, v[q].w, hi.y, lo.y);
        const int off = swz<CN>(p, n >> 3) + (n & 7);
        *reinterpret_cast<uint2*>(Sh + off) = hi;
        *reinterpret_cast<uint2*>(Sl + off) = lo;
      }
    } else {
      for (int i = threadIdx.x; i < PMAX * NMAX / 2; i += THREADS) {
        const int p = i / (NMAX / 2), n = (i % (NMAX / 2)) * 2;
        const float v0 = (p < P && n < N) ? st[p * N + n] : 0.0f;
        const float v1 = (p < P && n + 1 < N) ? st[p * N + n + 1] : 0.0f;
        unsigned hi, lo;
        split2(v0, v1, hi, lo);
        const int off = swz<CN>(p, n >> 3) + (n & 7);
        *reinterpret_cast<unsigned*>(Sh + off) = hi;
        *reinterpret_cast<unsigned*>(Sl + off) = lo;
      }
    }
  }
  chunk_cumsum(a + bi * asb + c0 * ass + h, ass, len, acs);
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int t0 = warp * 16;  // this warp's rows t of the chunk
  if (t0 >= len) return;
  unsigned cf[NMAX / 16][4];  // C's A fragments, k = n
#pragma unroll
  for (int kk = 0; kk < NMAX / 16; ++kk)
    ldmatrix_x4(cf[kk], Cs + swz<CN>(t0 + (lane & 15), kk * 2 + (lane >> 4)));
  float acc[PMAX / 8][4];  // y: rows t0 + gq (+ 8), columns p
#pragma unroll
  for (int n = 0; n < PMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const int ta = t0 + gq, tb = ta + 8;

  if (carry) {  // exp(acs_t) C S^T, B = S^T from S's rows p
#pragma unroll
    for (int kk = 0; kk < NMAX / 16; ++kk)
#pragma unroll
      for (int np = 0; np < PMAX / 16; ++np) {
        const int off = swz<CN>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                kk * 2 + ((lane >> 3) & 1));
        unsigned sh[4], sl[4];
        ldmatrix_x4(sh, Sh + off);
        ldmatrix_x4(sl, Sl + off);
        mma_bf16(acc[2 * np], cf[kk], sh[0], sh[1]);
        mma_bf16(acc[2 * np + 1], cf[kk], sh[2], sh[3]);
        mma_bf16(acc[2 * np], cf[kk], sl[0], sl[1]);
        mma_bf16(acc[2 * np + 1], cf[kk], sl[2], sl[3]);
      }
    const float ea = expf(acs[ta]), eb = expf(acs[tb]);
#pragma unroll
    for (int n = 0; n < PMAX / 8; ++n) {
      acc[n][0] *= ea;
      acc[n][1] *= ea;
      acc[n][2] *= eb;
      acc[n][3] *= eb;
    }
  }

  // 16 positions s at a time, the tiles at or below the diagonal:
  // R = (C B^T) o exp(acs_t - acs_s) for s <= t, in registers, then
  // y += R X with R as hi + lo A fragments
  for (int j = 0; j <= warp; ++j) {
    float s[2][4], s2[2][4];  // even and odd k-steps: four mma chains
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s2[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NMAX / 16; ++kk) {
      unsigned kb[4];
      ldmatrix_x4(kb, Bs + swz<CN>(j * 16 + (lane & 7) + ((lane >> 4) << 3),
                                   kk * 2 + ((lane >> 3) & 1)));
      float (&d)[2][4] = kk % 2 ? s2 : s;
      mma_bf16(d[0], cf[kk], kb[0], kb[1]);
      mma_bf16(d[1], cf[kk], kb[2], kb[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += s2[n][e];
    unsigned rh[4], rl[4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = r ? tb : ta, s0 = j * 16 + n * 8 + 2 * tq;
        const float at = acs[t];
        const float v0 = s0 <= t ? expf(at - acs[s0]) * s[n][2 * r] : 0.0f;
        const float v1 =
            s0 + 1 <= t ? expf(at - acs[s0 + 1]) * s[n][2 * r + 1] : 0.0f;
        split2(v0, v1, rh[2 * n + r], rl[2 * n + r]);
      }
#pragma unroll
    for (int dp = 0; dp < PMAX / 16; ++dp) {
      unsigned vb[4];
      ldmatrix_x4_trans(vb, Xs + swz<CP>(j * 16 + (lane & 7) +
                                             ((lane >> 3) & 1) * 8,
                                         dp * 2 + (lane >> 4)));
      mma_bf16(acc[2 * dp], rh, vb[0], vb[1]);
      mma_bf16(acc[2 * dp + 1], rh, vb[2], vb[3]);
      mma_bf16(acc[2 * dp], rl, vb[0], vb[1]);
      mma_bf16(acc[2 * dp + 1], rl, vb[2], vb[3]);
    }
  }

  // y rows t < len, columns p < P
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r ? tb : ta;
    if (t >= len) continue;
    bf16* yr = y + ((size_t)bi * S + c0 + t) * H * P + (size_t)h * P;
#pragma unroll
    for (int n = 0; n < PMAX / 8; ++n) {
      const int p = n * 8 + 2 * tq;
      if (p + 1 < P && P % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(yr + p) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
      } else {
        if (p < P) yr[p] = __float2bfloat16(acc[n][2 * r]);
        if (p + 1 < P) yr[p + 1] = __float2bfloat16(acc[n][2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------- fp32: FMA

// Stages rows [0, rows) x cols of src (row stride `stride` elements,
// columns contiguous) into dst (row stride ld); rows at or past `valid`
// are zero and never read.
template <int NT>
__device__ __forceinline__ void stage_f32(const float* src, long long stride,
                                          int valid, int rows, int cols,
                                          float* dst, int ld) {
  const int total = rows * cols;
  for (int base = 0; base < total; base += NT * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * NT + threadIdx.x;
      const int r = i / cols;
      v[u] = (i < total && r < valid) ? src[r * stride + (i - r * cols)]
                                      : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * NT + threadIdx.x;
      if (i < total) {
        const int r = i / cols;
        dst[r * ld + (i - r * cols)] = v[u];
      }
    }
  }
}

size_t state_fma_floats(int L, int P) {  // X, B's columns, acs
  return (size_t)L * (P + 1) + (size_t)L * (QN + 1) + LMAX;
}
size_t scan_fma_floats(int L, int P, int N) {  // C, B, X, acs, R or S
  const size_t r = (size_t)L * (L + 1) > (size_t)P * (N + 1)
                       ? (size_t)L * (L + 1)
                       : (size_t)P * (N + 1);
  return 2 * (size_t)L * (N + 1) + (size_t)L * (P + 1) + LMAX + r;
}

// Phases A and B, fp32: block (q, h, b) carries columns [32 q, 32 q + 32)
// of the state through the chunks in series, thread (tx, ty) rows
// p = ty + 16 i and columns n = 32 q + tx + 8 j:
// S = exp(acs_last) S + sum_s X[s]^T (B[s] exp(acs_last - acs_s)).
__global__ void __launch_bounds__(ST_THREADS)
ssd_state_fma(const float* __restrict__ x, const float* __restrict__ a,
              const float* __restrict__ b, const float* __restrict__ init,
              float* __restrict__ states, float* __restrict__ fin, int S,
              int H, int P, int G, int N, int L, int nc, long long xsb,
              long long xss, long long asb, long long ass, long long bsb,
              long long bss) {
  extern __shared__ float smem[];
  const int LDX = P + 1, LDB = QN + 1;
  float* Xs = smem;              // L x LDX
  float* Bs = Xs + L * LDX;      // L x LDB
  float* acs = Bs + L * LDB;     // LMAX
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / G), n0 = q * QN, nq = min(QN, N - n0);
  const size_t PN = (size_t)P * N, row = ((size_t)bi * H + h) * PN;
  float st[PI][QN / 8];
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < QN / 8; ++j) {
      const int p = ty + 16 * i, n = n0 + tx + 8 * j;
      st[i][j] = init != nullptr && p < P && n < N ? init[row + p * N + n]
                                                   : 0.0f;
    }
  for (int ci = 0; ci < nc; ++ci) {
    const int c0 = ci * L, len = min(L, S - c0);
    __syncthreads();  // the last chunk's tiles are read
    stage_f32<ST_THREADS>(x + bi * xsb + c0 * xss + (long long)h * P, xss,
                          len, L, P, Xs, LDX);
    stage_f32<ST_THREADS>(b + bi * bsb + c0 * bss + (long long)g * N + n0,
                          bss, len, L, nq, Bs, LDB);
    chunk_cumsum(a + bi * asb + c0 * ass + h, ass, len, acs);
    __syncthreads();

    const float last = acs[LMAX - 1], decay = expf(last);
    float* out = states + slot(bi, ci, h, nc, H) * PN;
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < QN / 8; ++j) {
        const int p = ty + 16 * i, n = n0 + tx + 8 * j;
        if ((ci > 0 || init != nullptr) && p < P && n < N)
          out[p * N + n] = st[i][j];
        st[i][j] *= decay;
      }
    for (int s = 0; s < len; ++s) {
      const float w = expf(last - acs[s]);
      float xv[PI], bv[QN / 8];
#pragma unroll
      for (int i = 0; i < PI; ++i)
        xv[i] = Xs[s * LDX + min(ty + 16 * i, P - 1)] * w;
#pragma unroll
      for (int j = 0; j < QN / 8; ++j)
        bv[j] = Bs[s * LDB + min(tx + 8 * j, nq - 1)];
#pragma unroll
      for (int i = 0; i < PI; ++i)
#pragma unroll
        for (int j = 0; j < QN / 8; ++j)
          st[i][j] = fmaf(xv[i], bv[j], st[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < QN / 8; ++j) {
      const int p = ty + 16 * i, n = n0 + tx + 8 * j;
      if (p < P && n < N) fin[row + p * N + n] = st[i][j];
    }
}

// Phase C, fp32; LI = 16-row tiles of a chunk (L <= 16 LI).  Thread
// (tx, ty) computes rows t = ty + 16 i and columns p = tx + 16 j of y.
template <int LI>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_fma(const float* __restrict__ x, const float* __restrict__ a,
             const float* __restrict__ b, const float* __restrict__ c,
             const float* __restrict__ states, float* __restrict__ y, int S,
             int H, int P, int G, int N, int L, int nc, long long xsb,
             long long xss, long long asb, long long ass, long long bsb,
             long long bss, long long csb, long long css, int has_init) {
  extern __shared__ float smem[];
  const int LDN = N + 1, LDP = P + 1, LDL = L + 1;
  float* Cs = smem;              // L x LDN
  float* Bs = Cs + L * LDN;     // L x LDN
  float* Xs = Bs + L * LDN;     // L x LDP
  float* acs = Xs + L * LDP;    // LMAX
  float* R = acs + LMAX;         // L x LDL, then P x LDN

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ci = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / G);
  const int c0 = ci * L, len = min(L, S - c0);
  // clamped indices: rows and columns past L or P read valid shared
  // memory and are never stored
  int tl[LI], sl[LI], pj[PI];
#pragma unroll
  for (int i = 0; i < LI; ++i) {
    tl[i] = min(ty + 16 * i, L - 1);
    sl[i] = min(tx + 16 * i, L - 1);
  }
#pragma unroll
  for (int j = 0; j < PI; ++j) pj[j] = min(tx + 16 * j, P - 1);

  stage_f32<THREADS>(c + bi * csb + c0 * css + (long long)g * N, css, len, L,
                     N, Cs, LDN);
  stage_f32<THREADS>(b + bi * bsb + c0 * bss + (long long)g * N, bss, len, L,
                     N, Bs, LDN);
  stage_f32<THREADS>(x + bi * xsb + c0 * xss + (long long)h * P, xss, len, L,
                     P, Xs, LDP);
  chunk_cumsum(a + bi * asb + c0 * ass + h, ass, len, acs);
  __syncthreads();

  // R[t][s] = exp(acs_t - acs_s) (C_t . B_s) for s <= t, else 0; the
  // exponential is evaluated only where s <= t
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

  // y[t][p] = sum_{s <= t} R[t][s] X[s][p]
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

  // y[t][p] += exp(acs_t) sum_n C[t][n] S[p][n], S the state entering
  // the chunk (zero for the first chunk without an initial state)
  if (has_init || ci > 0) {
    __syncthreads();  // R (C B^T) is read
    const float* st = states + slot(bi, ci, h, nc, H) * P * N;
    for (int i = tid; i < P * N; i += THREADS) {
      const int p = i / N;
      R[p * LDN + (i - p * N)] = st[i];
    }
    __syncthreads();
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
        for (int j = 0; j < PI; ++j)
          yacc[i][j] = fmaf(cv[i], sv[j], yacc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < LI; ++i) {
    const int t = ty + 16 * i;
    if (t >= len) continue;
#pragma unroll
    for (int j = 0; j < PI; ++j) {
      const int p = tx + 16 * j;
      if (p < P) y[((size_t)bi * S + c0 + t) * H * P + (size_t)h * P + p] =
          yacc[i][j];
    }
  }
}

// ------------------------------------------------------------ backward
// The gradients of y and of the final state give, per chunk (no Pallas
// kernel differentiates: the reference differentiates its jnp oracles),
// with L[t, s] = exp(acs_t - acs_s) for s <= t, w_s = exp(acs_last -
// acs_s), e_t = exp(acs_t), S_prev the state entering the chunk (the
// forward's scratch) and G the gradient of the state leaving it:
//
//   G_prev = exp(acs_last) G + dY^T (C o e)          (reverse over chunks)
//   R = (C B^T) o L,  Z = (dY X^T) o L,  Q = R o (dY X^T)
//   dX = R^T dY + w o (B G^T)
//   dC = Z B + e o (dY S_prev)
//   dB = Z^T C + w o (X G)
//   dacs_t = sum_s Q[t, s] - sum_s Q[s, t] + Yoff_t - W_t
//   da = reverse cumsum of dacs + exp(acs_last) <G, S_prev> + sum_s W_s
//
// (Yoff_t = C_t . (e o dY S_prev)_t, W_s = X_s . (w o B G^T)_s; ref.ssd_bwd
// writes the same out in PyTorch).  Three kernels on one stream:
//
//   a. ssd_bwd_state_*  grid (N / 32, head, batch), the mirror of the
//      forward's state kernel: block q carries columns [32 q, 32 q + 32) of
//      G from the final state's gradient (or zero) back through the chunks
//      in series, writes the G leaving each chunk to its scratch slot and
//      the initial state's gradient after the first chunk.
//   b. ssd_bwd_chunk_*  grid (chunk, head block, batch): every per-chunk
//      term above; dX and da written once, each head block's dB and dC to
//      fp32 scratch (B, S, G x head blocks, N).
//   c. ssd_bwd_group_sum  sums those over the head blocks of each state
//      group in order (db and dc), in b's and c's type.
//
// No atomics: every output element has one writer and every sum a fixed
// order, so two runs give the same bits.
//
// bf16 (the training path): every product on the tensor cores, as
// mma.sync.m16n8k16 bf16 with fp32 accumulators, on the forward's pattern
// (the swizzled 16-byte cp.async staging of stage_bf16, or element loads
// for unaligned or strided views; chunks padded with zero rows to a
// multiple of 16, P and N with zero columns to 64 and 128).  C, B, X and dY
// are bf16 inputs, exact operands.  The fp32 operands each enter as a bf16
// high part plus a bf16 low part (split2) in two mma into one accumulator:
// C o e in the state kernel; R, Z, G and S_prev in the chunk kernel.  One
// rounding of R or Z instead puts dx or db and dc 2.5e-3 (relative L2)
// from the fp32 sums, against 1e-4 split; one of C o e, G or S_prev moves
// the fp32 da (or the initial state's gradient) by 3e-4-2e-3 of its
// largest value, element by element, against 3e-6 split
// (tests/test_torch_ssd_backward.py emulates the arithmetic; S_prev
// rounded once failed the card tests).  The scales w and e multiply output
// rows, so they scale accumulators (w o (X G) and w o (B G^T) by w_s, e o
// (dY S_prev) by e_t) and the exact operand stays unsplit; Q's row sums, W
// and Yoff are taken from the registers that hold the products.
//
//   a. ssd_bwd_state_mma: ssd_state_mma with dY for X and C o e for B o w,
//      the chunks in reverse; 4 warps of 16 rows p by 32 columns n, D_c =
//      dY^T (C o e) and G in the mma accumulator layout, the next chunk's
//      copies issued while G is stored.
//   b. ssd_bwd_chunk_mma: a block takes `heads` heads of one group
//      in series (the wrapper's plan, ssd_bwd_plan: 10 at mamba2-2.7b's
//      training shape, 128 blocks), so C and B are staged once for them and
//      their dB and dC are summed in the head block's fp32 scratch rows
//      (each element read back by the thread that wrote it), which cuts
//      that scratch tenfold there.  Each warp owns 16 rows of the chunk.  A
//      warp holds R and Z by rows t, but dX and dB contract over t: the
//      pass over rows t writes R and Z as hi and lo 16 x 16 tiles to shared
//      memory and the warps owning rows s read them back with
//      ldmatrix.trans (faster on the H100 than computing B C^T and X dY^T
//      again, PERF.md).  Warp w runs tiles j <= w by rows t and j >= w by
//      rows s, nine each, with no block barrier between: each stored tile
//      and each warp's share of G carries a ready flag that its reader
//      polls (bounded: a lost flag traps, so a fault fails the launch and
//      never hangs).  Per head: dC = e o (dY S_prev) (then Yoff); a
//      barrier, G staged where S_prev was; then by rows t + Z B, Q's row
//      sums and each tile's column sums (into shared rows, added in warp
//      order), by rows s dX = w o (B G^T) (then W) + R^T dY and dB = w o
//      (X G) + Z^T C.  211,216 bytes of shared memory
//      (C, B, X, dY, S_prev or G as hi + lo, the R and Z tiles, the per-row
//      sums and flags): one block an SM; 255 registers a thread.
//   c. as fp32, over the head blocks.
//
// fp32: the FMA kernels of the first design, every head its own block
// (heads 1): a. ssd_bwd_state<float> (16 x 8 threads), b. ssd_bwd_chunk
// <float, LI> (16 x 16 threads; C, B, X and dY staged in fp32, C B^T and dY
// X^T in registers, then R and Z as packed lower triangles where B was, B
// where C was, and G, then S_prev, where R was; 208,928 bytes at a chunk of
// 128), c. the group sum over every head.
//
// Bound on the H100 at mamba2-2.7b's training shapes (B 4, S 512, H 80,
// P 64, N 128, G 1, chunk 128): about twice the forward's operations
// (chip_smoke.py's ssd_bwd_work), against x, b, c, dy, dx, db, dc, a and da
// read or written once and the saved states read once (about 108 MB): the
// bytes bound it on the tensor cores; on fp32 FMA the operations.

constexpr int BWD_THREADS = 256;  // chunk kernel: 16 x 16 threads
constexpr int LDN = NMAX + 1, LDP = PMAX + 1;
constexpr int NJ = NMAX / 16;     // columns n of a chunk-kernel thread
constexpr int GS_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stages a tile of `rows` x `cols` fp32 (row stride ld): element (r, k) is
// src[r * stride + k] for r < valid and k < width, else zero.
template <int NT, typename S>
__device__ __forceinline__ void stage_pad(float* dst, int ld, int rows,
                                          int cols, const S* src,
                                          long long stride, int valid,
                                          int width) {
  for (int i = threadIdx.x; i < rows * cols; i += NT) {
    const int r = i / cols, k = i - r * cols;
    dst[r * ld + k] =
        r < valid && k < width ? to_f32(src[r * stride + k]) : 0.0f;
  }
}

// Sum over the 16 threads of a half warp (those of one ty).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int tri(int t, int s) { return t * (t + 1) / 2 + s; }

// a: the reverse state recurrence, thread (tx, ty) rows p = ty + 16 i and
// columns n = 32 q + tx + 8 j of G, as the forward's fp32 state kernel.
template <typename T>
__global__ void __launch_bounds__(ST_THREADS)
ssd_bwd_state(const T* __restrict__ dy, const float* __restrict__ a,
              const T* __restrict__ c, const float* __restrict__ dfin,
              float* __restrict__ dstates, float* __restrict__ dinit, int S,
              int H, int P, int G, int N, int L, int nc, long long ysb,
              long long yss, long long asb, long long ass, long long csb,
              long long css) {
  extern __shared__ float smem[];
  const int LDY = P + 1, LDC = QN + 1;
  float* Ys = smem;              // L x LDY
  float* Cs = Ys + L * LDY;      // L x LDC
  float* acs = Cs + L * LDC;     // LMAX
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / G), n0 = q * QN, nq = min(QN, N - n0);
  const size_t PN = (size_t)P * N, row = ((size_t)bi * H + h) * PN;
  float st[PI][QN / 8];
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < QN / 8; ++j) {
      const int p = ty + 16 * i, n = n0 + tx + 8 * j;
      st[i][j] = dfin != nullptr && p < P && n < N ? dfin[row + p * N + n]
                                                   : 0.0f;
    }
  for (int ci = nc - 1; ci >= 0; --ci) {
    const int c0 = ci * L, len = min(L, S - c0);
    __syncthreads();  // the last chunk's tiles are read
    stage_pad<ST_THREADS>(Ys, LDY, L, P, dy + bi * ysb + c0 * yss +
                          (long long)h * P, yss, len, P);
    stage_pad<ST_THREADS>(Cs, LDC, L, QN, c + bi * csb + c0 * css +
                          (long long)g * N + n0, css, len, nq);
    chunk_cumsum(a + bi * asb + c0 * ass + h, ass, len, acs);
    __syncthreads();

    const float decay = expf(acs[LMAX - 1]);
    float* out = dstates + slot(bi, ci, h, nc, H) * PN;
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < QN / 8; ++j) {
        const int p = ty + 16 * i, n = n0 + tx + 8 * j;
        if (p < P && n < N) out[p * N + n] = st[i][j];
        st[i][j] *= decay;
      }
    for (int t = 0; t < len; ++t) {
      const float e = expf(acs[t]);
      float yv[PI], cv[QN / 8];
#pragma unroll
      for (int i = 0; i < PI; ++i)
        yv[i] = Ys[t * LDY + min(ty + 16 * i, P - 1)] * e;
#pragma unroll
      for (int j = 0; j < QN / 8; ++j) cv[j] = Cs[t * LDC + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < PI; ++i)
#pragma unroll
        for (int j = 0; j < QN / 8; ++j)
          st[i][j] = fmaf(yv[i], cv[j], st[i][j]);
    }
  }
  if (dinit == nullptr) return;
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < QN / 8; ++j) {
      const int p = ty + 16 * i, n = n0 + tx + 8 * j;
      if (p < P && n < N) dinit[row + p * N + n] = st[i][j];
    }
}

// The chunk kernel's shared memory in floats, for LR = 16 LI rows: C then
// B (LR x LDN); B, then R and Z as packed lower triangles, the R triangle
// then G and S_prev (PMAX x LDN); X and dY (LR x LDP); acs, dacs, W, Yoff,
// the column sums of Q by ty, and a block reduction's warp sums.
__host__ __device__ constexpr int bwd_tri(int LR) { return LR * (LR + 1) / 2; }
__host__ __device__ constexpr int bwd_lo(int LR) {
  return bwd_tri(LR) > PMAX * LDN ? bwd_tri(LR) : PMAX * LDN;
}
__host__ __device__ constexpr int bwd_bufb(int LR) {
  return LR * LDN > bwd_lo(LR) + bwd_tri(LR) ? LR * LDN
                                             : bwd_lo(LR) + bwd_tri(LR);
}
__host__ __device__ constexpr int bwd_smem_floats(int LR) {
  return LR * LDN + bwd_bufb(LR) + 2 * LR * LDP + 4 * LMAX + 16 * LMAX +
         BWD_THREADS / 32;
}

// b: block (chunk, head, batch).  Thread (tx, ty) = (tid % 16, tid / 16)
// holds rows ty + 16 i (t or s, i < LI) and columns tx + 16 j (s, p or n).
template <typename T, int LI>
__global__ void __launch_bounds__(BWD_THREADS, 1)
ssd_bwd_chunk(const T* __restrict__ x, const float* __restrict__ a,
              const T* __restrict__ b, const T* __restrict__ c,
              const T* __restrict__ dy, const float* __restrict__ states,
              const float* __restrict__ dstates, T* __restrict__ dx,
              float* __restrict__ da, float* __restrict__ dbh,
              float* __restrict__ dch, int S, int H, int P, int G, int N,
              int L, int nc, long long xsb, long long xss, long long asb,
              long long ass, long long bsb, long long bss, long long csb,
              long long css, long long ysb, long long yss, int has_init) {
  constexpr int LR = 16 * LI;
  extern __shared__ float smem[];
  float* bufA = smem;                       // C, then B: LR x LDN
  float* bufB = bufA + LR * LDN;            // B; R | Z; G or S_prev | Z
  float* lo = bufB;                         // R, then G, then S_prev
  float* hi = bufB + bwd_lo(LR);            // Z
  float* Xs = bufB + bwd_bufb(LR);          // LR x LDP
  float* Ys = Xs + LR * LDP;                // LR x LDP
  float* acs = Ys + LR * LDP;               // LMAX
  float* dacs = acs + LMAX;                 // LMAX
  float* Wv = dacs + LMAX;                  // LMAX
  float* Yo = Wv + LMAX;                    // LMAX
  float* colpart = Yo + LMAX;               // 16 x LMAX
  float* red = colpart + 16 * LMAX;         // BWD_THREADS / 32

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ci = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / G);
  const int c0 = ci * L, len = min(L, S - c0);
  const bool carry = has_init || ci > 0;
  const T* cg = c + bi * csb + c0 * css + (long long)g * N;
  const T* bg = b + bi * bsb + c0 * bss + (long long)g * N;
  const float* st_prev = states + slot(bi, ci, h, nc, H) * P * N;
  const float* gst = dstates + slot(bi, ci, h, nc, H) * P * N;

  stage_pad<BWD_THREADS>(bufA, LDN, LR, NMAX, cg, css, len, N);
  stage_pad<BWD_THREADS>(bufB, LDN, LR, NMAX, bg, bss, len, N);
  stage_pad<BWD_THREADS>(Xs, LDP, LR, PMAX,
                         x + bi * xsb + c0 * xss + (long long)h * P, xss,
                         len, P);
  stage_pad<BWD_THREADS>(Ys, LDP, LR, PMAX,
                         dy + bi * ysb + c0 * yss + (long long)h * P, yss,
                         len, P);
  chunk_cumsum(a + bi * asb + c0 * ass + h, ass, len, acs);
  __syncthreads();
  const float last = acs[LMAX - 1];

  // C B^T and dY X^T over the tiles at or below the diagonal, then R, Z
  // and the row and column sums of Q
  float r_[LI][LI], z_[LI][LI];
#pragma unroll
  for (int i = 0; i < LI; ++i)
#pragma unroll
    for (int j = 0; j < LI; ++j) r_[i][j] = z_[i][j] = 0.0f;
  for (int n = 0; n < N; ++n) {
    float cv[LI], bv[LI];
#pragma unroll
    for (int i = 0; i < LI; ++i) cv[i] = bufA[(ty + 16 * i) * LDN + n];
#pragma unroll
    for (int j = 0; j < LI; ++j) bv[j] = bufB[(tx + 16 * j) * LDN + n];
#pragma unroll
    for (int i = 0; i < LI; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) r_[i][j] = fmaf(cv[i], bv[j], r_[i][j]);
  }
  for (int p = 0; p < P; ++p) {
    float yv[LI], xv[LI];
#pragma unroll
    for (int i = 0; i < LI; ++i) yv[i] = Ys[(ty + 16 * i) * LDP + p];
#pragma unroll
    for (int j = 0; j < LI; ++j) xv[j] = Xs[(tx + 16 * j) * LDP + p];
#pragma unroll
    for (int i = 0; i < LI; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) z_[i][j] = fmaf(yv[i], xv[j], z_[i][j]);
  }
  float rs[LI], cs[LI];
#pragma unroll
  for (int i = 0; i < LI; ++i) rs[i] = cs[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < LI; ++i)
#pragma unroll
    for (int j = 0; j < LI; ++j) {
      const int t = ty + 16 * i, s = tx + 16 * j;
      float rv = 0.0f, zv = 0.0f;
      if (j <= i && s <= t) {
        const float l = expf(acs[t] - acs[s]);
        rv = l * r_[i][j];
        zv = l * z_[i][j];
        const float qv = rv * z_[i][j];
        rs[i] += qv;
        cs[j] += qv;
      }
      r_[i][j] = rv;
      z_[i][j] = zv;
    }
  __syncthreads();  // B is read: R and Z go where it was
#pragma unroll
  for (int i = 0; i < LI; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const int t = ty + 16 * i, s = tx + 16 * j;
      if (s <= t) {
        lo[tri(t, s)] = r_[i][j];
        hi[tri(t, s)] = z_[i][j];
      }
    }
#pragma unroll
  for (int i = 0; i < LI; ++i) {
    const float v = half_warp_sum(rs[i]);
    if (tx == 0) dacs[ty + 16 * i] = v;
  }
#pragma unroll
  for (int j = 0; j < LI; ++j) colpart[ty * LMAX + tx + 16 * j] = cs[j];
  __syncthreads();
  if (tid < LR) {
    float v = dacs[tid];
    for (int k = 0; k < 16; ++k) v -= colpart[k * LMAX + tid];
    dacs[tid] = v;
  }

  // dX = R^T dY (rows s, columns p) and dB = Z^T C (rows s, columns n)
  float dxa[LI][PI], dba[LI][NJ];
#pragma unroll
  for (int i = 0; i < LI; ++i) {
#pragma unroll
    for (int j = 0; j < PI; ++j) dxa[i][j] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dba[i][j] = 0.0f;
  }
  for (int t = 0; t < len; ++t) {
    float yv[PI], cv[NJ], rv[LI], zv[LI];
#pragma unroll
    for (int j = 0; j < PI; ++j) yv[j] = Ys[t * LDP + tx + 16 * j];
#pragma unroll
    for (int j = 0; j < NJ; ++j) cv[j] = bufA[t * LDN + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < LI; ++i) {
      const int s = ty + 16 * i;
      rv[i] = s <= t ? lo[tri(t, s)] : 0.0f;
      zv[i] = s <= t ? hi[tri(t, s)] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < LI; ++i) {
#pragma unroll
      for (int j = 0; j < PI; ++j) dxa[i][j] = fmaf(rv[i], yv[j], dxa[i][j]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) dba[i][j] = fmaf(zv[i], cv[j], dba[i][j]);
    }
  }
  __syncthreads();  // C and R are read: B where C was, G where R was
  stage_pad<BWD_THREADS>(bufA, LDN, LR, NMAX, bg, bss, len, N);
  stage_pad<BWD_THREADS>(lo, LDN, PMAX, NMAX, gst, N, P, N);
  __syncthreads();

  // w o (B G^T) into dX (and W = X . it), w o (X G) into dB, <G, S_prev>
  float w[LI];
#pragma unroll
  for (int i = 0; i < LI; ++i) w[i] = expf(last - acs[ty + 16 * i]);
  {
    float dxs[LI][PI];
#pragma unroll
    for (int i = 0; i < LI; ++i)
#pragma unroll
      for (int j = 0; j < PI; ++j) dxs[i][j] = 0.0f;
    for (int n = 0; n < N; ++n) {
      float bv[LI], gv[PI];
#pragma unroll
      for (int i = 0; i < LI; ++i) bv[i] = bufA[(ty + 16 * i) * LDN + n];
#pragma unroll
      for (int j = 0; j < PI; ++j) gv[j] = lo[(tx + 16 * j) * LDN + n];
#pragma unroll
      for (int i = 0; i < LI; ++i)
#pragma unroll
        for (int j = 0; j < PI; ++j) dxs[i][j] = fmaf(bv[i], gv[j], dxs[i][j]);
    }
#pragma unroll
    for (int i = 0; i < LI; ++i) {
      const int s = ty + 16 * i;
      float wsum = 0.0f;
#pragma unroll
      for (int j = 0; j < PI; ++j) {
        dxs[i][j] *= w[i];
        wsum = fmaf(Xs[s * LDP + tx + 16 * j], dxs[i][j], wsum);
        dxa[i][j] += dxs[i][j];
      }
      wsum = half_warp_sum(wsum);
      if (tx == 0) Wv[s] = wsum;
      if (s >= len) continue;
      T* out = dx + ((size_t)bi * S + c0 + s) * H * P + (size_t)h * P;
#pragma unroll
      for (int j = 0; j < PI; ++j)
        if (tx + 16 * j < P) store_as(out + tx + 16 * j, dxa[i][j]);
    }
  }
  for (int p = 0; p < P; ++p) {
    float xv[LI], gv[NJ];
#pragma unroll
    for (int i = 0; i < LI; ++i) xv[i] = Xs[(ty + 16 * i) * LDP + p] * w[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) gv[j] = lo[p * LDN + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < LI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) dba[i][j] = fmaf(xv[i], gv[j], dba[i][j]);
  }
#pragma unroll
  for (int i = 0; i < LI; ++i) {
    const int s = ty + 16 * i;
    if (s >= len) continue;
    float* out = dbh + (((size_t)bi * S + c0 + s) * H + h) * N;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < N) out[tx + 16 * j] = dba[i][j];
  }
  float gdot = 0.0f;
  if (carry)
    for (int k = tid; k < P * N; k += BWD_THREADS) {
      const int p = k / N;
      gdot = fmaf(lo[p * LDN + (k - p * N)], st_prev[k], gdot);
    }
  gdot = half_warp_sum(gdot);
  gdot += __shfl_xor_sync(0xffffffffu, gdot, 16);
  if ((tid & 31) == 0) red[tid >> 5] = gdot;
  __syncthreads();  // G is read: S_prev where it was
  if (carry) stage_pad<BWD_THREADS>(lo, LDN, PMAX, NMAX, st_prev, N, P, N);
  __syncthreads();

  // dC = e o (dY S_prev) (and Yoff = C . it), then + Z B (rows t)
  float dca[LI][NJ];
#pragma unroll
  for (int i = 0; i < LI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dca[i][j] = 0.0f;
  if (carry) {
    for (int p = 0; p < P; ++p) {
      float yv[LI], sv[NJ];
#pragma unroll
      for (int i = 0; i < LI; ++i) yv[i] = Ys[(ty + 16 * i) * LDP + p];
#pragma unroll
      for (int j = 0; j < NJ; ++j) sv[j] = lo[p * LDN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < LI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dca[i][j] = fmaf(yv[i], sv[j], dca[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < LI; ++i) {
    const int t = ty + 16 * i;
    const float e = expf(acs[t]);
    float yo = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tx + 16 * j;
      dca[i][j] *= e;
      if (t < len && n < N) yo = fmaf(to_f32(cg[t * css + n]), dca[i][j], yo);
    }
    yo = half_warp_sum(yo);
    if (tx == 0) Yo[t] = yo;
  }
  for (int s = 0; s < len; ++s) {
    float bv[NJ], zv[LI];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = bufA[s * LDN + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < LI; ++i) {
      const int t = ty + 16 * i;
      zv[i] = s <= t ? hi[tri(t, s)] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < LI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) dca[i][j] = fmaf(zv[i], bv[j], dca[i][j]);
  }
#pragma unroll
  for (int i = 0; i < LI; ++i) {
    const int t = ty + 16 * i;
    if (t >= len) continue;
    float* out = dch + (((size_t)bi * S + c0 + t) * H + h) * N;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < N) out[tx + 16 * j] = dca[i][j];
  }
  __syncthreads();  // dacs, W and Yoff are complete

  // da: the reverse cumsum of dacs + Yoff - W within the chunk, plus the
  // terms of the chunk's total decay, in a fixed order
  if (tid < len) {
    float v = 0.0f, wsum = 0.0f;
    for (int t = LR - 1; t >= tid; --t) v += dacs[t] + Yo[t] - Wv[t];
    for (int s = 0; s < LR; ++s) wsum += Wv[s];
    float gd = 0.0f;
    for (int k = 0; k < BWD_THREADS / 32; ++k) gd += red[k];
    da[((size_t)bi * S + c0 + tid) * H + h] = v + expf(last) * gd + wsum;
  }
}

// c: out[b, s, g, n] = sum over k < parts (in order) of part[b, s, g parts
// + k, n], the partial rows of group g (a head each for fp32, a head block
// each for bf16); blockIdx.y 0 for db (from dbh), 1 for dc (from dch).
template <typename T>
__global__ void __launch_bounds__(GS_THREADS)
ssd_bwd_group_sum(const float* __restrict__ dbh, const float* __restrict__ dch,
                  T* __restrict__ db, T* __restrict__ dc, long long rows,
                  int parts, int G, int N) {
  const long long i = (long long)blockIdx.x * GS_THREADS + threadIdx.x;
  if (i >= rows * G * N) return;
  const long long r = i / ((long long)G * N);
  const int gn = static_cast<int>(i - r * G * N), g = gn / N, n = gn - g * N;
  const float* part = (blockIdx.y == 0 ? dbh : dch) +
                      ((r * G + g) * (long long)parts) * N + n;
  float v = 0.0f;
  for (int k = 0; k < parts; ++k) v += part[(long long)k * N];
  store_as((blockIdx.y == 0 ? db : dc) + i, v);
}

// a, bf16: block (q, h, b) carries columns [32 q, 32 q + 32) of G, the
// gradient of the (P, N) state of (b, h), back through the chunks in the
// mma accumulator layout (warp w: rows p = 16 w + g (+ 8)), D_c = dY^T (C o
// e) on the tensor cores with C o e as hi + lo.  It writes the G leaving
// each chunk to the chunk's scratch slot and, after the first chunk, the
// initial state's gradient (unless dinit is null).
__global__ void __launch_bounds__(ST_THREADS)
ssd_bwd_state_mma(const bf16* __restrict__ dy, const float* __restrict__ a,
                  const bf16* __restrict__ c, const float* __restrict__ dfin,
                  float* __restrict__ dstates, float* __restrict__ dinit,
                  int S, int H, int P, int G, int N, int L, int nc,
                  long long ysb, long long yss, long long asb, long long ass,
                  long long csb, long long css, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ys = reinterpret_cast<bf16*>(smem_raw);  // LMAX x PMAX
  bf16* Ch = Ys + LMAX * PMAX;                   // LMAX x QN
  bf16* Cl = Ch + LMAX * QN;                     // LMAX x QN
  float* acs = reinterpret_cast<float*>(Cl + LMAX * QN);

  const int q = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / G), n0 = q * QN, nq = min(QN, N - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const bf16* yh = dy + bi * ysb + (long long)h * P;
  const bf16* cq = c + bi * csb + (long long)g * N + n0;
  const float* ah = a + bi * asb + h;
  const size_t PN = (size_t)P * N, row = ((size_t)bi * H + h) * PN;
  auto at = [&](int nt, int e) {
    return (16 * warp + gq + 8 * (e >> 1)) * N + n0 + 8 * nt + 2 * tq +
           (e & 1);
  };
  auto inside = [&](int nt, int e) {
    return 16 * warp + gq + 8 * (e >> 1) < P &&
           n0 + 8 * nt + 2 * tq + (e & 1) < N;
  };
  float st[QN / 8][4];
#pragma unroll
  for (int nt = 0; nt < QN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[nt][e] = dfin != nullptr && inside(nt, e) ? dfin[row + at(nt, e)]
                                                   : 0.0f;
  auto issue = [&](int ci) {
    const int c0 = ci * L, len = min(L, S - c0), rows = (len + 15) & ~15;
    stage_bf16<CP, ST_THREADS>(Ys, yh + c0 * yss, yss, len, rows, P, vec);
    stage_bf16<CQ, ST_THREADS>(Ch, cq + c0 * css, css, len, rows, nq, vec);
    cp_async_commit();
  };
  issue(nc - 1);
  for (int ci = nc - 1; ci >= 0; --ci) {
    const int c0 = ci * L, len = min(L, S - c0), rows = (len + 15) & ~15;
    __syncthreads();  // every warp has read the last chunk's acs (its decay)
    chunk_cumsum(ah + c0 * ass, ass, len, acs);
    cp_async_wait<0>();
    __syncthreads();

    // C o e in place as its high part, the low part beside it
    for (int i = threadIdx.x; i < rows * CQ; i += ST_THREADS) {
      const int r = i / CQ, off = swz<CQ>(r, i % CQ);
      const float e = expf(acs[r]);
      uint4* hp = reinterpret_cast<uint4*>(Ch + off);
      const uint4 v = *hp;
      const unsigned* in = reinterpret_cast<const unsigned*>(&v);
      uint4 hi, lo;
      unsigned* ho = reinterpret_cast<unsigned*>(&hi);
      unsigned* lw = reinterpret_cast<unsigned*>(&lo);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 u =
            *reinterpret_cast<const __nv_bfloat162*>(in + k);
        split2(__low2float(u) * e, __high2float(u) * e, ho[k], lw[k]);
      }
      *hp = hi;
      *reinterpret_cast<uint4*>(Cl + off) = lo;
    }
    __syncthreads();

    float d[QN / 8][4];  // D_c: A = dY^T (rows p, k = t), B = C o e
#pragma unroll
    for (int nt = 0; nt < QN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[nt][e] = 0.0f;
    if (16 * warp < P) {
      for (int kk = 0; kk < rows / 16; ++kk) {
        unsigned ya[4];
        ldmatrix_x4_trans(ya, Ys + swz<CP>(kk * 16 + (lane & 7) +
                                               (lane >> 4) * 8,
                                           warp * 2 + ((lane >> 3) & 1)));
#pragma unroll
        for (int np = 0; np < QN / 16; ++np) {
          const int off = swz<CQ>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  np * 2 + (lane >> 4));
          unsigned ch[4], cl[4];
          ldmatrix_x4_trans(ch, Ch + off);
          ldmatrix_x4_trans(cl, Cl + off);
          mma_bf16(d[2 * np], ya, ch[0], ch[1]);
          mma_bf16(d[2 * np + 1], ya, ch[2], ch[3]);
          mma_bf16(d[2 * np], ya, cl[0], cl[1]);
          mma_bf16(d[2 * np + 1], ya, cl[2], cl[3]);
        }
      }
    }
    __syncthreads();  // the chunk's tiles are read
    if (ci > 0) issue(ci - 1);

    // the gradient of the state leaving chunk ci, then of the one entering
    const float decay = expf(acs[LMAX - 1]);
    float* out = dstates + slot(bi, ci, h, nc, H) * PN;
#pragma unroll
    for (int nt = 0; nt < QN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (inside(nt, e)) out[at(nt, e)] = st[nt][e];
        st[nt][e] = decay * st[nt][e] + d[nt][e];
      }
  }
  if (dinit == nullptr) return;
#pragma unroll
  for (int nt = 0; nt < QN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (inside(nt, e)) dinit[row + at(nt, e)] = st[nt][e];
}

// The bf16 chunk kernel's shared memory: C, B (LMAX x NMAX), X, dY (LMAX x
// PMAX), S_prev then G as hi and lo (PMAX x NMAX each) in bf16; acs, Q's
// row sums, W, Yoff (LMAX each), Q's column sums by warp (8 x LMAX), the
// warps' partial sums of <G, S_prev>, of the reverse cumsum and of W, and
// the ready flags of the stored tiles and of each warp's share of G, and R
// and Z as hi and lo bf16 16 x 16 tiles for the 36 tiles at or below the
// diagonal: 211,216 bytes.
constexpr int CH_WARPS = THREADS / 32;
constexpr int TRI_TILES = CH_WARPS * (CH_WARPS + 1) / 2;
constexpr size_t CHUNK_MMA_SMEM =
    sizeof(bf16) * (2 * LMAX * NMAX + 2 * LMAX * PMAX + 2 * PMAX * NMAX) +
    sizeof(float) * (4 * LMAX + CH_WARPS * LMAX + 3 * CH_WARPS) +
    sizeof(int) * (TRI_TILES + CH_WARPS) +
    sizeof(bf16) * TRI_TILES * 4 * 256;
// A ready flag is polled at most this often (about a tenth of a second,
// where a flag normally comes within microseconds); then the kernel traps,
// so a lost flag fails the launch rather than hang the card or leave
// wrong gradients.
constexpr int READY_POLLS = 1 << 22;

// Sets a ready flag to `epoch` once the warp's shared-memory writes before
// it are visible to the block; waits for one (lane 0 polls, with a bound).
__device__ __forceinline__ void flag_set(int* f, int epoch) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) {
    __threadfence_block();
    *reinterpret_cast<volatile int*>(f) = epoch;
  }
}
__device__ __forceinline__ void flag_wait(const int* f, int epoch) {
  if (threadIdx.x % 32 == 0) {
    const volatile int* v = f;
    for (int n = 0; *v != epoch; ++n) {
      if (n == READY_POLLS) __trap();
      __nanosleep(32);
    }
    __threadfence_block();
  }
  __syncwarp();
}

// Loads the fp32 (P, N) matrix at src (zero past P and N) into the swizzled
// tile Sh as bf16, and, unless Sl is null, the remainder v - bf16(v) as
// bf16 into Sl (hi + lo); with `other`, also returns this thread's share of
// <src, other> (both fp32, in a fixed order), else 0.
__device__ __forceinline__ float stage_split(bf16* Sh, bf16* Sl,
                                             const float* src, int P, int N,
                                             const float* other) {
  float dot = 0.0f;
  if (N % 4 == 0) {
    constexpr int Q = PMAX * NMAX / 4 / THREADS;  // float4s a thread
    float4 v[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = threadIdx.x + q * THREADS;
      const int p = i / (NMAX / 4), n = (i % (NMAX / 4)) * 4;
      v[q] = (p < P && n < N)
                 ? *reinterpret_cast<const float4*>(src + p * N + n)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = threadIdx.x + q * THREADS;
      const int p = i / (NMAX / 4), n = (i % (NMAX / 4)) * 4;
      if (other != nullptr && p < P && n < N) {
        const float4 o = *reinterpret_cast<const float4*>(other + p * N + n);
        dot = fmaf(v[q].x, o.x, dot);
        dot = fmaf(v[q].y, o.y, dot);
        dot = fmaf(v[q].z, o.z, dot);
        dot = fmaf(v[q].w, o.w, dot);
      }
      uint2 hi, lo;
      split2(v[q].x, v[q].y, hi.x, lo.x);
      split2(v[q].z, v[q].w, hi.y, lo.y);
      const int off = swz<CN>(p, n >> 3) + (n & 7);
      *reinterpret_cast<uint2*>(Sh + off) = hi;
      if (Sl != nullptr) *reinterpret_cast<uint2*>(Sl + off) = lo;
    }
  } else {
    for (int i = threadIdx.x; i < PMAX * NMAX / 2; i += THREADS) {
      const int p = i / (NMAX / 2), n = (i % (NMAX / 2)) * 2;
      const bool in0 = p < P && n < N, in1 = p < P && n + 1 < N;
      const float v0 = in0 ? src[p * N + n] : 0.0f;
      const float v1 = in1 ? src[p * N + n + 1] : 0.0f;
      if (other != nullptr) {
        if (in0) dot = fmaf(v0, other[p * N + n], dot);
        if (in1) dot = fmaf(v1, other[p * N + n + 1], dot);
      }
      unsigned hi, lo;
      split2(v0, v1, hi, lo);
      const int off = swz<CN>(p, n >> 3) + (n & 7);
      *reinterpret_cast<unsigned*>(Sh + off) = hi;
      if (Sl != nullptr) *reinterpret_cast<unsigned*>(Sl + off) = lo;
    }
  }
  return dot;
}

// Sum over the four lanes of an mma row group (the lanes of one g).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// Sum over the eight lanes of one t in the mma layout (a column's rows).
__device__ __forceinline__ float column_lanes_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// A 16 x 16 tile of the masked fp32 products (two n-tiles of the mma
// accumulator layout) as the hi and lo A fragments of the next product:
// the m16n8 layout of two n-tiles is the m16k16 A layout.
__device__ __forceinline__ void split_tile(const float (&v)[2][4],
                                           unsigned (&hi)[4],
                                           unsigned (&lo)[4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      split2(v[n][2 * r], v[n][2 * r + 1], hi[2 * n + r], lo[2 * n + r]);
}

// Element offset of the bf16 pair (row, 2 tq + 8 n) in a stored 16 x 16
// tile (rows of two 16-byte chunks, the chunk index XOR-swizzled by row
// bit 2, so that ldmatrix's eight rows fall in distinct banks).
__device__ __forceinline__ int tile_at(int row, int chunk) {
  return row * 16 + ((chunk ^ ((row >> 2) & 1)) << 3);
}
// Stores A fragments f (the m16k16 layout, rows t, columns s) as a tile.
__device__ __forceinline__ void store_tile(bf16* t, const unsigned (&f)[4]) {
  const int lane = threadIdx.x % 32, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<unsigned*>(t + tile_at(gq + 8 * r, n) + 2 * tq) =
          f[2 * n + r];
}
// The transposed tile (rows s, columns t) as A fragments; ordered after
// the ready flag's poll (the memory clobber).
__device__ __forceinline__ void load_tile_trans(unsigned (&f)[4],
                                                const bf16* t) {
  const int lane = threadIdx.x % 32;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
      : "r"(smem_u32(t + tile_at((lane & 7) + ((lane >> 4) << 3),
                                 (lane >> 3) & 1)))
      : "memory");
}

// Adds (or, for `first`, stores) the accumulator tile acc (rows r0 + g (+
// 8), NT n-tiles of 8 columns) into the fp32 rows `out` (row stride
// `stride`), rows below `len` and columns below `cols`.
template <int NT>
__device__ __forceinline__ void add_rows(float* out, long long stride,
                                         const float (&acc)[NT][4], int r0,
                                         int len, int cols, bool first) {
  const int lane = threadIdx.x % 32, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + gq + 8 * r;
    if (t >= len) continue;
    float* o = out + t * stride;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * tq;
      if (n + 1 < cols && cols % 2 == 0) {
        float2 v = make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
        if (!first) {
          const float2 u = *reinterpret_cast<const float2*>(o + n);
          v.x += u.x;
          v.y += u.y;
        }
        *reinterpret_cast<float2*>(o + n) = v;
      } else {
        if (n < cols) o[n] = acc[nt][2 * r] + (first ? 0.0f : o[n]);
        if (n + 1 < cols)
          o[n + 1] = acc[nt][2 * r + 1] + (first ? 0.0f : o[n + 1]);
      }
    }
  }
}

// dX's accumulators (rows ra, rb; columns p of PMAX / 8 n-tiles) as bf16
// into the rows `out` (row stride `stride`), rows below `len`, columns
// below P.
__device__ __forceinline__ void store_dx(bf16* out, long long stride,
                                         const float (&acc)[PMAX / 8][4],
                                         int ra, int rb, int len, int P) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = r ? rb : ra;
    if (s >= len) continue;
    bf16* o = out + s * stride;
#pragma unroll
    for (int n = 0; n < PMAX / 8; ++n) {
      const int p = n * 8 + 2 * tq;
      if (p + 1 < P && P % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o + p) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
      } else {
        if (p < P) o[p] = __float2bfloat16(acc[n][2 * r]);
        if (p + 1 < P) o[p + 1] = __float2bfloat16(acc[n][2 * r + 1]);
      }
    }
  }
}

// w o (B G^T) for the warp's rows s (into acc, which it sets) and W_s = X_s
// . it (into Wv), on the tensor cores with G as hi + lo.
__device__ __forceinline__ void dx_state(float (&acc)[PMAX / 8][4],
                                         const bf16* Bs, const bf16* Xs,
                                         const bf16* Gh, const bf16* Gl,
                                         float* Wv, int r0, float wa,
                                         float wb) {
  const int lane = threadIdx.x % 32, tq = lane & 3;
  const int ra = r0 + (lane >> 2), rb = ra + 8;
#pragma unroll
  for (int n = 0; n < PMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < NMAX / 16; ++kk) {  // A = B (k = n); B = G^T
    unsigned bf[4];
    ldmatrix_x4(bf, Bs + swz<CN>(r0 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < PMAX / 16; ++np) {  // G's rows p
      const int off = swz<CN>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                              kk * 2 + ((lane >> 3) & 1));
      unsigned gh[4], gl[4];
      ldmatrix_x4(gh, Gh + off);
      ldmatrix_x4(gl, Gl + off);
      mma_bf16(acc[2 * np], bf, gh[0], gh[1]);
      mma_bf16(acc[2 * np + 1], bf, gh[2], gh[3]);
      mma_bf16(acc[2 * np], bf, gl[0], gl[1]);
      mma_bf16(acc[2 * np + 1], bf, gl[2], gl[3]);
    }
  }
  float wv[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < PMAX / 8; ++n) {
    acc[n][0] *= wa;
    acc[n][1] *= wa;
    acc[n][2] *= wb;
    acc[n][3] *= wb;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
          Xs + swz<CP>(r ? rb : ra, n) + 2 * tq);
      wv[r] = fmaf(__low2float(xv), acc[n][2 * r], wv[r]);
      wv[r] = fmaf(__high2float(xv), acc[n][2 * r + 1], wv[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float v = quad_sum(wv[r]);
    if (tq == 0) Wv[r ? rb : ra] = v;
  }
}

// w o (X G) for the warp's rows s (into acc, which it sets), G as hi + lo.
__device__ __forceinline__ void db_state(float (&acc)[NMAX / 8][4],
                                         const bf16* Xs, const bf16* Gh,
                                         const bf16* Gl, int r0, float wa,
                                         float wb) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < NMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < PMAX / 16; ++kk) {  // A = X (k = p); B = G
    unsigned xf[4];
    ldmatrix_x4(xf, Xs + swz<CP>(r0 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < NMAX / 16; ++np) {  // G's rows p = k
      const int off = swz<CN>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                              np * 2 + (lane >> 4));
      unsigned gh[4], gl[4];
      ldmatrix_x4_trans(gh, Gh + off);
      ldmatrix_x4_trans(gl, Gl + off);
      mma_bf16(acc[2 * np], xf, gh[0], gh[1]);
      mma_bf16(acc[2 * np + 1], xf, gh[2], gh[3]);
      mma_bf16(acc[2 * np], xf, gl[0], gl[1]);
      mma_bf16(acc[2 * np + 1], xf, gl[2], gl[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < NMAX / 8; ++n) {
    acc[n][0] *= wa;
    acc[n][1] *= wa;
    acc[n][2] *= wb;
    acc[n][3] *= wb;
  }
}

// b, bf16: block (chunk, head block, batch) takes heads [h0, h1) of group
// g in series; warp w owns rows 16 w .. 16 w + 15 of the chunk, t in its
// first pass, then s.  Per head: e o (dY S_prev), dC's state term, for
// every warp's rows t (S_prev staged as hi + lo); a barrier; G staged as
// hi + lo where S_prev was, each warp flagging its share; then no block
// barrier parts the passes: a warp goes on to its rows s as soon as it is
// done with its rows t, so warp w runs w + 1 tiles by rows t and 8 - w by
// rows s (nine each).  The pass over rows t also writes R and Z as hi and
// lo tiles to shared memory, each with a ready flag that the warp reading
// it polls, and the pass over rows s reads them back transposed
// (ldmatrix.trans) for dX and dB.
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_chunk_mma(const bf16* __restrict__ x, const float* __restrict__ a,
                  const bf16* __restrict__ b, const bf16* __restrict__ c,
                  const bf16* __restrict__ dy, const float* __restrict__ states,
                  const float* __restrict__ dstates, bf16* __restrict__ dx,
                  float* __restrict__ da, float* __restrict__ dbp,
                  float* __restrict__ dcp, int S, int H, int P, int G, int N,
                  int L, int nc, int heads, int hblocks, long long xsb,
                  long long xss, long long asb, long long ass, long long bsb,
                  long long bss, long long csb, long long css, long long ysb,
                  long long yss, int has_init, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // LMAX x NMAX
  bf16* Bs = Cs + LMAX * NMAX;                   // LMAX x NMAX
  bf16* Xs = Bs + LMAX * NMAX;                   // LMAX x PMAX
  bf16* Ys = Xs + LMAX * PMAX;                   // LMAX x PMAX
  bf16* Sh = Ys + LMAX * PMAX;                   // PMAX x NMAX: S_prev,
  bf16* Sl = Sh + PMAX * NMAX;                   // then G, hi and lo
  float* acs = reinterpret_cast<float*>(Sl + PMAX * NMAX);
  float* rsum = acs + LMAX;      // Q's row sums
  float* Wv = rsum + LMAX;
  float* Yo = Wv + LMAX;
  float* colpart = Yo + LMAX;    // CH_WARPS x LMAX: Q's column sums by warp
  float* red = colpart + CH_WARPS * LMAX;  // by warp: <G, S_prev>,
  float* tot = red + CH_WARPS;             // the cumsum's suffix sums,
  float* wtot = tot + CH_WARPS;            // W's sums
  int* ready = reinterpret_cast<int*>(wtot + CH_WARPS);  // TRI_TILES
  int* gready = ready + TRI_TILES;                        // CH_WARPS
  // tile (i, j <= i) of R hi, R lo, Z hi, Z lo at stash + 256 (4 (i (i +
  // 1) / 2 + j) + k)
  bf16* stash = reinterpret_cast<bf16*>(gready + CH_WARPS);
  auto tri = [](int i, int j) { return i * (i + 1) / 2 + j; };
  auto tile = [&](int i, int j, int k) {
    return stash + 256 * (4 * tri(i, j) + k);
  };

  const int ci = blockIdx.x, gy = blockIdx.y, bi = blockIdx.z;
  const int rep = H / G, g = gy / hblocks, hb = gy % hblocks;
  const int h0 = g * rep + hb * heads, h1 = min(h0 + heads, (g + 1) * rep);
  const int c0 = ci * L, len = min(L, S - c0), rows = (len + 15) & ~15;
  const int tiles = rows / 16;
  const bool carry = has_init || ci > 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16, ra = r0 + gq, rb = ra + 8;  // this warp's rows
  const bool active = warp < tiles;
  const long long prow = (long long)G * hblocks * N;  // scratch row stride
  float* dcr = dcp + ((size_t)bi * S + c0) * prow + (size_t)gy * N;
  float* dbr = dbp + ((size_t)bi * S + c0) * prow + (size_t)gy * N;
  const size_t PN = (size_t)P * N;

  for (int i = threadIdx.x; i < TRI_TILES + CH_WARPS; i += THREADS)
    ready[i] = 0;
  stage_bf16<CN, THREADS>(Cs, c + bi * csb + c0 * css + (long long)g * N, css,
                          len, rows, N, vec);
  stage_bf16<CN, THREADS>(Bs, b + bi * bsb + c0 * bss + (long long)g * N, bss,
                          len, rows, N, vec);
  for (int h = h0; h < h1; ++h) {
    const bool first = h == h0;
    const int epoch = h - h0 + 1;   // the ready flags' value for this head
    stage_bf16<CP, THREADS>(Xs, x + bi * xsb + c0 * xss + (long long)h * P,
                            xss, len, rows, P, vec);
    stage_bf16<CP, THREADS>(Ys, dy + bi * ysb + c0 * yss + (long long)h * P,
                            yss, len, rows, P, vec);
    cp_async_commit();
    const float* sprev = states + slot(bi, ci, h, nc, H) * PN;
    if (carry) stage_split(Sh, Sl, sprev, P, N, nullptr);
    chunk_cumsum(a + bi * asb + c0 * ass + h, ass, len, acs);
    cp_async_wait<0>();
    __syncthreads();
    const float last = acs[LMAX - 1];

    // ---- rows t: dC = e o (dY S_prev) (then Yoff), S_prev as hi + lo
    unsigned yf[PMAX / 16][4];  // dY's A fragments, k = p
    float acc[NMAX / 8][4];
#pragma unroll
    for (int n = 0; n < NMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    if (active) {
#pragma unroll
      for (int kk = 0; kk < PMAX / 16; ++kk)
        ldmatrix_x4(yf[kk], Ys + swz<CP>(r0 + (lane & 15), kk * 2 + (lane >> 4)));
      float yo[2] = {0.0f, 0.0f};
      if (carry) {  // B = S_prev, k = p: rows p of S
#pragma unroll
        for (int kk = 0; kk < PMAX / 16; ++kk)
#pragma unroll
          for (int np = 0; np < NMAX / 16; ++np) {
            const int off = swz<CN>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                    np * 2 + (lane >> 4));
            unsigned sh[4], sl[4];
            ldmatrix_x4_trans(sh, Sh + off);
            ldmatrix_x4_trans(sl, Sl + off);
            mma_bf16(acc[2 * np], yf[kk], sh[0], sh[1]);
            mma_bf16(acc[2 * np + 1], yf[kk], sh[2], sh[3]);
            mma_bf16(acc[2 * np], yf[kk], sl[0], sl[1]);
            mma_bf16(acc[2 * np + 1], yf[kk], sl[2], sl[3]);
          }
        const float ea = expf(acs[ra]), eb = expf(acs[rb]);
#pragma unroll
        for (int n = 0; n < NMAX / 8; ++n) {
          acc[n][0] *= ea;
          acc[n][1] *= ea;
          acc[n][2] *= eb;
          acc[n][3] *= eb;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const __nv_bfloat162 cv = *reinterpret_cast<const __nv_bfloat162*>(
                Cs + swz<CN>(r ? rb : ra, n) + 2 * tq);
            yo[r] = fmaf(__low2float(cv), acc[n][2 * r], yo[r]);
            yo[r] = fmaf(__high2float(cv), acc[n][2 * r + 1], yo[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float yv = quad_sum(yo[r]);
        if (tq == 0) Yo[r ? rb : ra] = yv;
      }
    }
    __syncthreads();  // S_prev is read: G where it was, each warp's share
    {                 // flagged; <G, S_prev> by warp
      float dot = stage_split(Sh, Sl, dstates + slot(bi, ci, h, nc, H) * PN,
                              P, N, carry ? sprev : nullptr);
      dot = column_lanes_sum(quad_sum(dot));
      if (lane == 0) red[warp] = dot;
      flag_set(gready + warp, epoch);
    }

    if (active) {
      // ---- rows t: + Z B; Q's row sums and each tile's column sums
      unsigned cf[NMAX / 16][4];  // C's A fragments, k = n
#pragma unroll
      for (int kk = 0; kk < NMAX / 16; ++kk)
        ldmatrix_x4(cf[kk], Cs + swz<CN>(r0 + (lane & 15), kk * 2 + (lane >> 4)));
      float rs[2] = {0.0f, 0.0f};
      for (int j = 0; j <= warp; ++j) {
        float cb[2][4], cb2[2][4], yx[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) cb[n][e] = cb2[n][e] = yx[n][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < NMAX / 16; ++kk) {  // C B^T, B's rows s
          unsigned kb[4];
          ldmatrix_x4(kb, Bs + swz<CN>(j * 16 + (lane & 7) + ((lane >> 4) << 3),
                                       kk * 2 + ((lane >> 3) & 1)));
          float (&d)[2][4] = kk % 2 ? cb2 : cb;
          mma_bf16(d[0], cf[kk], kb[0], kb[1]);
          mma_bf16(d[1], cf[kk], kb[2], kb[3]);
        }
#pragma unroll
        for (int kk = 0; kk < PMAX / 16; ++kk) {  // dY X^T, X's rows s
          unsigned kx[4];
          ldmatrix_x4(kx, Xs + swz<CP>(j * 16 + (lane & 7) + ((lane >> 4) << 3),
                                       kk * 2 + ((lane >> 3) & 1)));
          mma_bf16(yx[0], yf[kk], kx[0], kx[1]);
          mma_bf16(yx[1], yf[kk], kx[2], kx[3]);
        }
        float z[2][4], rr[2][4], cs[2][2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) cs[n][e] = 0.0f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int t = r ? rb : ra;
            const float at = acs[t];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int s = j * 16 + n * 8 + 2 * tq + e, k = 2 * r + e;
              const float l = s <= t ? expf(at - acs[s]) : 0.0f;
              const float v = yx[n][k];
              rr[n][k] = l * (cb[n][k] + cb2[n][k]);
              const float qv = rr[n][k] * v;
              z[n][k] = l * v;
              rs[r] += qv;
              cs[n][e] += qv;
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = column_lanes_sum(cs[n][e]);
            if (gq == 0) colpart[warp * LMAX + j * 16 + n * 8 + 2 * tq + e] = v;
          }
        unsigned zh[4], zl[4];
        split_tile(z, zh, zl);
        unsigned rh[4], rl[4];
        split_tile(rr, rh, rl);
        store_tile(tile(warp, j, 0), rh);
        store_tile(tile(warp, j, 1), rl);
        store_tile(tile(warp, j, 2), zh);
        store_tile(tile(warp, j, 3), zl);
        flag_set(ready + tri(warp, j), epoch);
#pragma unroll
        for (int np = 0; np < NMAX / 16; ++np) {  // + Z B, B's rows s = k
          unsigned vb[4];
          ldmatrix_x4_trans(vb, Bs + swz<CN>(j * 16 + (lane & 7) +
                                                 ((lane >> 3) & 1) * 8,
                                             np * 2 + (lane >> 4)));
          mma_bf16(acc[2 * np], zh, vb[0], vb[1]);
          mma_bf16(acc[2 * np + 1], zh, vb[2], vb[3]);
          mma_bf16(acc[2 * np], zl, vb[0], vb[1]);
          mma_bf16(acc[2 * np + 1], zl, vb[2], vb[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float rv = quad_sum(rs[r]);
        if (tq == 0) rsum[r ? rb : ra] = rv;
      }
      add_rows<NMAX / 8>(dcr, prow, acc, r0, len, N, first);
    }

    if (active) {
      const float wa = expf(last - acs[ra]), wb = expf(last - acs[rb]);
      const bf16 *Gh = Sh, *Gl = Sl;
      for (int w = 0; w < CH_WARPS; ++w) flag_wait(gready + w, epoch);
      bf16* dxr = dx + ((size_t)bi * S + c0) * H * P + (size_t)h * P;
      // ---- rows s: dX = w o (B G^T) (then W) + R^T dY and dB = w o (X
      // G) + Z^T C, R^T and Z^T read back from the stored tiles
      float ax[PMAX / 8][4], ab[NMAX / 8][4];
      dx_state(ax, Bs, Xs, Gh, Gl, Wv, r0, wa, wb);
      db_state(ab, Xs, Gh, Gl, r0, wa, wb);
      for (int j = warp; j < tiles; ++j) {  // the tiles (j, warp): rows t
        flag_wait(ready + tri(j, warp), epoch);
        unsigned rh[4], rl[4], zh[4], zl[4];
        load_tile_trans(rh, tile(j, warp, 0));
        load_tile_trans(rl, tile(j, warp, 1));
        load_tile_trans(zh, tile(j, warp, 2));
        load_tile_trans(zl, tile(j, warp, 3));
#pragma unroll
        for (int dp = 0; dp < PMAX / 16; ++dp) {  // + R^T dY, dY's rows t
          unsigned vb[4];
          ldmatrix_x4_trans(vb, Ys + swz<CP>(j * 16 + (lane & 7) +
                                                 ((lane >> 3) & 1) * 8,
                                             dp * 2 + (lane >> 4)));
          mma_bf16(ax[2 * dp], rh, vb[0], vb[1]);
          mma_bf16(ax[2 * dp + 1], rh, vb[2], vb[3]);
          mma_bf16(ax[2 * dp], rl, vb[0], vb[1]);
          mma_bf16(ax[2 * dp + 1], rl, vb[2], vb[3]);
        }
#pragma unroll
        for (int np = 0; np < NMAX / 16; ++np) {  // + Z^T C, C's rows t
          unsigned vb[4];
          ldmatrix_x4_trans(vb, Cs + swz<CN>(j * 16 + (lane & 7) +
                                                 ((lane >> 3) & 1) * 8,
                                             np * 2 + (lane >> 4)));
          mma_bf16(ab[2 * np], zh, vb[0], vb[1]);
          mma_bf16(ab[2 * np + 1], zh, vb[2], vb[3]);
          mma_bf16(ab[2 * np], zl, vb[0], vb[1]);
          mma_bf16(ab[2 * np + 1], zl, vb[2], vb[3]);
        }
      }
      store_dx(dxr, (long long)H * P, ax, ra, rb, len, P);
      add_rows<NMAX / 8>(dbr, prow, ab, r0, len, N, first);
    }
    __syncthreads();  // rsum, colpart, Yo, Wv and red are complete

    // ---- da: the reverse cumsum of dacs + Yoff - W within the chunk, plus
    // exp(acs_last) <G, S_prev> + sum_s W_s, in a fixed order (warps 0-3:
    // positions 32 w .. 32 w + 31)
    float v = 0.0f, wsum = 0.0f;
    const int t = threadIdx.x;
    if (t < rows) {
      v = rsum[t] + Yo[t] - Wv[t];
      for (int k = t / 16; k < tiles; ++k) v -= colpart[k * LMAX + t];
      wsum = Wv[t];
    }
    if (t < LMAX) {
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {  // suffix sums within the warp
        const float u = __shfl_down_sync(0xffffffffu, v, o);
        if (lane + o < 32) v += u;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
      if (lane == 0) {
        tot[warp] = v;
        wtot[warp] = wsum;
      }
    }
    __syncthreads();
    if (t < len) {
      for (int w = warp + 1; w < LMAX / 32; ++w) v += tot[w];
      float gd = 0.0f, ws = 0.0f;
      for (int w = 0; w < CH_WARPS; ++w) gd += red[w];
      for (int w = 0; w < LMAX / 32; ++w) ws += wtot[w];
      da[((size_t)bi * S + c0 + t) * H + h] =
          v + (carry ? expf(last) * gd : 0.0f) + ws;
    }
    __syncthreads();  // the head's tiles and sums are read
  }
}

// ------------------------------------------------------------ dispatch

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// A bf16 operand whose rows start on 16-byte boundaries: the pointer, and
// its batch and position strides in elements (a stride of a dim of one
// is never used).
bool aligned16(const void* p, int B, long long sb, int S, long long ss) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (B == 1 || sb % 8 == 0) &&
         (S == 1 || ss % 8 == 0);
}

struct Args {
  const void *x, *a, *b, *c, *init;
  void *y, *fin, *states;
  int B, S, H, P, G, N, L, nc, state_blocks;
  long long xsb, xss, asb, ass, bsb, bss, csb, css;
  cudaStream_t stream;
};

template <int LI>
int launch_scan_fma(const Args& r, size_t smem) {
  auto kernel = ssd_scan_fma<LI>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(r.nc, r.H, r.B), THREADS, smem, r.stream>>>(
      static_cast<const float*>(r.x), static_cast<const float*>(r.a),
      static_cast<const float*>(r.b), static_cast<const float*>(r.c),
      static_cast<const float*>(r.states), static_cast<float*>(r.y), r.S,
      r.H, r.P, r.G, r.N, r.L, r.nc, r.xsb, r.xss, r.asb, r.ass, r.bsb,
      r.bss, r.csb, r.css, r.init != nullptr);
  return static_cast<int>(cudaGetLastError());
}

int phase_ab(const Args& r, bool bf) {
  const dim3 grid(r.state_blocks, r.H, r.B);
  if (bf) {
    const size_t smem = state_mma_smem();
    const cudaError_t e = allow_smem(ssd_state_mma, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool vec = r.P % 8 == 0 && r.N % 8 == 0 &&
                     aligned16(r.x, r.B, r.xsb, r.S, r.xss) &&
                     aligned16(r.b, r.B, r.bsb, r.S, r.bss);
    ssd_state_mma<<<grid, ST_THREADS, smem, r.stream>>>(
        static_cast<const bf16*>(r.x), static_cast<const float*>(r.a),
        static_cast<const bf16*>(r.b), static_cast<const float*>(r.init),
        static_cast<float*>(r.states), static_cast<float*>(r.fin), r.S, r.H,
        r.P, r.G, r.N, r.L, r.nc, r.xsb, r.xss, r.asb, r.ass, r.bsb, r.bss,
        vec);
  } else {
    const size_t smem = sizeof(float) * state_fma_floats(r.L, r.P);
    const cudaError_t e = allow_smem(ssd_state_fma, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_state_fma<<<grid, ST_THREADS, smem, r.stream>>>(
        static_cast<const float*>(r.x), static_cast<const float*>(r.a),
        static_cast<const float*>(r.b), static_cast<const float*>(r.init),
        static_cast<float*>(r.states), static_cast<float*>(r.fin), r.S, r.H,
        r.P, r.G, r.N, r.L, r.nc, r.xsb, r.xss, r.asb, r.ass, r.bsb, r.bss);
  }
  return static_cast<int>(cudaGetLastError());
}

int phase_c(const Args& r, bool bf) {
  if (bf) {
    const size_t smem = scan_mma_smem();
    const cudaError_t e = allow_smem(ssd_scan_mma, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool vec = r.P % 8 == 0 && r.N % 8 == 0 &&
                     aligned16(r.x, r.B, r.xsb, r.S, r.xss) &&
                     aligned16(r.b, r.B, r.bsb, r.S, r.bss) &&
                     aligned16(r.c, r.B, r.csb, r.S, r.css);
    ssd_scan_mma<<<dim3(r.nc, r.H, r.B), THREADS, smem, r.stream>>>(
        static_cast<const bf16*>(r.x), static_cast<const float*>(r.a),
        static_cast<const bf16*>(r.b), static_cast<const bf16*>(r.c),
        static_cast<const float*>(r.states), static_cast<bf16*>(r.y), r.S,
        r.H, r.P, r.G, r.N, r.L, r.nc, r.xsb, r.xss, r.asb, r.ass, r.bsb,
        r.bss, r.csb, r.css, r.init != nullptr, vec);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * scan_fma_floats(r.L, r.P, r.N);
  if (r.L <= 16) return launch_scan_fma<1>(r, smem);
  if (r.L <= 32) return launch_scan_fma<2>(r, smem);
  if (r.L <= 64) return launch_scan_fma<4>(r, smem);
  return launch_scan_fma<8>(r, smem);
}

int run(const Args& r, bool bf) {
  if (r.L < 1 || r.L > LMAX || r.P < 1 || r.P > PMAX || r.N < 1 ||
      r.N > NMAX || r.G < 1 || r.H % r.G != 0 || r.S < 0 ||
      r.nc != (r.S + r.L - 1) / r.L || r.state_blocks * QN < r.N)
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = phase_ab(r, bf);
  if (e != 0 || r.nc == 0) return e;
  return phase_c(r, bf);
}

struct BwdArgs {
  const void *x, *a, *b, *c, *dy, *states, *dfin;
  void *dx, *da, *db, *dc, *dinit, *dstates, *dbh, *dch;
  int B, S, H, P, G, N, L, nc, state_blocks, heads, has_init;
  long long xsb, xss, asb, ass, bsb, bss, csb, css, ysb, yss;
  cudaStream_t stream;
};

template <int LI>
int launch_bwd_chunk(const BwdArgs& r) {
  auto kernel = ssd_bwd_chunk<float, LI>;
  const size_t smem = sizeof(float) * bwd_smem_floats(16 * LI);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(r.nc, r.H, r.B), BWD_THREADS, smem, r.stream>>>(
      static_cast<const float*>(r.x), static_cast<const float*>(r.a),
      static_cast<const float*>(r.b), static_cast<const float*>(r.c),
      static_cast<const float*>(r.dy), static_cast<const float*>(r.states),
      static_cast<const float*>(r.dstates), static_cast<float*>(r.dx),
      static_cast<float*>(r.da), static_cast<float*>(r.dbh),
      static_cast<float*>(r.dch), r.S, r.H, r.P, r.G, r.N, r.L, r.nc, r.xsb,
      r.xss, r.asb, r.ass, r.bsb, r.bss, r.csb, r.css, r.ysb, r.yss,
      r.has_init);
  return static_cast<int>(cudaGetLastError());
}

// fp32: a, b (a block a head) and c above on one stream.
int run_bwd_f32(const BwdArgs& r) {
  const size_t smem_a =
      sizeof(float) * ((size_t)r.L * (r.P + 1) + (size_t)r.L * (QN + 1) +
                       LMAX);
  cudaError_t e = allow_smem(ssd_bwd_state<float>, smem_a);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_state<float><<<dim3(r.state_blocks, r.H, r.B), ST_THREADS, smem_a,
                         r.stream>>>(
      static_cast<const float*>(r.dy), static_cast<const float*>(r.a),
      static_cast<const float*>(r.c), static_cast<const float*>(r.dfin),
      static_cast<float*>(r.dstates), static_cast<float*>(r.dinit), r.S, r.H,
      r.P, r.G, r.N, r.L, r.nc, r.ysb, r.yss, r.asb, r.ass, r.csb, r.css);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || r.nc == 0) return err;
  return r.L <= 16   ? launch_bwd_chunk<1>(r)
         : r.L <= 32 ? launch_bwd_chunk<2>(r)
         : r.L <= 64 ? launch_bwd_chunk<4>(r)
                     : launch_bwd_chunk<8>(r);
}

// bf16: a and b on the tensor cores (b a block `heads` heads of a group).
int run_bwd_bf16(const BwdArgs& r) {
  const bool vec = r.P % 8 == 0 && r.N % 8 == 0 &&
                   aligned16(r.x, r.B, r.xsb, r.S, r.xss) &&
                   aligned16(r.b, r.B, r.bsb, r.S, r.bss) &&
                   aligned16(r.c, r.B, r.csb, r.S, r.css) &&
                   aligned16(r.dy, r.B, r.ysb, r.S, r.yss);
  const size_t smem_a = state_mma_smem();
  cudaError_t e = allow_smem(ssd_bwd_state_mma, smem_a);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_state_mma<<<dim3(r.state_blocks, r.H, r.B), ST_THREADS, smem_a,
                      r.stream>>>(
      static_cast<const bf16*>(r.dy), static_cast<const float*>(r.a),
      static_cast<const bf16*>(r.c), static_cast<const float*>(r.dfin),
      static_cast<float*>(r.dstates), static_cast<float*>(r.dinit), r.S, r.H,
      r.P, r.G, r.N, r.L, r.nc, r.ysb, r.yss, r.asb, r.ass, r.csb, r.css,
      vec);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || r.nc == 0) return err;
  e = allow_smem(ssd_bwd_chunk_mma, CHUNK_MMA_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int hblocks = (r.H / r.G + r.heads - 1) / r.heads;
  ssd_bwd_chunk_mma<<<dim3(r.nc, r.G * hblocks, r.B), THREADS, CHUNK_MMA_SMEM,
                      r.stream>>>(
      static_cast<const bf16*>(r.x), static_cast<const float*>(r.a),
      static_cast<const bf16*>(r.b), static_cast<const bf16*>(r.c),
      static_cast<const bf16*>(r.dy), static_cast<const float*>(r.states),
      static_cast<const float*>(r.dstates), static_cast<bf16*>(r.dx),
      static_cast<float*>(r.da), static_cast<float*>(r.dbh),
      static_cast<float*>(r.dch), r.S, r.H, r.P, r.G, r.N, r.L, r.nc,
      r.heads, hblocks, r.xsb, r.xss, r.asb, r.ass, r.bsb, r.bss, r.csb,
      r.css, r.ysb, r.yss, r.has_init, vec);
  return static_cast<int>(cudaGetLastError());
}

// The backward kernels (a, b, c above) on one stream.
template <typename T>
int run_bwd(const BwdArgs& r) {
  constexpr bool bf = sizeof(T) == 2;
  if (r.L < 1 || r.L > LMAX || r.P < 1 || r.P > PMAX || r.N < 1 ||
      r.N > NMAX || r.G < 1 || r.H % r.G != 0 || r.S < 0 ||
      r.nc != (r.S + r.L - 1) / r.L || r.state_blocks * QN < r.N ||
      r.heads < 1 || r.heads > r.H / r.G || (!bf && r.heads != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = bf ? run_bwd_bf16(r) : run_bwd_f32(r);
  if (err != 0 || r.nc == 0) return err;
  const long long rows = (long long)r.B * r.S;
  const long long total = rows * r.G * r.N;
  const unsigned blocks =
      static_cast<unsigned>((total + GS_THREADS - 1) / GS_THREADS);
  const int parts = (r.H / r.G + r.heads - 1) / r.heads;
  ssd_bwd_group_sum<T><<<dim3(blocks, 2), GS_THREADS, 0, r.stream>>>(
      static_cast<const float*>(r.dbh), static_cast<const float*>(r.dch),
      static_cast<T*>(r.db), static_cast<T*>(r.dc), rows, parts, r.G, r.N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  x (B, S, H, P) and b, c (B, S, G, N)
// in the entry point's type, a (B, S, H) fp32, each with its batch and
// position strides in elements and its last dims contiguous (x: (H, P)
// with strides (P, 1); a: H with stride 1; b, c: (G, N) with strides
// (N, 1)); init (B, H, P, N) fp32 or null for zero; y (B, S, H, P) and
// fin (B, H, P, N) contiguous outputs; states (B, nc, H, P, N) fp32
// scratch.  L is the chunk (1..128), nc = ceil(S / L) chunks,
// state_blocks * 32 >= N (ssd_plan), P <= 64, N <= 128.  Each launches
// the state kernel and the scan kernel on `stream` and returns the first
// nonzero cudaGetLastError() after a launch (0 = launched).
extern "C" int ssd_f32(const void* x, const void* a, const void* b,
                       const void* c, const void* init, void* y, void* fin,
                       void* states, int B, int S, int H, int P, int G, int N,
                       int L, int nc, int state_blocks, long long xsb,
                       long long xss, long long asb, long long ass,
                       long long bsb, long long bss, long long csb,
                       long long css, void* stream) {
  return run({x, a, b, c, init, y, fin, states, B, S, H, P, G, N, L, nc,
              state_blocks, xsb, xss, asb, ass, bsb, bss, csb, css,
              static_cast<cudaStream_t>(stream)},
             false);
}

extern "C" int ssd_bf16(const void* x, const void* a, const void* b,
                        const void* c, const void* init, void* y, void* fin,
                        void* states, int B, int S, int H, int P, int G,
                        int N, int L, int nc, int state_blocks,
                        long long xsb, long long xss, long long asb,
                        long long ass, long long bsb, long long bss,
                        long long csb, long long css, void* stream) {
  return run({x, a, b, c, init, y, fin, states, B, S, H, P, G, N, L, nc,
              state_blocks, xsb, xss, asb, ass, bsb, bss, csb, css,
              static_cast<cudaStream_t>(stream)},
             true);
}

// The backward, on the forward's operands (the same types, layouts and
// strides), dy (B, S, H, P) in x's type with its batch and position strides
// (ysb, yss) and its (H, P) contiguous, `states` the forward's scratch (the
// state entering each chunk; the first chunk's read only if has_init) and
// dfin (B, H, P, N) fp32 or null for zero.  Writes dx (B, S, H, P) in x's
// type, da (B, S, H) fp32, db and dc (B, S, G, N) in x's type, all
// contiguous, and dinit (B, H, P, N) fp32 unless null; dstates (B, nc, H, P,
// N) and dbh, dch (B, S, G x ceil(H / G / heads), N) are fp32 scratch.
// `heads`: heads a block of the chunk kernel takes (ssd_bwd_plan; 1 for
// fp32).  Launches the three backward kernels on `stream` and returns the
// first nonzero cudaGetLastError() after a launch (0 = launched).
extern "C" int ssd_bwd_f32(const void* x, const void* a, const void* b,
                           const void* c, const void* dy, const void* states,
                           const void* dfin, void* dx, void* da, void* db,
                           void* dc, void* dinit, void* dstates, void* dbh,
                           void* dch, int B, int S, int H, int P, int G,
                           int N, int L, int nc, int state_blocks, int heads,
                           int has_init, long long xsb, long long xss,
                           long long asb, long long ass, long long bsb,
                           long long bss, long long csb, long long css,
                           long long ysb, long long yss, void* stream) {
  return run_bwd<float>(
      {x, a, b, c, dy, states, dfin, dx, da, db, dc, dinit, dstates, dbh,
       dch, B, S, H, P, G, N, L, nc, state_blocks, heads, has_init, xsb, xss,
       asb, ass, bsb, bss, csb, css, ysb, yss,
       static_cast<cudaStream_t>(stream)});
}

extern "C" int ssd_bwd_bf16(const void* x, const void* a, const void* b,
                            const void* c, const void* dy, const void* states,
                            const void* dfin, void* dx, void* da, void* db,
                            void* dc, void* dinit, void* dstates, void* dbh,
                            void* dch, int B, int S, int H, int P, int G,
                            int N, int L, int nc, int state_blocks, int heads,
                            int has_init, long long xsb, long long xss,
                            long long asb, long long ass, long long bsb,
                            long long bss, long long csb, long long css,
                            long long ysb, long long yss, void* stream) {
  return run_bwd<bf16>(
      {x, a, b, c, dy, states, dfin, dx, da, db, dc, dinit, dstates, dbh,
       dch, B, S, H, P, G, N, L, nc, state_blocks, heads, has_init, xsb, xss,
       asb, ass, bsb, bss, csb, css, ysb, yss,
       static_cast<cudaStream_t>(stream)});
}
