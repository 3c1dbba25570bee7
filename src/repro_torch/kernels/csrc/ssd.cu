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
//   b. ssd_bwd_chunk_*  grid (chunk, head, batch): every per-chunk term
//      above; dX and da written once, each head's dB and dC to fp32
//      scratch (B, S, H, N).
//   c. ssd_bwd_group_sum_*  sums those over the H / G heads of each state
//      group in head order (db and dc; mamba2-2.7b sums all 80 heads into
//      its one group), in b's and c's type.
//
// Every product runs on fp32 FMA, bf16 inputs converted as they are staged
// (a first design: the tensor-core design is later work, ROADMAP K.13).
// No atomics: every output element has one writer and every sum a fixed
// order, so two runs give the same bits.  Block b stages C, B, X and dY of
// its chunk in fp32 (rows past the true length and columns past N and P
// zero), and reuses its shared memory through the phases: C B^T and dY X^T
// in registers, then R and Z as packed lower triangles where B was, then B
// where C was, and G, then S_prev, where R was; 208,928 bytes at a chunk of
// 128, one block an SM.
//
// Bound on the H100 at mamba2-2.7b's training shapes (B 4, S 512, H 80,
// P 64, N 128, G 1, chunk 128): about twice the forward's operations
// (chip_smoke.py's ssd_bwd_work), against x, b, c, dy, dx, db, dc, a and da
// read or written once and the saved states read once (about 107 MB): the
// bytes bound it on the tensor cores; on fp32 FMA, as here, the operations.

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

// c: out[b, s, g, n] = sum over the heads h of group g (in head order) of
// part[b, s, h, n]; blockIdx.y 0 for db (from dbh), 1 for dc (from dch).
template <typename T>
__global__ void __launch_bounds__(GS_THREADS)
ssd_bwd_group_sum(const float* __restrict__ dbh, const float* __restrict__ dch,
                  T* __restrict__ db, T* __restrict__ dc, long long rows,
                  int H, int G, int N) {
  const long long i = (long long)blockIdx.x * GS_THREADS + threadIdx.x;
  if (i >= rows * G * N) return;
  const long long r = i / ((long long)G * N);
  const int gn = static_cast<int>(i - r * G * N), g = gn / N, n = gn - g * N;
  const int rep = H / G;
  const float* part = (blockIdx.y == 0 ? dbh : dch) +
                      (r * H + (long long)g * rep) * N + n;
  float v = 0.0f;
  for (int k = 0; k < rep; ++k) v += part[(long long)k * N];
  store_as((blockIdx.y == 0 ? db : dc) + i, v);
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
  int B, S, H, P, G, N, L, nc, state_blocks, has_init;
  long long xsb, xss, asb, ass, bsb, bss, csb, css, ysb, yss;
  cudaStream_t stream;
};

template <typename T, int LI>
int launch_bwd_chunk(const BwdArgs& r) {
  auto kernel = ssd_bwd_chunk<T, LI>;
  const size_t smem = sizeof(float) * bwd_smem_floats(16 * LI);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(r.nc, r.H, r.B), BWD_THREADS, smem, r.stream>>>(
      static_cast<const T*>(r.x), static_cast<const float*>(r.a),
      static_cast<const T*>(r.b), static_cast<const T*>(r.c),
      static_cast<const T*>(r.dy), static_cast<const float*>(r.states),
      static_cast<const float*>(r.dstates), static_cast<T*>(r.dx),
      static_cast<float*>(r.da), static_cast<float*>(r.dbh),
      static_cast<float*>(r.dch), r.S, r.H, r.P, r.G, r.N, r.L, r.nc, r.xsb,
      r.xss, r.asb, r.ass, r.bsb, r.bss, r.csb, r.css, r.ysb, r.yss,
      r.has_init);
  return static_cast<int>(cudaGetLastError());
}

// The three backward kernels (a, b, c above) on one stream.
template <typename T>
int run_bwd(const BwdArgs& r) {
  if (r.L < 1 || r.L > LMAX || r.P < 1 || r.P > PMAX || r.N < 1 ||
      r.N > NMAX || r.G < 1 || r.H % r.G != 0 || r.S < 0 ||
      r.nc != (r.S + r.L - 1) / r.L || r.state_blocks * QN < r.N)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_a =
      sizeof(float) * ((size_t)r.L * (r.P + 1) + (size_t)r.L * (QN + 1) +
                       LMAX);
  cudaError_t e = allow_smem(ssd_bwd_state<T>, smem_a);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_state<T><<<dim3(r.state_blocks, r.H, r.B), ST_THREADS, smem_a,
                     r.stream>>>(
      static_cast<const T*>(r.dy), static_cast<const float*>(r.a),
      static_cast<const T*>(r.c), static_cast<const float*>(r.dfin),
      static_cast<float*>(r.dstates), static_cast<float*>(r.dinit), r.S, r.H,
      r.P, r.G, r.N, r.L, r.nc, r.ysb, r.yss, r.asb, r.ass, r.csb, r.css);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || r.nc == 0) return err;
  err = r.L <= 16   ? launch_bwd_chunk<T, 1>(r)
        : r.L <= 32 ? launch_bwd_chunk<T, 2>(r)
        : r.L <= 64 ? launch_bwd_chunk<T, 4>(r)
                    : launch_bwd_chunk<T, 8>(r);
  if (err != 0) return err;
  const long long rows = (long long)r.B * r.S;
  const long long total = rows * r.G * r.N;
  const unsigned blocks =
      static_cast<unsigned>((total + GS_THREADS - 1) / GS_THREADS);
  ssd_bwd_group_sum<T><<<dim3(blocks, 2), GS_THREADS, 0, r.stream>>>(
      static_cast<const float*>(r.dbh), static_cast<const float*>(r.dch),
      static_cast<T*>(r.db), static_cast<T*>(r.dc), rows, r.H, r.G, r.N);
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
// N) and dbh, dch (B, S, H, N) are fp32 scratch.  Launches the three
// backward kernels on `stream` and returns the first nonzero
// cudaGetLastError() after a launch (0 = launched).
extern "C" int ssd_bwd_f32(const void* x, const void* a, const void* b,
                           const void* c, const void* dy, const void* states,
                           const void* dfin, void* dx, void* da, void* db,
                           void* dc, void* dinit, void* dstates, void* dbh,
                           void* dch, int B, int S, int H, int P, int G,
                           int N, int L, int nc, int state_blocks,
                           int has_init, long long xsb, long long xss,
                           long long asb, long long ass, long long bsb,
                           long long bss, long long csb, long long css,
                           long long ysb, long long yss, void* stream) {
  return run_bwd<float>(
      {x, a, b, c, dy, states, dfin, dx, da, db, dc, dinit, dstates, dbh,
       dch, B, S, H, P, G, N, L, nc, state_blocks, has_init, xsb, xss, asb,
       ass, bsb, bss, csb, css, ysb, yss, static_cast<cudaStream_t>(stream)});
}

extern "C" int ssd_bwd_bf16(const void* x, const void* a, const void* b,
                            const void* c, const void* dy, const void* states,
                            const void* dfin, void* dx, void* da, void* db,
                            void* dc, void* dinit, void* dstates, void* dbh,
                            void* dch, int B, int S, int H, int P, int G,
                            int N, int L, int nc, int state_blocks,
                            int has_init, long long xsb, long long xss,
                            long long asb, long long ass, long long bsb,
                            long long bss, long long csb, long long css,
                            long long ysb, long long yss, void* stream) {
  return run_bwd<bf16>(
      {x, a, b, c, dy, states, dfin, dx, da, db, dc, dinit, dstates, dbh,
       dch, B, S, H, P, G, N, L, nc, state_blocks, has_init, xsb, xss, asb,
       ass, bsb, bss, csb, css, ysb, yss, static_cast<cudaStream_t>(stream)});
}
