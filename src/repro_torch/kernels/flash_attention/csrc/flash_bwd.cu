// flash_bwd: the gradient of causal or non-causal GQA attention (dq, dk,
// dv from q, k, v, the forward's output o, its row log-sum-exp L and the
// output gradient do) in bfloat16 or float32 on Hopper (sm_90a), every
// product on the tensor cores: bfloat16 on wgmma fed by TMA, float32 on
// mma.sync in 3xTF32.
//
// Replaces: no TPU kernel.  The reference differentiates its jnp oracle
// (src/repro/kernels/flash_attention/ref.py attention_ref under
// jax.value_and_grad in src/repro/launch/train.py); the TPU kernel
// flash_attention_pallas (src/repro/kernels/flash_attention/kernel.py)
// has no backward.  The port sends a CUDA tensor to a kernel or raises, so
// the backward of its flash_attention op is this kernel.
//
// Computes FlashAttention-2's backward (ref.py: attention_bwd_ref is its
// plain version), for each batch b and query head h reading kv head
// h / group, with scale = 1 / sqrt(D) and L the forward's:
//   Delta[i] = sum_d do[i, d] o[i, d]
//   P[i, j]  = exp(scale q_i . k_j - L[i]),  dP[i, j] = do_i . v_j
//   dS[i, j] = P[i, j] (dP[i, j] - Delta[i])
//   dq_i = scale sum_j dS[i, j] k_j;  dk_j = scale sum_{h, i} dS[i, j] q_i;
//   dv_j = sum_{h, i} P[i, j] do_i
// where dk and dv sum over the group query heads of their kv head.  Row i
// sees all Sk keys, or with `causal` the keys j <= i + (Sk - S) (the
// diagonal aligned bottom-right, as the forward kernels'); a row that sees
// no key has L = +inf, so P = 0 and zero gradient.
//
// Operands: q, o, do, dq are (B, S, HQ, D) and k, v, dk, dv (B, Sk, KH,
// D), contiguous, of one dtype (the wrapper copies what is not), with
// 16-byte aligned bases; L (written by the forward kernels, flash_wgmma.cu
// and flash_tf32x3.cu) is float32 (B, HQ, S), and the Delta pass writes it
// again beside Delta, as float32 pairs (L, Delta) of rows padded to a
// multiple of 128 (+inf, 0 past S), so that a tile's pairs are one bulk
// copy.  D is what the forward takes: bfloat16 a multiple of 16 up to
// 128, padded in shared memory to DP = 64 or 128 (TMA zero-fills the
// columns past D); float32 a multiple of 4 up to 128, padded to DP = 32,
// 64, 96 or 128 with zeros (kernel.py:flash_bwd_plan).  Any S and Sk:
// ragged tiles are zero-filled and their positions masked.
//
// Three launches on one stream:
//   1. flash_bwd_delta_kernel: Delta, one warp a row, lanes along D in a
//      fixed order, written beside the row's L; a pass over o and do alone
//      (L is the forward's, so no launch recomputes the scores for it);
//   2. dk dv: one block per (keys, b x kv head), whose dk and dv stay in
//      registers; it loops over the group's query heads and, for each, the
//      query tiles whose rows see its keys (causal: tiles above the
//      diagonal are skipped), recomputing S^T and dP^T with the keys as
//      rows, so P^T and dS^T are already the A operands of dV += P^T dO
//      and dK += dS^T Q;
//   3. dq: one block per (query rows, b x h), whose dq stays in registers;
//      it loops over the key tiles the rows see, recomputing S and dP.
// On the bf16 route the tile is the grid's slow axis, so that every
// head's heaviest causal tile (the first keys, the last query rows)
// starts first: with the head the slow axis, the last heads' heaviest
// blocks started last and left the card idle at the end.
// Five products of S x Sk x D per head would do; this design does seven
// (S and dP twice), so that neither dq nor dk and dv need atomics: every
// output element is written by one thread and every sum runs in a fixed
// order, so two calls are bitwise equal.
//
// bfloat16 (flash_bwd_dkdv_wgmma_kernel, flash_bwd_dq_wgmma_kernel): 256
// threads, two warpgroups of 64 rows each and no producer warps (the
// forward has a producer warpgroup; see the tile sizes below).  Thread 0
// keeps the streamed tiles in flight by TMA (128-byte swizzle, boxes of 64
// rows x 64 columns) through a ring of three stages of full and empty
// mbarriers: it refills a stage once both warpgroups have arrived on its
// empty barrier (each wait traps after two seconds, so a fault in the ring
// ends the launch with an error instead of hanging the card).  In dk dv
// a stage also holds its tile's (L, Delta) pairs, one bulk copy; in dq
// each thread reads its two rows' pairs once.  Both warpgroups run every
// product on wgmma:
//   dk dv (128 keys a block, query tiles of 64 rows): S^T = K Q^T and dP^T
//     = V dO^T with both operands K-major in shared memory (m64n64k16);
//     P^T and dS^T are formed on the accumulator fragments and converted
//     in place to bf16 A-operand registers, as the forward converts P;
//     dV += P^T dO and dK += dS^T Q read dO and Q through the descriptor's
//     transpose bit (m64n64k16, one 64-column half of D at a time);
//   dq (128 query rows a block, key tiles of 64): S = Q K^T and dP = dO
//     V^T shared by shared; dQ += dS K reads K through the transpose bit.
// Tile sizes: a thread holds the running dK and dV (DP / 2 floats each),
// then the S^T and dP^T fragments (32 each at 64 x 64), then the bf16 P^T
// and dS^T (16 each) and one fresh partial of a 64-column half (32):
// about 200 live values at DP 128, which ptxas fits in the 255 registers
// that 256 threads leave with about 460 bytes a thread spilled; query
// tiles of 128 rows, or the dV and dK partials in flight together, spill
// more.  dq holds its running dQ (DP / 2), S and dP (32 each) and a
// whole-D partial (DP / 2).  P and dS are rounded once to bf16 as A operands
// (FlashAttention-2's and -3's choice; the plain version keeps them in
// float32: attention_bwd_ref(..., operands=torch.bfloat16) models it, the
// floor of the card's row-by-row check).
//
// float32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): 128 threads, 64
// rows a block (16 a warp), the streamed tiles of 16 rows through a
// two-stage cp.async ring, every product 3xTF32 on mma.sync m16n8k8
// (hopper.cuh: split, mma; the forward's flash_tf32x3.cu scheme), each
// operand split into hi and lo and hi.hi, lo.hi, hi.lo summed in three
// accumulators.
//
// On both routes each query tile's contribution to dk and dv, and each key
// tile's to dq, is summed on the tensor cores in fresh accumulators over
// that tile only and then added to the running sums on the CUDA cores: a
// float32 sum chained across many tiles on the tensor cores truncates
// one-signed, an error that grows with the number of tiles (PERF.md §6).
//
// What bounds it on this card: five products of S x Sk x D per head (half
// of them with `causal`) against a few bytes per score: the tensor cores.
// This design does seven on wgmma in bf16; each warpgroup runs its
// products and the exponentials between them in turn, and the two
// warpgroups of a block overlap each other's.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float2 to_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 to_f2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------
// 1. Delta of each query row, beside its L: ld[b HQ + h][i] = (L, Delta)
// for the rows i < S, (+inf, 0) for the padding rows up to SP (S rounded
// up to ROW_PAD), so that the dk dv kernels read a tile's pairs whole
// grid ceil(B HQ SP / DELTA_WARPS), a warp a row
constexpr int DELTA_WARPS = 8;
constexpr int ROW_PAD = 128;

template <typename T>
__global__ void __launch_bounds__(DELTA_WARPS * 32)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       const float* __restrict__ lse, float2* __restrict__ ld,
                       int S, int SP, int HQ, int D, long long rows) {
  const long long row = (long long)blockIdx.x * DELTA_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long bh = row / SP;
  const int i = (int)(row % SP);
  float2 out = make_float2(INFINITY, 0.f);
  if (i < S) {
    const long long b = bh / HQ, h = bh % HQ;
    const long long base = ((b * S + i) * HQ + h) * D;
    float acc = 0.f;
    for (int d = 2 * lane; d < D; d += 64) {  // D is even on both routes
      const float2 x = to_f2(dout + base + d), y = to_f2(o + base + d);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, sh);
    out = make_float2(lse[bh * S + i], acc);
  }
  if (lane == 0) ld[row] = out;
}

// ---------------------------------------------------------------------
// float32: dk dv and dq on mma.sync in 3xTF32
constexpr int THREADS = 128;  // 4 warps
constexpr int ROWS = 64;      // rows a block owns (16 a warp)
constexpr int PAD = 4;        // floats of padding in a shared row
constexpr int TILE = 16;      // rows of a streamed tile

// The A operand of a 16 x 16 (rows x depth) product step and the B operand
// of a 16 x 8 (depth x cols) one, for thread (g, t) = (lane / 4, lane % 4):
// A holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1), (g, 2t+8), (g, 2t+9),
// (g+8, 2t+8), (g+8, 2t+9) and B holds (2t, g), (2t+1, g), (2t+8, g),
// (2t+9, g): m16n8k16's fragments.  The two m16n8k8 steps take depth t
// from 2t and t + 4 from 2t + 1 (the forward's pairing).
struct FragA {
  float x[8];
};
struct FragB {
  float x[4];
};

// C of a 16 x 8 product: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1), as
// hi.hi, lo.hi and hi.lo sums
struct Acc {
  float c[4], s1[4], s2[4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = s1[e] = s2[e] = 0.f;
  }
  __device__ __forceinline__ float get(int e) const {
    return c[e] + (s1[e] + s2[e]);
  }
};

__device__ __forceinline__ void mma16(Acc& d, const FragA& a,
                                      const FragB& b) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float xa[4] = {a.x[4 * half], a.x[4 * half + 2],
                         a.x[4 * half + 1], a.x[4 * half + 3]};
    const float xb[2] = {b.x[2 * half], b.x[2 * half + 1]};
    Frag<4> fa;
    Frag<2> fb;
    split<false>(xa, fa);
    split<false>(xb, fb);
    mma(true, d.s1, fa.lo, fb.hi);
    mma(true, d.s2, fa.hi, fb.lo);
    mma(true, d.c, fa.hi, fb.hi);
  }
}

// A from rows r0 .. r0+15 and depth columns c0 .. c0+15 of X (row stride ld)
__device__ __forceinline__ void load_a(FragA& a, const float* X, int ld,
                                       int r0, int c0, int g, int t) {
  const float* p = X + (r0 + g) * ld + c0 + 2 * t;
  const float2 u0 = *reinterpret_cast<const float2*>(p);
  const float2 u1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float2 u2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 u3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
  a.x[0] = u0.x;
  a.x[1] = u0.y;
  a.x[2] = u1.x;
  a.x[3] = u1.y;
  a.x[4] = u2.x;
  a.x[5] = u2.y;
  a.x[6] = u3.x;
  a.x[7] = u3.y;
}

// B (depth x col) whose element (kk, n) is X[n0 + n][k0 + kk]: the rows of
// X are the product's columns (Q, K, V, dO read along D)
__device__ __forceinline__ void load_b_rows(FragB& b, const float* X, int ld,
                                            int n0, int k0, int g, int t) {
  const float* p = X + (n0 + g) * ld + k0 + 2 * t;
  const float2 u0 = *reinterpret_cast<const float2*>(p);
  const float2 u1 = *reinterpret_cast<const float2*>(p + 8);
  b.x[0] = u0.x;
  b.x[1] = u0.y;
  b.x[2] = u1.x;
  b.x[3] = u1.y;
}

// B whose element (kk, n) is X[k0 + kk][n0 + n]: the rows of X are the
// product's depth (Q, K, dO as the right operand of dS Q, dS K, P^T dO)
__device__ __forceinline__ void load_b_cols(FragB& b, const float* X, int ld,
                                            int k0, int n0, int g, int t) {
  const float* p = X + (k0 + 2 * t) * ld + n0 + g;
  b.x[0] = p[0];
  b.x[1] = p[ld];
  b.x[2] = p[8 * ld];
  b.x[3] = p[9 * ld];
}

// A from two C tiles in registers (columns 16m .. 16m+7 and 16m+8 ..
// 16m+15 of a product): the C layout is the A layout, so P and dS never
// leave the registers
__device__ __forceinline__ void a_from_c(FragA& a, const float (&lo)[4],
                                         const float (&hi)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    a.x[e] = lo[e];
    a.x[4 + e] = hi[e];
  }
}

// issue the copy of rows r_begin .. r_begin + nrows of a (row stride
// `stride` elements, D contiguous) into dst (row stride ld, DP columns) by
// cp.async, rows >= rmax and columns >= D zero-filled; the whole block
// takes part, and the caller commits the group and waits for it
template <int DP>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long stride, int r_begin,
                                          int nrows, int rmax, int D) {
  constexpr int CH = DP / 4;  // 16-byte chunks of a padded row
  for (int e = threadIdx.x; e < nrows * CH; e += blockDim.x) {
    const int r = e / CH, c = e % CH;
    const bool ok = r_begin + r < rmax && 4 * c < D;
    cp_async<16>(dst + r * ld + c * 4,
                 ok ? src + (long long)(r_begin + r) * stride + c * 4 : src,
                 ok ? 16 : 0);
  }
}

// 2. dk and dv, float32
// grid (ceil(Sk / ROWS), B * KH)
template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float2* __restrict__ ld, float* __restrict__ dk,
                      float* __restrict__ dv, int S, int SP, int Sk, int HQ,
                      int KH, int D, int causal, float scale) {
  constexpr int LD = DP + PAD;
  constexpr int QT = TILE;       // query rows of a tile
  constexpr int NT = QT / 8;     // its 8-row groups (the products' columns)
  constexpr int MT = QT / 16;    // its 16-row depth steps
  constexpr int DT = DP / 8;     // 8-column tiles of D
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + ROWS * LD;
  // two stages of a query tile: Q, dO, L and Delta
  float* Qring = Vs + ROWS * LD;
  float* Oring = Qring + 2 * QT * LD;
  float* Lring = Oring + 2 * QT * LD;
  float* Dring = Lring + 2 * QT;

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / KH, hk = blockIdx.y % KH;
  const int group = HQ / KH;
  const int k0 = blockIdx.x * ROWS;
  const int off = Sk - S;
  const long long qstride = (long long)HQ * D, kstride = (long long)KH * D;

  load_rows<DP>(Ks, LD, k + ((long long)b * Sk * KH + hk) * D, kstride, k0,
                ROWS, Sk, D);
  load_rows<DP>(Vs, LD, v + ((long long)b * Sk * KH + hk) * D, kstride, k0,
                ROWS, Sk, D);

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int wk0 = k0 + 16 * warp;  // this warp's first key
  const int j0 = wk0 + g, j1 = j0 + 8;
  const bool wactive = wk0 < Sk;
  // the first row that sees key k0
  const int q_first = causal ? max(0, k0 - off) : 0;
  const int qt_first = q_first / QT;
  const int nqt = (S + QT - 1) / QT;

  // the (head, query tile) pairs in order, flattened, so one ring serves
  // them all: each iteration issues the next pair's tile into the other
  // stage before it waits for its own
  const int nq = max(nqt - qt_first, 0);
  const int total = group * nq;
  auto issue = [&](int idx) {
    const int sg = idx & 1;
    const int h = hk * group + idx / nq;
    const int q0 = (qt_first + idx % nq) * QT;
    const long long base = ((long long)b * S * HQ + h) * D;
    load_rows<DP>(Qring + sg * QT * LD, LD, q + base, qstride, q0, QT, S, D);
    load_rows<DP>(Oring + sg * QT * LD, LD, dout + base, qstride, q0, QT, S,
                  D);
    const float2* lb = ld + ((long long)b * HQ + h) * SP + q0;
    for (int r = threadIdx.x; r < QT; r += blockDim.x) {
      Lring[sg * QT + r] = lb[r].x;  // the padding rows: +inf, 0
      Dring[sg * QT + r] = lb[r].y;
    }
  };
  if (total > 0) issue(0);
  cp_async_commit();  // with K and V
  for (int idx = 0; idx < total; ++idx) {
    __syncthreads();  // the other stage's reads (pair idx - 1) are done
    if (idx + 1 < total) issue(idx + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // pair idx is in, for every thread
    const int sg = idx & 1;
    const int q0 = (qt_first + idx % nq) * QT;
    const float* Qs = Qring + sg * QT * LD;
    const float* Os = Oring + sg * QT * LD;
    const float* Ls = Lring + sg * QT;
    const float* Ds = Dring + sg * QT;
    // does any row of the tile see any of this warp's keys?
    const int row_last = min(q0 + QT, S) - 1;
    if (!wactive || (causal && row_last + off < wk0)) continue;

    // S^T (keys x rows) = K Q^T and dP^T = V dO^T
    Acc st[NT], dpt[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      st[nt].zero();
      dpt[nt].zero();
    }
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      FragA ak, av;
      load_a(ak, Ks, LD, 16 * warp, kk, g, t);
      load_a(av, Vs, LD, 16 * warp, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        FragB bq, bo;
        load_b_rows(bq, Qs, LD, 8 * nt, kk, g, t);
        mma16(st[nt], ak, bq);
        load_b_rows(bo, Os, LD, 8 * nt, kk, g, t);
        mma16(dpt[nt], av, bo);
      }
    }
    // P^T and dS^T, masked
    float p[NT][4], ds[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = 8 * nt + 2 * t + (e & 1);  // row of the tile
        const int i = q0 + ci;
        const int j = e < 2 ? j0 : j1;
        const bool ok = i < S && j < Sk && (!causal || j <= i + off);
        const float pv = ok ? expf(st[nt].get(e) * scale - Ls[ci]) : 0.f;
        p[nt][e] = pv;
        ds[nt][e] = pv * (dpt[nt].get(e) - Ds[ci]);
      }
    }
    FragA pa[MT], sa[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      a_from_c(pa[m], p[2 * m], p[2 * m + 1]);
      a_from_c(sa[m], ds[2 * m], ds[2 * m + 1]);
    }
    // dV += P^T dO and dK += dS^T Q, each 8-column tile of D summed over
    // this query tile alone, then added on the CUDA cores
#pragma unroll
    for (int nd = 0; nd < DT; ++nd) {
      Acc cv, ck;
      cv.zero();
      ck.zero();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        FragB bo, bq;
        load_b_cols(bo, Os, LD, 16 * m, 8 * nd, g, t);
        mma16(cv, pa[m], bo);
        load_b_cols(bq, Qs, LD, 16 * m, 8 * nd, g, t);
        mma16(ck, sa[m], bq);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dva[nd][e] += cv.get(e);
        dka[nd][e] += ck.get(e);
      }
    }
  }
  cp_async_wait<0>();
  if (!wactive) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = half ? j1 : j0;
    if (j >= Sk) continue;
    const long long row = (((long long)b * Sk + j) * KH + hk) * D;
#pragma unroll
    for (int nd = 0; nd < DT; ++nd) {
      const int c = 8 * nd + 2 * t;  // D is a multiple of 4: c + 1 < D too
      if (c >= D) continue;
      dk[row + c] = dka[nd][2 * half] * scale;
      dk[row + c + 1] = dka[nd][2 * half + 1] * scale;
      dv[row + c] = dva[nd][2 * half];
      dv[row + c + 1] = dva[nd][2 * half + 1];
    }
  }
}

// 3. dq, float32
// grid (ceil(S / ROWS), B * HQ)
template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float2* __restrict__ ld, float* __restrict__ dq,
                    int S, int SP, int Sk, int HQ, int KH, int D, int causal,
                    float scale) {
  constexpr int LD = DP + PAD;
  constexpr int KT = TILE;  // keys of a tile
  constexpr int NT = KT / 8;
  constexpr int MT = KT / 16;
  constexpr int DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Os = Qs + ROWS * LD;  // dO
  float* Kring = Os + ROWS * LD;  // two stages of a key tile: K, then V
  float* Vring = Kring + 2 * KT * LD;
  float* Ls = Vring + 2 * KT * LD;
  float* Ds = Ls + ROWS;

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / HQ, h = blockIdx.y % HQ;
  const int hk = h / (HQ / KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest first
  const int off = Sk - S;
  const long long qstride = (long long)HQ * D, kstride = (long long)KH * D;
  const float* kb = k + ((long long)b * Sk * KH + hk) * D;
  const float* vb = v + ((long long)b * Sk * KH + hk) * D;

  load_rows<DP>(Qs, LD, q + ((long long)b * S * HQ + h) * D, qstride, q0,
                ROWS, S, D);
  load_rows<DP>(Os, LD, dout + ((long long)b * S * HQ + h) * D, qstride, q0,
                ROWS, S, D);
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    const float2 x = ld[(long long)blockIdx.y * SP + q0 + r];
    Ls[r] = x.x;  // the padding rows: +inf, 0
    Ds[r] = x.y;
  }

  const int q_last = min(q0 + ROWS, S) - 1;
  const int k_end = causal ? min(Sk, q_last + off + 1) : Sk;
  const int ntiles = k_end > 0 ? (k_end + KT - 1) / KT : 0;
  const bool active = q0 + 16 * warp < S;
  const int w_last = min(q0 + 16 * warp + 15, S - 1);
  const int w_end = causal ? min(Sk, w_last + off + 1) : Sk;
  const int lr0 = 16 * warp + g, lr1 = lr0 + 8;  // rows of the block
  const int r0 = q0 + lr0, r1 = q0 + lr1;

  float dqa[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  // Q, dO and the first key tile in one group; then each iteration issues
  // the next tile into the other stage before it waits for its own
  if (ntiles > 0) {
    load_rows<DP>(Kring, LD, kb, kstride, 0, KT, Sk, D);
    load_rows<DP>(Vring, LD, vb, kstride, 0, KT, Sk, D);
  }
  cp_async_commit();
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * KT;
    __syncthreads();  // the other stage's reads (tile kt - 1) are done
    if (kt + 1 < ntiles) {
      const int nx = ((kt + 1) & 1) * KT * LD;
      load_rows<DP>(Kring + nx, LD, kb, kstride, k0 + KT, KT, Sk, D);
      load_rows<DP>(Vring + nx, LD, vb, kstride, k0 + KT, KT, Sk, D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt (and Q, dO, L, Delta) is in, for every thread
    const float* Ks = Kring + (kt & 1) * KT * LD;
    const float* Vs = Vring + (kt & 1) * KT * LD;
    if (!active || k0 >= w_end) continue;
    const float L0 = Ls[lr0], L1 = Ls[lr1], D0 = Ds[lr0], D1 = Ds[lr1];

    // S = Q K^T and dP = dO V^T
    Acc s[NT], dp[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt].zero();
      dp[nt].zero();
    }
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      FragA aq, ao;
      load_a(aq, Qs, LD, 16 * warp, kk, g, t);
      load_a(ao, Os, LD, 16 * warp, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        FragB bk, bv;
        load_b_rows(bk, Ks, LD, 8 * nt, kk, g, t);
        mma16(s[nt], aq, bk);
        load_b_rows(bv, Vs, LD, 8 * nt, kk, g, t);
        mma16(dp[nt], ao, bv);
      }
    }
    float ds[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + 8 * nt + 2 * t + (e & 1);
        const int i = e < 2 ? r0 : r1;
        const bool ok = i < S && j < Sk && (!causal || j <= i + off);
        const float pv =
            ok ? expf(s[nt].get(e) * scale - (e < 2 ? L0 : L1)) : 0.f;
        ds[nt][e] = pv * (dp[nt].get(e) - (e < 2 ? D0 : D1));
      }
    }
    FragA sa[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) a_from_c(sa[m], ds[2 * m], ds[2 * m + 1]);
    // dQ += dS K, each 8-column tile of D summed over this key tile alone
#pragma unroll
    for (int nd = 0; nd < DT; ++nd) {
      Acc c;
      c.zero();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        FragB bk;
        load_b_cols(bk, Ks, LD, 16 * m, 8 * nd, g, t);
        mma16(c, sa[m], bk);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[nd][e] += c.get(e);
    }
  }
  cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? r1 : r0;
    if (i >= S) continue;
    const long long row = (((long long)b * S + i) * HQ + h) * D;
#pragma unroll
    for (int nd = 0; nd < DT; ++nd) {
      const int c = 8 * nd + 2 * t;
      if (c >= D) continue;
      dq[row + c] = dqa[nd][2 * half] * scale;
      dq[row + c + 1] = dqa[nd][2 * half + 1] * scale;
    }
  }
}

// ---------------------------------------------------------------------
// bfloat16: dk dv and dq on wgmma, fed by TMA
// two warpgroups and no producer: 256 threads leave each 255 registers,
// where ptxas sizes every thread of a 288- or 384-thread block at 168
// (registers go to warps in groups of four, and setmaxnreg does not raise
// what ptxas allocates): the running dK and dV with the S^T and dP^T
// fragments need about 200, and at 168 dk dv spilled about 1 KB a thread
constexpr int WG_THREADS = 256;
constexpr int STAGES = 3;        // ring depth
constexpr int ROW_BYTES = 128;   // one 64-column bf16 swizzle atom row
constexpr int BOX = 64;          // rows of a TMA box
constexpr int BKV = 128;         // dk dv: keys a block (64 a warpgroup)
constexpr int BQT = 64;          // dk dv: query rows of a streamed tile
constexpr int BQ2 = 128;         // dq: query rows a block (64 a warpgroup)
constexpr int BK2 = 64;          // dq: keys of a streamed tile

template <int DP>
struct DkdvSmem {
  static constexpr int ATOMS = DP / 64;
  static constexpr int KV_BYTES = ATOMS * BKV * ROW_BYTES;  // K or V
  static constexpr int QT_BYTES = ATOMS * BQT * ROW_BYTES;  // Q or dO tile
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int RING_OFF = 2 * KV_BYTES;
  static constexpr int STAGE_BYTES = 2 * QT_BYTES;          // Q, then dO
  static constexpr int LD_BYTES = BQT * 8;                  // (L, Delta)
  static constexpr int LD_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = LD_OFF + STAGES * LD_BYTES;
  // kv_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;  // room to align to 1024
};

template <int DP>
struct DqSmem {
  static constexpr int ATOMS = DP / 64;
  static constexpr int Q_BYTES = ATOMS * BQ2 * ROW_BYTES;   // Q or dO
  static constexpr int KV_BYTES = ATOMS * BK2 * ROW_BYTES;  // a K or V tile
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int RING_OFF = 2 * Q_BYTES;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;          // K, then V
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
  // q_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// `rows` rows (a multiple of BOX) from row r0 of head h, batch b of a (D,
// S, H, B) tensor map into dst, each 64-column atom `atom_bytes` apart
__device__ __forceinline__ void tma_rows(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int atoms,
                                         int atom_bytes, int rows, int r0,
                                         int h, int b) {
  for (int a = 0; a < atoms; ++a)
    for (int r = 0; r < rows; r += BOX)
      tma_load_4d(dst + a * atom_bytes + r * ROW_BYTES, map, bar, a * 64,
                  r0 + r, h, b);
}

// the bf16 A-operand registers of 16-column steps kk of a 64 x 64
// accumulator fragment, as the forward converts P
__device__ __forceinline__ void frag_to_a(const float (&x)[32],
                                          uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// 2. dk and dv, bfloat16
// grid (B * KH, ceil(Sk / BKV)), WG_THREADS threads
template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float2* __restrict__ ld,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int S, int SP, int Sk, int HQ, int KH, int D,
                            int causal, float scale_log2, float scale) {
  using L = DkdvSmem<DP>;
  constexpr int ATOMS = L::ATOMS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sK = smem;
  uint8_t* sV = smem + L::V_OFF;
  uint8_t* ring = smem + L::RING_OFF;
  float2* sld = reinterpret_cast<float2*>(smem + L::LD_OFF);  // [STAGES][BQT]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + STAGES;

  // key tile 0 sees the most query rows under `causal`: the grid's slow
  // axis is the key tile, so every head's first tile is launched first
  const int b = blockIdx.x / KH, hk = blockIdx.x % KH;
  const int group = HQ / KH;
  const int k0 = blockIdx.y * BKV;
  const int off = Sk - S;  // bottom-right alignment of the diagonal
  // the query tiles whose rows see key k0, for each head of the group
  const int q_first = causal ? max(0, k0 - off) : 0;
  const int qt_first = q_first / BQT;
  const int nq = max((S + BQT - 1) / BQT - qt_first, 0);
  const int total = group * nq;

  // tile idx of the flattened (head, query tile) walk into its stage
  auto issue = [&](int idx) {
    const int s = idx % STAGES;
    const int h = hk * group + idx / nq;
    const int q0 = (qt_first + idx % nq) * BQT;
    uint8_t* st = ring + s * L::STAGE_BYTES;
    mbar_expect_tx(&full[s], L::STAGE_BYTES + L::LD_BYTES);
    tma_rows(st, &tq, &full[s], ATOMS, BQT * ROW_BYTES, BQT, q0, h, b);
    tma_rows(st + L::QT_BYTES, &tdo, &full[s], ATOMS, BQT * ROW_BYTES, BQT,
             q0, h, b);
    bulk_load(sld + s * BQT, ld + ((long long)b * HQ + h) * SP + q0,
              L::LD_BYTES, &full[s]);
  };
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per warpgroup
    }
    mbar_fence_init();
    if (total > 0) {
      mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
      tma_rows(sK, &tk, kv_full, ATOMS, BKV * ROW_BYTES, BKV, k0, hk, b);
      tma_rows(sV, &tv, kv_full, ATOMS, BKV * ROW_BYTES, BKV, k0, hk, b);
      for (int idx = 0; idx < min(STAGES, total); ++idx) issue(idx);
    }
  }
  __syncthreads();

  // ---- 64 keys per warpgroup ----
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int kw0 = k0 + wg * 64;                        // this warpgroup's
  const int j0 = kw0 + (tid / 32) * 16 + lane / 4;     // keys j0, j0 + 8
  const int j1 = j0 + 8;
  const int cq = (lane % 4) * 2;  // fragment column within an 8-block

  float dka[DP / 2], dva[DP / 2];
  zero(dka);
  zero(dva);
  const uint32_t k_addr = smem_u32(sK) + wg * 64 * ROW_BYTES;
  const uint32_t v_addr = smem_u32(sV) + wg * 64 * ROW_BYTES;

  if (total > 0) mbar_wait_bounded(kv_full, 0);
  for (int idx = 0; idx < total; ++idx) {
    const int s = idx % STAGES;
    const int ph = (idx / STAGES) & 1;
    const int q0 = (qt_first + idx % nq) * BQT;
    mbar_wait_bounded(&full[s], ph);
    const int row_last = min(q0 + BQT, S) - 1;
    const bool skip = kw0 >= Sk || (causal && row_last + off < kw0);
    if (!skip) {
      const uint32_t q_addr = smem_u32(ring + s * L::STAGE_BYTES);
      const uint32_t do_addr = q_addr + L::QT_BYTES;
      // S^T = K Q^T and dP^T = V dO^T over DP / 16 steps of 16 columns
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the atom
        wgmma_ss_n64(
            st, desc_b128(k_addr + (kk / 4) * BKV * ROW_BYTES + col, 16, 1024),
            desc_b128(q_addr + (kk / 4) * BQT * ROW_BYTES + col, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n64(
            dpt, desc_b128(v_addr + (kk / 4) * BKV * ROW_BYTES + col, 16, 1024),
            desc_b128(do_addr + (kk / 4) * BQT * ROW_BYTES + col, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);
      // P^T, masked: columns are query rows i, fragment rows keys j
      const float2* lds = sld + s * BQT;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int ci = (e / 4) * 8 + cq + (e & 1);
        const int i = q0 + ci, j = (e & 2) ? j1 : j0;
        const bool ok = i < S && j < Sk && (!causal || j <= i + off);
        st[e] = ok ? exp2f(fmaf(st[e], scale_log2, -lds[ci].x * LOG2E))
                   : 0.f;
      }
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dpt[e] = st[e] * (dpt[e] - lds[(e / 4) * 8 + cq + (e & 1)].y);
      uint32_t pa[4][4], sa[4][4];
      frag_to_a(st, pa);
      frag_to_a(dpt, sa);
      // dV += P^T dO and dK += dS^T Q, one 64-column half of D at a time,
      // each summed over this query tile in fresh registers; dO and Q are
      // MN-major (D contiguous): 16-row steps 2048 bytes apart
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) {
        float part[32];
        zero(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n64_tb(part, pa[kk],
                          desc_b128(do_addr + a * BQT * ROW_BYTES +
                                        kk * 16 * ROW_BYTES,
                                    BQT * ROW_BYTES, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int e = 0; e < 32; ++e) dva[a * 32 + e] += part[e];
        zero(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n64_tb(part, sa[kk],
                          desc_b128(q_addr + a * BQT * ROW_BYTES +
                                        kk * 16 * ROW_BYTES,
                                    BQT * ROW_BYTES, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int e = 0; e < 32; ++e) dka[a * 32 + e] += part[e];
      }
    }
    // the stage is free once both warpgroups are done with it: thread 0
    // then refills it with tile idx + STAGES
    if (tid == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && idx + STAGES < total) {
      mbar_wait_bounded(&empty[s], ph);
      issue(idx + STAGES);
    }
    __syncwarp();  // warp 0 converges before its next wgmma
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = half ? j1 : j0;
    if (j >= Sk) continue;
    const size_t row = (((size_t)b * Sk + j) * KH + hk) * D;
#pragma unroll
    for (int n8 = 0; n8 < DP / 8; ++n8) {
      const int c = n8 * 8 + cq;
      if (c < D) {
        const int x = n8 * 4 + half * 2;
        *reinterpret_cast<__nv_bfloat162*>(dk + row + c) =
            __floats2bfloat162_rn(dka[x] * scale, dka[x + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + row + c) =
            __floats2bfloat162_rn(dva[x], dva[x + 1]);
      }
    }
  }
}

// 3. dq, bfloat16
// grid (B * HQ, ceil(S / BQ2)), WG_THREADS threads
template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float2* __restrict__ ld,
                          bf16* __restrict__ dq, int S, int SP, int Sk,
                          int HQ, int KH, int D, int causal, float scale_log2,
                          float scale) {
  using L = DqSmem<DP>;
  constexpr int ATOMS = L::ATOMS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sDO = smem + L::DO_OFF;
  uint8_t* ring = smem + L::RING_OFF;  // [STAGES] x (K, V) of BK2 keys
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + STAGES;

  // the last query tile sees the most keys under `causal`: the grid's
  // slow axis is the query tile, last first
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / HQ, h = blockIdx.x % HQ;
  const int hk = h / (HQ / KH);
  const int q0 = qt * BQ2;
  const int off = Sk - S;
  int k_end = Sk;
  if (causal) k_end = min(Sk, min(q0 + BQ2, S) + off);
  const int n_kt = k_end > 0 ? (k_end + BK2 - 1) / BK2 : 0;

  auto issue = [&](int j) {
    const int s = j % STAGES;
    uint8_t* st = ring + s * L::STAGE_BYTES;
    mbar_expect_tx(&full[s], L::STAGE_BYTES);
    tma_rows(st, &tk, &full[s], ATOMS, BK2 * ROW_BYTES, BK2, j * BK2, hk, b);
    tma_rows(st + L::KV_BYTES, &tv, &full[s], ATOMS, BK2 * ROW_BYTES, BK2,
             j * BK2, hk, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
    if (n_kt > 0) {
      mbar_expect_tx(q_full, 2 * L::Q_BYTES);
      tma_rows(sQ, &tq, q_full, ATOMS, BQ2 * ROW_BYTES, BQ2, q0, h, b);
      tma_rows(sDO, &tdo, q_full, ATOMS, BQ2 * ROW_BYTES, BQ2, q0, h, b);
      for (int j = 0; j < min(STAGES, n_kt); ++j) issue(j);
    }
  }
  __syncthreads();

  // ---- 64 query rows per warpgroup ----
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int wrow0 = q0 + wg * 64;
  const int wlast = min(wrow0 + 63, S - 1);
  const int r0 = wrow0 + (tid / 32) * 16 + lane / 4;  // rows r0, r0 + 8
  const int r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  // (L, Delta) of the rows: the padding rows past S give +inf, 0
  const float2 x0 = ld[(long long)blockIdx.x * SP + r0];
  const float2 x1 = ld[(long long)blockIdx.x * SP + r1];
  const float L0 = x0.x * LOG2E, L1 = x1.x * LOG2E, D0 = x0.y, D1 = x1.y;

  float dqa[DP / 2];
  zero(dqa);
  const uint32_t q_addr = smem_u32(sQ) + wg * 64 * ROW_BYTES;
  const uint32_t do_addr = smem_u32(sDO) + wg * 64 * ROW_BYTES;

  if (n_kt > 0) mbar_wait_bounded(q_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % STAGES;
    const int ph = (j / STAGES) & 1;
    const int k0 = j * BK2;
    mbar_wait_bounded(&full[s], ph);
    const bool skip = wrow0 >= S || (causal && k0 > wlast + off);
    if (!skip) {
      const uint32_t k_addr = smem_u32(ring + s * L::STAGE_BYTES);
      const uint32_t v_addr = k_addr + L::KV_BYTES;
      // S = Q K^T and dP = dO V^T
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n64(
            sc, desc_b128(q_addr + (kk / 4) * BQ2 * ROW_BYTES + col, 16, 1024),
            desc_b128(k_addr + (kk / 4) * BK2 * ROW_BYTES + col, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n64(
            dp, desc_b128(do_addr + (kk / 4) * BQ2 * ROW_BYTES + col, 16, 1024),
            desc_b128(v_addr + (kk / 4) * BK2 * ROW_BYTES + col, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int c = k0 + (e / 4) * 8 + cq + (e & 1);
        const int r = (e & 2) ? r1 : r0;
        const bool ok = c < Sk && (!causal || c <= r + off);
        sc[e] = ok ? exp2f(fmaf(sc[e], scale_log2, (e & 2) ? -L1 : -L0))
                   : 0.f;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dp[e] = sc[e] * (dp[e] - ((e & 2) ? D1 : D0));
      uint32_t sa[4][4];
      frag_to_a(dp, sa);
      // dQ += dS K over this key tile in fresh registers; K is MN-major (D
      // contiguous): 16-key steps 2048 bytes apart, 64-column atoms BK2 *
      // 128 bytes apart
      float part[DP / 2];
      zero(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dkd = desc_b128(k_addr + kk * 16 * ROW_BYTES,
                                       BK2 * ROW_BYTES, 1024);
        if constexpr (DP == 128)
          wgmma_rs_n128_tb(part, sa[kk], dkd);
        else
          wgmma_rs_n64_tb(part, sa[kk], dkd);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) dqa[e] += part[e];
    }
    if (tid == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && j + STAGES < n_kt) {
      mbar_wait_bounded(&empty[s], ph);
      issue(j + STAGES);
    }
    __syncwarp();  // warp 0 converges before its next wgmma
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= S) continue;
    const size_t row = (((size_t)b * S + r) * HQ + h) * D;
#pragma unroll
    for (int n8 = 0; n8 < DP / 8; ++n8) {
      const int c = n8 * 8 + cq;
      if (c < D) {
        const int x = n8 * 4 + half * 2;
        *reinterpret_cast<__nv_bfloat162*>(dq + row + c) =
            __floats2bfloat162_rn(dqa[x] * scale, dqa[x + 1] * scale);
      }
    }
  }
}

// a contiguous (B, S, H, D) bf16 tensor as a (D, S, H, B) tensor map with
// boxes of (64, BOX, 1, 1)
int make_map(CUtensorMap* map, const void* base, int B, int S, int H,
             int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)D * 2;
  const cuuint64_t strides[3] = {row * H, row, row * H * S};
  const cuuint32_t box[4] = {64, (cuuint32_t)BOX, 1, 1};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base,
                          dims, strides, box);
}

template <typename KernelFn>
cudaError_t set_smem(KernelFn fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, void* dq, void* dk, void* dv,
                 const float2* ld, int B, int S, int SP, int Sk, int HQ,
                 int KH, int D, int causal, float scale,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, B, S, HQ, D);
  if (!err) err = make_map(&tdo, dout, B, S, HQ, D);
  if (!err) err = make_map(&tk, k, B, Sk, KH, D);
  if (!err) err = make_map(&tv, v, B, Sk, KH, D);
  if (err) return err;
  const float scale_log2 = scale * LOG2E;
  cudaError_t e;
  if ((e = set_smem(flash_bwd_dkdv_wgmma_kernel<DP>, DkdvSmem<DP>::ALLOC)) !=
      cudaSuccess)
    return (int)e;
  if ((e = set_smem(flash_bwd_dq_wgmma_kernel<DP>, DqSmem<DP>::ALLOC)) !=
      cudaSuccess)
    return (int)e;
  flash_bwd_dkdv_wgmma_kernel<DP>
      <<<dim3(B * KH, (Sk + BKV - 1) / BKV), WG_THREADS, DkdvSmem<DP>::ALLOC,
         stream>>>(tq, tk, tv, tdo, ld, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), S, SP, Sk, HQ, KH, D, causal,
                   scale_log2, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dq_wgmma_kernel<DP>
      <<<dim3(B * HQ, (S + BQ2 - 1) / BQ2), WG_THREADS, DqSmem<DP>::ALLOC,
         stream>>>(tq, tk, tv, tdo, ld, static_cast<bf16*>(dq), S, SP, Sk,
                   HQ, KH, D, causal, scale_log2, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, const float2* ld, int B, int S,
               int SP, int Sk, int HQ, int KH, int D, int causal, float scale,
               cudaStream_t stream) {
  constexpr int LD = DP + PAD;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  // the streamed tiles take two stages each
  const int dkdv_smem = (2 * ROWS + 4 * TILE) * LD * 4 + 4 * TILE * 4;
  const int dq_smem = (2 * ROWS + 4 * TILE) * LD * 4 + 2 * ROWS * 4;
  cudaError_t e;
  if ((e = set_smem(flash_bwd_dkdv_kernel<DP>, dkdv_smem)) != cudaSuccess)
    return (int)e;
  if ((e = set_smem(flash_bwd_dq_kernel<DP>, dq_smem)) != cudaSuccess)
    return (int)e;
  flash_bwd_dkdv_kernel<DP>
      <<<dim3((Sk + ROWS - 1) / ROWS, B * KH), THREADS, dkdv_smem, stream>>>(
          qf, kf, vf, df, ld, static_cast<float*>(dk),
          static_cast<float*>(dv), S, SP, Sk, HQ, KH, D, causal, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<DP>
      <<<dim3((S + ROWS - 1) / ROWS, B * HQ), THREADS, dq_smem, stream>>>(
          qf, kf, vf, df, ld, static_cast<float*>(dq), S, SP, Sk, HQ, KH, D,
          causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, const float* lse,
                         float2* ld, int B, int S, int SP, int HQ, int D,
                         cudaStream_t stream) {
  const long long rows = (long long)B * HQ * SP;
  flash_bwd_delta_kernel<T>
      <<<(unsigned)((rows + DELTA_WARPS - 1) / DELTA_WARPS), DELTA_WARPS * 32,
         0, stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                      lse, ld, S, SP, HQ, D, rows);
  return cudaGetLastError();
}

}  // namespace

// Launch the three kernels on `stream`; returns cudaGetLastError() (or the
// error of cudaFuncSetAttribute, ERR_NO_ENCODE or ERR_ENCODE_BASE + the
// CUresult of a tensor map), or cudaErrorInvalidValue for HQ not a multiple
// of KH or a D and DP the route does not take: bfloat16 D a multiple of 16
// up to 128 and DP 64 (D <= 64) or 128; float32 (`is_f32`) D a multiple of
// 4 up to 128 and DP D rounded up to a multiple of 32
// (kernel.py:flash_bwd_plan).  q, o, dout, dq are contiguous (B, S, HQ, D);
// k, v, dk, dv contiguous (B, Sk, KH, D), bases 16-byte aligned; lse the
// forward's L, float32 (B, HQ, S); ld scratch, float32 (B HQ, SP, 2) with
// SP = S rounded up to a multiple of 128, 16-byte aligned.  The wrapper
// checks dtypes, shapes and alignment, allocates every output and never
// calls this with B, S, Sk or HQ equal to 0.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* dout, void* dq,
                                void* dk, void* dv, const float* lse,
                                float* ld, int B, int S, int Sk, int HQ,
                                int KH, int D, int causal, int is_f32, int dp,
                                float scale, void* stream) {
  if (KH <= 0 || HQ % KH || D > 128) return (int)cudaErrorInvalidValue;
  if (is_f32 ? (D < 4 || D % 4 || dp != (D + 31) / 32 * 32)
             : (D < 16 || D % 16 || dp != (D <= 64 ? 64 : 128)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int SP = (S + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  float2* ld2 = reinterpret_cast<float2*>(ld);
  cudaError_t e =
      is_f32 ? launch_delta<float>(o, dout, lse, ld2, B, S, SP, HQ, D, cs)
             : launch_delta<bf16>(o, dout, lse, ld2, B, S, SP, HQ, D, cs);
  if (e != cudaSuccess) return (int)e;
  if (!is_f32) {
    if (dp == 64)
      return launch_wgmma<64>(q, k, v, dout, dq, dk, dv, ld2, B, S, SP, Sk,
                              HQ, KH, D, causal, scale, cs);
    return launch_wgmma<128>(q, k, v, dout, dq, dk, dv, ld2, B, S, SP, Sk,
                             HQ, KH, D, causal, scale, cs);
  }
  switch (dp) {
    case 32:
      return launch_f32<32>(q, k, v, dout, dq, dk, dv, ld2, B, S, SP, Sk, HQ,
                            KH, D, causal, scale, cs);
    case 64:
      return launch_f32<64>(q, k, v, dout, dq, dk, dv, ld2, B, S, SP, Sk, HQ,
                            KH, D, causal, scale, cs);
    case 96:
      return launch_f32<96>(q, k, v, dout, dq, dk, dv, ld2, B, S, SP, Sk, HQ,
                            KH, D, causal, scale, cs);
    default:
      return launch_f32<128>(q, k, v, dout, dq, dk, dv, ld2, B, S, SP, Sk,
                             HQ, KH, D, causal, scale, cs);
  }
}
