// flash_bwd: the gradient of causal or non-causal GQA attention (dq, dk,
// dv from q, k, v, the forward's output o and its gradient do) in
// bfloat16 or float32 on Hopper (sm_90a), every product on the tensor
// cores through mma.sync.
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
// h / group, with scale = 1 / sqrt(D):
//   L[i]     = log sum_j exp(scale q_i . k_j)   over the keys row i sees
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
// 16-byte aligned bases; L and Delta are float32 scratch (B * HQ * S).  D
// is 64, 96 or 128.  Any S and Sk: ragged tiles are zero-filled and their
// positions masked.
//
// Three launches on one stream:
//   1. stats: one block per (64 query rows, b x h), 4 warps of 16 rows,
//      streams the key tiles the rows see, recomputes L by a running max
//      and sum (the forward kernels do not save it), and Delta (one warp a
//      row, a fixed shuffle order);
//   2. dk dv: one block per (64 keys, b x kv head), each warp owning 16
//      keys whose dk and dv stay in registers; it loops over the group's
//      query heads and, for each, the query tiles whose rows see its keys
//      (causal: tiles above the diagonal are skipped), recomputing S^T and
//      dP^T with the keys as rows, so P^T and dS^T are already the A
//      operands of dV += P^T dO and dK += dS^T Q;
//   3. dq: one block per (64 query rows, b x h), each warp owning 16 rows
//      whose dq stays in registers; it loops over the key tiles the rows
//      see (heaviest causal tiles launched first), recomputing S and dP.
// Every output element is written by one thread, and every sum runs in a
// fixed order: nothing is atomic, so two calls are bitwise equal.
//
// Precision: the products run on mma.sync with float32 accumulators.
// bfloat16: m16n8k16 from the bf16 operands (exact products), with P and dS
// rounded once to bf16 as A operands (FlashAttention-2's choice; the plain
// version keeps them in float32).  float32: 3xTF32 on m16n8k8 (hopper.cuh:
// split, mma; the forward's flash_tf32x3.cu scheme), each operand split
// into hi and lo and hi.hi, lo.hi, hi.lo summed in three accumulators.
// Each query tile's contribution to dk and dv, and each key tile's to dq,
// is summed on the tensor cores in fresh accumulators over that tile only
// and then added to the running sums on the CUDA cores: a float32 sum
// chained across many tiles on the tensor cores truncates one-signed, an
// error that grows with the number of tiles (PERF.md §6).
//
// What bounds it on this card: five products of S x Sk x D per head (half
// of them with `causal`) against a few bytes per score: the tensor cores.
// This first design recomputes S three times (stats, dk dv, dq) and dP
// twice, eight products in all, and runs mma.sync, not wgmma: it is simple
// and right first.  Each pass streams its tiles (key tiles, or a KV
// head's (query head, query tile) pairs) through a two-stage cp.async
// ring: the next tile's copy is in flight while the current one's
// products run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;  // 4 warps
constexpr int ROWS = 64;      // rows a block owns (16 a warp)
constexpr float NEG_INF = -1e30f;

// PAD: elements of padding in a shared-memory row, so fragment loads
// spread over the banks; TILE: rows of a streamed tile, fewer in float32,
// whose 3xTF32 accumulators take three times the registers
template <typename T>
struct Cfg {
  static constexpr int PAD = sizeof(T) == 2 ? 8 : 4;
  static constexpr int TILE = sizeof(T) == 2 ? 32 : 16;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The A operand of a 16 x 16 (rows x depth) product step and the B operand
// of a 16 x 8 (depth x cols) one, for thread (g, t) = (lane / 4, lane % 4).
// In "canonical" order, A holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1),
// (g, 2t+8), (g, 2t+9), (g+8, 2t+8), (g+8, 2t+9) and B holds (2t, g),
// (2t+1, g), (2t+8, g), (2t+9, g): m16n8k16's fragments.  bfloat16 keeps
// them packed in pairs; float32 keeps the values, and its two m16n8k8
// steps take depth t from 2t and t + 4 from 2t + 1 (the forward's
// pairing), so the same elements feed either product.
template <typename T>
struct FragA;
template <>
struct FragA<bf16> {
  uint32_t r[4];
};
template <>
struct FragA<float> {
  float x[8];
};
template <typename T>
struct FragB;
template <>
struct FragB<bf16> {
  uint32_t r[2];
};
template <>
struct FragB<float> {
  float x[4];
};

// C of a 16 x 8 product: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
template <typename T>
struct Acc;
template <>
struct Acc<bf16> {
  float c[4];
  __device__ __forceinline__ void zero() { c[0] = c[1] = c[2] = c[3] = 0.f; }
  __device__ __forceinline__ float get(int e) const { return c[e]; }
};
template <>
struct Acc<float> {
  float c[4], s1[4], s2[4];  // hi.hi, lo.hi, hi.lo
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = s1[e] = s2[e] = 0.f;
  }
  __device__ __forceinline__ float get(int e) const {
    return c[e] + (s1[e] + s2[e]);
  }
};

__device__ __forceinline__ void mma16(Acc<bf16>& d, const FragA<bf16>& a,
                                      const FragB<bf16>& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d.c[0]), "+f"(d.c[1]), "+f"(d.c[2]), "+f"(d.c[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
        "r"(b.r[1]));
}

__device__ __forceinline__ void mma16(Acc<float>& d, const FragA<float>& a,
                                      const FragB<float>& b) {
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
__device__ __forceinline__ void load_a(FragA<bf16>& a, const bf16* X, int ld,
                                       int r0, int c0, int g, int t) {
  const bf16* p = X + (r0 + g) * ld + c0 + 2 * t;
  a.r[0] = *reinterpret_cast<const uint32_t*>(p);
  a.r[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a.r[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a.r[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}
__device__ __forceinline__ void load_a(FragA<float>& a, const float* X,
                                       int ld, int r0, int c0, int g, int t) {
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
__device__ __forceinline__ void load_b_rows(FragB<bf16>& b, const bf16* X,
                                            int ld, int n0, int k0, int g,
                                            int t) {
  const bf16* p = X + (n0 + g) * ld + k0 + 2 * t;
  b.r[0] = *reinterpret_cast<const uint32_t*>(p);
  b.r[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}
__device__ __forceinline__ void load_b_rows(FragB<float>& b, const float* X,
                                            int ld, int n0, int k0, int g,
                                            int t) {
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
__device__ __forceinline__ void load_b_cols(FragB<bf16>& b, const bf16* X,
                                            int ld, int k0, int n0, int g,
                                            int t) {
  const bf16* p = X + (k0 + 2 * t) * ld + n0 + g;
  b.r[0] = pack_raw(p[0], p[ld]);
  b.r[1] = pack_raw(p[8 * ld], p[9 * ld]);
}
__device__ __forceinline__ void load_b_cols(FragB<float>& b, const float* X,
                                            int ld, int k0, int n0, int g,
                                            int t) {
  const float* p = X + (k0 + 2 * t) * ld + n0 + g;
  b.x[0] = p[0];
  b.x[1] = p[ld];
  b.x[2] = p[8 * ld];
  b.x[3] = p[9 * ld];
}

// A from two C tiles in registers (columns 16m .. 16m+7 and 16m+8 ..
// 16m+15 of a product): the C layout is the A layout, so P and dS never
// leave the registers
__device__ __forceinline__ void a_from_c(FragA<bf16>& a, const float (&lo)[4],
                                         const float (&hi)[4]) {
  a.r[0] = pack_bf16(lo[0], lo[1]);
  a.r[1] = pack_bf16(lo[2], lo[3]);
  a.r[2] = pack_bf16(hi[0], hi[1]);
  a.r[3] = pack_bf16(hi[2], hi[3]);
}
__device__ __forceinline__ void a_from_c(FragA<float>& a,
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    a.x[e] = lo[e];
    a.x[4 + e] = hi[e];
  }
}

// issue the copy of rows r_begin .. r_begin + nrows of a (row stride
// `stride` elements, D contiguous) into dst (row stride ld) by cp.async,
// rows >= rmax zero-filled; the whole block takes part, and the caller
// commits the group and waits for it
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long stride, int r_begin,
                                          int nrows, int rmax) {
  constexpr int PER = 16 / sizeof(T);  // elements of a 16-byte chunk
  constexpr int CH = D / PER;
  for (int e = threadIdx.x; e < nrows * CH; e += blockDim.x) {
    const int r = e / CH, c = e % CH;
    const bool ok = r_begin + r < rmax;
    cp_async<16>(dst + r * ld + c * PER,
                 ok ? src + (long long)(r_begin + r) * stride + c * PER : src,
                 ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------------
// 1. L and Delta of each query row
// grid (ceil(S / ROWS), B * HQ)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ lse, float* __restrict__ delta,
                       int S, int Sk, int HQ, int KH, int causal,
                       float scale) {
  constexpr int LD = D + Cfg<T>::PAD;
  constexpr int KT = Cfg<T>::TILE;
  constexpr int NT = KT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Kring = Qs + ROWS * LD;  // two stages of KT rows

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / HQ, h = blockIdx.y % HQ;
  const int hk = h / (HQ / KH);
  const int q0 = blockIdx.x * ROWS;
  const int off = Sk - S;
  const long long qstride = (long long)HQ * D, kstride = (long long)KH * D;
  const T* qb = q + ((long long)b * S * HQ + h) * D;
  const T* kb = k + ((long long)b * Sk * KH + hk) * D;

  // Delta: one warp a row, lanes along D, a fixed shuffle order
  for (int r = warp; r < ROWS && q0 + r < S; r += THREADS / 32) {
    const long long row = ((long long)b * S + q0 + r) * HQ * D + h * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc += to_f(dout[row + d]) * to_f(o[row + d]);
#pragma unroll
    for (int sh = 16; sh > 0; sh /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, sh);
    if (lane == 0) delta[(long long)blockIdx.y * S + q0 + r] = acc;
  }

  const int q_last = min(q0 + ROWS, S) - 1;
  const int k_end = causal ? min(Sk, q_last + off + 1) : Sk;
  const int ntiles = k_end > 0 ? (k_end + KT - 1) / KT : 0;
  const bool active = q0 + 16 * warp < S;
  const int w_last = min(q0 + 16 * warp + 15, S - 1);
  const int w_end = causal ? min(Sk, w_last + off + 1) : Sk;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // Q and the first key tile in one group; then each iteration issues the
  // next tile into the other stage before it waits for its own
  load_rows<T, D>(Qs, LD, qb, qstride, q0, ROWS, S);
  if (ntiles > 0) load_rows<T, D>(Kring, LD, kb, kstride, 0, KT, Sk);
  cp_async_commit();
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * KT;
    __syncthreads();  // the other stage's reads (tile kt - 1) are done
    if (kt + 1 < ntiles)
      load_rows<T, D>(Kring + ((kt + 1) & 1) * KT * LD, LD, kb, kstride,
                      k0 + KT, KT, Sk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt is in, for every thread
    const T* Ks = Kring + (kt & 1) * KT * LD;
    if (!active || k0 >= w_end) continue;
    Acc<T> s[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt].zero();
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA<T> a;
      load_a(a, Qs, LD, 16 * warp, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        FragB<T> fb;
        load_b_rows(fb, Ks, LD, 8 * nt, kk, g, t);
        mma16(s[nt], a, fb);
      }
    }
    float sv[NT][4];
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + 8 * nt + 2 * t + (e & 1);
        const int r = e < 2 ? r0 : r1;
        const bool ok = c < Sk && (!causal || c <= r + off);
        sv[nt][e] = ok ? s[nt].get(e) * scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(sv[nt][0], sv[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sv[nt][2], sv[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sum0 += expf(sv[nt][0] - mn0) + expf(sv[nt][1] - mn0);  // -inf -> 0
      sum1 += expf(sv[nt][2] - mn1) + expf(sv[nt][3] - mn1);
    }
    l0 = l0 * expf(m0 - mn0) + sum0;
    l1 = l1 * expf(m1 - mn1) + sum1;
    m0 = mn0;
    m1 = mn1;
  }
  cp_async_wait<0>();
  if (!active) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (t == 0) {
    float* out = lse + (long long)blockIdx.y * S;
    if (r0 < S) out[r0] = l0 > 0.f ? m0 + logf(l0) : INFINITY;
    if (r1 < S) out[r1] = l1 > 0.f ? m1 + logf(l1) : INFINITY;
  }
}

// ---------------------------------------------------------------------
// 2. dk and dv
// grid (ceil(Sk / ROWS), B * KH)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int Sk, int HQ, int KH,
                      int causal, float scale) {
  constexpr int LD = D + Cfg<T>::PAD;
  constexpr int QT = Cfg<T>::TILE;  // query rows of a tile
  constexpr int NT = QT / 8;     // its 8-row groups (the products' columns)
  constexpr int MT = QT / 16;    // its 16-row depth steps
  constexpr int DT = D / 8;      // 8-column tiles of D
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + ROWS * LD;
  // two stages of a query tile: Q, dO, L and Delta
  T* Qring = Vs + ROWS * LD;
  T* Oring = Qring + 2 * QT * LD;
  float* Lring = reinterpret_cast<float*>(Oring + 2 * QT * LD);
  float* Dring = Lring + 2 * QT;

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / KH, hk = blockIdx.y % KH;
  const int group = HQ / KH;
  const int k0 = blockIdx.x * ROWS;
  const int off = Sk - S;
  const long long qstride = (long long)HQ * D, kstride = (long long)KH * D;

  load_rows<T, D>(Ks, LD, k + ((long long)b * Sk * KH + hk) * D, kstride,
                  k0, ROWS, Sk);
  load_rows<T, D>(Vs, LD, v + ((long long)b * Sk * KH + hk) * D, kstride,
                  k0, ROWS, Sk);

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
    load_rows<T, D>(Qring + sg * QT * LD, LD, q + base, qstride, q0, QT, S);
    load_rows<T, D>(Oring + sg * QT * LD, LD, dout + base, qstride, q0, QT,
                    S);
    const float* lb = lse + ((long long)b * HQ + h) * S;
    const float* db = delta + ((long long)b * HQ + h) * S;
    for (int r = threadIdx.x; r < QT; r += blockDim.x) {
      const bool ok = q0 + r < S;
      Lring[sg * QT + r] = ok ? lb[q0 + r] : INFINITY;
      Dring[sg * QT + r] = ok ? db[q0 + r] : 0.f;
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
    const T* Qs = Qring + sg * QT * LD;
    const T* Os = Oring + sg * QT * LD;
    const float* Ls = Lring + sg * QT;
    const float* Ds = Dring + sg * QT;
    // does any row of the tile see any of this warp's keys?
    const int row_last = min(q0 + QT, S) - 1;
    if (!wactive || (causal && row_last + off < wk0)) continue;

    // S^T (keys x rows) = K Q^T and dP^T = V dO^T
    Acc<T> st[NT], dpt[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      st[nt].zero();
      dpt[nt].zero();
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA<T> ak, av;
      load_a(ak, Ks, LD, 16 * warp, kk, g, t);
      load_a(av, Vs, LD, 16 * warp, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        FragB<T> bq, bo;
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
    FragA<T> pa[MT], sa[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      a_from_c(pa[m], p[2 * m], p[2 * m + 1]);
      a_from_c(sa[m], ds[2 * m], ds[2 * m + 1]);
    }
    // dV += P^T dO and dK += dS^T Q, each 8-column tile of D summed over
    // this query tile alone, then added on the CUDA cores
#pragma unroll
    for (int nd = 0; nd < DT; ++nd) {
      Acc<T> cv, ck;
      cv.zero();
      ck.zero();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        FragB<T> bo, bq;
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
      const int c = 8 * nd + 2 * t;
      dk[row + c] = from_f<T>(dka[nd][2 * half] * scale);
      dk[row + c + 1] = from_f<T>(dka[nd][2 * half + 1] * scale);
      dv[row + c] = from_f<T>(dva[nd][2 * half]);
      dv[row + c + 1] = from_f<T>(dva[nd][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// 3. dq
// grid (ceil(S / ROWS), B * HQ)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int Sk, int HQ, int KH, int causal, float scale) {
  constexpr int LD = D + Cfg<T>::PAD;
  constexpr int KT = Cfg<T>::TILE;  // keys of a tile
  constexpr int NT = KT / 8;
  constexpr int MT = KT / 16;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Os = Qs + ROWS * LD;  // dO
  T* Kring = Os + ROWS * LD;  // two stages of a key tile: K, then V
  T* Vring = Kring + 2 * KT * LD;
  float* Ls = reinterpret_cast<float*>(Vring + 2 * KT * LD);
  float* Ds = Ls + ROWS;

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / HQ, h = blockIdx.y % HQ;
  const int hk = h / (HQ / KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest first
  const int off = Sk - S;
  const long long qstride = (long long)HQ * D, kstride = (long long)KH * D;
  const T* kb = k + ((long long)b * Sk * KH + hk) * D;
  const T* vb = v + ((long long)b * Sk * KH + hk) * D;

  load_rows<T, D>(Qs, LD, q + ((long long)b * S * HQ + h) * D, qstride, q0,
                  ROWS, S);
  load_rows<T, D>(Os, LD, dout + ((long long)b * S * HQ + h) * D, qstride,
                  q0, ROWS, S);
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    const bool ok = q0 + r < S;
    Ls[r] = ok ? lse[(long long)blockIdx.y * S + q0 + r] : INFINITY;
    Ds[r] = ok ? delta[(long long)blockIdx.y * S + q0 + r] : 0.f;
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
    load_rows<T, D>(Kring, LD, kb, kstride, 0, KT, Sk);
    load_rows<T, D>(Vring, LD, vb, kstride, 0, KT, Sk);
  }
  cp_async_commit();
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * KT;
    __syncthreads();  // the other stage's reads (tile kt - 1) are done
    if (kt + 1 < ntiles) {
      const int nx = ((kt + 1) & 1) * KT * LD;
      load_rows<T, D>(Kring + nx, LD, kb, kstride, k0 + KT, KT, Sk);
      load_rows<T, D>(Vring + nx, LD, vb, kstride, k0 + KT, KT, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt (and Q, dO, L, Delta) is in, for every thread
    const T* Ks = Kring + (kt & 1) * KT * LD;
    const T* Vs = Vring + (kt & 1) * KT * LD;
    if (!active || k0 >= w_end) continue;
    const float L0 = Ls[lr0], L1 = Ls[lr1], D0 = Ds[lr0], D1 = Ds[lr1];

    // S = Q K^T and dP = dO V^T
    Acc<T> s[NT], dp[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt].zero();
      dp[nt].zero();
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA<T> aq, ao;
      load_a(aq, Qs, LD, 16 * warp, kk, g, t);
      load_a(ao, Os, LD, 16 * warp, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        FragB<T> bk, bv;
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
    FragA<T> sa[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) a_from_c(sa[m], ds[2 * m], ds[2 * m + 1]);
    // dQ += dS K, each 8-column tile of D summed over this key tile alone
#pragma unroll
    for (int nd = 0; nd < DT; ++nd) {
      Acc<T> c;
      c.zero();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        FragB<T> bk;
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
      dq[row + c] = from_f<T>(dqa[nd][2 * half] * scale);
      dq[row + c + 1] = from_f<T>(dqa[nd][2 * half + 1] * scale);
    }
  }
}

template <typename KernelFn>
cudaError_t set_smem(KernelFn fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int B, int S, int Sk, int HQ, int KH, int causal,
           float scale, cudaStream_t stream) {
  constexpr int LD = D + Cfg<T>::PAD;
  constexpr int TL = Cfg<T>::TILE;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* dot = static_cast<const T*>(dout);
  // the streamed tiles take two stages each
  const int stats_smem = (ROWS + 2 * TL) * LD * (int)sizeof(T);
  const int dkdv_smem =
      (2 * ROWS + 4 * TL) * LD * (int)sizeof(T) + 4 * TL * 4;
  const int dq_smem = (2 * ROWS + 4 * TL) * LD * (int)sizeof(T) + 2 * ROWS * 4;
  cudaError_t e;
  if ((e = set_smem(flash_bwd_stats_kernel<T, D>, stats_smem)) != cudaSuccess)
    return (int)e;
  if ((e = set_smem(flash_bwd_dkdv_kernel<T, D>, dkdv_smem)) != cudaSuccess)
    return (int)e;
  if ((e = set_smem(flash_bwd_dq_kernel<T, D>, dq_smem)) != cudaSuccess)
    return (int)e;
  const dim3 q_grid((S + ROWS - 1) / ROWS, B * HQ);
  const dim3 k_grid((Sk + ROWS - 1) / ROWS, B * KH);
  flash_bwd_stats_kernel<T, D><<<q_grid, THREADS, stats_smem, stream>>>(
      qt, kt, ot, dot, lse, delta, S, Sk, HQ, KH, causal, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<T, D><<<k_grid, THREADS, dkdv_smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, Sk, HQ, KH, causal, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, D><<<q_grid, THREADS, dq_smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), S, Sk, HQ, KH,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* o, const void* dout, void* dq, void* dk, void* dv,
             float* lse, float* delta, int B, int S, int Sk, int HQ, int KH,
             int causal, float scale, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, Sk,
                         HQ, KH, causal, scale, stream);
  if (D == 96)
    return launch<T, 96>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, Sk,
                         HQ, KH, causal, scale, stream);
  return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, Sk,
                        HQ, KH, causal, scale, stream);
}

}  // namespace

// Launch the three kernels on `stream`; returns cudaGetLastError() (or the
// error of cudaFuncSetAttribute), or cudaErrorInvalidValue for D not 64,
// 96 or 128, or HQ not a multiple of KH.  `is_f32` picks float32 operands,
// else bfloat16.  q, o, dout, dq are contiguous (B, S, HQ, D); k, v, dk, dv
// contiguous (B, Sk, KH, D); lse and delta float32 scratch of B * HQ * S.
// The wrapper checks dtypes, shapes and alignment, allocates every output
// and never calls this with B, S, Sk or HQ equal to 0.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* dout, void* dq,
                                void* dk, void* dv, float* lse, float* delta,
                                int B, int S, int Sk, int HQ, int KH, int D,
                                int causal, int is_f32, float scale,
                                void* stream) {
  if ((D != 64 && D != 96 && D != 128) || KH <= 0 || HQ % KH)
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (is_f32)
    return launch_d<float>(D, q, k, v, o, dout, dq, dk, dv, lse, delta, B, S,
                           Sk, HQ, KH, causal, scale, cs);
  return launch_d<bf16>(D, q, k, v, o, dout, dq, dk, dv, lse, delta, B, S,
                        Sk, HQ, KH, causal, scale, cs);
}
