// flash_wide: GQA attention and its gradient for head dims above 128,
// float32 or bfloat16 operands, on the CUDA cores of Hopper (sm_90a).  The
// tensor-core kernels beside it (flash_wgmma.cu, flash_tf32x3.cu,
// flash_bwd.cu) keep a query tile's scores and output in registers sized
// for D <= 128; this simple variant takes the wider heads they refuse.  No
// config of the repository has such a head: it makes the op take every head
// dim, as the TPU kernel does.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas (body _flash_kernel), for D > 128; the gradient
// has no TPU kernel (the reference differentiates its jnp oracle,
// src/repro/kernels/flash_attention/ref.py:18), as flash_bwd.cu.
//
// Computes, for each batch b, query head h and query row i (query head h
// reads kv head h / group):
//   out[b, i, h] = softmax_j(q[b, i, h] / sqrt(D) . k[b, j, h / group])
//                  @ v[b, j, h / group]
// over the keys j the row sees: all Sk, or with `causal` j <= i + Sk - S
// (the diagonal aligned bottom-right, the reference oracles' mask).  With a
// log-sum-exp buffer each row's L = m + ln l of its scaled scores is
// written too (+inf for a row that sees no key, whose output is zeros).
// The backward takes that L: Delta_i = do_i . o_i, then dq (a pass over
// each query row's keys) and dk, dv (a pass over each key row's query rows
// of every head in its group), with p = exp(s - L), ds = p (do . v -
// Delta): no atomics, every sum in one thread's fixed order.
//
// Layout: one warp a row (a query row in the forward and dq, a key row in
// dk dv), its D values spread over the 32 lanes (lane + 32 t, t < 8), eight
// rows a block; a dot product is each lane's partial sum reduced across
// the warp by shuffles.  The other operand streams through shared memory
// in tiles of 16 rows, read by consecutive lanes at consecutive addresses.
// Everything is float32 (bfloat16 operands are widened on load, results
// rounded once on store).  Operands are contiguous (the wrapper makes
// them so): q, out, do, dq (B, S, HQ, D); k, v, dk, dv (B, Sk, KH, D); L
// and Delta (B, HQ, S).
//
// Head dims above MAXD = 256 (the "sliced" kernels): a lane holds 8
// values, so the head dim is walked in slices of 256 columns.  A score
// (and in the backward do . v) is summed over the slices, each slice of
// the register-side row against the same slice of a streamed tile.  The
// forward takes two launches: each row's L (an online max and sum over
// its keys), then one block per (rows, slice of the output): p = exp(s -
// L) recomputed from L, its slice of p v accumulated and written.  The
// backward writes dq, dk and dv slice by slice in the same way (a block a
// slice, each recomputing p and ds from L and Delta over the whole head
// dim).  So each output slice pays the whole score work again: right, not
// fast.
//
// What bounds it on this card: each score costs a warp's dot product, a
// five-step shuffle reduction and an exponential on the CUDA cores, far
// from the tensor cores' rate: a simple variant that is right, timed in
// chip_smoke.py phase 7 (PERF.md), not a fast one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;             // rows a block
constexpr int TILE = 16;             // rows of the streamed operand a tile
constexpr int MAXD = 256;
constexpr int EPL = MAXD / 32;       // values a lane holds

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ void st(T* p, float x);
template <>
__device__ __forceinline__ void st<float>(float* p, float x) {
  *p = x;
}
template <>
__device__ __forceinline__ void st<__nv_bfloat16>(__nv_bfloat16* p,
                                                   float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One row of D values into a lane's registers (zeros past D), times `mul`.
template <typename T>
__device__ __forceinline__ void load_row(const T* row, int D, int lane,
                                         float mul, float (&r)[EPL]) {
#pragma unroll
  for (int t = 0; t < EPL; ++t) {
    const int e = lane + 32 * t;
    r[t] = e < D ? ld(row + e) * mul : 0.f;
  }
}

__device__ __forceinline__ float dot(const float (&r)[EPL], const float* s,
                                     int D, int lane) {
  float part = 0.f;
#pragma unroll
  for (int t = 0; t < EPL; ++t) {
    const int e = lane + 32 * t;
    if (e < D) part = fmaf(r[t], s[e], part);
  }
  return warp_sum(part);
}

// The keys a block of query rows [i0, i0 + WARPS) needs: all Sk, or up to
// its last row's causal limit.
__device__ __forceinline__ int key_end(int i0, int S, int Sk, int causal) {
  if (!causal) return Sk;
  const int last = min(S - 1, i0 + WARPS - 1);
  return min(Sk, max(0, last + Sk - S + 1));
}

// Rows [r0, r0 + TILE) of a (B, rows, H, D) operand at (b, h) into shared
// memory as float32 (times `mul`), zeros past the last row.
template <typename T>
__device__ __forceinline__ void load_tile(float (*dst)[MAXD], const T* src,
                                          int b, int rows, int H, int h,
                                          int D, int r0, float mul) {
  for (int x = threadIdx.x; x < TILE * D; x += blockDim.x) {
    const int j = x / D, e = x % D, r = r0 + j;
    dst[j][e] = r < rows
        ? ld(src + ((size_t)(b * rows + r) * H + h) * D + e) * mul : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_wide_fwd(const T* q, const T* k, const T* v, T* out, float* lse,
               int S, int Sk, int HQ, int KH, int D, int causal,
               float scale) {
  __shared__ float ks[TILE][MAXD];
  __shared__ float vs[TILE][MAXD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (HQ / KH);
  const int i0 = blockIdx.x * WARPS, i = i0 + warp;
  const bool row = i < S;
  const int lim = causal ? i + Sk - S : Sk - 1;     // the row's last key
  float qr[EPL], acc[EPL];
  if (row) load_row(q + ((size_t)(b * S + i) * HQ + h) * D, D, lane, scale,
                    qr);
#pragma unroll
  for (int t = 0; t < EPL; ++t) acc[t] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int kend = key_end(i0, S, Sk, causal);
  for (int k0 = 0; k0 < kend; k0 += TILE) {
    __syncthreads();
    load_tile(ks, k, b, Sk, KH, kh, D, k0, 1.f);
    load_tile(vs, v, b, Sk, KH, kh, D, k0, 1.f);
    __syncthreads();
    if (!row) continue;
    float s[TILE];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const int kj = k0 + j;
      const float sj = dot(qr, ks[j], D, lane);
      s[j] = (kj < Sk && kj <= lim) ? sj : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    if (tmax == -INFINITY) continue;
    const float mn = fmaxf(m, tmax);
    const float corr = expf(m - mn);
    l *= corr;
#pragma unroll
    for (int t = 0; t < EPL; ++t) acc[t] *= corr;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const float p = expf(s[j] - mn);
      l += p;
#pragma unroll
      for (int t = 0; t < EPL; ++t) {
        const int e = lane + 32 * t;
        if (e < D) acc[t] = fmaf(p, vs[j][e], acc[t]);
      }
    }
    m = mn;
  }
  if (!row) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* o = out + ((size_t)(b * S + i) * HQ + h) * D;
#pragma unroll
  for (int t = 0; t < EPL; ++t) {
    const int e = lane + 32 * t;
    if (e < D) st(o + e, acc[t] * inv);
  }
  if (lse != nullptr && lane == 0)
    lse[((size_t)b * HQ + h) * S + i] = l > 0.f ? m + logf(l) : INFINITY;
}

// Delta_i = do_i . o_i, (B, HQ, S) float32.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_wide_delta(const T* o, const T* dout, float* delta, int S, int HQ,
                 int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z, i = blockIdx.x * WARPS + warp;
  if (i >= S) return;
  const size_t off = ((size_t)(b * S + i) * HQ + h) * D;
  float part = 0.f;
  for (int e = lane; e < D; e += 32)
    part = fmaf(ld(dout + off + e), ld(o + off + e), part);
  part = warp_sum(part);
  if (lane == 0) delta[((size_t)b * HQ + h) * S + i] = part;
}

// dq_i = scale * sum_j ds_ij k_j over the keys row i sees.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_wide_dq(const T* q, const T* k, const T* v, const T* dout,
              const float* lse, const float* delta, T* dq, int S, int Sk,
              int HQ, int KH, int D, int causal, float scale) {
  __shared__ float ks[TILE][MAXD];
  __shared__ float vs[TILE][MAXD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (HQ / KH);
  const int i0 = blockIdx.x * WARPS, i = i0 + warp;
  const bool row = i < S;
  const int lim = causal ? i + Sk - S : Sk - 1;
  float qr[EPL], dr[EPL], acc[EPL];
  float L = INFINITY, Dl = 0.f;
  if (row) {
    const size_t off = ((size_t)(b * S + i) * HQ + h) * D;
    load_row(q + off, D, lane, scale, qr);
    load_row(dout + off, D, lane, 1.f, dr);
    L = lse[((size_t)b * HQ + h) * S + i];
    Dl = delta[((size_t)b * HQ + h) * S + i];
  }
#pragma unroll
  for (int t = 0; t < EPL; ++t) acc[t] = 0.f;
  const int kend = key_end(i0, S, Sk, causal);
  for (int k0 = 0; k0 < kend; k0 += TILE) {
    __syncthreads();
    load_tile(ks, k, b, Sk, KH, kh, D, k0, 1.f);
    load_tile(vs, v, b, Sk, KH, kh, D, k0, 1.f);
    __syncthreads();
    if (!row) continue;
    for (int j = 0; j < TILE; ++j) {
      const int kj = k0 + j;
      if (kj >= Sk || kj > lim) break;
      const float p = expf(dot(qr, ks[j], D, lane) - L);
      const float ds = p * (dot(dr, vs[j], D, lane) - Dl);
#pragma unroll
      for (int t = 0; t < EPL; ++t) {
        const int e = lane + 32 * t;
        if (e < D) acc[t] = fmaf(ds, ks[j][e], acc[t]);
      }
    }
  }
  if (!row) return;
  T* o = dq + ((size_t)(b * S + i) * HQ + h) * D;
#pragma unroll
  for (int t = 0; t < EPL; ++t) {
    const int e = lane + 32 * t;
    if (e < D) st(o + e, acc[t] * scale);
  }
}

// dk_j = sum_i ds_ij (scale q_i), dv_j = sum_i p_ij do_i over the query
// rows of every head in key j's group that see it.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_wide_dkdv(const T* q, const T* k, const T* v, const T* dout,
                const float* lse, const float* delta, T* dk, T* dv, int S,
                int Sk, int HQ, int KH, int D, int causal, float scale) {
  __shared__ float qs[TILE][MAXD];
  __shared__ float ds_[TILE][MAXD];
  __shared__ float Ls[TILE], Ds[TILE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kh = blockIdx.y, b = blockIdx.z, G = HQ / KH;
  const int j0 = blockIdx.x * WARPS, j = j0 + warp;
  const bool row = j < Sk;
  const int shift = Sk - S;
  float kr[EPL], vr[EPL], gk[EPL], gv[EPL];
  if (row) {
    const size_t off = ((size_t)(b * Sk + j) * KH + kh) * D;
    load_row(k + off, D, lane, 1.f, kr);
    load_row(v + off, D, lane, 1.f, vr);
  }
#pragma unroll
  for (int t = 0; t < EPL; ++t) gk[t] = gv[t] = 0.f;
  // the first query row any key of the block is visible to
  const int ibeg = causal ? max(0, j0 - shift) : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int r0 = ibeg - ibeg % TILE; r0 < S; r0 += TILE) {
      __syncthreads();
      load_tile(qs, q, b, S, HQ, h, D, r0, scale);
      load_tile(ds_, dout, b, S, HQ, h, D, r0, 1.f);
      if (threadIdx.x < TILE) {
        const int r = r0 + threadIdx.x;
        const size_t at = ((size_t)b * HQ + h) * S + r;
        Ls[threadIdx.x] = r < S ? lse[at] : INFINITY;
        Ds[threadIdx.x] = r < S ? delta[at] : 0.f;
      }
      __syncthreads();
      if (!row) continue;
      for (int x = 0; x < TILE; ++x) {
        const int i = r0 + x;
        if (i >= S || (causal && j > i + shift)) continue;
        const float p = expf(dot(kr, qs[x], D, lane) - Ls[x]);
        const float ds = p * (dot(vr, ds_[x], D, lane) - Ds[x]);
#pragma unroll
        for (int t = 0; t < EPL; ++t) {
          const int e = lane + 32 * t;
          if (e < D) {
            gv[t] = fmaf(p, ds_[x][e], gv[t]);
            gk[t] = fmaf(ds, qs[x][e], gk[t]);
          }
        }
      }
    }
  }
  if (!row) return;
  const size_t off = ((size_t)(b * Sk + j) * KH + kh) * D;
#pragma unroll
  for (int t = 0; t < EPL; ++t) {
    const int e = lane + 32 * t;
    if (e < D) {
      st(dk + off + e, gk[t]);
      st(dv + off + e, gv[t]);
    }
  }
}

// ---------------------------------------------------------------------
// D > MAXD: the head dim in slices of MAXD columns
// ---------------------------------------------------------------------
__host__ __device__ __forceinline__ int n_slices(int D) {
  return (D + MAXD - 1) / MAXD;
}

// Columns [c0, c0 + w) of rows [r0, r0 + TILE) of a (B, rows, H, D)
// operand at (b, h) into shared memory as float32 (times `mul`), zeros
// past the last row.
template <typename T>
__device__ __forceinline__ void load_cols(float (*dst)[MAXD], const T* src,
                                          int b, int rows, int H, int h,
                                          int D, int c0, int w, int r0,
                                          float mul) {
  for (int x = threadIdx.x; x < TILE * w; x += blockDim.x) {
    const int j = x / w, e = x % w, r = r0 + j;
    dst[j][e] = r < rows
        ? ld(src + ((size_t)(b * rows + r) * H + h) * D + c0 + e) * mul
        : 0.f;
  }
}

// s[j] = (amul a) . (bmul b_j) over the whole head dim, for this warp's
// row a (D values at `arow`, valid where `row`) and the TILE rows b_j from
// r0 of a (B, rows, H, D) operand at (b, h): slice by slice, each slice of
// the tile staged in `buf`.  Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void sliced_dots(const T* arow, bool row,
                                            float amul, const T* src, int b,
                                            int rows, int H, int h, int D,
                                            int r0, float bmul,
                                            float (*buf)[MAXD],
                                            float (&s)[TILE]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < TILE; ++j) s[j] = 0.f;
  float r[EPL];
  for (int c0 = 0; c0 < D; c0 += MAXD) {
    const int w = min(MAXD, D - c0);
    __syncthreads();
    load_cols(buf, src, b, rows, H, h, D, c0, w, r0, bmul);
    if (row) load_row(arow + c0, w, lane, amul, r);
    __syncthreads();
    if (row) {
#pragma unroll
      for (int j = 0; j < TILE; ++j) s[j] += dot(r, buf[j], w, lane);
    }
  }
}

// Each query row's L over its keys (scores summed over the slices).
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_wide_fwd_lse(const T* q, const T* k, float* lse, int S, int Sk,
                   int HQ, int KH, int D, int causal, float scale) {
  __shared__ float buf[TILE][MAXD];
  const int warp = threadIdx.x / 32;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (HQ / KH);
  const int i0 = blockIdx.x * WARPS, i = i0 + warp;
  const bool row = i < S;
  const int lim = causal ? i + Sk - S : Sk - 1;
  const T* qrow = q + ((size_t)(b * S + min(i, S - 1)) * HQ + h) * D;
  float m = -INFINITY, l = 0.f;
  const int kend = key_end(i0, S, Sk, causal);
  for (int k0 = 0; k0 < kend; k0 += TILE) {
    float s[TILE];
    sliced_dots(qrow, row, scale, k, b, Sk, KH, kh, D, k0, 1.f, buf, s);
    if (!row) continue;
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const int kj = k0 + j;
      if (!(kj < Sk && kj <= lim)) s[j] = -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    if (tmax == -INFINITY) continue;
    const float mn = fmaxf(m, tmax);
    l *= expf(m - mn);
#pragma unroll
    for (int j = 0; j < TILE; ++j) l += expf(s[j] - mn);
    m = mn;
  }
  if (row && threadIdx.x % 32 == 0)
    lse[((size_t)b * HQ + h) * S + i] = l > 0.f ? m + logf(l) : INFINITY;
}

// One slice of the output: out[:, c0:c0 + w] = sum_j exp(s_j - L) v_j.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_wide_fwd_slice(const T* q, const T* k, const T* v, T* out,
                     const float* lse, int S, int Sk, int HQ, int KH,
                     int D, int causal, float scale) {
  __shared__ float buf[TILE][MAXD];
  __shared__ float vs[TILE][MAXD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ns = n_slices(D);
  const int h = blockIdx.y, b = blockIdx.z / ns, c0 = blockIdx.z % ns * MAXD;
  const int w = min(MAXD, D - c0), kh = h / (HQ / KH);
  const int i0 = blockIdx.x * WARPS, i = i0 + warp;
  const bool row = i < S;
  const int lim = causal ? i + Sk - S : Sk - 1;
  const T* qrow = q + ((size_t)(b * S + min(i, S - 1)) * HQ + h) * D;
  const float L = row ? lse[((size_t)b * HQ + h) * S + i] : INFINITY;
  float acc[EPL];
#pragma unroll
  for (int t = 0; t < EPL; ++t) acc[t] = 0.f;
  const int kend = key_end(i0, S, Sk, causal);
  for (int k0 = 0; k0 < kend; k0 += TILE) {
    float s[TILE];
    sliced_dots(qrow, row, scale, k, b, Sk, KH, kh, D, k0, 1.f, buf, s);
    __syncthreads();
    load_cols(vs, v, b, Sk, KH, kh, D, c0, w, k0, 1.f);
    __syncthreads();
    if (!row) continue;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const int kj = k0 + j;
      if (kj >= Sk || kj > lim) continue;
      const float p = expf(s[j] - L);
#pragma unroll
      for (int t = 0; t < EPL; ++t) {
        const int e = lane + 32 * t;
        if (e < w) acc[t] = fmaf(p, vs[j][e], acc[t]);
      }
    }
  }
  if (!row) return;
  T* o = out + ((size_t)(b * S + i) * HQ + h) * D + c0;
#pragma unroll
  for (int t = 0; t < EPL; ++t) {
    const int e = lane + 32 * t;
    if (e < w) st(o + e, acc[t]);
  }
}

// One slice of dq: dq_i[c] = scale * sum_j ds_ij k_j[c].
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_wide_dq_slice(const T* q, const T* k, const T* v, const T* dout,
                    const float* lse, const float* delta, T* dq, int S,
                    int Sk, int HQ, int KH, int D, int causal, float scale) {
  __shared__ float buf[TILE][MAXD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ns = n_slices(D);
  const int h = blockIdx.y, b = blockIdx.z / ns, c0 = blockIdx.z % ns * MAXD;
  const int w = min(MAXD, D - c0), kh = h / (HQ / KH);
  const int i0 = blockIdx.x * WARPS, i = i0 + warp;
  const bool row = i < S;
  const int lim = causal ? i + Sk - S : Sk - 1;
  const size_t off = ((size_t)(b * S + min(i, S - 1)) * HQ + h) * D;
  float L = INFINITY, Dl = 0.f;
  if (row) {
    L = lse[((size_t)b * HQ + h) * S + i];
    Dl = delta[((size_t)b * HQ + h) * S + i];
  }
  float acc[EPL];
#pragma unroll
  for (int t = 0; t < EPL; ++t) acc[t] = 0.f;
  const int kend = key_end(i0, S, Sk, causal);
  for (int k0 = 0; k0 < kend; k0 += TILE) {
    float s[TILE], dp[TILE];
    sliced_dots(q + off, row, scale, k, b, Sk, KH, kh, D, k0, 1.f, buf, s);
    sliced_dots(dout + off, row, 1.f, v, b, Sk, KH, kh, D, k0, 1.f, buf,
                dp);
    __syncthreads();
    load_cols(buf, k, b, Sk, KH, kh, D, c0, w, k0, 1.f);
    __syncthreads();
    if (!row) continue;
    for (int j = 0; j < TILE; ++j) {
      const int kj = k0 + j;
      if (kj >= Sk || kj > lim) break;
      const float ds = expf(s[j] - L) * (dp[j] - Dl);
#pragma unroll
      for (int t = 0; t < EPL; ++t) {
        const int e = lane + 32 * t;
        if (e < w) acc[t] = fmaf(ds, buf[j][e], acc[t]);
      }
    }
  }
  if (!row) return;
  T* o = dq + ((size_t)(b * S + i) * HQ + h) * D + c0;
#pragma unroll
  for (int t = 0; t < EPL; ++t) {
    const int e = lane + 32 * t;
    if (e < w) st(o + e, acc[t] * scale);
  }
}

// One slice of dk and dv: dk_j[c] = sum_i ds_ij (scale q_i[c]), dv_j[c] =
// sum_i p_ij do_i[c] over the query rows of every head in key j's group
// that see it.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_wide_dkdv_slice(const T* q, const T* k, const T* v, const T* dout,
                      const float* lse, const float* delta, T* dk, T* dv,
                      int S, int Sk, int HQ, int KH, int D, int causal,
                      float scale) {
  __shared__ float qs[TILE][MAXD];
  __shared__ float dos[TILE][MAXD];
  __shared__ float Ls[TILE], Ds[TILE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ns = n_slices(D);
  const int kh = blockIdx.y, b = blockIdx.z / ns, c0 = blockIdx.z % ns * MAXD;
  const int w = min(MAXD, D - c0), G = HQ / KH;
  const int j0 = blockIdx.x * WARPS, j = j0 + warp;
  const bool row = j < Sk;
  const int shift = Sk - S;
  const size_t off = ((size_t)(b * Sk + min(j, Sk - 1)) * KH + kh) * D;
  float gk[EPL], gv[EPL];
#pragma unroll
  for (int t = 0; t < EPL; ++t) gk[t] = gv[t] = 0.f;
  const int ibeg = causal ? max(0, j0 - shift) : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int r0 = ibeg - ibeg % TILE; r0 < S; r0 += TILE) {
      float s[TILE], dp[TILE];
      sliced_dots(k + off, row, 1.f, q, b, S, HQ, h, D, r0, scale, qs, s);
      sliced_dots(v + off, row, 1.f, dout, b, S, HQ, h, D, r0, 1.f, dos,
                  dp);
      __syncthreads();
      load_cols(qs, q, b, S, HQ, h, D, c0, w, r0, scale);
      load_cols(dos, dout, b, S, HQ, h, D, c0, w, r0, 1.f);
      if (threadIdx.x < TILE) {
        const int r = r0 + threadIdx.x;
        const size_t at = ((size_t)b * HQ + h) * S + r;
        Ls[threadIdx.x] = r < S ? lse[at] : INFINITY;
        Ds[threadIdx.x] = r < S ? delta[at] : 0.f;
      }
      __syncthreads();
      if (!row) continue;
      for (int x = 0; x < TILE; ++x) {
        const int i = r0 + x;
        if (i >= S || (causal && j > i + shift)) continue;
        const float p = expf(s[x] - Ls[x]);
        const float ds = p * (dp[x] - Ds[x]);
#pragma unroll
        for (int t = 0; t < EPL; ++t) {
          const int e = lane + 32 * t;
          if (e < w) {
            gv[t] = fmaf(p, dos[x][e], gv[t]);
            gk[t] = fmaf(ds, qs[x][e], gk[t]);
          }
        }
      }
    }
  }
  if (!row) return;
  const size_t out = ((size_t)(b * Sk + j) * KH + kh) * D + c0;
#pragma unroll
  for (int t = 0; t < EPL; ++t) {
    const int e = lane + 32 * t;
    if (e < w) {
      st(dk + out + e, gk[t]);
      st(dv + out + e, gv[t]);
    }
  }
}

bool bad_shape(int B, int HQ, int KH, int S, int Sk, int D) {
  return B < 1 || KH < 1 || HQ % KH || S < 1 || Sk < 1 || D < 1 ||
         HQ > 65535 || KH > 65535 || (long long)B * n_slices(D) > 65535;
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse,
        int B, int HQ, int KH, int S, int Sk, int D, int causal,
        float scale, cudaStream_t cs) {
  dim3 grid((S + WARPS - 1) / WARPS, HQ, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (D <= MAXD) {
    flash_wide_fwd<T><<<grid, WARPS * 32, 0, cs>>>(
        qt, kt, vt, static_cast<T*>(out), lse, S, Sk, HQ, KH, D, causal,
        scale);
    return (int)cudaGetLastError();
  }
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  flash_wide_fwd_lse<T><<<grid, WARPS * 32, 0, cs>>>(qt, kt, lse, S, Sk, HQ,
                                                     KH, D, causal, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 slices((S + WARPS - 1) / WARPS, HQ, B * n_slices(D));
  flash_wide_fwd_slice<T><<<slices, WARPS * 32, 0, cs>>>(
      qt, kt, vt, static_cast<T*>(out), lse, S, Sk, HQ, KH, D, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const void* dout, void* dq, void* dk, void* dv, const float* lse,
        float* delta, int B, int HQ, int KH, int S, int Sk, int D,
        int causal, float scale, cudaStream_t cs) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  dim3 rows((S + WARPS - 1) / WARPS, HQ, B);
  flash_wide_delta<T><<<rows, WARPS * 32, 0, cs>>>(
      static_cast<const T*>(o), dt, delta, S, HQ, D);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (D > MAXD) {
    dim3 qsl((S + WARPS - 1) / WARPS, HQ, B * n_slices(D));
    flash_wide_dq_slice<T><<<qsl, WARPS * 32, 0, cs>>>(
        qt, kt, vt, dt, lse, delta, static_cast<T*>(dq), S, Sk, HQ, KH, D,
        causal, scale);
    err = (int)cudaGetLastError();
    if (err) return err;
    dim3 ksl((Sk + WARPS - 1) / WARPS, KH, B * n_slices(D));
    flash_wide_dkdv_slice<T><<<ksl, WARPS * 32, 0, cs>>>(
        qt, kt, vt, dt, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), S, Sk, HQ, KH, D, causal, scale);
    return (int)cudaGetLastError();
  }
  flash_wide_dq<T><<<rows, WARPS * 32, 0, cs>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dq), S, Sk, HQ, KH, D,
      causal, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  dim3 keys((Sk + WARPS - 1) / WARPS, KH, B);
  flash_wide_dkdv<T><<<keys, WARPS * 32, 0, cs>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, Sk, HQ, KH, D, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The forward: out (and L where lse is not null); bf16 selects bfloat16
// operands, else float32.  Up to MAXD one launch; above it two (L, then
// the output's slices), and lse must not be null.  Returns a CUDA error
// code (0: launched).
extern "C" int flash_wide_launch(const void* q, const void* k, const void* v,
                                 void* out, float* lse, int B, int HQ,
                                 int KH, int S, int Sk, int D, int causal,
                                 int bf16, float scale, void* stream) {
  if (bad_shape(B, HQ, KH, S, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fwd<__nv_bfloat16>(q, k, v, out, lse, B, HQ, KH, S, Sk, D, causal,
                              scale, cs);
  return fwd<float>(q, k, v, out, lse, B, HQ, KH, S, Sk, D, causal, scale,
                    cs);
}

// The backward from the forward's L: Delta (scratch, (B, HQ, S) float32),
// then dq, then dk and dv (above MAXD, slice by slice).  Three launches.
extern "C" int flash_wide_bwd_launch(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, void* dq, void* dk,
                                     void* dv, const float* lse,
                                     float* delta, int B, int HQ, int KH,
                                     int S, int Sk, int D, int causal,
                                     int bf16, float scale, void* stream) {
  if (bad_shape(B, HQ, KH, S, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bwd<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta, B,
                              HQ, KH, S, Sk, D, causal, scale, cs);
  return bwd<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, HQ, KH, S,
                    Sk, D, causal, scale, cs);
}
