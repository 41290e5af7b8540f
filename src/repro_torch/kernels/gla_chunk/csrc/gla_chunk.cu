// gla_chunk: the chunked gated-linear-attention scan (Mamba2's SSD, mLSTM)
// on Hopper (sm_90a), float32 math with q and k in float32 or bfloat16.
//
// Replaces: src/repro/kernels/gla_chunk/kernel.py, gla_chunk_pallas (body
// _gla_kernel), the TPU kernel of the chunked scan behind Mamba2's prefill
// (models/ssm.py chunked_gla).  It computes the same function; it is not a
// block by block copy.
//
// Computes, for each batch b and head h, over the S steps in order:
//   h_t = exp(la_t) h_{t-1} + k_t v_tᵀ,   y_t = q_t · h_t,   h_{-1} = h0
// chunk by chunk, T steps at a time (L the within-tile cumsum of la, L_tot
// its last entry):
//   y = (q kᵀ ⊙ exp(L_i − L_j) ⊙ causal) v + exp(L_i) (q h)
//   h ← exp(L_tot) h + (k ⊙ exp(L_tot − L))ᵀ v
// The scan gives the same y and h for any tile length T, up to rounding, so
// the caller's chunk Q is walked in tiles of min(Q, 64) rows; a last tile
// shorter than T (S not a multiple of T) is zero-filled, which is exact:
// a zero row of k and v adds nothing to the state and la = 0 decays
// nothing.  The causal mask is applied before the exponential (above the
// diagonal L_i − L_j > 0 could overflow); below it every exponent is <= 0
// for la <= 0.
//
// Operands, each read through its own strides: q, k (B, S, H, N) float32 or
// bfloat16 (one dtype; upcast exactly), with a contiguous last dim and the
// other strides multiples of 4 elements (a head stride of 0 reads one q/k
// row for every head in place: Mamba2 broadcasts C and B over heads);
// v (B, S, H, P) and la (B, S, H) float32; h0 (B, H, N, P) float32 or
// absent (zeros).  Out: y (B, S, H, P) in float32 or bfloat16, written
// through its strides; hout (B, H, N, P) float32, contiguous.  N is a
// multiple of 4 up to 64; P is any size.
//
// What bounds it on this card: per tile and head 2T²N + 2T²P + 4TNP
// operations (the score tile, its product with v, q h and the state
// update) against (2N + P + 1) T words read and T P written: about 130
// operations per byte at T = N = P = 64, under the bf16 tensor cores'
// 295 per byte, so a tensor-core kernel would be bound by bytes.  This
// first kernel runs all four products as float32 FMAs on the CUDA cores
// (67 TFLOP/s at best), so it sits an order of magnitude or more above
// that bound: wgmma, TMA and a prefetch of the next tile are for a later
// kernel.
//
// What the design does: the TPU kernel keeps h in VMEM across an ordered
// grid axis of chunks.  Here one block of 128 threads owns one (batch,
// head) pair and a 32-column slice of P, and walks the tiles itself in
// order, keeping its 64 x 32 slice of h in registers (mirrored in shared
// memory for the q h product).  Each column of y and h depends only on the
// same column of v and h, so cutting P across blocks is exact, and it
// gives twice the blocks of a B = 1 prefill's 64 heads on 132 SMs; each
// slice recomputes the score tile.  q and k (transposed, for the score
// tile), k again row by row with a padded stride (for the state update),
// the v slice, the weighted score tile (transposed) and h live in float32
// shared memory: 83.7 KB, over the 48 KB default, so the launcher opts in
// with cudaFuncSetAttribute.  Each thread computes a 4 x 8 score
// micro-tile and 4 x 4 micro-tiles of y and h from float4 reads of shared
// memory.  The cumsum of la is a fixed-order warp scan; every other sum
// runs in a fixed order and nothing is atomic, so two calls are bitwise
// equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TM = 64;        // rows of a tile, at most
constexpr int NP = 64;        // N, padded
constexpr int PB = 32;        // columns of P per block
constexpr int KNS = NP + 4;   // row stride of Kn: conflict-free float4 rows

constexpr size_t SMEM_FLOATS = (size_t)NP * TM     // Qt [n][r]
                               + (size_t)NP * TM   // Kt [n][r]
                               + (size_t)TM * KNS  // Kn [r][n]
                               + (size_t)TM * PB   // Vs [r][c]
                               + (size_t)TM * TM   // Wt [j][i]
                               + (size_t)NP * PB   // Hs [n][c]
                               + 3 * TM + 4;       // L, exp(L), exp(Ltot-L)

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static void load4(const float* p, float (&f)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
  __device__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  __device__ static void load4(const __nv_bfloat16* p, float (&f)[4]) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

struct Strides {
  long long q[3], k[3];   // b, s, h (n contiguous)
  long long v[4];         // b, s, h, p
  long long la[3];        // b, s, h
  long long h0[4];        // b, h, n, p
  long long y[4];         // b, s, h, p
};

// grid (B * H, ceil(P / PB)); T in 1..TM.
template <typename TQ, typename TY>
__global__ void __launch_bounds__(THREADS)
gla_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ la,
           const float* __restrict__ h0, TY* __restrict__ y,
           float* __restrict__ hout, int H, int S, int N, int P, int T,
           Strides st) {
  extern __shared__ float smem[];
  float* Qt = smem;
  float* Kt = Qt + NP * TM;
  float* Kn = Kt + NP * TM;
  float* Vs = Kn + TM * KNS;
  float* Wt = Vs + TM * PB;
  float* Hs = Wt + TM * TM;
  float* Ls = Hs + NP * PB;
  float* eL = Ls + TM;
  float* eK = eL + TM;
  float* eTot = eK + TM;

  const int b = blockIdx.x / H;
  const int hd = blockIdx.x % H;
  const int p0 = blockIdx.y * PB;
  const int t = threadIdx.x;
  const int tx = t % 8;   // columns tx*4 .. tx*4+3 (and +32 for scores)
  const int ty = t / 8;   // rows ty*4 .. ty*4+3

  const TQ* qb = q + b * st.q[0] + hd * st.q[2];
  const TQ* kb = k + b * st.k[0] + hd * st.k[2];
  const float* vb = v + b * st.v[0] + hd * st.v[2];
  const float* lb = la + b * st.la[0] + hd * st.la[2];
  TY* yb = y + b * st.y[0] + hd * st.y[2];

  // this thread's 4 x 4 piece of h: rows ty*4+i, columns p0 + tx*4+e
  float hr[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = ty * 4 + i, p = p0 + tx * 4 + e;
      hr[i][e] = (h0 != nullptr && n < N && p < P)
                     ? h0[b * st.h0[0] + hd * st.h0[1] + n * st.h0[2] +
                          p * st.h0[3]]
                     : 0.f;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(Hs + (ty * 4 + i) * PB + tx * 4) =
        make_float4(hr[i][0], hr[i][1], hr[i][2], hr[i][3]);

  for (int s0 = 0; s0 < S; s0 += T) {
    const int nrow = min(T, S - s0);
    __syncthreads();  // the previous tile's readers are done
    // q and k: Qt[n][r], Kt[n][r] (lanes walk rows), Kn[r][n]
    for (int e = t; e < TM * (NP / 4); e += THREADS) {
      const int r = e % TM;
      const int n = (e / TM) * 4;
      float fq[4] = {0.f, 0.f, 0.f, 0.f};
      float fk[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < nrow && n < N) {
        Io<TQ>::load4(qb + (s0 + r) * st.q[1] + n, fq);
        Io<TQ>::load4(kb + (s0 + r) * st.k[1] + n, fk);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        Qt[(n + i) * TM + r] = fq[i];
        Kt[(n + i) * TM + r] = fk[i];
      }
      *reinterpret_cast<float4*>(Kn + r * KNS + n) =
          make_float4(fk[0], fk[1], fk[2], fk[3]);
    }
    // this block's columns of v: Vs[r][c] (lanes walk columns)
    for (int e = t; e < TM * PB; e += THREADS) {
      const int c = e % PB;
      const int r = e / PB;
      const int p = p0 + c;
      Vs[r * PB + c] = (r < nrow && p < P)
                           ? vb[(s0 + r) * st.v[1] + p * st.v[3]]
                           : 0.f;
    }
    // L = cumsum(la) over the tile: warp 0, two rows a lane, a fixed-order
    // scan of the pair sums
    if (t < 32) {
      const int r0 = 2 * t, r1 = 2 * t + 1;
      const float a0 = r0 < nrow ? lb[(s0 + r0) * st.la[1]] : 0.f;
      const float a1 = r1 < nrow ? lb[(s0 + r1) * st.la[1]] : 0.f;
      float incl = a0 + a1;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const float o = __shfl_up_sync(0xffffffffu, incl, d);
        if (t >= d) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (t == 0) excl = 0.f;
      const float ltot = __shfl_sync(0xffffffffu, incl, 31);
      const float l0 = excl + a0;
      Ls[r0] = l0;
      Ls[r1] = incl;
      eL[r0] = expf(l0);
      eL[r1] = expf(incl);
      eK[r0] = expf(ltot - l0);
      eK[r1] = expf(ltot - incl);
      if (t == 0) eTot[0] = expf(ltot);
    }
    __syncthreads();

    // score tile, weighted and masked: Wt[j][i] = (q_i . k_j) exp(L_i - L_j)
    // for j <= i, else 0.  Rows ty*4+i, columns tx*4 + 32*(j/4) + j%4.
    {
      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 a =
            *reinterpret_cast<const float4*>(Qt + n * TM + ty * 4);
        const float4 b0 =
            *reinterpret_cast<const float4*>(Kt + n * TM + tx * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(Kt + n * TM + 32 + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx * 4 + (j / 4) * 32 + (j % 4);
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          w[i] = c <= r ? s[i][j] * expf(Ls[r] - Ls[c]) : 0.f;
        }
        *reinterpret_cast<float4*>(Wt + c * TM + ty * 4) =
            make_float4(w[0], w[1], w[2], w[3]);
      }
    }
    __syncthreads();

    // y = W v + exp(L_i) (q h): rows ty*4+i, columns tx*4+e
    {
      float acc[4][4], qh[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = qh[i][e] = 0.f;
#pragma unroll 4
      for (int j = 0; j < nrow; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(Wt + j * TM + ty * 4);
        const float4 x = *reinterpret_cast<const float4*>(Vs + j * PB + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(av[i], xv[e], acc[i][e]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 a = *reinterpret_cast<const float4*>(Qt + n * TM + ty * 4);
        const float4 x = *reinterpret_cast<const float4*>(Hs + n * PB + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) qh[i][e] = fmaf(av[i], xv[e], qh[i][e]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= nrow) continue;
        const float el = eL[r];
        TY* yr = yb + (s0 + r) * st.y[1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + tx * 4 + e;
          if (p < P)
            Io<TY>::store(yr + p * st.y[3], fmaf(el, qh[i][e], acc[i][e]));
        }
      }
    }

    // h <- exp(Ltot) h + (k exp(Ltot - L))ᵀ v: rows n = ty*4+i
    {
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) g[i][e] = 0.f;
#pragma unroll 4
      for (int j = 0; j < nrow; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(Kn + j * KNS + ty * 4);
        const float4 x = *reinterpret_cast<const float4*>(Vs + j * PB + tx * 4);
        const float ek = eK[j];
        const float av[4] = {a.x * ek, a.y * ek, a.z * ek, a.w * ek};
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) g[i][e] = fmaf(av[i], xv[e], g[i][e]);
      }
      const float et = eTot[0];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) hr[i][e] = fmaf(hr[i][e], et, g[i][e]);
    }
    __syncthreads();  // every read of the old h is done
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(Hs + (ty * 4 + i) * PB + tx * 4) =
          make_float4(hr[i][0], hr[i][1], hr[i][2], hr[i][3]);
  }

  float* ho = hout + (size_t)blockIdx.x * N * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = ty * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + tx * 4 + e;
      if (p < P) ho[(size_t)n * P + p] = hr[i][e];
    }
  }
}

template <typename TQ, typename TY>
int launch(const void* q, const void* k, const void* v, const void* la,
           const void* h0, void* y, void* hout, int B, int H, int S, int N,
           int P, int T, const Strides& st, cudaStream_t stream) {
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      gla_kernel<TQ, TY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (P + PB - 1) / PB);
  gla_kernel<TQ, TY><<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k),
      static_cast<const float*>(v), static_cast<const float*>(la),
      static_cast<const float*>(h0), static_cast<TY*>(y),
      static_cast<float*>(hout), H, S, N, P, T, st);
  return (int)cudaGetLastError();
}

template <typename TQ>
int dispatch_y(int y_dtype, const void* q, const void* k, const void* v,
               const void* la, const void* h0, void* y, void* hout, int B,
               int H, int S, int N, int P, int T, const Strides& st,
               cudaStream_t stream) {
  if (y_dtype == 0)
    return launch<TQ, float>(q, k, v, la, h0, y, hout, B, H, S, N, P, T, st,
                             stream);
  if (y_dtype == 1)
    return launch<TQ, __nv_bfloat16>(q, k, v, la, h0, y, hout, B, H, S, N, P,
                                     T, st, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (or the error of
// cudaFuncSetAttribute), cudaErrorInvalidValue for an unknown dtype code
// (0 float32, 1 bfloat16), N not a multiple of 4 in 4..64, or T outside
// 1..64.  `strides` holds 21 element strides: q (b, s, h), k (b, s, h),
// v (b, s, h, p), la (b, s, h), h0 (b, h, n, p), y (b, s, h, p).  h0 may
// be null (zeros).  The wrapper checks shapes, strides and alignment,
// allocates y and hout, and never calls this with B, H, S or P equal to 0.
extern "C" int gla_chunk_launch(const void* q, const void* k, const void* v,
                                const void* la, const void* h0, void* y,
                                void* hout, int q_dtype, int y_dtype, int B,
                                int H, int S, int N, int P, int T,
                                const long long* strides, void* stream) {
  if (N < 4 || N > NP || N % 4 || T < 1 || T > TM)
    return (int)cudaErrorInvalidValue;
  Strides st;
  const long long* s = strides;
  for (int i = 0; i < 3; ++i) st.q[i] = *s++;
  for (int i = 0; i < 3; ++i) st.k[i] = *s++;
  for (int i = 0; i < 4; ++i) st.v[i] = *s++;
  for (int i = 0; i < 3; ++i) st.la[i] = *s++;
  for (int i = 0; i < 4; ++i) st.h0[i] = *s++;
  for (int i = 0; i < 4; ++i) st.y[i] = *s++;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return dispatch_y<float>(y_dtype, q, k, v, la, h0, y, hout, B, H, S, N,
                             P, T, st, cs);
  if (q_dtype == 1)
    return dispatch_y<__nv_bfloat16>(y_dtype, q, k, v, la, h0, y, hout, B, H,
                                     S, N, P, T, st, cs);
  return (int)cudaErrorInvalidValue;
}
