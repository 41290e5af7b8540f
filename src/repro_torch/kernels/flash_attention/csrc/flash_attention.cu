// flash_attention: causal or non-causal GQA prefill attention on Hopper
// (sm_90a) in float32, with an online softmax in float32.  bfloat16
// operands go to the tensor-core kernel beside this one (flash_wgmma.cu);
// float32 stays here because wgmma has no float32 operand, and TF32 would
// round q and k to 10 mantissa bits, far outside the 1e-5 float32 check
// (this kernel beats PyTorch's float32 attention call at Llama's S 4096).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas (body _flash_kernel), the TPU kernel behind the LM
// substrate's prefill (models/attention.py attn_prefill).  It computes the
// same function; it is not a block by block copy.
//
// Computes, for each batch b, query head h and query row i:
//   out[b, i, h] = softmax_j(q[b, i, h] / sqrt(D) . k[b, j, h / group])
//                  @ v[b, j, h / group]
// over the keys j the row sees: all Sk of them, or with `causal` the keys
// j <= i + (Sk - S) (the diagonal aligned bottom-right, the reference
// oracles' mask; at S = Sk it is the TPU kernel's q_pos >= k_pos).  q is
// scaled before the product, as the TPU kernel does; m, l and acc are kept
// per query row in float32; l is clamped at 1e-30 before the division, so
// a row that sees no key gives zeros.  Query head h reads kv head
// h / group in place: no KV copy.
//
// Operands: q and out are (B, S, HQ, D) and k, v are (B, Sk, KH, D), each
// read through its own strides with a contiguous last dim (the model's
// native layout needs no transpose).  Any S and Sk: ragged tiles are
// zero-filled and their positions masked.  D is a multiple of 4, at most
// 128.
//
// What bounds it on this card: two matrix products per tile, 4 * S * Sk * D
// operations per head (half of them with `causal`), against a few bytes per
// score.  In float32 the products run as FMAs on the CUDA cores (67
// TFLOP/s at best), an order of magnitude above the bf16 tensor-core bound
// the time is measured against.
//
// What the design does: one block of 128 threads per (64 query rows, batch
// x query head), heaviest causal tiles launched first.  The Q tile (scaled,
// transposed), one K tile (transposed) and one V tile of 64 keys, and the
// 64 x 64 score tile live in float32 shared memory (112.5 KB at D = 128,
// opted in above 48 KB with cudaFuncSetAttribute).  Each thread computes a
// 4 x 8 score micro-tile and a 4 x 16 output micro-tile from float4 reads
// of shared memory.  Two threads per row take the tile's row max and sum;
// masked scores are -inf and get zero weight.  K tiles above the causal
// diagonal are not visited.  Every sum runs in a fixed order and nothing is
// atomic, so two calls are bitwise equal.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}

template <int DP>
constexpr size_t smem_floats() {
  return (size_t)DP * BQ      // Qt [DP][BQ]
         + (size_t)DP * BK    // Kt [DP][BK]
         + (size_t)BK * DP    // Vs [BK][DP]
         + (size_t)BK * BQ    // Pt [BK][BQ]: scores, then weights
         + 2 * BQ;            // alpha, l per row
}

// grid (ceil(S / BQ), B * HQ); DP = D rounded up to 64 or 128.
template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int HQ,
             int KH, int S, int Sk, int D, long long qsb, long long qss,
             long long qsh, long long ksb, long long kss, long long ksh,
             long long vsb, long long vss, long long vsh, long long osb,
             long long oss, long long osh, int causal, float scale) {
  constexpr int NJ = DP / 32;  // output float4 columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;
  float* Kt = Qt + DP * BQ;
  float* Vs = Kt + DP * BK;
  float* Pt = Vs + BK * DP;
  float* alpha_s = Pt + BK * BQ;
  float* l_s = alpha_s + BQ;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / HQ;
  const int h = blockIdx.y % HQ;
  const int hk = h / (HQ / KH);
  const int q0 = qt * BQ;
  const int off = Sk - S;  // bottom-right alignment of the diagonal
  const int t = threadIdx.x;
  const int tx = t % 8;    // micro-tile columns tx*4 + 32*j
  const int ty = t / 8;    // micro-tile rows ty*4 .. ty*4+3

  const float* qb = q + (size_t)b * qsb + (size_t)h * qsh;
  const float* kb = k + (size_t)b * ksb + (size_t)hk * ksh;
  const float* vb = v + (size_t)b * vsb + (size_t)hk * vsh;

  // Q tile, scaled and transposed: Qt[d][r]; lanes walk rows
  for (int e = t; e < BQ * (DP / 4); e += THREADS) {
    const int r = e % BQ;
    const int d = (e / BQ) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < S && d < D) load4(qb + (size_t)(q0 + r) * qss + d, f);
#pragma unroll
    for (int i = 0; i < 4; ++i) Qt[(d + i) * BQ + r] = f[i] * scale;
  }

  int k_end = Sk;
  if (causal) k_end = min(Sk, min(q0 + BQ, S) - 1 + off + 1);
  const int n_kt = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  float m_r = NEG_INF, l_r = 0.f;  // row t / 2, kept by both of its threads
  float acc[4][NJ * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ * 4; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    // K tile transposed: Kt[d][c]; lanes walk keys
    for (int e = t; e < BK * (DP / 4); e += THREADS) {
      const int c = e % BK;
      const int d = (e / BK) * 4;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + c < Sk && d < D)
        load4(kb + (size_t)(k0 + c) * kss + d, f);
#pragma unroll
      for (int i = 0; i < 4; ++i) Kt[(d + i) * BK + c] = f[i];
    }
    // V tile as it is: Vs[c][d]; lanes walk d
    for (int e = t; e < BK * (DP / 4); e += THREADS) {
      const int d = (e % (DP / 4)) * 4;
      const int c = e / (DP / 4);
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + c < Sk && d < D)
        load4(vb + (size_t)(k0 + c) * vss + d, f);
      *reinterpret_cast<float4*>(Vs + c * DP + d) =
          make_float4(f[0], f[1], f[2], f[3]);
    }
    __syncthreads();

    // scores: rows ty*4+i, columns tx*4 + 32*(j/4) + j%4
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * BQ + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Kt + d * BK + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Kt + d * BK + 32 + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = tx * 4 + (j / 4) * 32 + (j % 4);
      const int c = k0 + cl;
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty * 4 + i;
        const bool ok = c < Sk && (!causal || c <= r + off);
        w[i] = ok ? s[i][j] : -INFINITY;
      }
      *reinterpret_cast<float4*>(Pt + cl * BQ + ty * 4) =
          make_float4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();

    // online softmax: two threads per row, 32 columns each
    {
      const int row = t >> 1;
      const int c0 = (t & 1) * 32;
      float tmax = NEG_INF;
      for (int c = c0; c < c0 + 32; ++c) tmax = fmaxf(tmax, Pt[c * BQ + row]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_new = fmaxf(m_r, tmax);
      float sum = 0.f;
      for (int c = c0; c < c0 + 32; ++c) {
        const float p = expf(Pt[c * BQ + row] - m_new);  // -inf -> 0
        Pt[c * BQ + row] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = expf(m_r - m_new);
      l_r = l_r * alpha + sum;
      m_r = m_new;
      if ((t & 1) == 0) alpha_s[row] = alpha;
    }
    __syncthreads();

    // acc = alpha * acc + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ * 4; ++j) acc[i][j] *= a;
    }
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + c * BQ + ty * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 x =
            *reinterpret_cast<const float4*>(Vs + c * DP + j * 32 + tx * 4);
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j * 4 + e] = fmaf(pv[i], xv[e], acc[i][j * 4 + e]);
      }
    }
  }

  if ((t & 1) == 0) l_s[t >> 1] = l_r;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float l = fmaxf(l_s[ty * 4 + i], 1e-30f);
    float* o = out + (size_t)b * osb + (size_t)r * oss + (size_t)h * osh;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = j * 32 + tx * 4 + e;
        if (d < D) o[d] = acc[i][j * 4 + e] / l;
      }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int HQ, int KH, int S, int Sk, int D, const long long* st,
           int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<DP>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * HQ);
  flash_kernel<DP><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, HQ, KH, S, Sk, D, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (or the error of
// cudaFuncSetAttribute), cudaErrorInvalidValue for D > 128.  `strides`
// holds 12 element strides: q (b, s, h), k (b, s, h), v (b, s, h), out
// (b, s, h); the last dim of each is contiguous.  The wrapper checks
// shapes, strides and alignment, allocates `out`, and never calls this
// with B, S or HQ equal to 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int HQ,
                                      int KH, int S, int Sk, int D,
                                      const long long* strides, int causal,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  if (D <= 64)
    return launch<64>(qf, kf, vf, of, B, HQ, KH, S, Sk, D, strides, causal,
                      scale, st);
  if (D <= 128)
    return launch<128>(qf, kf, vf, of, B, HQ, KH, S, Sk, D, strides, causal,
                       scale, st);
  return (int)cudaErrorInvalidValue;
}
