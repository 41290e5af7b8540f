// flash_tf32x3: causal or non-causal GQA prefill attention in float32 on
// Hopper (sm_90a), both products on the tensor cores (mma.sync TF32) in
// 3xTF32, accurate to float32, with an online softmax in float32.
// bfloat16 operands go to the wgmma kernel beside this one
// (flash_wgmma.cu).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas (body _flash_kernel), for float32 operands: the
// TPU kernel behind the LM substrate's prefill (models/attention.py
// attn_prefill).  It computes the same function; it is not a block by
// block copy.
//
// Computes, for each batch b, query head h and query row i:
//   out[b, i, h] = softmax_j(q[b, i, h] / sqrt(D) . k[b, j, h / group])
//                  @ v[b, j, h / group]
// over the keys j the row sees: all Sk of them, or with `causal` the keys
// j <= i + (Sk - S) (the diagonal aligned bottom-right, the reference
// oracles' mask; at S = Sk it is the TPU kernel's q_pos >= k_pos).  q is
// scaled before the product, as the TPU kernel does; m, l and the output
// are kept per query row in float32; l is clamped at 1e-30 before the
// division, so a row that sees no key gives zeros.  Given a log-sum-exp
// buffer (the training forward, for the backward flash_bwd.cu), each row's
// L = m + ln l of its scaled scores is written there too, float32 (B, HQ,
// S), +inf for a row that sees no key; the output does not depend on
// whether it is written.  Query head h reads kv head h / group in place:
// no KV copy.
//
// Operands: q and out are (B, S, HQ, D) and k, v are (B, Sk, KH, D), each
// read through its own strides with a contiguous last dim (zamba2's q, k
// and v are views); the strides are multiples of 4 elements and the bases
// 16-byte aligned (the wrapper checks).  Any S and Sk: ragged tiles are
// zero-filled and their positions masked.  D is a multiple of 4 up to 128,
// padded in shared memory to DP, a multiple of 8, with zero columns (they
// add nothing to q kᵀ, and the output's padded columns are not stored).
//
// Precision: both products run on mma.sync.m16n8k8 TF32 as 3xTF32
// (hopper.cuh: split, mma3).  Each operand is split in registers into hi,
// x rounded to TF32 to nearest, and lo = x − hi; hi·hi, lo·hi and hi·lo go
// into separate float32 accumulators and the two small ones are added to
// the big one at the end of each key tile.  The three accumulators of P V
// start from zero at each key tile and are added to the running output on
// the CUDA cores: the tensor cores' float32 accumulation truncates, and
// with every tile chained into the output, whisper's 1500 keys left an
// error of about 1e-5 of max|out|, 5x the plain version's, at its
// encoder (PERF.md).  One TF32 product would round
// q, k and the weights to 10 mantissa bits, far outside the 1e-5 float32
// check; 3xTF32 is as accurate as float32 FMAs (ref.py:
// attention_tf32x3_model models the arithmetic on the CPU; chip_smoke.py
// phase 7 and tests/test_torch_cuda.py hold the kernel to 4x the plain
// version's float64 error).
//
// What bounds it on this card: two matrix products per key tile, 4 * S *
// Sk * D operations per head (half of them with `causal`), against a few
// bytes per score: the tensor cores.  3xTF32 does three TF32 products per
// float32 product, and mma.sync runs TF32 at about 320 TFLOP/s on an H100
// (tools/mma_rate.py; wgmma's 495 takes TF32 only K-major, and V is not),
// so the floor is 3 * ops at that rate, about 107 TFLOP/s of float32
// products, nine times the bf16 bound the time is measured against.  Each
// product also pays for the splits and fragment loads on the CUDA cores,
// and the softmax of a tile runs between its two products; this kernel
// reaches about a third of that floor (PERF.md).
//
// What the design does (FlashAttention-2's layout): one block of 4 or 8
// warps per (64 or 128 query rows, batch x query head), heaviest causal
// tiles launched first; each warp owns 16 query rows.  The scaled-on-load
// Q tile stays in shared memory; K and V tiles of BK keys (64 at DP <= 64,
// else 32) arrive through a ring of 2 or 3 cp.async stages
// (kernel.py:flash_f32_plan picks rows, BK, stages and the shared-memory
// bytes; the launcher refuses a byte count that differs from make_layout's).
// Row strides keep every fragment load free of bank conflicts: Q and K are
// read as pairs of depth columns (stride 8 mod 16 words), V by rows 2t and
// 2t + 1 (stride 4 mod 8).  The scores stay in the accumulator registers
// and the online softmax runs on them (a quad of lanes shares a row).
// The QK product pairs depth t with column 2t and t + 4 with 2t + 1, and the
// PV product pairs its depth (the keys) the same way, so the score
// accumulator of an 8-key tile is, element for element, the A fragment of
// the PV product: P never leaves the registers, and is split into hi and
// lo there.  8-key tiles a warp's rows cannot see (above the causal
// diagonal, past Sk) run no products; K tiles above the block's diagonal
// are not loaded.  Every sum runs in a fixed order and nothing is atomic,
// so two calls are bitwise equal.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

using namespace hopper;

namespace {

constexpr int MAX_THREADS = 256;
constexpr int SMEM_MAX = 232448;
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long q[3], k[3], v[3], o[3];  // b, s, h (the last dim contiguous)
};

// The shared-memory layout of one plan; kernel.py:flash_f32_plan computes
// the same byte count and the launcher refuses a plan whose count differs.
// Q at 0 (bq rows), then `stages` stages of K (bk rows) and V (bk rows).
// Row strides in floats: Q and K qs (8 mod 16), V vs (4 mod 8).
struct Layout {
  int bq, bk, dp, stages;
  int qs, vs;
  int k_off, v_off, stage_bytes, total;
};

Layout make_layout(int bq, int bk, int D, int stages) {
  Layout L;
  L.bq = bq;
  L.bk = bk;
  L.dp = (D + 7) / 8 * 8;
  L.stages = stages;
  L.qs = L.dp + (L.dp % 16 == 0 ? 8 : 0);
  L.vs = L.dp + 4;
  L.k_off = bq * L.qs * 4;
  L.v_off = bk * L.qs * 4;
  L.stage_bytes = L.v_off + bk * L.vs * 4;
  L.total = L.k_off + stages * L.stage_bytes;
  return L;
}

__device__ __forceinline__ void zero(float (&x)[4]) {
  x[0] = x[1] = x[2] = x[3] = 0.f;
}

// grid (ceil(S / bq), B * HQ), bq / 16 warps; DPI >= dp (64 or 128), BK
// the key tile.  Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16
// x 8) holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8)
// holds (t, g), (t + 4, g); C holds (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).  Both products take depth t from column (or key) 2t
// and t + 4 from 2t + 1, in both operands: the sum is the same.
template <int DPI, int BK>
__global__ void __launch_bounds__(MAX_THREADS, 1)
flash_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ lse, int HQ, int KH, int S, int Sk,
                    int D, int causal, float scale, Layout L, Strides st) {
  constexpr int NT = BK / 8;    // 8-key tiles of a key tile
  constexpr int OT = DPI / 8;   // 8-column tiles of the output, at most
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);

  const int dp = L.dp, qs = L.qs, vs = L.vs, bq = L.bq;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  // the warp index from lane 0, so that the compiler sees it (and every
  // count derived from it) as uniform across the warp
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / HQ;
  const int h = blockIdx.y % HQ;
  const int hk = h / (HQ / KH);
  const int q0 = qt * bq;
  const int off = Sk - S;  // bottom-right alignment of the diagonal
  const int chunks = dp / 4;  // 16-byte chunks of a padded row

  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* kb = k + b * st.k[0] + hk * st.k[2];
  const float* vb = v + b * st.v[0] + hk * st.v[2];

  // the Q tile, rows past S and columns past D zero-filled; it completes
  // with the first stage's group
  for (int e = tid; e < bq * chunks; e += nthreads) {
    const int r = e / chunks, c = e % chunks;
    const bool ok = q0 + r < S && 4 * c < D;
    cp_async<16>(Qs + r * qs + 4 * c,
                 ok ? qb + (long long)(q0 + r) * st.q[1] + 4 * c : qb,
                 ok ? 16 : 0);
  }
  auto issue = [&](int tile, int stage) {
    unsigned char* base = smem + L.k_off + stage * L.stage_bytes;
    float* Kd = reinterpret_cast<float*>(base);
    float* Vd = reinterpret_cast<float*>(base + L.v_off);
    const int k0 = tile * BK;
    for (int e = tid; e < BK * chunks; e += nthreads) {
      const int r = e / chunks, c = e % chunks;
      const bool ok = k0 + r < Sk && 4 * c < D;
      const long long row = k0 + r;
      cp_async<16>(Kd + r * qs + 4 * c, ok ? kb + row * st.k[1] + 4 * c : kb,
                   ok ? 16 : 0);
      cp_async<16>(Vd + r * vs + 4 * c, ok ? vb + row * st.v[1] + 4 * c : vb,
                   ok ? 16 : 0);
    }
  };

  // the keys the block sees, and those this warp's rows see
  const int q_last = min(q0 + bq, S) - 1;
  const int k_end = causal ? min(Sk, q_last + off + 1) : Sk;
  const int ntiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  const bool active = q0 + 16 * warp < S;
  const int w_last = min(q0 + 16 * warp + 15, S - 1);
  const int w_end = causal ? min(Sk, w_last + off + 1) : Sk;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;

  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) zero(o[j]);
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // stages - 1 groups ahead, empty ones past the last tile, so that the
  // wait below always leaves exactly the newer tiles' groups in flight
  for (int s = 0; s < L.stages - 1; ++s) {
    if (s < ntiles) issue(s, s);
    cp_async_commit();
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    const int nxt = tile + L.stages - 1;
    if (nxt < ntiles) issue(nxt, nxt % L.stages);
    cp_async_commit();
    if (L.stages == 3)
      cp_async_wait<2>();
    else if (L.stages == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // this tile's K and V (and Q) are in

    const int k0 = tile * BK;
    if (active && k0 < w_end) {
      const unsigned char* base =
          smem + L.k_off + (tile % L.stages) * L.stage_bytes;
      const float* Ks = reinterpret_cast<const float*>(base);
      const float* Vs = reinterpret_cast<const float*>(base + L.v_off);

      // scores (q / sqrt(D)) kᵀ of this warp's 16 rows and BK keys
      float sb[NT][4], s1[NT][4], s2[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        zero(sb[j]);
        zero(s1[j]);
        zero(s2[j]);
      }
      const float* pa = Qs + (16 * warp + g) * qs + 2 * t;
      const float* pk = Ks + g * qs + 2 * t;
#pragma unroll 2
      for (int kk = 0; kk < dp; kk += 8) {
        const float2 u = *reinterpret_cast<const float2*>(pa + kk);
        const float2 w = *reinterpret_cast<const float2*>(pa + kk + 8 * qs);
        const float x[4] = {u.x * scale, w.x * scale, u.y * scale,
                            w.y * scale};
        Frag<4> fa;
        split<false>(x, fa);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 zz =
              *reinterpret_cast<const float2*>(pk + 8 * j * qs + kk);
          const float z[2] = {zz.x, zz.y};
          Frag<2> fb;
          split<false>(z, fb);
          mma3<false, false>(k0 + 8 * j < w_end, sb[j], s1[j], s2[j], fa,
                             fb);
        }
      }

      // masked scores and the online softmax over this tile
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + 8 * j + 2 * t + (e & 1);
          const int r = e < 2 ? r0 : r1;
          const bool ok = c < Sk && (!causal || c <= r + off);
          const float val = sb[j][e] + (s1[j][e] + s2[j][e]);
          sb[j][e] = ok ? val : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(sb[j][0], sb[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sb[j][2], sb[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // the weights, re-laid as the A fragments of P V and split
      Frag<4> pf[NT];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float p0 = expf(sb[j][0] - mn0);  // -inf -> 0
        const float p1 = expf(sb[j][1] - mn0);
        const float p2 = expf(sb[j][2] - mn1);
        const float p3 = expf(sb[j][3] - mn1);
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        const float x[4] = {p0, p2, p1, p3};
        split<false>(x, pf[j]);
      }
      l0 = l0 * a0 + sum0;  // this lane's share of the row sums
      l1 = l1 * a1 + sum1;

      // o = alpha o + P V, one 8-column tile of the output at a time.  The
      // tile's P V is summed in fresh accumulators and added to o on the
      // CUDA cores: the tensor cores' float32 accumulation truncates, so
      // chaining every key tile's products into o would carry a one-signed
      // error that grows with Sk (about 1e-5 of max|out| at whisper's 1500
      // keys); a tile's 8 chained products carry little of it
      const float* pv = Vs + 2 * t * vs + g;
#pragma unroll
      for (int jn = 0; jn < OT; ++jn) {
        if (8 * jn < dp) {
          float c0[4], c1[4], c2[4];
          zero(c0);
          zero(c1);
          zero(c2);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float z[2] = {pv[8 * j * vs + 8 * jn],
                                pv[(8 * j + 1) * vs + 8 * jn]};
            Frag<2> fb;
            split<false>(z, fb);
            mma3<false, false>(k0 + 8 * j < w_end, c0, c1, c2, pf[j], fb);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[jn][e] = o[jn][e] * (e < 2 ? a0 : a1)
                       + (c0[e] + (c1[e] + c2[e]));
        }
      }
    }
    __syncthreads();  // every read of this stage is done before its refill
  }
  cp_async_wait<0>();
  if (!active) return;

  // the row sums over the quad, in a fixed order, then the store
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= S) continue;
    const float dn = half ? d1 : d0;
    if (lse != nullptr && t == 0) {
      const float l = half ? l1 : l0;
      lse[(long long)blockIdx.y * S + r] =
          l > 0.f ? (half ? m1 : m0) + logf(l) : INFINITY;
    }
    float* orow = out + b * st.o[0] + (long long)r * st.o[1] + h * st.o[2];
#pragma unroll
    for (int jn = 0; jn < OT; ++jn) {
      const int c = 8 * jn + 2 * t;
      if (c < D)
        *reinterpret_cast<float2*>(orow + c) = make_float2(
            o[jn][2 * half] / dn, o[jn][2 * half + 1] / dn);
    }
  }
}

template <int DPI, int BK>
int launch(const float* q, const float* k, const float* v, float* out,
           float* lse, int B, int HQ, int KH, int S, int Sk, int D, int causal,
           float scale, const Layout& L, const Strides& st,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_tf32x3_kernel<DPI, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + L.bq - 1) / L.bq, B * HQ);
  flash_tf32x3_kernel<DPI, BK><<<grid, L.bq * 2, L.total, stream>>>(
      q, k, v, out, lse, HQ, KH, S, Sk, D, causal, scale, L, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (or the error of
// cudaFuncSetAttribute), or cudaErrorInvalidValue for D not a multiple of
// 4 in 4..128, rows per block `bq` not 64 or 128, a key tile `bk` that is
// not the instance's (64 at D <= 64, else 32), `stages` not 1..3, or
// `smem` that is not this plan's shared-memory byte count
// (kernel.py:flash_f32_plan) or is over 232,448.  `strides` holds 12
// element strides: q (b, s, h), k (b, s, h), v (b, s, h), out (b, s, h);
// the last dim of each is contiguous.  lse is null, or (B, HQ, S) float32
// for each row's L.  The wrapper checks shapes, strides and alignment,
// allocates `out`, and never calls this with B, S or HQ equal to 0.
extern "C" int flash_tf32x3_launch(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int B, int HQ, int KH, int S, int Sk,
                                   int D,
                                   const long long* strides, int causal,
                                   float scale, int bq, int bk, int stages,
                                   int smem, void* stream) {
  if (D < 4 || D > 128 || D % 4 || (bq != 64 && bq != 128) || stages < 1 ||
      stages > 3)
    return (int)cudaErrorInvalidValue;
  const int dp = (D + 7) / 8 * 8;
  if (bk != (dp <= 64 ? 64 : 32)) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(bq, bk, D, stages);
  if (L.total != smem || L.total > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  if (dp <= 64)
    return launch<64, 64>(qf, kf, vf, of, lse, B, HQ, KH, S, Sk, D, causal,
                          scale, L, st, cs);
  return launch<128, 32>(qf, kf, vf, of, lse, B, HQ, KH, S, Sk, D, causal,
                         scale, L, st, cs);
}
