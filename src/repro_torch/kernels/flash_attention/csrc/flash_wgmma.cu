// flash_wgmma: causal or non-causal GQA prefill attention in bfloat16 on
// Hopper (sm_90a), both products on the tensor cores (wgmma), K and V
// tiles streamed by the Tensor Memory Accelerator (TMA) through a ring of
// shared-memory stages.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas (body _flash_kernel), for bfloat16 operands: the
// TPU kernel behind the LM substrate's prefill (models/attention.py
// attn_prefill).  float32 operands go to the 3xTF32 kernel beside this one
// (flash_tf32x3.cu): one TF32 product would round q and k to 10 mantissa
// bits, far outside the 1e-5 float32 check.
//
// Computes, for each batch b, query head h and query row i:
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / group] / sqrt(D))
//                  @ v[b, j, h / group]
// over the keys j the row sees: all Sk of them, or with `causal` the keys
// j <= i + (Sk - S) (the diagonal aligned bottom-right, the reference
// oracles' mask).  The scores are accumulated in float32 from the bf16
// operands (each bf16 x bf16 product is exact in float32) and scaled in
// float32, so only the order of summation differs from the plain version.
// m, l and the output accumulator are float32 per query row; l is clamped
// at 1e-30 before the division, so a row that sees no key gives zeros.
// Given a log-sum-exp buffer (the training forward, for the backward
// flash_bwd.cu), each row's L = m scale + ln l is written there too,
// float32 (B, HQ, S), +inf for a row that sees no key; the output does not
// depend on whether it is written.
// The weights P go into the second product as two bf16 halves, hi =
// bf16(p) and lo = bf16(p - hi), about 16 bits of p, in two products: the
// plain version keeps P in float32.  P rounded once to bf16 (FlashAttention-
// 3's choice) kept each call within the op's limit of 2^-6 * max|out|, but
// on an H100 it moved Llama-3.2-3B's int8 serve-path logits from 2.9e-2 to
// 4.6e-2 of max|logit| of the plain replay, against a limit of 5e-2; the
// second half costs half again the tensor-core operations.
//
// Operands: q and out are (B, S, HQ, D), k and v (B, Sk, KH, D).  q, k and
// v are read in place through TMA tensor maps made for each call from the
// operands' own strides (the wrapper checks that every stride and base is
// a multiple of 16 bytes); query head h reads kv head h / group through
// the TMA coordinate, with no copy.  out is contiguous.  Any S and Sk: TMA
// zero-fills rows past the end, keys >= Sk are masked and only rows < S
// are stored.  D is a multiple of 16 up to 128; it is padded in shared
// memory to DP = 64 or 128 (TMA zero-fills the columns >= D).
//
// What bounds it on this card: 4 * S * Sk * D operations per head (half
// of them with `causal`) against a few bytes per score, so the bf16
// tensor-core rate (989 TFLOP/s dense) at every prompt length the models
// use.
//
// What the design does about it: one block of 384 threads per (128 query
// rows, batch x query head), heaviest causal tiles launched first.  Warp-
// group 2 is the producer: one thread loads the Q tile once and then keeps
// the K and V tiles of 128 keys in flight by TMA (128-byte swizzle)
// through a ring of two stages, with full barriers (one for K and one for
// V per stage, completed by the TMA transaction count) and empty barriers
// (one arrival per consumer warpgroup); setmaxnreg gives its registers to
// the consumers.  Warpgroups 0 and 1 take 64 query rows each: S = Q K^T is
// wgmma with both operands in shared memory (K's rows are already K-major,
// D contiguous, so there is no transpose); the online softmax runs on the
// score fragments in float32 (a quad of lanes shares a row); P is
// converted from the score fragment to bf16 A-operand registers in place
// (hi and lo halves); O += P V is wgmma with V read from shared memory
// through the descriptor's transpose bit, so V is never copied.  K tiles
// above the causal diagonal are not loaded, tiles below it are not
// masked.  Every sum runs in a fixed order and nothing is atomic, so two
// calls are bitwise equal.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;       // query rows per block (two warpgroups of 64)
constexpr int BK = 128;       // keys per K/V tile
constexpr int STAGES = 2;     // K/V ring depth
constexpr int THREADS = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int ROW_BYTES = 128;  // one 64-column bf16 swizzle atom row
constexpr float NEG_INF = -1e30f;

// D (+)= A B: A (64 x 16) and B (16 x 128) both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int DP>
struct Smem {
  static constexpr int ATOMS = DP / 64;
  static constexpr int Q_BYTES = ATOMS * BQ * ROW_BYTES;
  static constexpr int KV_BYTES = ATOMS * BK * ROW_BYTES;  // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;  // room to align to 1024
};

// grid (ceil(S / BQ), B * HQ), THREADS threads; DP = 64 or 128
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int HQ, int KH, int S, int Sk, int D, int causal,
                   float scale_log2) {
  using L = Smem<DP>;
  constexpr int ATOMS = L::ATOMS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + L::Q_BYTES;                   // [STAGES][ATOMS][BK][64]
  uint8_t* sV = sK + STAGES * L::KV_BYTES;         // [STAGES][ATOMS][BK][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / HQ;
  const int h = blockIdx.y % HQ;
  const int hk = h / (HQ / KH);
  const int q0 = qt * BQ;
  const int off = Sk - S;  // bottom-right alignment of the diagonal
  int k_end = Sk;
  if (causal) k_end = min(Sk, min(q0 + BQ, S) + off);
  const int n_kt = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256 && n_kt > 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int a = 0; a < ATOMS; ++a)
        tma_load_4d(sQ + a * BQ * ROW_BYTES, &tq, q_full, a * 64, q0, h, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], L::KV_BYTES);
        for (int a = 0; a < ATOMS; ++a)
          tma_load_4d(sK + s * L::KV_BYTES + a * BK * ROW_BYTES, &tk,
                      &k_full[s], a * 64, j * BK, hk, b);
        mbar_expect_tx(&v_full[s], L::KV_BYTES);
        for (int a = 0; a < ATOMS; ++a)
          tma_load_4d(sV + s * L::KV_BYTES + a * BK * ROW_BYTES, &tv,
                      &v_full[s], a * 64, j * BK, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int wrow0 = q0 + wg * 64;           // this warpgroup's first row
    const int wlast = min(wrow0 + 63, S - 1);  // and last valid row
    const int r0 = wrow0 + (tid / 32) * 16 + lane / 4;  // rows r0, r0 + 8
    const int r1 = r0 + 8;
    const int cq = (lane % 4) * 2;  // fragment column within an 8-block

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this lane's
    const uint32_t q_addr = smem_u32(sQ) + wg * 64 * ROW_BYTES;

    if (n_kt > 0) mbar_wait(q_full, 0);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % STAGES;
      const int ph = (j / STAGES) & 1;
      const int k0 = j * BK;
      // the K-full wait also orders this warpgroup's empty arrivals: two
      // of them never land in one phase of the barrier
      mbar_wait(&k_full[s], ph);
      const bool skip = wrow0 >= S || (causal && k0 > wlast + off);
      if (!skip) {
        // S = Q K^T over DP / 16 steps of 16 columns
        float sc[BK / 2];
        const uint32_t k_addr = smem_u32(sK + s * L::KV_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;  // bytes into the atom
          const uint64_t da = desc_b128(
              q_addr + (kk / 4) * BQ * ROW_BYTES + col, 16, 1024);
          const uint64_t db = desc_b128(
              k_addr + (kk / 4) * BK * ROW_BYTES + col, 16, 1024);
          wgmma_ss_n128(sc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);

        // mask the ragged edge and the diagonal tile only
        const bool need_mask =
            k0 + BK > Sk || (causal && k0 + BK - 1 > wrow0 + off);
        if (need_mask) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int c = k0 + (i / 4) * 8 + cq + (i & 1);
            const int r = (i & 2) ? r1 : r0;
            if (c >= Sk || (causal && c > r + off)) sc[i] = -INFINITY;
          }
        }
        // online softmax on the fragments: a quad of lanes holds a row
        float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          if (i & 2) mx1 = fmaxf(mx1, sc[i]);
          else mx0 = fmaxf(mx0, sc[i]);
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = exp2f((m0 - mn0) * scale_log2);
        const float al1 = exp2f((m1 - mn1) * scale_log2);
        const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;
        m0 = mn0;
        m1 = mn1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          if (i & 2) {
            sc[i] = exp2f(fmaf(sc[i], scale_log2, -ms1));  // -inf -> 0
            sum1 += sc[i];
          } else {
            sc[i] = exp2f(fmaf(sc[i], scale_log2, -ms0));
            sum0 += sc[i];
          }
        }
        l0 = l0 * al0 + sum0;
        l1 = l1 * al1 + sum1;
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] *= (i & 2) ? al1 : al0;
        // P as two bf16 A fragments, hi and lo: the score fragment of keys
        // 16kk..16kk+15 is the A fragment of the k-step kk, pair by pair
        uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x0 = sc[8 * kk + 2 * e], x1 = sc[8 * kk + 2 * e + 1];
            __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
            const float2 hf = __bfloat1622float2(hi);
            __nv_bfloat162 lo = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
            p_hi[kk][e] = *reinterpret_cast<uint32_t*>(&hi);
            p_lo[kk][e] = *reinterpret_cast<uint32_t*>(&lo);
          }

        // O += P V over BK / 16 steps of 16 keys; V is MN-major (D
        // contiguous): 8-key groups 1024 bytes apart, 64-column atoms
        // BK * 128 bytes apart
        mbar_wait(&v_full[s], ph);
        const uint32_t v_addr = smem_u32(sV + s * L::KV_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = desc_b128(v_addr + kk * 16 * ROW_BYTES,
                                        BK * ROW_BYTES, 1024);
          if constexpr (DP == 128) {
            wgmma_rs_n128_tb(o, p_hi[kk], dv);
            wgmma_rs_n128_tb(o, p_lo[kk], dv);
          } else {
            wgmma_rs_n64_tb(o, p_hi[kk], dv);
            wgmma_rs_n64_tb(o, p_lo[kk], dv);
          }
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(o);
      }
      if (tid == 0) mbar_arrive(&empty[s]);
    }

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
      if (lse != nullptr && lane % 4 == 0) {
        const float l = half ? l1 : l0, m = half ? m1 : m0;
        lse[((size_t)b * HQ + h) * S + r] =
            l > 0.f ? (m * scale_log2 + log2f(l)) * 0.69314718055994531f
                    : INFINITY;
      }
      __nv_bfloat16* orow =
          out + (((size_t)b * S + r) * HQ + h) * (size_t)D;
#pragma unroll
      for (int n8 = 0; n8 < DP / 8; ++n8) {
        const int c = n8 * 8 + cq;
        if (c < D) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(o[n8 * 4 + half * 2] / dn,
                                    o[n8 * 4 + half * 2 + 1] / dn);
        }
      }
    }
  }
}

// a (D, S, H, B) bf16 tensor map with boxes of (64, rows, 1, 1)
int make_map(CUtensorMap* map, const void* base,
             const unsigned long long* dims,
             const unsigned long long* strides, int rows) {
  const cuuint64_t gdim[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t gstride[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base,
                          gdim, gstride, box);
}

template <int DP>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           void* out, float* lse, int B, int HQ, int KH, int S, int Sk, int D,
           int causal, float scale_log2, cudaStream_t stream) {
  const int smem = Smem<DP>::ALLOC;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * HQ);
  flash_wgmma_kernel<DP><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, HQ, KH, S, Sk, D,
      causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`.  `dims` holds the tensor-map dims (D, S, H, B) of q,
// k and v (12 values) and `strides` their byte strides of dims 1-3 (9
// values), both from the wrapper's plan (kernel.py:wgmma_plan), which
// checks dtype, shapes, strides and alignment; out is contiguous (B, S,
// HQ, D) bf16; lse is null, or (B, HQ, S) float32 for each row's L.
// Returns 0, a CUDA runtime error, cudaErrorInvalidValue for
// D > 128, ERR_NO_ENCODE or ERR_ENCODE_BASE + a CUresult.  Never called
// with B, S or HQ equal to 0.
extern "C" int flash_wgmma_launch(const void* q, const void* k, const void* v,
                                  void* out, float* lse, int B, int HQ,
                                  int KH, int S,
                                  int Sk, int D,
                                  const unsigned long long* dims,
                                  const unsigned long long* strides,
                                  int causal, float scale_log2,
                                  void* stream) {
  if (D > 128) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, dims, strides, BQ);
  if (!err) err = make_map(&tk, k, dims + 4, strides + 3, BK);
  if (!err) err = make_map(&tv, v, dims + 8, strides + 6, BK);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<64>(tq, tk, tv, out, lse, B, HQ, KH, S, Sk, D, causal,
                      scale_log2, st);
  return launch<128>(tq, tk, tv, out, lse, B, HQ, KH, S, Sk, D, causal,
                     scale_log2, st);
}
