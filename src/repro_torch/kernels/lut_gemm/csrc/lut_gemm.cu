// lut_gemm: C[t] = epilogue(A[t] @ W[t]^T) for int8 activations A and int8
// weights W that hold sign-extended b-bit values (b = 1, 2 or 4), computed
// by table lookup (T-MAC) instead of multiplies, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lut_gemm/kernel.py, lut_gemm_pallas (body
// _lut_kernel), the TPU kernel the task-ISA engine routes decode-shaped
// GEMM launch groups (at most 16 rows) through when the weights are packed
// sub-byte.  It computes the same function; it is not a block by block copy.
//
// Algorithm: split K into groups of g lanes.  Per activation row and group,
// the table T[p] of all 2^g subset sums (bit j of p selects lane j).  Each
// b-bit weight is sum_{t<b-1} 2^t bit_t - 2^(b-1) bit_(b-1); per bit plane
// the g weight bits of a group form a g-bit index into T.  So
//   acc[m, n] = sum_t coef_t * sum_group T[m, group, idx_t(group, n)].
// Every sum is taken in uint32, which is exact modulo 2^32: the result is
// bit-identical to the dense int32 GEMM whatever the order, so the kernel is
// deterministic (and a split of K across blocks adds up to the same bits).
//
// Entry width: from two rows up, a table word holds two rows' entries as
// lo + 65536 * hi (mod 2^32), and the lookups of one 16-byte weight vector
// are summed in that packed form, the coefficient multiplying both halves.
// The packed sum is L + 65536 * H where L and H are the two rows' dot
// products over the vector's 16 lanes: |a * w| <= 128 * 8 = 1024 per lane,
// so |L|, |H| <= 16 * 1024 = 16384 < 2^15.  So after each vector L is the
// sign-extended low half and H = (packed - L) >> 16, exactly; both are then
// added into 32-bit row sums.  ref.py:lut_gemm_table_ref models the same
// words and is held against the dense GEMM at the extremes on the CPU.
//
// Operands: A is (T, M, K) int8 row-major, W is (T, N, K) int8 row-major
// (each output channel's weights contiguous along K), out is (T, M, N):
// int32 for "none", int8 for "requant" (clip(acc >> shift, -128, 127),
// truncating arithmetic shift; 32 or more fills with the sign).  M, N and
// K are any sizes: the ragged edges are masked (zero lanes add nothing to a
// subset sum, zero weights select entry 0 = 0), so no operand is padded.
//
// What bounds it on this card: at decode shapes (M <= 16) the work is
// 2*M*N*K int8 operations over N*K weight bytes, at most 32 operations per
// byte: far below the int8 tensor-core ridge, so the bound is the bytes of
// W (and A, C) at 3.35 TB/s.
//
// What the design does about it:
//  * the weight stream: a warp reads 512 contiguous bytes of one W row per
//    K chunk, a 16-byte vector per lane, for each of its C columns (8, or
//    4 from 4 rows up); the chunk's weight and activation loads are issued
//    before the barrier that frees the previous chunk's table, so they are
//    in flight meanwhile; the activations are staged in shared memory;
//  * rows: instantiated for MT = 1, 2, 4, 8 or 16 rows (the host picks the
//    least MT >= M), so the lookups scale with M, not with 16; M > 16 runs
//    passes of 16 rows;
//  * the table of a 512-lane chunk, built by all threads, is laid out so
//    that one ld.shared (.v4 from 8 rows up) returns up to eight rows of one
//    (group, pattern), and the lanes of one shared-memory wavefront land in
//    distinct banks whatever patterns their weights select: the lane's
//    vector index is the fastest-moving part of the address;
//  * a short K (at most 256) spreads each warp's columns over its lanes
//    (`vw` below) instead of leaving most lanes idle;
//  * the split of K: when the column blocks would leave SMs idle (N 192, N
//    3072), the host splits the chunks across blocks; each block writes its
//    uint32 partial sums to a scratch buffer, and the last block of a column
//    block to finish (a ticket counter, reset to 0 by that block) adds the
//    partials and runs the epilogue.  One kernel launch per call either way;
//  * every instance is held to two blocks per SM (128 registers): the
//    lookups are latency-bound, and at 16 rows the smaller register budget
//    (a few bytes spilled) measured faster than one block per SM.
// What bounds it in practice is the lookups, not the weight stream: at 16
// rows the shared-memory bandwidth (two 16-byte loads, eight rows each,
// per group, plane and column), at 1 row the index arithmetic of each.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // eight warps
constexpr int WARPS = THREADS / 32;
constexpr int KC = 512;       // K lanes per chunk: one 16-byte vector a lane

enum { EPI_NONE = 0, EPI_REQUANT = 1 };

__device__ __forceinline__ int epilogue_value(uint32_t s, int epilogue,
                                              int shift) {
  const int v = (int)s;
  if (epilogue == EPI_NONE) return v;
  int q = shift >= 32 ? (v < 0 ? -1 : 0) : (v >> shift);
  return q < -128 ? -128 : (q > 127 ? 127 : q);
}

__device__ __forceinline__ void store_out(void* out, size_t o, uint32_t s,
                                          int epilogue, int shift) {
  const int v = epilogue_value(s, epilogue, shift);
  if (epilogue == EPI_NONE)
    static_cast<int32_t*>(out)[o] = v;
  else
    static_cast<int8_t*>(out)[o] = (int8_t)v;
}

// the G-bit index of bit plane t of the G weight bytes in `w` (lane j in
// byte j): (x * 0x01020408) >> 24 gathers bit 0 of four bytes
template <int G>
__device__ __forceinline__ uint32_t plane_index(uint32_t lo, uint32_t hi,
                                                int t) {
  if constexpr (G == 2) {
    const uint32_t x = (lo >> t) & 0x0101u;
    return ((x * 0x0102u) >> 8) & 3u;
  } else if constexpr (G == 4) {
    const uint32_t x = (lo >> t) & 0x01010101u;
    return (x * 0x01020408u) >> 24;
  } else {
    const uint32_t x = (lo >> t) & 0x01010101u;
    const uint32_t y = (hi >> t) & 0x01010101u;
    return ((x * 0x01020408u) >> 24) | (((y * 0x01020408u) >> 24) << 4);
  }
}

template <int G, int MT>
struct Cfg {
  static constexpr int P = 1 << G;
  static constexpr int RP = MT >= 2 ? 2 : 1;      // rows per table word
  static constexpr int WPP = MT / RP;             // words per pattern
  static constexpr int UW = WPP >= 4 ? 4 : WPP;   // words per shared load
  static constexpr int NU = WPP / UW;             // loads per pattern
  static constexpr int LW = 32 / UW;              // lanes per wavefront
  static constexpr int GPV = 16 / G;              // groups per vector
  static constexpr int C = MT >= 4 ? 4 : 8;       // columns per warp
  static constexpr int BN = WARPS * C;
  static constexpr int TABLE_WORDS = (KC / G) * P * WPP;
  static constexpr int A_WORDS = MT * KC / 4;     // the chunk's activations
  static constexpr int RED_WORDS = WARPS * C * MT * 33;
  static constexpr int MAIN_WORDS = TABLE_WORDS + A_WORDS;
  static constexpr int SMEM_WORDS =
      MAIN_WORDS > RED_WORDS ? MAIN_WORDS : RED_WORDS;
};

// the word index of (vector v, group gsub of the vector, load unit nu,
// pattern p): the vector's lane position within a wavefront moves fastest
template <int G, int MT>
__device__ __forceinline__ int unit_word(int v, int gsub, int nu, int p) {
  using F = Cfg<G, MT>;
  return (((((v / F::LW) * F::GPV + gsub) * F::NU + nu) * F::P + p) * F::LW +
          (v % F::LW)) * F::UW;
}

// grid (ceil(N / BN), splits, T); THREADS threads; dynamic shared memory
// SMEM_WORDS * 4 bytes.  `vw` (32, or for K <= 256 a smaller power of two
// that still covers K) is the number of 16-byte vectors a chunk reads of
// each column: lane l takes vector l % vw of the C * vw / 32 columns of
// slot l / vw, so a short K spreads a warp's columns over its lanes
// instead of leaving most lanes idle.  The table is built for all 32
// lanes, lane l's copy holding vector l % vw, so the lookups keep their
// bank-conflict-free layout.
template <int G, int MT>
__global__ void __launch_bounds__(THREADS, 2)
lut_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                void* __restrict__ out, uint32_t* __restrict__ part,
                int* __restrict__ tickets, int M, int N, int K, int bits,
                int epilogue, int shift, int vw, int chunks_per_split) {
  using F = Cfg<G, MT>;
  constexpr int C = F::C;
  extern __shared__ uint32_t smem[];
  uint32_t* table = smem;
  uint8_t* sA = reinterpret_cast<uint8_t*>(smem + F::TABLE_WORDS);

  const int t = blockIdx.z;
  const int splits = gridDim.y;
  A += (size_t)t * M * K;
  W += (size_t)t * N * K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int v = lane % vw;      // this lane's vector of a chunk
  const int cj = C * vw / 32;   // and its columns, from local column
  const int col0 = warp * C + (lane / vw) * cj;
  const int nb0 = blockIdx.x * F::BN;
  const int kc = vw * 16;       // K lanes per chunk
  const int nchunks = (K + kc - 1) / kc;
  const int c_lo = blockIdx.y * chunks_per_split;
  const int c_hi = min(nchunks, c_lo + chunks_per_split);
  // 16-byte vector loads where every row starts 16-byte aligned
  const bool w_vec =
      (K & 15) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  const bool a_vec =
      (K & 15) == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const int sign_t = bits - 1;

  for (int m0 = 0; m0 < M; m0 += MT) {
    uint32_t acc[C][MT];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[c][m] = 0u;

    for (int ch = c_lo; ch < c_hi; ++ch) {
      const int k0 = ch * kc;
      const int kv = k0 + v * 16;  // this lane's vector
      // the weight vectors of this chunk, in flight while the table builds
      uint4 wv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int n = nb0 + col0 + c;
        wv[c] = make_uint4(0u, 0u, 0u, 0u);
        if (c < cj && n < N && kv < K) {
          const int8_t* p = W + (size_t)n * K + kv;
          if (w_vec) {
            wv[c] = __ldg(reinterpret_cast<const uint4*>(p));
          } else {
            uint32_t w4[4] = {0u, 0u, 0u, 0u};
            for (int j = 0; j < 16 && kv + j < K; ++j)
              w4[j / 4] |= (uint32_t)(uint8_t)p[j] << (8 * (j % 4));
            wv[c] = make_uint4(w4[0], w4[1], w4[2], w4[3]);
          }
        }
      }

      // the chunk's activations, rows m0 .. m0 + MT (zero past M and K):
      // loaded before the barrier, stored to shared memory after it
      constexpr int A_PER_THREAD = (MT * 32 + THREADS - 1) / THREADS;
      uint4 xa[A_PER_THREAD];
#pragma unroll
      for (int i = 0; i < A_PER_THREAD; ++i) {
        const int e = threadIdx.x + i * THREADS;
        const int r = e / vw;
        const int k = k0 + (e % vw) * 16;
        xa[i] = make_uint4(0u, 0u, 0u, 0u);
        if (e < MT * vw && m0 + r < M && k < K) {
          const int8_t* p = A + (size_t)(m0 + r) * K + k;
          if (a_vec) {
            xa[i] = __ldg(reinterpret_cast<const uint4*>(p));
          } else {
            uint32_t a4[4] = {0u, 0u, 0u, 0u};
            for (int j = 0; j < 16 && k + j < K; ++j)
              a4[j / 4] |= (uint32_t)(uint8_t)p[j] << (8 * (j % 4));
            xa[i] = make_uint4(a4[0], a4[1], a4[2], a4[3]);
          }
        }
      }
      __syncthreads();  // the previous chunk's table and activations are free
#pragma unroll
      for (int i = 0; i < A_PER_THREAD; ++i) {
        const int e = threadIdx.x + i * THREADS;
        if (e < MT * vw)
          *reinterpret_cast<uint4*>(sA + (e / vw) * KC + (e % vw) * 16) =
              xa[i];
      }
      __syncthreads();
      // build: one task per (lane's vector copy, group, table word)
      // computes the word for all 2^G patterns; neighbouring threads take
      // neighbouring lanes' copies
      const int nvec = min(vw, (K - k0 + 15) / 16);
      for (int task = threadIdx.x; task < 32 * F::GPV * F::WPP;
           task += THREADS) {
        const int lq = task % F::LW;
        const int rest = task / F::LW;
        const int wi = rest % F::WPP;
        const int rest2 = rest / F::WPP;
        const int gsub = rest2 % F::GPV;
        const int vl = (rest2 / F::GPV) * F::LW + lq;  // the lane
        const int va = vl % vw;                        // its vector
        if (va >= nvec) continue;
        // the G lanes' activations of rows wi*RP .. wi*RP + RP - 1, packed
        uint32_t av[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          uint32_t x = 0u;
#pragma unroll
          for (int r = 0; r < F::RP; ++r) {
            const int a = (int)(int8_t)sA[(wi * F::RP + r) * KC + va * 16 +
                                          gsub * G + j];
            x += (uint32_t)a << (16 * r);
          }
          av[j] = x;
        }
        const int nu = wi / F::UW;
        const int wsub = wi % F::UW;
        uint32_t* dst = table + unit_word<G, MT>(vl, gsub, nu, 0) + wsub;
        constexpr int PSTRIDE = F::LW * F::UW;  // words between patterns
        // entry p = the sum of the lanes whose bit is set in p; each
        // sum is spelled out per p, so no array is indexed at run time
        if constexpr (G <= 4) {
#pragma unroll
          for (int p = 0; p < F::P; ++p) {
            uint32_t s = 0u;
#pragma unroll
            for (int j = 0; j < G; ++j)
              if (p & (1 << j)) s += av[j];
            dst[p * PSTRIDE] = s;
          }
        } else {
#pragma unroll 1
          for (int ph = 0; ph < 16; ++ph) {
            const uint32_t hv = ((ph & 1) ? av[4] : 0u) +
                                ((ph & 2) ? av[5] : 0u) +
                                ((ph & 4) ? av[6] : 0u) +
                                ((ph & 8) ? av[7] : 0u);
#pragma unroll
            for (int pl = 0; pl < 16; ++pl) {
              uint32_t s = hv;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (pl & (1 << j)) s += av[j];
              dst[(ph * 16 + pl) * PSTRIDE] = s;
            }
          }
        }
      }
      __syncthreads();

      if (kv < K) {
        // loops over groups and planes, the columns unrolled inside: the
        // columns' loads are independent, and the code stays small (a
        // cold instruction cache costs the short launches)
        const uint32_t* tl = table + unit_word<G, MT>(lane, 0, 0, 0);
        constexpr int GSTRIDE = F::NU * F::P * F::LW * F::UW;  // per gsub
        constexpr int NSTRIDE = F::P * F::LW * F::UW;          // per nu
        constexpr int PSTRIDE = F::LW * F::UW;                 // per pattern
        uint32_t pk[C][F::WPP];
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int i = 0; i < F::WPP; ++i) pk[c][i] = 0u;
#pragma unroll 1
        for (int gsub = 0; gsub < F::GPV; ++gsub) {
          uint32_t lo[C], hi[C];  // this group's weight bytes, per column
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const uint4 x = wv[c];
            hi[c] = 0u;
            if constexpr (G == 2) {
              const int q = gsub >> 1;
              const uint32_t wd =
                  q == 0 ? x.x : (q == 1 ? x.y : (q == 2 ? x.z : x.w));
              lo[c] = wd >> (16 * (gsub & 1));
            } else if constexpr (G == 4) {
              lo[c] = gsub == 0 ? x.x
                                : (gsub == 1 ? x.y : (gsub == 2 ? x.z : x.w));
            } else {
              lo[c] = gsub == 0 ? x.x : x.z;
              hi[c] = gsub == 0 ? x.y : x.w;
            }
          }
          const uint32_t* tg = tl + gsub * GSTRIDE;
#pragma unroll 1
          for (int tb = 0; tb < bits; ++tb) {
            const uint32_t coef = tb == sign_t ? (uint32_t)(-(1 << tb))
                                               : (uint32_t)(1 << tb);
#pragma unroll
            for (int c = 0; c < C; ++c) {
              if (c >= cj) continue;  // not break: the loop stays unrolled
              const uint32_t* e =
                  tg + plane_index<G>(lo[c], hi[c], tb) * PSTRIDE;
#pragma unroll
              for (int nu = 0; nu < F::NU; ++nu) {
                if constexpr (F::UW == 4) {
                  const uint4 x =
                      *reinterpret_cast<const uint4*>(e + nu * NSTRIDE);
                  pk[c][nu * 4 + 0] += x.x * coef;
                  pk[c][nu * 4 + 1] += x.y * coef;
                  pk[c][nu * 4 + 2] += x.z * coef;
                  pk[c][nu * 4 + 3] += x.w * coef;
                } else if constexpr (F::UW == 2) {
                  const uint2 x =
                      *reinterpret_cast<const uint2*>(e + nu * NSTRIDE);
                  pk[c][0] += x.x * coef;
                  pk[c][1] += x.y * coef;
                } else {
                  pk[c][nu] += e[nu * NSTRIDE] * coef;
                }
              }
            }
          }
        }
        // unpack the vector's sums into the row sums (see the note)
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int i = 0; i < F::WPP; ++i) {
            if constexpr (F::RP == 1) {
              acc[c][i] += pk[c][i];
            } else {
              const int lo16 = (int)(int16_t)(pk[c][i] & 0xFFFFu);
              const int hi16 = ((int)pk[c][i] - lo16) >> 16;
              acc[c][2 * i] += (uint32_t)lo16;
              acc[c][2 * i + 1] += (uint32_t)hi16;
            }
          }
      }
    }

    // the lanes' sums of each (column, row), through shared memory: lane
    // (slot, vector v) holds column col0 + c's sums over vector v
    __syncthreads();  // the last chunk's lookups are done
    uint32_t* red = smem + warp * (C * MT * 33);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c >= cj) continue;
#pragma unroll
      for (int m = 0; m < MT; ++m)
        red[((col0 - warp * C + c) * MT + m) * 33 + v] = acc[c][m];
    }
    __syncwarp();
    const int mt = min(MT, M - m0);
    for (int e = lane; e < C * MT; e += 32) {
      const int c = e / MT;
      const int m = e % MT;
      uint32_t s = 0u;
      for (int l = 0; l < vw; ++l) s += red[e * 33 + l];
      const int n = nb0 + warp * C + c;
      if (m >= mt || n >= N) continue;
      const size_t o = (size_t)t * M * N + (size_t)(m0 + m) * N + n;
      if (splits == 1)
        store_out(out, o, s, epilogue, shift);
      else
        part[(size_t)blockIdx.y * gridDim.z * M * N + o] = s;
    }
    __syncthreads();  // red aliases the next pass's table
  }

  if (splits > 1) {
    // the last split block of this column block adds the partials in
    // split order and runs the epilogue (the host never splits when
    // M > MT, so this follows the single row pass)
    __shared__ int last;
    __threadfence();
    __syncthreads();
    int* ticket = tickets + (size_t)t * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int ncols = min(F::BN, N - nb0);
    const size_t stride = (size_t)gridDim.z * M * N;
    for (int e = threadIdx.x; e < M * ncols; e += THREADS) {
      const int m = e / ncols;
      const int n = nb0 + e % ncols;
      const size_t o = (size_t)t * M * N + (size_t)m * N + n;
      uint32_t s = 0u;
      for (int sp = 0; sp < splits; ++sp) s += __ldcg(part + sp * stride + o);
      store_out(out, o, s, epilogue, shift);
    }
    if (threadIdx.x == 0) *ticket = 0;  // ready for the next call
  }
}

template <int G, int MT>
int launch(const int8_t* A, const int8_t* W, void* out, uint32_t* part,
           int* tickets, int T, int M, int N, int K, int bits, int epilogue,
           int shift, int vw, int splits, int chunks_per_split,
           cudaStream_t s) {
  using F = Cfg<G, MT>;
  if (vw < 1 || vw > 32 || 32 % vw || F::C * vw < 32)
    return (int)cudaErrorInvalidValue;
  const int smem = F::SMEM_WORDS * 4;
  cudaError_t e = cudaFuncSetAttribute(
      lut_gemm_kernel<G, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + F::BN - 1) / F::BN, splits, T);
  lut_gemm_kernel<G, MT><<<grid, THREADS, smem, s>>>(
      A, W, out, part, tickets, M, N, K, bits, epilogue, shift, vw,
      chunks_per_split);
  return (int)cudaGetLastError();
}

template <int G>
int by_rows(const int8_t* A, const int8_t* W, void* out, uint32_t* part,
            int* tickets, int T, int M, int N, int K, int bits, int epilogue,
            int shift, int mt, int vw, int splits, int cps,
            cudaStream_t s) {
  switch (mt) {
    case 1:
      return launch<G, 1>(A, W, out, part, tickets, T, M, N, K, bits,
                          epilogue, shift, vw, splits, cps, s);
    case 2:
      return launch<G, 2>(A, W, out, part, tickets, T, M, N, K, bits,
                          epilogue, shift, vw, splits, cps, s);
    case 4:
      return launch<G, 4>(A, W, out, part, tickets, T, M, N, K, bits,
                          epilogue, shift, vw, splits, cps, s);
    default:
      break;
  }
  if constexpr (G < 8) {
    if (mt == 8)
      return launch<G, 8>(A, W, out, part, tickets, T, M, N, K, bits,
                          epilogue, shift, vw, splits, cps, s);
    if (mt == 16)
      return launch<G, 16>(A, W, out, part, tickets, T, M, N, K, bits,
                           epilogue, shift, vw, splits, cps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a group other than 2, 4 or 8, a row count
// `mt` it has no instance for or a `vw` the instance cannot spread.  `mt`,
// `vw`, `splits` and `chunks_per_split` come from the wrapper's plan
// (kernel.py:lut_plan); with splits > 1, `part`
// holds splits * T * M * N uint32 and `tickets` T * ceil(N / BN) zeroed
// ints (left zeroed).  The wrapper checks dtypes, shapes and contiguity,
// allocates `out`, and never calls this with T, M or N equal to 0.
extern "C" int lut_gemm_launch(const void* a, const void* w, void* out,
                               void* part, void* tickets, int T, int M, int N,
                               int K, int bits, int group, int epilogue,
                               int shift, int mt, int vw, int splits,
                               int chunks_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* W = static_cast<const int8_t*>(w);
  uint32_t* P = static_cast<uint32_t*>(part);
  int* tk = static_cast<int*>(tickets);
  switch (group) {
    case 2:
      return by_rows<2>(A, W, out, P, tk, T, M, N, K, bits, epilogue, shift,
                        mt, vw, splits, chunks_per_split, s);
    case 4:
      return by_rows<4>(A, W, out, P, tk, T, M, N, K, bits, epilogue, shift,
                        mt, vw, splits, chunks_per_split, s);
    case 8:
      return by_rows<8>(A, W, out, P, tk, T, M, N, K, bits, epilogue, shift,
                        mt, vw, splits, chunks_per_split, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
