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
// deterministic without any care for order.
//
// Operands: A is (T, M, K) int8 row-major, W is (T, N, K) int8 row-major
// (each output channel's weights contiguous along K, as the engine
// snapshots them from the weight SRAM), out is (T, M, N): int32 for "none",
// int8 for "requant" (clip(acc >> shift, -128, 127), truncating arithmetic
// shift; 32 or more fills with the sign).  M, N and K are any sizes: the
// ragged edges are masked (zero lanes add nothing to a subset sum, zero
// weights select table entry 0 = 0), so no operand is padded.
//
// What bounds it on this card: at decode shapes (M <= 16) the work is
// 2*M*N*K int8 operations over N*K weight bytes, i.e. at most 32 operations
// per byte: far below the int8 tensor-core ridge, so the bound is the bytes
// of W (and A, C) at 3.35 TB/s.
//
// What the design does about it: each weight byte is read once per 16-row
// pass (the activation table is rebuilt per K chunk in shared memory, which
// is cheap next to the weight stream), and the eight warps of a block split
// every K chunk by group in an interleaved order, so one column's weight
// bytes are read as consecutive 32-byte sectors by the block as a whole.
// Each thread owns one output column of one K slice and keeps its 16 row
// sums in registers; the eight slices are summed in shared memory at the
// end in a fixed order.  Grid: (column blocks of 32, T).  Not done yet:
// vector loads of several groups at once, a split of K across blocks for
// small N, and a pipelined weight stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 32;          // output columns per block (one warp wide)
constexpr int KS = 8;           // K slices per block (one warp each)
constexpr int THREADS = BN * KS;
constexpr int MT = 16;          // rows per pass: the engine's LUT rows cap
constexpr int TABLE_INTS = 8192;  // 32 KB of subset sums per K chunk

enum { EPI_NONE = 0, EPI_REQUANT = 1 };

template <int G>
__global__ void __launch_bounds__(THREADS)
lut_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                void* __restrict__ out, int M, int N, int K, int bits,
                int epilogue, int shift) {
  constexpr int P = 1 << G;
  constexpr int GC = TABLE_INTS / (MT * P);  // groups per K chunk
  constexpr int KC = GC * G;                 // K lanes per chunk
  static_assert(KS * MT * BN <= TABLE_INTS, "red aliases the table");
  __shared__ int table[TABLE_INTS];   // [group][row][pattern] per K chunk
  uint32_t* red = reinterpret_cast<uint32_t*>(table);  // [slice][row][col]

  const size_t t = blockIdx.y;
  A += t * (size_t)M * K;
  W += t * (size_t)N * K;
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int n = blockIdx.x * BN + lane;
  const bool col_ok = n < N;
  const int8_t* wrow = W + (size_t)(col_ok ? n : 0) * K;

  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mt = min(MT, M - m0);
    uint32_t acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0u;

    for (int k0 = 0; k0 < K; k0 += KC) {
      __syncthreads();  // the previous chunk's table reads are done
      // build: each (group, row) pair's 2^G subset sums, incrementally
      for (int pr = threadIdx.x; pr < GC * MT; pr += THREADS) {
        const int gi = pr / MT;
        const int m = pr % MT;
        int av[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int k = k0 + gi * G + j;
          av[j] = (m < mt && k < K) ? (int)A[(size_t)(m0 + m) * K + k] : 0;
        }
        int* row = table + (gi * MT + m) * P;
        row[0] = 0;
        for (int p = 1; p < P; ++p)
          row[p] = row[p & (p - 1)] + av[__ffs(p) - 1];
      }
      __syncthreads();
      if (col_ok) {
        const int groups = min(GC, (K - k0 + G - 1) / G);
        for (int gi = slice; gi < groups; gi += KS) {
          const int kb = k0 + gi * G;
          uint32_t wb[G];
#pragma unroll
          for (int j = 0; j < G; ++j)
            wb[j] = (kb + j < K) ? (uint32_t)(uint8_t)wrow[kb + j] : 0u;
          const int* tg = table + gi * MT * P;
          for (int tb = 0; tb < bits; ++tb) {
            int idx = 0;
#pragma unroll
            for (int j = 0; j < G; ++j) idx |= (int)((wb[j] >> tb) & 1u) << j;
            if (tb == bits - 1) {  // the sign plane: coefficient -2^tb
#pragma unroll
              for (int m = 0; m < MT; ++m)
                acc[m] -= (uint32_t)tg[m * P + idx] << tb;
            } else {
#pragma unroll
              for (int m = 0; m < MT; ++m)
                acc[m] += (uint32_t)tg[m * P + idx] << tb;
            }
          }
        }
      }
    }

    // sum the K slices in a fixed order, then the epilogue
    __syncthreads();  // the last chunk's table reads are done
#pragma unroll
    for (int m = 0; m < MT; ++m) red[(slice * MT + m) * BN + lane] = acc[m];
    __syncthreads();
    for (int e = threadIdx.x; e < MT * BN; e += THREADS) {
      const int m = e / BN;
      const int c = e % BN;
      const int col = blockIdx.x * BN + c;
      if (m >= mt || col >= N) continue;
      uint32_t s = 0u;
#pragma unroll
      for (int k = 0; k < KS; ++k) s += red[(k * MT + m) * BN + c];
      const int v = (int)s;
      const size_t o = t * (size_t)M * N + (size_t)(m0 + m) * N + col;
      if (epilogue == EPI_NONE) {
        static_cast<int32_t*>(out)[o] = v;
      } else {
        int q = shift >= 32 ? (v < 0 ? -1 : 0) : (v >> shift);
        q = q < -128 ? -128 : (q > 127 ? 127 : q);
        static_cast<int8_t*>(out)[o] = (int8_t)q;
      }
    }
    __syncthreads();  // red is rewritten by the next row pass
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a group size other than 2, 4 or 8.  The
// wrapper checks dtypes, shapes and contiguity, allocates `out`, and never
// calls this with T, M or N equal to 0.
extern "C" int lut_gemm_launch(const void* a, const void* w, void* out, int T,
                               int M, int N, int K, int bits, int group,
                               int epilogue, int shift, void* stream) {
  const dim3 grid((N + BN - 1) / BN, T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* W = static_cast<const int8_t*>(w);
  switch (group) {
    case 2:
      lut_gemm_kernel<2><<<grid, THREADS, 0, s>>>(A, W, out, M, N, K, bits,
                                                  epilogue, shift);
      break;
    case 4:
      lut_gemm_kernel<4><<<grid, THREADS, 0, s>>>(A, W, out, M, N, K, bits,
                                                  epilogue, shift);
      break;
    case 8:
      lut_gemm_kernel<8><<<grid, THREADS, 0, s>>>(A, W, out, M, N, K, bits,
                                                  epilogue, shift);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
