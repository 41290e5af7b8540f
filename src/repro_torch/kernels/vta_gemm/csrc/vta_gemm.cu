// vta_gemm: C[t] = epilogue(A[t] @ W[t]^T + bias) for int8 A, W and an int32
// accumulator, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/vta_gemm/kernel.py, vta_gemm_pallas (body
// _gemm_kernel), the TPU kernel that resolves every coalesced GEMM tile of
// the task-ISA engine.  It computes the same function; it is not a block by
// block copy.
//
// Operands: A is (T, M, K) int8 row-major, W is (T, N, K) int8 row-major
// (each output channel's weights contiguous along K, the layout the engine
// snapshots from the weight SRAM), bias (N,) int32 and scale (N,) float32
// are shared by all T tiles, and the output is (T, M, N): int32 for
// "none", int8 for "requant", float32 for "dequant".  M, N and K are any
// sizes: the edges are masked here, so the 128-padding the TPU BlockSpecs
// needed is gone.
//
// What bounds it on this card: at the engine's shapes (M = 14..3136 rows,
// N = 64..512 channels, K = 64..4608) the int8 tensor-core rate (1,979
// TOPS dense) is never reached; a full-width ResNet layer moves well under
// a megabyte and does at most a few GOPs, so the small direct-conv tiles
// are bound by launch latency and by the bytes of A, W and the output.
//
// What the design does about it: one launch covers T peer tiles (grid.z,
// in place of the TPU's jax.vmap), so a batch of virtual-thread tiles pays
// one launch.  Each block computes a 64x64 output tile with four warps
// issuing mma.sync m16n8k32 s8 (int8 tensor cores, int32 accumulate); the
// K loop runs inside the block (the TPU's sequential third grid axis), over
// 32-byte K steps staged in shared memory with 16-byte loads where K and
// the pointers allow it.  The epilogue is fused after the last K step.
// There is no multi-stage pipeline, TMA or wgmma yet: a right kernel first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // K bytes per step (one m16n8k32)
constexpr int SROW = BK + 16; // 48-byte smem rows: fragment reads hit 32 banks
constexpr int THREADS = 128;  // four warps, 2x2 over the 64x64 tile

enum { EPI_NONE = 0, EPI_REQUANT = 1, EPI_DEQUANT = 2 };

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage a 64-row x 32-byte tile of a row-major (rows, K) int8 matrix into
// shared memory, zero-filling rows >= n_rows and columns >= K.  Each of the
// 128 threads moves 16 bytes.
template <bool VEC>
__device__ __forceinline__ void load_tile(int8_t* s, const int8_t* g,
                                          int row0, int n_rows, int k0,
                                          int K) {
  const int r = threadIdx.x >> 1;
  const int c = (threadIdx.x & 1) * 16;
  const int gr = row0 + r;
  const int gk = k0 + c;
  int4 v = make_int4(0, 0, 0, 0);
  if (VEC) {
    // K % 16 == 0 and 16-byte aligned rows: a chunk is all in or all out
    if (gr < n_rows && gk < K)
      v = *reinterpret_cast<const int4*>(g + (size_t)gr * K + gk);
  } else if (gr < n_rows) {
    alignas(16) int8_t tmp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      tmp[i] = (gk + i < K) ? g[(size_t)gr * K + gk + i] : (int8_t)0;
    v = *reinterpret_cast<const int4*>(tmp);
  }
  *reinterpret_cast<int4*>(s + r * SROW + c) = v;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
vta_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                const int32_t* __restrict__ bias,
                const float* __restrict__ scale, void* __restrict__ out,
                int M, int N, int K, int epilogue, int shift) {
  __shared__ __align__(16) int8_t As[BM * SROW];
  __shared__ __align__(16) int8_t Ws[BN * SROW];

  const size_t t = blockIdx.z;
  A += t * (size_t)M * K;
  W += t * (size_t)N * K;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // groupID
  const int q = lane & 3;   // thread in group
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<VEC>(As, A, m0, M, k0, K);
    load_tile<VEC>(Ws, W, n0, N, k0, K);
    __syncthreads();
    uint32_t af[2][4];
    uint32_t bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* base = As + (wm + i * 16 + g) * SROW + q * 4;
      af[i][0] = *reinterpret_cast<const uint32_t*>(base);
      af[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * SROW);
      af[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
      af[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * SROW + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* base = Ws + (wn + j * 8 + g) * SROW + q * 4;
      bf[j][0] = *reinterpret_cast<const uint32_t*>(base);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    __syncthreads();
  }

  // fused epilogue: bias (wrapping, in uint32), then none/requant/dequant
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + i * 16 + g + ((e >> 1) << 3);
        const int col = n0 + wn + j * 8 + q * 2 + (e & 1);
        if (row >= M || col >= N) continue;
        int v = acc[i][j][e];
        if (bias != nullptr)
          v = (int)((uint32_t)v + (uint32_t)bias[col]);
        const size_t o = t * (size_t)M * N + (size_t)row * N + col;
        if (epilogue == EPI_NONE) {
          static_cast<int32_t*>(out)[o] = v;
        } else if (epilogue == EPI_REQUANT) {
          // arithmetic shift; 32 or more fills with the sign bit
          int s = shift >= 32 ? (v < 0 ? -1 : 0) : (v >> shift);
          s = s < -128 ? -128 : (s > 127 ? 127 : s);
          static_cast<int8_t*>(out)[o] = (int8_t)s;
        } else {
          static_cast<float*>(out)[o] = (float)v * scale[col];
        }
      }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// wrapper checks dtypes, shapes and contiguity, allocates `out`, and never
// calls this with T, M or N equal to 0.
extern "C" int vta_gemm_launch(const void* a, const void* w, const void* bias,
                               const void* scale, void* out, int T, int M,
                               int N, int K, int epilogue, int shift,
                               void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, T);
  const bool vec = (K % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* W = static_cast<const int8_t*>(w);
  const int32_t* B = static_cast<const int32_t*>(bias);
  const float* S = static_cast<const float*>(scale);
  if (vec)
    vta_gemm_kernel<true><<<grid, THREADS, 0, s>>>(A, W, B, S, out, M, N, K,
                                                   epilogue, shift);
  else
    vta_gemm_kernel<false><<<grid, THREADS, 0, s>>>(A, W, B, S, out, M, N, K,
                                                    epilogue, shift);
  return (int)cudaGetLastError();
}
