// vta_gemm: C[t] = epilogue(A[t] @ W[t]^T + bias) for int8 A, W and an int32
// accumulator, on Hopper (sm_90a); and quantized_linear, the same GEMM with
// the dynamic int8 quantization of float activations in front of it.
//
// Replaces: src/repro/kernels/vta_gemm/kernel.py, vta_gemm_pallas (body
// _gemm_kernel), the TPU kernel that resolves every coalesced GEMM tile of
// the task-ISA engine and every quantized linear of the LM substrate
// (src/repro/kernels/vta_gemm/ops.py:quantized_linear).  It computes the
// same function; it is not a block by block copy.
//
// Operands: A is (T, M, K) row-major: int8, or for quantized_linear float32
// or bfloat16 activations x (T = 1); W is (T, N, K) int8 row-major (each
// output channel's weights contiguous along K: the layout the engine
// snapshots from the weight SRAM, and what quantize_params stores); bias
// (N,) int32 and scale (N,) float32 are shared by all T tiles; the output
// is (T, M, N): int32 for "none", int8 for "requant", float32 for
// "dequant", x's dtype for quantized_linear.
//
// quantized_linear's steps are the plain chain's (ref.py), in its order:
//   amax = max|x| (exact in x's dtype), clamped below at `lo` (1e-6 in x's
//   dtype); x_scale = amax / 127 by an IEEE float32 division, rounded to
//   nearest even in x's dtype; x_q = clip(rint(x / x_scale), -128, 127) by
//   an IEEE division; y = float(acc) * (w_scale[n] * x_scale), each product
//   rounded once (no FMA); y rounded to nearest even in x's dtype.  Built
//   without fast math.  Up to 16 rows x_q lives only in shared memory;
//   above 16 rows one launch writes it to device memory once a call and
//   the GEMM reads it from there (vta_wgmma.cu).
//
// Two instances, the host picks by M (kernel.py:gemm_plan):
//
// * wgmma (M > 16: the engine's tiles, M = 14..3136, N = 64..512, K =
//   64..4608, and the LM's prefill linears): in vta_wgmma.cu, whose note
//   gives its design.
//
// * Skinny (M <= 16: a decode step's 1-16 tokens), in this file.  Bound by
//   the weight bytes: 2*M operations per weight byte (8 at M 4), far below
//   the ~590 at which the int8 tensor cores bind.  Y^T = W X^T on mma.sync
//   m16n8k32 s8, weights on the tall side: a warp owns 16 output channels
//   and X's rows (padded to 8 or 16) are the narrow side.  A lane loads 16
//   contiguous bytes of each of its two weight rows per 64-byte K step;
//   since integer sums are exact in any order, the fragments take K in that
//   permuted order (bytes 0-7 of the lane's 16 feed the first k32 step,
//   8-15 the second) and X's fragments follow the same permutation, so
//   every load is 16 bytes and no shuffle is needed.  M, N and K are any
//   sizes: the edges are masked, so nothing is padded in memory.  The
//   weights stream through an 8-stage cp.async ring in shared memory (8 KB
//   a stage for the block's eight warps; each lane reads back only what it
//   copied, so no barrier guards the ring).  A block takes 128 channels and
//   one slice of K; the slices (kernel.py:gemm_plan) bring the grid to
//   about two blocks per SM at every LM shape.  The slices' int32 partials
//   are added with atomicAdd into a scratch buffer (integer addition wraps
//   and is associative mod 2^32: the same bits in any order); the last
//   block of a column block (a ticket counter) takes the sums, leaving
//   zeros, and runs the epilogue.  For quantized_linear the grid (at most
//   two blocks per SM, launched cooperatively, so all are resident) first
//   shares one amax: each block reduces a slice of x, atomicMax on the bits
//   (|x| >= 0 orders as its bit pattern), and waits at a grid-wide counter;
//   the weight copies of the first seven stages are already in flight
//   meanwhile.  Each block then quantizes its K slice of x into shared
//   memory.  One launch per call; two where the grid would not be resident
//   (x_scale from the amax launch below first).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vta_common.cuh"

namespace {

using namespace vta;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ==== x_scale in its own launch (ahead of a skinny one) ==================
constexpr int AMAX_THREADS = 256;

// Each block reduces a grid-stride share of x and writes its max to
// part[block]; the last block to finish (ticket, reset by it) takes the max
// of the parts and writes x_scale to xs_out[0].
template <typename XT>
__global__ void __launch_bounds__(AMAX_THREADS)
vta_gemm_amax_kernel(const XT* __restrict__ x, long long n,
                     unsigned* __restrict__ part, unsigned* __restrict__ ticket,
                     float* __restrict__ xs_out, float lo) {
  __shared__ unsigned red[AMAX_THREADS / 32];
  __shared__ int last;
  unsigned v = 0u;
  for (long long i = (long long)blockIdx.x * AMAX_THREADS + threadIdx.x;
       i < n; i += (long long)gridDim.x * AMAX_THREADS)
    v = max(v, abs_bits(x[i]));
  v = block_max(v, red);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = v;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  unsigned r = 0u;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += AMAX_THREADS)
    r = max(r, __ldcg(part + b));
  r = block_max(r, red);
  if (threadIdx.x == 0) {
    xs_out[0] = x_scale_of<XT>(r, lo);
    *ticket = 0u;  // ready for the next call
  }
}

// ==== the skinny instance (M <= 16) ======================================
constexpr int SK_WARPS = 8;
constexpr int SK_THREADS = 32 * SK_WARPS;
constexpr int SK_BN = 16 * SK_WARPS;  // 128 channels per block
constexpr int SK_KC = 64;             // K bytes per warp step (two k32 MMAs)
constexpr int SK_STAGES = 8;
constexpr int SK_STAGE = SK_THREADS * 32;  // 32 bytes a lane: two rows

// QM: 0 int8 A; 1 float A, x_scale from xs_in; 2 float A, x_scale from the
// grid-wide amax (cooperative launch, T = 1).  MP: X rows padded to 8 or 16.
template <int QM, typename AT, int MP, bool VEC>
__global__ void __launch_bounds__(SK_THREADS, 2)
vta_gemm_skinny_kernel(const AT* __restrict__ A, const int8_t* __restrict__ W,
                       const int32_t* __restrict__ bias,
                       const float* __restrict__ scale,
                       const float* __restrict__ xs_in,
                       void* __restrict__ out, uint32_t* __restrict__ ws,
                       unsigned* __restrict__ sync,
                       unsigned* __restrict__ tickets, int M, int N, int K,
                       int epilogue, int shift, int kslice, float lo) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ unsigned red[SK_WARPS];
  __shared__ float xs_sh;
  __shared__ int last;
  constexpr int NT = MP / 8;
  const int xstride = (kslice % 128 == 0) ? kslice + 64 : kslice;
  int8_t* ring = smem;
  int8_t* xq = smem + SK_STAGES * SK_STAGE;

  const int t = blockIdx.z;
  A += (size_t)t * M * K;
  W += (size_t)t * N * K;
  const int n0 = blockIdx.x * SK_BN;
  const int kb = blockIdx.y * kslice;
  const int ke = min(kb + kslice, K);
  const int nsteps = ke > kb ? (ke - kb + SK_KC - 1) / SK_KC : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row0 = n0 + warp * 16 + g;  // and row0 + 8

  // the lane's 32 bytes of a stage: row0's 16 at +0, row0 + 8's at +4096
  auto load_stage = [&](int step) {
    int8_t* dst = ring + (step % SK_STAGES) * SK_STAGE + threadIdx.x * 16;
    const int k = kb + step * SK_KC + tq * 16;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool ok = row < N && k < ke;
      if (VEC) {
        cp_async16(dst + r * (SK_STAGE / 2),
                   ok ? W + (size_t)row * K + k : W, ok ? 16 : 0);
      } else {
        *reinterpret_cast<int4*>(dst + r * (SK_STAGE / 2)) =
            ok ? Act<int8_t>::template load16<false>(
                     W + (size_t)row * K + k, ke - k, 0.f)
               : make_int4(0, 0, 0, 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) {
    if (s < nsteps) load_stage(s);
    cp_async_commit();
  }

  float xs = 0.f;
  if constexpr (QM == 1) xs = *xs_in;
  if constexpr (QM == 2)
    xs = grid_x_scale<AT>(A, (long long)M * K, sync, lo, red, &xs_sh);

  // X's K slice, quantized (or copied), into xq[MP][xstride]; zero-padded
  for (int e = threadIdx.x; e < MP * (kslice / 16); e += SK_THREADS) {
    const int m = e / (kslice / 16);
    const int k = (e % (kslice / 16)) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (m < M && kb + k < ke)
      v = Act<AT>::template load16<VEC>(A + (size_t)m * K + kb + k,
                                        ke - kb - k, xs);
    *reinterpret_cast<int4*>(xq + m * xstride + k) = v;
  }
  __syncthreads();

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<SK_STAGES - 2>();
    const int8_t* src = ring + (step % SK_STAGES) * SK_STAGE + threadIdx.x * 16;
    const int4 w0 = *reinterpret_cast<const int4*>(src);
    const int4 w1 = *reinterpret_cast<const int4*>(src + SK_STAGE / 2);
    if (step + SK_STAGES - 1 < nsteps) load_stage(step + SK_STAGES - 1);
    cp_async_commit();
    const uint32_t a0[4] = {(uint32_t)w0.x, (uint32_t)w1.x, (uint32_t)w0.y,
                            (uint32_t)w1.y};
    const uint32_t a1[4] = {(uint32_t)w0.z, (uint32_t)w1.z, (uint32_t)w0.w,
                            (uint32_t)w1.w};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int4 xv = *reinterpret_cast<const int4*>(
          xq + (j * 8 + g) * xstride + step * SK_KC + tq * 16);
      const uint32_t b0[2] = {(uint32_t)xv.x, (uint32_t)xv.y};
      const uint32_t b1[2] = {(uint32_t)xv.z, (uint32_t)xv.w};
      mma_s8(acc[j], a0, b0);
      mma_s8(acc[j], a1, b1);
    }
  }
  cp_async_wait<0>();

  using OT = typename QOut<AT>::T;
  const size_t tbase = (size_t)t * M * N;
  if (gridDim.y == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = row0 + ((e >> 1) << 3);
        const int m = j * 8 + tq * 2 + (e & 1);
        if (n < N && m < M)
          store_out<OT>(out, tbase + (size_t)m * N + n, acc[j][e], bias,
                        scale, xs, n, epilogue, shift);
      }
    return;
  }
  // the split of K: add the partials, the last block runs the epilogue
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = row0 + ((e >> 1) << 3);
      const int m = j * 8 + tq * 2 + (e & 1);
      if (n < N && m < M)
        atomicAdd(ws + tbase + (size_t)m * N + n, (uint32_t)acc[j][e]);
    }
  __threadfence();
  __syncthreads();
  unsigned* ticket = tickets + (size_t)t * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int ncols = min(SK_BN, N - n0);
  for (int e = threadIdx.x; e < M * ncols; e += SK_THREADS) {
    const int m = e / ncols;
    const int n = n0 + e % ncols;
    const size_t o = tbase + (size_t)m * N + n;
    const int v = (int)atomicExch(ws + o, 0u);  // the sum; leaves a zero
    store_out<OT>(out, o, v, bias, scale, xs, n, epilogue, shift);
  }
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next call
}

size_t skinny_smem(int MP, int kslice) {
  const int xstride = (kslice % 128 == 0) ? kslice + 64 : kslice;
  return (size_t)SK_STAGES * SK_STAGE + (size_t)MP * xstride;
}

template <int QM, typename AT, int MP, bool VEC>
int launch_skinny(const void* a, const int8_t* w, const int32_t* bias,
                  const float* scale, const float* xs_in, void* out,
                  uint32_t* ws, unsigned* sync, unsigned* tickets, int T,
                  int M, int N, int K, int epilogue, int shift, int splits,
                  int kslice, float lo, cudaStream_t st) {
  auto* fn = vta_gemm_skinny_kernel<QM, AT, MP, VEC>;
  const size_t smem = skinny_smem(MP, kslice);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)  // two blocks' shared memory on every SM
    e = cudaFuncSetAttribute(fn,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + SK_BN - 1) / SK_BN, splits, T);
  const AT* A = static_cast<const AT*>(a);
  if (QM == 2) {
    void* args[] = {&A, &w, &bias, &scale, &xs_in, &out, &ws, &sync,
                    &tickets, &M, &N, &K, &epilogue, &shift, &kslice, &lo};
    e = cudaLaunchCooperativeKernel((const void*)fn, grid, dim3(SK_THREADS),
                                    args, smem, st);
    if (e != cudaSuccess) return (int)e;
  } else {
    fn<<<grid, SK_THREADS, smem, st>>>(A, w, bias, scale, xs_in, out, ws,
                                       sync, tickets, M, N, K, epilogue,
                                       shift, kslice, lo);
  }
  return (int)cudaGetLastError();
}

template <int QM, typename AT>
int dispatch_skinny(bool vec, const void* a, const int8_t* w,
                    const int32_t* bias, const float* scale,
                    const float* xs_in, void* out, uint32_t* ws,
                    unsigned* sync, unsigned* tickets, int T, int M, int N,
                    int K, int epilogue, int shift, int splits, int kslice,
                    float lo, cudaStream_t st) {
#define SK_LAUNCH(MP, V)                                                     \
  return launch_skinny<QM, AT, MP, V>(a, w, bias, scale, xs_in, out, ws,     \
                                      sync, tickets, T, M, N, K, epilogue,   \
                                      shift, splits, kslice, lo, st)
  if (M <= 8) {
    if (vec) SK_LAUNCH(8, true);
    SK_LAUNCH(8, false);
  }
  if (vec) SK_LAUNCH(16, true);
  SK_LAUNCH(16, false);
#undef SK_LAUNCH
}

// quantized_linear on float x (AT float or bf16)
template <typename AT>
int launch_qlinear(bool vec, int route, const void* a, const int8_t* w,
                   const float* scale, const float* xs_given, float* xs_buf,
                   unsigned* part, void* out, uint32_t* ws, unsigned* sync,
                   int M, int N, int K, int splits, int kslice,
                   int amax_blocks, float lo, cudaStream_t st) {
  const float* xs = xs_given;
  if (xs == nullptr && route == 1) {
    // x_scale in a launch of its own: part[0, amax_blocks) the block
    // maxima, part[amax_blocks] the ticket
    vta_gemm_amax_kernel<AT><<<amax_blocks, AMAX_THREADS, 0, st>>>(
        static_cast<const AT*>(a), (long long)M * K, part,
        part + amax_blocks, xs_buf, lo);
    const int e = (int)cudaGetLastError();
    if (e != 0) return e;
    xs = xs_buf;
  }
  unsigned* tickets = sync + 4;
  if (route == 2)
    return dispatch_skinny<2, AT>(vec, a, w, nullptr, scale, nullptr, out,
                                  ws, sync, tickets, 1, M, N, K, EPI_QLINEAR,
                                  0, splits, kslice, lo, st);
  return dispatch_skinny<1, AT>(vec, a, w, nullptr, scale, xs, out, ws,
                                sync, tickets, 1, M, N, K, EPI_QLINEAR, 0,
                                splits, kslice, lo, st);
}

}  // namespace

// The skinny instance.  Launch on `stream`; returns the first
// cudaGetLastError() (or launch error) that is not 0.  The wrapper
// (kernel.py) checks dtypes, shapes and contiguity, allocates `out`, never
// calls this with T, M or N equal to 0, and picks the route and split from
// kernel.py:gemm_plan:
//   route 1: the skinny instance; 2 (quantized_linear only): the skinny
//   one with the grid-wide amax, launched cooperatively.
// `ws` is a zeroed uint32 scratch of T * M * N (skinny with splits > 1),
// left zeroed; `sync` holds four zeroed words for the grid-wide amax and
// then a zeroed ticket per column block, left zeroed.
// a_dtype 0 (int8 A, epilogue 0-2, bias and scale as given) is vta_gemm.
// a_dtype 1 or 2 (float32 or bfloat16 x, T = 1) is quantized_linear:
// `scale` is w_scale; x_scale comes from `xs_given` (a device float) when
// it is not null, else from the amax (route 2 in the GEMM's launch, route
// 1 in a launch before it, through `xs_buf` and `part`, which holds
// amax_blocks + 1 zeroed words, left zeroed); `lo` is 1e-6 in x's dtype.
extern "C" int vta_gemm_launch(const void* a, const void* w, const void* bias,
                               const void* scale, void* out, void* ws,
                               void* sync, const void* xs_given, void* xs_buf,
                               void* part, int T, int M, int N, int K,
                               int a_dtype, int epilogue, int shift,
                               int route, int splits, int kslice,
                               int amax_blocks, float lo, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* W = static_cast<const int8_t*>(w);
  const int32_t* B = static_cast<const int32_t*>(bias);
  const float* S = static_cast<const float*>(scale);
  uint32_t* WS = static_cast<uint32_t*>(ws);
  unsigned* SY = static_cast<unsigned*>(sync);
  const bool vec = (K % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if (route != 1 && route != 2) return (int)cudaErrorInvalidValue;
  if (a_dtype == A_INT8)
    return dispatch_skinny<0, int8_t>(vec, a, W, B, S, nullptr, out, WS, SY,
                                      SY + 4, T, M, N, K, epilogue, shift,
                                      splits, kslice, 0.f, st);
  const float* XG = static_cast<const float*>(xs_given);
  float* XB = static_cast<float*>(xs_buf);
  unsigned* P = static_cast<unsigned*>(part);
  if (a_dtype == A_F32)
    return launch_qlinear<float>(vec, route, a, W, S, XG, XB, P, out, WS, SY,
                                 M, N, K, splits, kslice, amax_blocks, lo,
                                 st);
  if (a_dtype == A_BF16)
    return launch_qlinear<__nv_bfloat16>(vec, route, a, W, S, XG, XB, P, out,
                                         WS, SY, M, N, K, splits, kslice,
                                         amax_blocks, lo, st);
  return (int)cudaErrorInvalidValue;
}
