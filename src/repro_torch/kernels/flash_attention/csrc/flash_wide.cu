// flash_wide: GQA attention and its gradient for head dims above 128,
// bfloat16 or float32 operands, every product on the tensor cores of
// Hopper (sm_90a): bfloat16 on wgmma fed by TMA, float32 on mma.sync in
// 3xTF32.  The kernels beside it (flash_wgmma.cu, flash_tf32x3.cu,
// flash_bwd.cu) keep a tile's whole head dim in shared memory and its
// output in registers sized for D <= 128; these stream the head dim.  No
// config of the repository has such a head: they make the op take every
// head dim, as the TPU kernel does, at a tensor-core rate.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas (body _flash_kernel), for D > 128; the gradient
// has no TPU kernel (the reference differentiates its jnp oracle,
// src/repro/kernels/flash_attention/ref.py:18), as flash_bwd.cu.
//
// Computes, for each batch b, query head h and query row i (query head h
// reads kv head h / group), with scale = 1 / sqrt(D) of the unpadded D:
//   out[b, i, h] = softmax_j(scale q[b, i, h] . k[b, j, h / group])
//                  @ v[b, j, h / group]
// over the keys j the row sees: all Sk, or with `causal` j <= i + Sk - S
// (the diagonal aligned bottom-right, the reference oracles' mask).  With a
// log-sum-exp buffer each row's L = m + ln l of its scaled scores is
// written too (+inf for a row that sees no key, whose output is zeros).
// The backward takes that L: Delta_i = do_i . o_i, then dq and dk, dv with
// P = exp(s - L) and dS = P (dP - Delta) recomputed, as flash_bwd.cu.
//
// Operands: contiguous (the wrapper makes them so), q, out, do, dq (B, S,
// HQ, D); k, v, dk, dv (B, Sk, KH, D); L and Delta (B, HQ, S) float32.  D
// is the op's head dim zero-padded (kernel.py:head_dim_plan) to a multiple
// of 16 in bfloat16 and of 4 in float32: the zero columns add nothing to
// the scores and their outputs are sliced off.
//
// The design: the head dim is cut into chunks (64 bfloat16 columns, one
// 128-byte swizzle row; 128 float32 columns), and every output is written
// in slices; each slice is a block of its own and recomputes the scores over
// the whole head dim:
//   forward, bfloat16, D <= 256: one launch, one slice, an online softmax
//     (flash_wgmma.cu's: m, l, O rescaled each key tile);
//   forward otherwise: two launches, each row's L (an online max and sum,
//     no V), then one block per (rows, slice of 256 bfloat16 or 128
//     float32 columns) with P = exp(s - L) from L and no rescale;
//   backward: Delta, then dk dv and dq, a block per (rows, slice: 128
//     columns of dk and dv, 256 of dq in bfloat16, 128 in float32).
// Products per head (S x Sk x D each, halved by `causal`): the bfloat16
// forward at D <= 256 three (S once, P V as bf16 hi + lo halves, as
// flash_wgmma.cu); above 256 with n = D / 256 slices 1 + n + 2 (L's
// scores, each slice's, P V); float32 with n = D / 128 slices 1 + n + 1.
// The bfloat16 backward: dq in slices of 256 columns, 2m + 1 with m =
// D / 256 (S and dP for each slice, dS K); dk dv in slices of 128, 2n + 2
// with n = D / 128: nine at D 256 where flash_bwd.cu does seven at D 128
// (dk and dv in slices of 256 would hold 256 accumulators a thread, over
// the 255 registers a thread may have).  The float32 backward: dq in
// slices of 128 too, 4n + 3.
//
// bfloat16, on wgmma fed by TMA (128-byte swizzle, boxes of 64 columns)
// through a ring of mbarrier stages, two warpgroups of 64 rows a block
// (256 threads leave each 255 registers: flash_bwd.cu's budget).  The
// warpgroups consume the same items; the one that releases a stage last
// refills it (thread 0 of its warpgroup issues the TMA), so neither waits
// for the other's release and each runs up to the ring's depth ahead.
// Each wait traps after two seconds.  A product is waited for before the
// ring's branches (ptxas serializes a wgmma in flight across a branch
// that can split a warpgroup), and none sits under such a branch: a
// warpgroup's rows that see none of a tile's keys compute it masked.
//   forward (flash_wide_fwd_wgmma_kernel): 128 query rows a block, key
//     tiles of 64; the block's Q tile stays in shared memory (D <= 512),
//     a key tile's K chunks (up to four, 32 KB) are an item and its V
//     slice another.  S = Q K^T is wgmma m64n64k16 from shared memory,
//     the online softmax runs on its fragments, P goes in as bf16 hi and
//     lo halves (flash_wgmma.cu's reason) from registers, and O += P V is
//     m64n128k16 over two V chunks at once, read through the descriptor's
//     transpose bit.  Above D 512 a Q chunk streams beside each K chunk.
//   backward (flash_wide_dq_wgmma_kernel, flash_wide_dkdv_wgmma_kernel):
//     dq: 128 query rows a block; dk dv: 128 keys; key or query tiles of
//     64.  Up to D 256 the block's own
//     operands stay in shared memory (dq: Q and dO; dk dv: K and V, 128
//     KB) and each tile of the other two is two items (32 KB each) whose
//     stages the products with dS and P read too; above, every chunk of
//     all four operands streams (48 KB items), then the slice's chunks.
//     S and dP (S^T and dP^T) are m64n64k16 from shared memory; P and dS
//     are rounded once to bf16 A fragments (flash_bwd.cu's choice,
//     modelled by attention_bwd_ref(..., operands=torch.bfloat16)), and
//     dQ, dK, dV take m64n128k16 products over two chunks at a time.
//   Why two operand paths (resident up to F_QRES_MAX / B_RES_MAX chunks,
//   streamed above): the streamed path alone (both limits 0) against the
//   resident one, B1 H8 causal bf16, device ms on an H100 80GB HBM3 at
//   700 W (tools/flash_wide_paths.py, outputs bitwise equal): forward D
//   256 / 320 / 512 0.152 / 0.136 / 0.197 streamed, 0.132 / 0.125 / 0.156
//   resident (D 160: 0.119 against 0.122); backward D 160 / 256 0.343 /
//   0.412 streamed, 0.309 / 0.355 resident.  A resident tile is read once
//   a block, where the streamed path reads it again every key tile.
//
// float32 (flash_wide_*_tf32_kernel): 128 threads, four warps of 16 rows;
// the block fills a two-stage ring of cp.async stages (rows padded to 132
// floats, so fragment loads are free of bank conflicts) with 128-column
// chunks, and every product is mma.sync m16n8k8 in 3xTF32 (hopper.cuh:
// split, mma; flash_tf32x3.cu's scheme).  Forward: 64 query rows a block,
// key tiles of 32; backward: 64 rows a block, tiles of 16 of the other
// operand.
//
// On the float32 route each key (or query) tile's products with P or dS,
// and each chunk's 3xTF32 scores, are summed in fresh accumulators and
// added on the CUDA cores: a float32 sum chained across many tiles on the
// tensor cores truncates one-signed (PERF.md), far inside float32's 1e-5
// checks only that way.  The bfloat16 route chains its sums on the
// tensor cores, as flash_wgmma.cu's O: its products are exact in float32,
// and the truncation (2^-23 a step) stays far below the bf16 rounding of
// every output (checked on the card against the float64 backward, row by
// row, as flash_bwd.cu).  Nothing is atomic and every
// sum runs in one fixed order, so two calls are bitwise equal.
//
// What bounds it on this card: 4 to 9 products of S x Sk x D per head
// (above) against a few bytes per score: the tensor cores.  What it pays
// besides: each warpgroup waits for its products before the softmax and
// before each ring release (no overlap of a tile's softmax with the next
// tile's products inside a warpgroup), the bf16 forward's P V in two
// halves, and the recomputed scores of each slice.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.69314718055994531f;
constexpr float NEG_INF = -1e30f;

enum Mode { ONLINE = 0, LSE = 1, SLICE = 2 };

__device__ __forceinline__ float2 to_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 to_f2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---------------------------------------------------------------------
// Delta of each query row: delta[(b HQ + h) S + i] = do_i . o_i
// grid ceil(B HQ S / DELTA_WARPS), a warp a row, lanes along D in a fixed
// order
constexpr int DELTA_WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(DELTA_WARPS * 32)
flash_wide_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                        float* __restrict__ delta, int S, int HQ, int D,
                        long long rows) {
  const long long row = (long long)blockIdx.x * DELTA_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long bh = row / S;
  const long long i = row % S;
  const long long b = bh / HQ, h = bh % HQ;
  const long long base = ((b * S + i) * HQ + h) * D;
  float acc = 0.f;
  for (int d = 2 * lane; d < D; d += 64) {  // D is even on both routes
    const float2 x = to_f2(dout + base + d), y = to_f2(o + base + d);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (lane == 0) delta[row] = acc;
}

// =====================================================================
// bfloat16: wgmma fed by TMA
constexpr int WG_THREADS = 256;  // two warpgroups, no producer warps
constexpr int ROW_BYTES = 128;   // one 64-column bf16 swizzle atom row
constexpr int ATOM = 64 * ROW_BYTES;  // a 64-row, 64-column box: 8 KB

// the bf16 A-operand registers of the four 16-column k-steps of a 64 x 64
// accumulator fragment (P or dS), converted in place
__device__ __forceinline__ void frag_to_a(const float (&x)[32],
                                          uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// S (+)= A B^T over one 64-column chunk: A (64 rows) and B (64 rows) both
// K-major 128-byte-swizzled in shared memory, four k-steps of 16
__device__ __forceinline__ void chunk_ss(float (&d)[32], uint32_t a,
                                         uint32_t b, bool acc) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64(d, desc_b128(a + kk * 32, 16, 1024),
                 desc_b128(b + kk * 32, 16, 1024), (acc || kk > 0) ? 1 : 0);
}

// D += A B over 64 keys (rows): A the bf16 registers of a 64 x 64
// fragment, B a 64-row, 64-column box read MN-major (16-row steps 2048
// bytes apart)
__device__ __forceinline__ void chunk_rs(float (&d)[32],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_n64_tb(d, a[kk],
                    desc_b128(b + kk * 16 * ROW_BYTES, ATOM, 1024));
}

// D += A B over 64 keys (rows) into two adjacent 64-column atoms of the
// output (d0: the first, d1: the second): one m64n128k16 a k-step, B two
// 64-row, 64-column boxes ATOM bytes apart read MN-major
__device__ __forceinline__ void wgmma_rs_n128_tb2(float (&d0)[32],
                                                 float (&d1)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]),
        "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]),
        "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]),
        "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]),
        "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]),
        "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]),
        "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The ring shared by the bf16 kernels: `stages` stages whose full
// barriers TMA completes, and a count of the releases of each stage.  A
// warpgroup releases item i once its products that read it are waited for
// (none is in flight across the branch below); the warpgroup that
// releases a stage last refills it with item i + stages, so no warpgroup
// waits for another's release (each runs up to the ring's depth ahead).
struct Ring {
  uint64_t* full;
  int* released;
  int stages;
  int consumers;  // warpgroups that release each item
  __device__ __forceinline__ void wait(int i) {
    mbar_wait_bounded(&full[i % stages], (i / stages) & 1);
  }
  template <typename Issue>
  __device__ __forceinline__ void release(int i, int total, Issue& issue) {
    if (threadIdx.x % 128 == 0) {
      const int s = i % stages;
      __threadfence_block();
      const int n = atomicAdd(&released[s], 1);
      __threadfence_block();
      if (n == consumers * (i / stages + 1) - 1 && i + stages < total)
        issue(i + stages);
    }
    __syncwarp();  // the warp converges before its next wgmma
  }
  __device__ __forceinline__ void init() {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
  }
};

// the shared-memory layout of a bf16 kernel: `res` bytes of resident
// operands, then as many stages of `stage` bytes as fit (at most `most`),
// then the barriers and release counts; the launcher allocates `alloc`
// bytes
struct Layout {
  int res, stage, stages, bar, alloc;
};
constexpr int SMEM_BLOCK = 232448;  // the most a block may use
__host__ __device__ inline Layout make_layout(int res, int stage, int most) {
  Layout L;
  L.res = res;
  L.stage = stage;
  L.stages = (SMEM_BLOCK - 1024 - 8 * (2 * most + 1) - res) / stage;
  if (L.stages > most) L.stages = most;
  L.bar = res + L.stages * stage;
  L.alloc = L.bar + 8 * (2 * L.stages + 1) + 1024;
  return L;
}

// ---- forward ----
constexpr int F_WGS = 2;                // warpgroups a block
constexpr int F_THREADS = 128 * F_WGS;  // 64 query rows a warpgroup
constexpr int F_BQ = 64 * F_WGS;        // query rows a block
constexpr int F_BK = 64;        // keys a tile
constexpr int F_QRES_MAX = 8;   // chunks of a resident Q tile (D <= 512)

// QRES: the block's Q tile (nc chunks of F_BQ rows) stays in shared
// memory; a key tile is one item of its K chunks (up to four, 32 KB), or
// two above four, and its V slice (up to four chunks) one more.  Else (D >
// 512) an item is one chunk of Q beside the same chunk of K, read again
// each key tile, and the V slice one more.
__host__ __device__ inline Layout fwd_layout(int nc) {
  return make_layout(nc <= F_QRES_MAX ? nc * F_WGS * ATOM : 0, 4 * ATOM, 6);
}

// P (bf16 A fragments) times the V slice's nv chunks of 64 columns (up to
// four, adjacent in a stage at st) into o: two atoms a product where they
// pair
__device__ __forceinline__ void pv_slice(float (&o)[4][32],
                                         const uint32_t (&p)[4][4],
                                         uint32_t st, int nv) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t b = st + kk * 16 * ROW_BYTES;
    if (nv >= 2)
      wgmma_rs_n128_tb2(o[0], o[1], p[kk], desc_b128(b, ATOM, 1024));
    else
      wgmma_rs_n64_tb(o[0], p[kk], desc_b128(b, ATOM, 1024));
    if (nv >= 4)
      wgmma_rs_n128_tb2(o[2], o[3], p[kk],
                        desc_b128(b + 2 * ATOM, ATOM, 1024));
    else if (nv == 3)
      wgmma_rs_n64_tb(o[2], p[kk], desc_b128(b + 2 * ATOM, ATOM, 1024));
  }
}

// dS (bf16 A fragments) times K's ns chunks of 64 columns (up to four,
// adjacent at st) into dq
__device__ __forceinline__ void dq_slice(float (&dq)[4][32],
                                         const uint32_t (&ds)[4][4],
                                         uint32_t st, int ns) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t b = st + kk * 16 * ROW_BYTES;
    if (ns >= 2)
      wgmma_rs_n128_tb2(dq[0], dq[1], ds[kk], desc_b128(b, ATOM, 1024));
    else
      wgmma_rs_n64_tb(dq[0], ds[kk], desc_b128(b, ATOM, 1024));
    if (ns >= 4)
      wgmma_rs_n128_tb2(dq[2], dq[3], ds[kk],
                        desc_b128(b + 2 * ATOM, ATOM, 1024));
    else if (ns == 3)
      wgmma_rs_n64_tb(dq[2], ds[kk], desc_b128(b + 2 * ATOM, ATOM, 1024));
  }
}

// grid (ceil(S / F_BQ), B * HQ, slices), F_THREADS threads.  MODE ONLINE
// (D <= 256: the whole output, L where lse is given), LSE (L only) or
// SLICE (output columns 256 z .. 256 z + 255 from the given L).
template <int MODE, bool QRES>
__global__ void __launch_bounds__(F_THREADS)
flash_wide_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            bf16* __restrict__ out, float* __restrict__ lse,
                            int HQ, int KH, int S, int Sk, int D, int causal,
                            float scale_log2) {
  const int nc = (D + 63) / 64;
  const Layout L = fwd_layout(nc);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ring_mem = smem + L.res;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  Ring ring{bars, reinterpret_cast<int*>(bars + L.stages), L.stages,
            F_WGS};
  uint64_t* q_full = bars + 2 * L.stages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / HQ, h = blockIdx.y % HQ;
  const int hk = h / (HQ / KH);
  const int q0 = qt * F_BQ;
  const int off = Sk - S;  // bottom-right alignment of the diagonal
  const int a0 = blockIdx.z * 4;  // this slice's first 64-column chunk
  const int nv = MODE == LSE ? 0 : min(4, nc - a0);
  const int n_s = QRES ? (nc + 3) / 4 : nc;  // score items a key tile
  const int per = n_s + (MODE == LSE ? 0 : 1);
  int k_end = Sk;
  if (causal) k_end = min(Sk, min(q0 + F_BQ, S) + off);
  const int n_kt = k_end > 0 ? (k_end + F_BK - 1) / F_BK : 0;
  const int total = n_kt * per;

  auto issue = [&](int i) {
    const int j = i / per, r = i % per;
    uint8_t* st = ring_mem + (i % L.stages) * L.stage;
    uint64_t* bar = &ring.full[i % L.stages];
    if (r < n_s) {
      if (QRES) {
        const int cn = min(4, nc - 4 * r);
        mbar_expect_tx(bar, cn * ATOM);
        for (int x = 0; x < cn; ++x)
          tma_load_4d(st + x * ATOM, &tk, bar, (4 * r + x) * 64, j * F_BK,
                      hk, b);
      } else {
        mbar_expect_tx(bar, (F_WGS + 1) * ATOM);
        tma_load_4d(st, &tq, bar, r * 64, q0, h, b);
        tma_load_4d(st + F_WGS * ATOM, &tk, bar, r * 64, j * F_BK, hk, b);
      }
    } else {
      mbar_expect_tx(bar, nv * ATOM);
      for (int a = 0; a < nv; ++a)
        tma_load_4d(st + a * ATOM, &tv, bar, (a0 + a) * 64, j * F_BK, hk, b);
    }
  };
  if (threadIdx.x == 0) {
    ring.init();
    mbar_init(q_full, 1);
    mbar_fence_init();
    if (QRES && total > 0) {
      mbar_expect_tx(q_full, nc * F_WGS * ATOM);
      for (int c = 0; c < nc; ++c)
        tma_load_4d(smem + c * F_WGS * ATOM, &tq, q_full, c * 64, q0, h, b);
    }
    for (int i = 0; i < min(L.stages, total); ++i) issue(i);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int wrow0 = q0 + wg * 64;  // this warpgroup's first row
  const int r0 = wrow0 + (tid / 32) * 16 + lane / 4;  // rows r0, r0 + 8
  const int r1 = r0 + 8;
  const int cq = (lane % 4) * 2;  // fragment column within an 8-block
  const uint32_t qbase = smem_u32(smem) + wg * ATOM;
  const uint32_t rbase = smem_u32(ring_mem);

  // SLICE: the rows' L in log2 units (+inf past S: P = 0)
  float lg0 = 0.f, lg1 = 0.f;
  if (MODE == SLICE) {
    lg0 = r0 < S ? lse[(size_t)blockIdx.y * S + r0] * LOG2E : INFINITY;
    lg1 = r1 < S ? lse[(size_t)blockIdx.y * S + r1] * LOG2E : INFINITY;
  }
  float o[4][32];
#pragma unroll
  for (int a = 0; a < 4; ++a) zero(o[a]);
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this lane's

  if (QRES && total > 0) mbar_wait_bounded(q_full, 0);

  // the scores' masks, then L's online max and sum (ONLINE, LSE) or P
  // from the given L (SLICE); ONLINE rescales O; P (not LSE) as two bf16
  // A fragments, hi and lo
  auto softmax = [&](float (&sc)[32], int k0, uint32_t (&p_hi)[4][4],
                     uint32_t (&p_lo)[4][4]) {
    // mask the ragged edge and the tiles that reach past the diagonal
    if (k0 + F_BK > Sk || (causal && k0 + F_BK - 1 > wrow0 + off)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int c = k0 + (e / 4) * 8 + cq + (e & 1);
        const int r = (e & 2) ? r1 : r0;
        if (c >= Sk || (causal && c > r + off)) sc[e] = -INFINITY;
      }
    }
    if (MODE == SLICE) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        sc[e] = exp2f(fmaf(sc[e], scale_log2, (e & 2) ? -lg1 : -lg0));
    } else {
      // online softmax on the fragments: a quad of lanes holds a row
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (e & 2) mx1 = fmaxf(mx1, sc[e]);
        else mx0 = fmaxf(mx0, sc[e]);
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
      for (int e = 0; e < 32; ++e) {
        if (e & 2) {
          sc[e] = exp2f(fmaf(sc[e], scale_log2, -ms1));  // -inf -> 0
          sum1 += sc[e];
        } else {
          sc[e] = exp2f(fmaf(sc[e], scale_log2, -ms0));
          sum0 += sc[e];
        }
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      if (MODE == ONLINE) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int e = 0; e < 32; ++e) o[a][e] *= (e & 2) ? al1 : al0;
          fence_regs(o[a]);  // rescaled before the next products' fence
        }
      }
    }
    if (MODE != LSE) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x0 = sc[8 * kk + 2 * e], x1 = sc[8 * kk + 2 * e + 1];
          __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hi);
          __nv_bfloat162 lo = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
          p_hi[kk][e] = *reinterpret_cast<uint32_t*>(&hi);
          p_lo[kk][e] = *reinterpret_cast<uint32_t*>(&lo);
        }
    }
  };
  // O[:, slice] += P V[:, slice] of key tile j (item i), accumulated on
  // the tensor cores as flash_wgmma.cu's O; committed, not waited
  auto pv = [&](int i, const uint32_t (&p_hi)[4][4],
                const uint32_t (&p_lo)[4][4]) {
    const uint32_t st = rbase + (i % L.stages) * L.stage;
    wgmma_fence();
    pv_slice(o, p_hi, st, nv);
    pv_slice(o, p_lo, st, nv);
    wgmma_commit();
  };

  // each key tile: its score items (QRES: one or two items of K chunks
  // against the resident Q; else one Q chunk beside one K chunk an item),
  // then its V item, each waited, used and released in turn: no product
  // is in flight across the ring's branches (a compiler-inserted wait
  // there would serialize the products)
  int it = 0;
  for (int j = 0; j < n_kt; ++j) {
    float sc[32];
    for (int r = 0; r < n_s; ++r, ++it) {
      ring.wait(it);
      const uint32_t st = rbase + (it % L.stages) * L.stage;
      wgmma_fence();
      if (QRES) {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (4 * r + x < nc)
            chunk_ss(sc, qbase + (4 * r + x) * F_WGS * ATOM, st + x * ATOM,
                     r + x > 0);
      } else {
        chunk_ss(sc, st + wg * ATOM, st + F_WGS * ATOM, r > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      ring.release(it, total, issue);
    }
    fence_regs(sc);
    uint32_t p_hi[4][4], p_lo[4][4];
    softmax(sc, j * F_BK, p_hi, p_lo);
    if (MODE != LSE) {
      ring.wait(it);
      pv(it, p_hi, p_lo);
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < 4; ++a) fence_regs(o[a]);
      ring.release(it, total, issue);
      ++it;
    }
  }

  if (MODE != SLICE) {
    // the row sums over the quad, in a fixed order
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  }
  const float d0 = MODE == ONLINE ? fmaxf(l0, 1e-30f) : 1.f;
  const float d1 = MODE == ONLINE ? fmaxf(l1, 1e-30f) : 1.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= S) continue;
    if (MODE != SLICE && lse != nullptr && lane % 4 == 0) {
      const float l = half ? l1 : l0, m = half ? m1 : m0;
      lse[(size_t)blockIdx.y * S + r] =
          l > 0.f ? (m * scale_log2 + log2f(l)) * LN2 : INFINITY;
    }
    if (MODE != LSE) {
      const float dn = half ? d1 : d0;
      bf16* orow = out + (((size_t)b * S + r) * HQ + h) * (size_t)D;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (a >= nv) continue;
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int c = (a0 + a) * 64 + n8 * 8 + cq;
          if (c < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                __floats2bfloat162_rn(o[a][n8 * 4 + half * 2] / dn,
                                      o[a][n8 * 4 + half * 2 + 1] / dn);
        }
      }
    }
  }
}

// ---- backward ----
constexpr int B_RES_MAX = 4;  // chunks of the resident operands (D <= 256)

// RES (D <= 256): the block's own operands (dq: Q and dO of its 128 rows;
// dk dv: K and V of its 128 keys) stay in shared memory, and each tile of
// the other operands is two items (dq: K, then V; dk dv: Q, then dO) of
// its nc chunks (32 KB at most); the products with dS and P read the
// same stages.  Else every chunk streams through 48 KB stages: the nc
// chunks of all four operands, then the slice's chunks.
__host__ __device__ inline Layout bwd_layout(bool res) {
  return res ? make_layout(B_RES_MAX * 4 * ATOM, 4 * ATOM, 4)
             : make_layout(0, 6 * ATOM, 4);
}

// dq: 128 query rows a block (64 a warpgroup), key tiles of 64, dq columns
// 128 z .. 128 z + 127.  grid (B * HQ, ceil(S / 128), slices), WG_THREADS
// threads
template <bool RES>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wide_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq, int S, int Sk, int HQ,
                           int KH, int D, int causal, float scale_log2,
                           float scale) {
  const Layout L = bwd_layout(RES);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ring_mem = smem + L.res;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  Ring ring{bars, reinterpret_cast<int*>(bars + L.stages), L.stages, 2};
  uint64_t* res_full = bars + 2 * L.stages;

  // the last query tile sees the most keys under `causal`: the grid's
  // slow axis is the query tile, last first
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / HQ, h = bh % HQ;
  const int hk = h / (HQ / KH);
  const int q0 = qt * 128;
  const int off = Sk - S;
  const int nc = (D + 63) / 64;
  const int a0 = blockIdx.z * 4;  // this slice's first 64-column chunk
  const int ns = min(4, nc - a0);
  const int per = RES ? 2 : nc + ns;  // items a key tile
  int k_end = Sk;
  if (causal) k_end = min(Sk, min(q0 + 128, S) + off);
  const int n_kt = k_end > 0 ? (k_end + 63) / 64 : 0;
  const int total = n_kt * per;

  auto issue = [&](int i) {
    const int j = i / per, r = i % per;
    uint8_t* st = ring_mem + (i % L.stages) * L.stage;
    uint64_t* bar = &ring.full[i % L.stages];
    if (RES) {
      const CUtensorMap* m = r == 0 ? &tk : &tv;
      mbar_expect_tx(bar, nc * ATOM);
      for (int c = 0; c < nc; ++c)
        tma_load_4d(st + c * ATOM, m, bar, c * 64, j * 64, hk, b);
    } else if (r < nc) {
      mbar_expect_tx(bar, 6 * ATOM);
      tma_load_4d(st, &tq, bar, r * 64, q0, h, b);
      tma_load_4d(st + 2 * ATOM, &tdo, bar, r * 64, q0, h, b);
      tma_load_4d(st + 4 * ATOM, &tk, bar, r * 64, j * 64, hk, b);
      tma_load_4d(st + 5 * ATOM, &tv, bar, r * 64, j * 64, hk, b);
    } else {
      mbar_expect_tx(bar, ATOM);
      tma_load_4d(st, &tk, bar, (a0 + r - nc) * 64, j * 64, hk, b);
    }
  };
  if (threadIdx.x == 0) {
    ring.init();
    mbar_init(res_full, 1);
    mbar_fence_init();
    if (RES && total > 0) {
      mbar_expect_tx(res_full, nc * 4 * ATOM);
      for (int c = 0; c < nc; ++c) {
        tma_load_4d(smem + c * 2 * ATOM, &tq, res_full, c * 64, q0, h, b);
        tma_load_4d(smem + (B_RES_MAX + c) * 2 * ATOM, &tdo, res_full,
                    c * 64, q0, h, b);
      }
    }
    for (int i = 0; i < min(L.stages, total); ++i) issue(i);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int wrow0 = q0 + wg * 64;
  const int r0 = wrow0 + (tid / 32) * 16 + lane / 4;  // rows r0, r0 + 8
  const int r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  // L (log2 units) and Delta of the rows: +inf, 0 past S
  const float L0 = r0 < S ? lse[(size_t)bh * S + r0] * LOG2E : INFINITY;
  const float L1 = r1 < S ? lse[(size_t)bh * S + r1] * LOG2E : INFINITY;
  const float D0 = r0 < S ? delta[(size_t)bh * S + r0] : 0.f;
  const float D1 = r1 < S ? delta[(size_t)bh * S + r1] : 0.f;
  const uint32_t qres = smem_u32(smem) + wg * ATOM;
  const uint32_t dores = qres + B_RES_MAX * 2 * ATOM;
  const uint32_t rbase = smem_u32(ring_mem);

  float dqa[4][32];
#pragma unroll
  for (int a = 0; a < 4; ++a) zero(dqa[a]);
  if (RES && total > 0) mbar_wait_bounded(res_full, 0);
  int it = 0;
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * 64;
    // S = Q K^T and dP = dO V^T over the head dim (every warpgroup issues
    // every product; the masks zero what its rows do not see)
    float sc[32], dp[32];
    uint32_t sk = 0;  // RES: the stage of this tile's K
    if (RES) {
      ring.wait(it);
      sk = rbase + (it % L.stages) * L.stage;
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < B_RES_MAX; ++c)
        if (c < nc) chunk_ss(sc, qres + c * 2 * ATOM, sk + c * ATOM, c > 0);
      wgmma_commit();
      ring.wait(it + 1);
      const uint32_t sv = rbase + ((it + 1) % L.stages) * L.stage;
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < B_RES_MAX; ++c)
        if (c < nc) chunk_ss(dp, dores + c * 2 * ATOM, sv + c * ATOM, c > 0);
      wgmma_commit();
      wgmma_wait<0>();
      ring.release(it + 1, total, issue);
    } else {
      for (int c = 0; c < nc; ++c, ++it) {
        ring.wait(it);
        const uint32_t st = rbase + (it % L.stages) * L.stage;
        wgmma_fence();
        chunk_ss(sc, st + wg * ATOM, st + 4 * ATOM, c > 0);
        chunk_ss(dp, st + 2 * ATOM + wg * ATOM, st + 5 * ATOM, c > 0);
        wgmma_commit();
        wgmma_wait<0>();
        ring.release(it, total, issue);
      }
    }
    fence_regs(sc);
    fence_regs(dp);
    uint32_t sa[4][4];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int c = k0 + (e / 4) * 8 + cq + (e & 1);
      const int r = (e & 2) ? r1 : r0;
      const bool ok = c < Sk && (!causal || c <= r + off);
      const float p =
          ok ? exp2f(fmaf(sc[e], scale_log2, (e & 2) ? -L1 : -L0)) : 0.f;
      dp[e] = p * (dp[e] - ((e & 2) ? D1 : D0));
    }
    frag_to_a(dp, sa);
    // dQ[:, slice] += dS K[:, slice], accumulated on the tensor cores
    // (bf16 products, a bf16 output: as the forward's O)
    if (RES) {
      wgmma_fence();
      dq_slice(dqa, sa, sk + a0 * ATOM, ns);
      wgmma_commit();
      wgmma_wait<0>();
      ring.release(it, total, issue);
      it += 2;
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (a < ns) {
          ring.wait(it);
          const uint32_t st = rbase + (it % L.stages) * L.stage;
          wgmma_fence();
          chunk_rs(dqa[a], sa, st);
          wgmma_commit();
          wgmma_wait<0>();
          ring.release(it, total, issue);
          ++it;
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) fence_regs(dqa[a]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= S) continue;
    bf16* row = dq + (((size_t)b * S + r) * HQ + h) * (size_t)D;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (a >= ns) continue;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int c = (a0 + a) * 64 + n8 * 8 + cq;
        if (c < D) {
          const int x = n8 * 4 + half * 2;
          *reinterpret_cast<__nv_bfloat162*>(row + c) =
              __floats2bfloat162_rn(dqa[a][x] * scale,
                                    dqa[a][x + 1] * scale);
        }
      }
    }
  }
}

// dk dv: 128 keys a block (64 a warpgroup), query tiles of 64 rows of
// every head of the group, dk and dv columns 128 z .. 128 z + 127.
// grid (B * KH, ceil(Sk / 128), slices), WG_THREADS threads
template <bool RES>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wide_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int S, int Sk, int HQ, int KH, int D, int causal,
                             float scale_log2, float scale) {
  const Layout L = bwd_layout(RES);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ring_mem = smem + L.res;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  Ring ring{bars, reinterpret_cast<int*>(bars + L.stages), L.stages, 2};
  uint64_t* res_full = bars + 2 * L.stages;

  // key tile 0 sees the most query rows under `causal`: the grid's slow
  // axis is the key tile, so every head's first tile is launched first
  const int b = blockIdx.x / KH, hk = blockIdx.x % KH;
  const int group = HQ / KH;
  const int k0 = blockIdx.y * 128;
  const int off = Sk - S;
  const int nc = (D + 63) / 64;
  const int a0 = blockIdx.z * 2;
  const int ns = min(2, nc - a0);
  const int per = RES ? 2 : nc + ns;  // items a query tile
  // the query tiles whose rows see key k0, for each head of the group
  const int q_first = causal ? max(0, k0 - off) : 0;
  const int qt_first = q_first / 64;
  const int nq = max((S + 63) / 64 - qt_first, 0);
  const int total = group * nq * per;

  auto issue = [&](int i) {
    const int t = i / per, r = i % per;
    const int h = hk * group + t / nq;
    const int q0 = (qt_first + t % nq) * 64;
    uint8_t* st = ring_mem + (i % L.stages) * L.stage;
    uint64_t* bar = &ring.full[i % L.stages];
    if (RES) {
      const CUtensorMap* m = r == 0 ? &tq : &tdo;
      mbar_expect_tx(bar, nc * ATOM);
      for (int c = 0; c < nc; ++c)
        tma_load_4d(st + c * ATOM, m, bar, c * 64, q0, h, b);
    } else if (r < nc) {
      mbar_expect_tx(bar, 6 * ATOM);
      tma_load_4d(st, &tk, bar, r * 64, k0, hk, b);
      tma_load_4d(st + 2 * ATOM, &tv, bar, r * 64, k0, hk, b);
      tma_load_4d(st + 4 * ATOM, &tq, bar, r * 64, q0, h, b);
      tma_load_4d(st + 5 * ATOM, &tdo, bar, r * 64, q0, h, b);
    } else {
      mbar_expect_tx(bar, 2 * ATOM);
      tma_load_4d(st, &tq, bar, (a0 + r - nc) * 64, q0, h, b);
      tma_load_4d(st + ATOM, &tdo, bar, (a0 + r - nc) * 64, q0, h, b);
    }
  };
  if (threadIdx.x == 0) {
    ring.init();
    mbar_init(res_full, 1);
    mbar_fence_init();
    if (RES && total > 0) {
      mbar_expect_tx(res_full, nc * 4 * ATOM);
      for (int c = 0; c < nc; ++c) {
        tma_load_4d(smem + c * 2 * ATOM, &tk, res_full, c * 64, k0, hk, b);
        tma_load_4d(smem + (B_RES_MAX + c) * 2 * ATOM, &tv, res_full,
                    c * 64, k0, hk, b);
      }
    }
    for (int i = 0; i < min(L.stages, total); ++i) issue(i);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int kw0 = k0 + wg * 64;                     // this warpgroup's keys
  const int j0 = kw0 + (tid / 32) * 16 + lane / 4;  // keys j0, j0 + 8
  const int j1 = j0 + 8;
  const int cq = (lane % 4) * 2;
  const uint32_t kres = smem_u32(smem) + wg * ATOM;
  const uint32_t vres = kres + B_RES_MAX * 2 * ATOM;
  const uint32_t rbase = smem_u32(ring_mem);

  float dka[2][32], dva[2][32];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    zero(dka[a]);
    zero(dva[a]);
  }
  if (RES && total > 0) mbar_wait_bounded(res_full, 0);
  int it = 0;
  for (int t = 0; t < group * nq; ++t) {
    const int h = hk * group + t / nq;
    const int q0 = (qt_first + t % nq) * 64;
    // S^T = K Q^T and dP^T = V dO^T over the head dim
    float st_[32], dpt[32];
    uint32_t sq = 0, so = 0;  // RES: the stages of this tile's Q and dO
    if (RES) {
      ring.wait(it);
      sq = rbase + (it % L.stages) * L.stage;
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < B_RES_MAX; ++c)
        if (c < nc) chunk_ss(st_, kres + c * 2 * ATOM, sq + c * ATOM, c > 0);
      wgmma_commit();
      ring.wait(it + 1);
      so = rbase + ((it + 1) % L.stages) * L.stage;
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < B_RES_MAX; ++c)
        if (c < nc) chunk_ss(dpt, vres + c * 2 * ATOM, so + c * ATOM, c > 0);
      wgmma_commit();
      wgmma_wait<0>();
    } else {
      for (int c = 0; c < nc; ++c, ++it) {
        ring.wait(it);
        const uint32_t st = rbase + (it % L.stages) * L.stage;
        wgmma_fence();
        chunk_ss(st_, st + wg * ATOM, st + 4 * ATOM, c > 0);
        chunk_ss(dpt, st + 2 * ATOM + wg * ATOM, st + 5 * ATOM, c > 0);
        wgmma_commit();
        wgmma_wait<0>();
        ring.release(it, total, issue);
      }
    }
    fence_regs(st_);
    fence_regs(dpt);
    // P^T and dS^T, masked: columns are query rows i, fragment rows keys
    // j; each thread's 16 columns read their L and Delta once
    uint32_t pa[4][4], sa[4][4];
    const size_t lrow = ((size_t)b * HQ + h) * S;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i = q0 + n8 * 8 + cq + x;
        const float Li = i < S ? lse[lrow + i] * LOG2E : INFINITY;
        const float Di = i < S ? delta[lrow + i] : 0.f;
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int e = n8 * 4 + y * 2 + x;
          const int j = y ? j1 : j0;
          const bool ok = i < S && j < Sk && (!causal || j <= i + off);
          const float p = ok ? exp2f(fmaf(st_[e], scale_log2, -Li)) : 0.f;
          st_[e] = p;
          dpt[e] = p * (dpt[e] - Di);
        }
      }
    frag_to_a(st_, pa);
    frag_to_a(dpt, sa);
    // dV[:, slice] += P^T dO[:, slice] and dK[:, slice] += dS^T Q[:,
    // slice], accumulated on the tensor cores (bf16 products, bf16
    // outputs: as the forward's O)
    if (RES) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t bo = so + a0 * ATOM + kk * 16 * ROW_BYTES;
        const uint32_t bq = sq + a0 * ATOM + kk * 16 * ROW_BYTES;
        if (ns == 2) {
          wgmma_rs_n128_tb2(dva[0], dva[1], pa[kk],
                            desc_b128(bo, ATOM, 1024));
          wgmma_rs_n128_tb2(dka[0], dka[1], sa[kk],
                            desc_b128(bq, ATOM, 1024));
        } else {
          wgmma_rs_n64_tb(dva[0], pa[kk], desc_b128(bo, ATOM, 1024));
          wgmma_rs_n64_tb(dka[0], sa[kk], desc_b128(bq, ATOM, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      ring.release(it, total, issue);
      ring.release(it + 1, total, issue);
      it += 2;
    } else {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        if (a < ns) {
          ring.wait(it);
          const uint32_t st = rbase + (it % L.stages) * L.stage;
          wgmma_fence();
          chunk_rs(dva[a], pa, st + ATOM);
          chunk_rs(dka[a], sa, st);
          wgmma_commit();
          wgmma_wait<0>();
          ring.release(it, total, issue);
          ++it;
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      fence_regs(dva[a]);
      fence_regs(dka[a]);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = half ? j1 : j0;
    if (j >= Sk) continue;
    const size_t row = (((size_t)b * Sk + j) * KH + hk) * (size_t)D;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (a >= ns) continue;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int c = (a0 + a) * 64 + n8 * 8 + cq;
        if (c < D) {
          const int x = n8 * 4 + half * 2;
          *reinterpret_cast<__nv_bfloat162*>(dk + row + c) =
              __floats2bfloat162_rn(dka[a][x] * scale,
                                    dka[a][x + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + row + c) =
              __floats2bfloat162_rn(dva[a][x], dva[a][x + 1]);
        }
      }
    }
  }
}

// =====================================================================
// float32: mma.sync in 3xTF32, a block-wide cp.async ring
constexpr int T_THREADS = 128;  // 4 warps of 16 rows
constexpr int CW = 128;         // columns of a chunk (512 bytes)
constexpr int LDF = CW + 4;     // floats of a chunk row in shared memory
constexpr int ND = CW / 8;      // 8-column tiles of a chunk
constexpr int SLC = 128 / CW;   // chunks of an output slice (128 columns)
constexpr int T_STAGES = 2;

// The A operand of a 16 x 16 (rows x depth) product step and the B operand
// of a 16 x 8 (depth x cols) one, for thread (g, t) = (lane / 4, lane % 4):
// flash_bwd.cu's fragments (m16n8k16's layout; the two m16n8k8 steps take
// depth t from 2t and t + 4 from 2t + 1).
struct FragA {
  float x[8];
};
struct FragB {
  float x[4];
};

// C of a 16 x 8 product: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1), as
// hi.hi, lo.hi and hi.lo sums
struct Acc {
  float c[4], s1[4], s2[4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = s1[e] = s2[e] = 0.f;
  }
  __device__ __forceinline__ float get(int e) const {
    return c[e] + (s1[e] + s2[e]);
  }
};

__device__ __forceinline__ void mma16(Acc& d, const FragA& a,
                                      const FragB& b) {
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

// A from rows r0 .. r0+15 and depth columns c0 .. c0+15 of X
__device__ __forceinline__ void load_a(FragA& a, const float* X, int r0,
                                       int c0, int g, int t) {
  const float* p = X + (r0 + g) * LDF + c0 + 2 * t;
  const float2 u0 = *reinterpret_cast<const float2*>(p);
  const float2 u1 = *reinterpret_cast<const float2*>(p + 8 * LDF);
  const float2 u2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 u3 = *reinterpret_cast<const float2*>(p + 8 * LDF + 8);
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
// X are the product's columns
__device__ __forceinline__ void load_b_rows(FragB& b, const float* X, int n0,
                                            int k0, int g, int t) {
  const float* p = X + (n0 + g) * LDF + k0 + 2 * t;
  const float2 u0 = *reinterpret_cast<const float2*>(p);
  const float2 u1 = *reinterpret_cast<const float2*>(p + 8);
  b.x[0] = u0.x;
  b.x[1] = u0.y;
  b.x[2] = u1.x;
  b.x[3] = u1.y;
}

// B whose element (kk, n) is X[k0 + kk][n0 + n]: the rows of X are the
// product's depth
__device__ __forceinline__ void load_b_cols(FragB& b, const float* X, int k0,
                                            int n0, int g, int t) {
  const float* p = X + (k0 + 2 * t) * LDF + n0 + g;
  b.x[0] = p[0];
  b.x[1] = p[LDF];
  b.x[2] = p[8 * LDF];
  b.x[3] = p[9 * LDF];
}

// A from two C tiles in registers (columns 16m .. 16m+7 and 16m+8 ..
// 16m+15 of a product): the C layout is the A layout
__device__ __forceinline__ void a_from_c(FragA& a, const float (&lo)[4],
                                         const float (&hi)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    a.x[e] = lo[e];
    a.x[4 + e] = hi[e];
  }
}

// issue the copy of chunk `col0 / CW` of rows r_begin .. r_begin + nrows
// of a (row stride `stride` elements) into dst by cp.async, rows >= rmax
// and columns >= D zero-filled; the whole block takes part
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           long long stride, int r_begin,
                                           int nrows, int rmax, int col0,
                                           int D) {
  constexpr int CH = CW / 4;  // 16-byte pieces of a chunk row
  for (int e = threadIdx.x; e < nrows * CH; e += T_THREADS) {
    const int r = e / CH, c = col0 + 4 * (e % CH);
    const bool ok = r_begin + r < rmax && c < D;
    cp_async<16>(dst + r * LDF + (c - col0),
                 ok ? src + (long long)(r_begin + r) * stride + c : src,
                 ok ? 16 : 0);
  }
}

// the ring of the float32 kernels: issue(i) fills stage i % T_STAGES;
// ring_start issues the first T_STAGES - 1 items, ring_begin(i) issues
// item i + T_STAGES - 1 and waits for item i; the __syncthreads after each
// item keeps its stage from being refilled while a warp still reads it
template <typename Issue>
__device__ __forceinline__ void ring_begin(int i, int total, Issue& issue) {
  if (i + T_STAGES - 1 < total) issue(i + T_STAGES - 1);
  cp_async_commit();
  cp_async_wait<T_STAGES - 1>();
  __syncthreads();
}
template <typename Issue>
__device__ __forceinline__ void ring_start(int total, Issue& issue) {
  for (int s = 0; s < T_STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }
}

// ---- forward ----
constexpr int TF_BQ = 64;   // query rows a block
constexpr int TF_BK = 32;   // keys a tile
constexpr int TF_NT = TF_BK / 8;
constexpr int TF_STAGE = (TF_BQ + TF_BK) * LDF;  // floats: Q chunk, K chunk

// grid (ceil(S / TF_BQ), B * HQ, slices), T_THREADS threads.  MODE LSE (L
// only) or SLICE (output columns 128 z .. 128 z + 127 from the given L).
template <int MODE>
__global__ void __launch_bounds__(T_THREADS)
flash_wide_fwd_tf32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, float* __restrict__ lse,
                           int HQ, int KH, int S, int Sk, int D, int causal,
                           float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / HQ, h = blockIdx.y % HQ;
  const int hk = h / (HQ / KH);
  const int q0 = qt * TF_BQ;
  const int off = Sk - S;
  const int nc = (D + CW - 1) / CW;
  const int a0 = blockIdx.z * SLC;  // this slice's first chunk
  const int nv = MODE == LSE ? 0 : min(SLC, nc - a0);
  const int per = nc + nv;
  const int q_last = min(q0 + TF_BQ, S) - 1;
  const int k_end = causal ? min(Sk, q_last + off + 1) : Sk;
  const int n_kt = k_end > 0 ? (k_end + TF_BK - 1) / TF_BK : 0;
  const int total = n_kt * per;
  const long long qs = (long long)HQ * D, ks = (long long)KH * D;
  const float* qb = q + (long long)b * S * qs + (long long)h * D;
  const float* kb = k + (long long)b * Sk * ks + (long long)hk * D;
  const float* vb = v + (long long)b * Sk * ks + (long long)hk * D;

  auto issue = [&](int i) {
    float* st = ring + (i % T_STAGES) * TF_STAGE;
    const int j = i / per, r = i % per;
    if (r < nc) {
      load_chunk(st, qb, qs, q0, TF_BQ, S, r * CW, D);
      load_chunk(st + TF_BQ * LDF, kb, ks, j * TF_BK, TF_BK, Sk, r * CW, D);
    } else {
      load_chunk(st, vb, ks, j * TF_BK, TF_BK, Sk, (a0 + r - nc) * CW, D);
    }
  };

  const bool active = q0 + 16 * warp < S;
  const int w_last = min(q0 + 16 * warp + 15, S - 1);
  const int w_end = causal ? min(Sk, w_last + off + 1) : Sk;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  float L0 = 0.f, L1 = 0.f;
  if (MODE == SLICE) {
    L0 = r0 < S ? lse[(long long)blockIdx.y * S + r0] : INFINITY;
    L1 = r1 < S ? lse[(long long)blockIdx.y * S + r1] : INFINITY;
  }
  float o[16][4];
#pragma unroll
  for (int x = 0; x < 16; ++x) zero(o[x]);
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  ring_start(total, issue);
  int it = 0;
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * TF_BK;
    const bool on = active && k0 < w_end;
    float sacc[TF_NT][4];
#pragma unroll
    for (int n = 0; n < TF_NT; ++n) zero(sacc[n]);
    for (int c = 0; c < nc; ++c, ++it) {
      ring_begin(it, total, issue);
      if (on) {
        const float* Qs = ring + (it % T_STAGES) * TF_STAGE;
        const float* Ks = Qs + TF_BQ * LDF;
        Acc s[TF_NT];
#pragma unroll
        for (int n = 0; n < TF_NT; ++n) s[n].zero();
#pragma unroll
        for (int kk = 0; kk < CW; kk += 16) {
          FragA aq;
          load_a(aq, Qs, 16 * warp, kk, g, t);
#pragma unroll
          for (int n = 0; n < TF_NT; ++n) {
            FragB bk;
            load_b_rows(bk, Ks, 8 * n, kk, g, t);
            mma16(s[n], aq, bk);
          }
        }
#pragma unroll
        for (int n = 0; n < TF_NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[n][e] += s[n].get(e);
      }
      __syncthreads();
    }
    // the scaled, masked scores; then L's online max and sum, or P
    FragA pa[TF_NT / 2];
    if (on) {
      float p[TF_NT][4];
#pragma unroll
      for (int n = 0; n < TF_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + 8 * n + 2 * t + (e & 1);
          const int r = e < 2 ? r0 : r1;
          const bool ok = c < Sk && (!causal || c <= r + off);
          p[n][e] = ok ? sacc[n][e] * scale : -INFINITY;
        }
      if (MODE == LSE) {
        float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
        for (int n = 0; n < TF_NT; ++n) {
          mx0 = fmaxf(mx0, fmaxf(p[n][0], p[n][1]));
          mx1 = fmaxf(mx1, fmaxf(p[n][2], p[n][3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int n = 0; n < TF_NT; ++n) {
          sum0 += expf(p[n][0] - mn0) + expf(p[n][1] - mn0);  // -inf -> 0
          sum1 += expf(p[n][2] - mn1) + expf(p[n][3] - mn1);
        }
        l0 = l0 * expf(m0 - mn0) + sum0;
        l1 = l1 * expf(m1 - mn1) + sum1;
        m0 = mn0;
        m1 = mn1;
      } else {
#pragma unroll
        for (int n = 0; n < TF_NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[n][e] = expf(p[n][e] - (e < 2 ? L0 : L1));  // -inf -> 0
#pragma unroll
        for (int m = 0; m < TF_NT / 2; ++m)
          a_from_c(pa[m], p[2 * m], p[2 * m + 1]);
      }
    }
    if constexpr (MODE == SLICE) {
      // O[:, chunk a] += P V[:, chunk a], each 8-column tile over this
      // key tile in fresh accumulators, added on the CUDA cores
#pragma unroll
      for (int a = 0; a < SLC; ++a) {
        if (a < nv) {
          ring_begin(it, total, issue);
          if (on) {
            const float* Vs = ring + (it % T_STAGES) * TF_STAGE;
#pragma unroll
            for (int nd = 0; nd < ND; ++nd) {
              Acc cv;
              cv.zero();
#pragma unroll
              for (int m = 0; m < TF_NT / 2; ++m) {
                FragB bv;
                load_b_cols(bv, Vs, 16 * m, 8 * nd, g, t);
                mma16(cv, pa[m], bv);
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) o[ND * a + nd][e] += cv.get(e);
            }
          }
          __syncthreads();
          ++it;
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  if (MODE == LSE) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= S) continue;
    if (MODE == LSE) {
      if (t == 0) {
        const float l = half ? l1 : l0;
        lse[(long long)blockIdx.y * S + r] =
            l > 0.f ? (half ? m1 : m0) + logf(l) : INFINITY;
      }
    } else {
      float* orow = out + (((long long)b * S + r) * HQ + h) * D;
#pragma unroll
      for (int a = 0; a < SLC; ++a) {
        if (a >= nv) continue;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const int c = (a0 + a) * CW + 8 * nd + 2 * t;
          if (c < D)
            *reinterpret_cast<float2*>(orow + c) = make_float2(
                o[ND * a + nd][2 * half], o[ND * a + nd][2 * half + 1]);
        }
      }
    }
  }
}

// ---- backward ----
constexpr int TB_ROWS = 64;  // rows a block owns (16 a warp)
constexpr int TB_TILE = 16;  // rows of the other operand's tile
constexpr int TB_STAGE = (2 * TB_ROWS + 2 * TB_TILE) * LDF;

// dq: 64 query rows a block, key tiles of 16, dq columns 128 z .. 128 z +
// 127.  Items of a key tile: the nc chunks of (Q, dO, K, V), then the
// slice's chunks of K.  grid (ceil(S / 64), B * HQ, slices)
__global__ void __launch_bounds__(T_THREADS)
flash_wide_dq_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq, int S, int Sk, int HQ,
                          int KH, int D, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / HQ, h = bh % HQ;
  const int hk = h / (HQ / KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TB_ROWS;  // heaviest first
  const int off = Sk - S;
  const int nc = (D + CW - 1) / CW;
  const int a0 = blockIdx.z * SLC;
  const int ns = min(SLC, nc - a0);
  const int per = nc + ns;
  const int q_last = min(q0 + TB_ROWS, S) - 1;
  const int k_end = causal ? min(Sk, q_last + off + 1) : Sk;
  const int n_kt = k_end > 0 ? (k_end + TB_TILE - 1) / TB_TILE : 0;
  const int total = n_kt * per;
  const long long qs = (long long)HQ * D, ks = (long long)KH * D;
  const float* qb = q + (long long)b * S * qs + (long long)h * D;
  const float* ob = dout + (long long)b * S * qs + (long long)h * D;
  const float* kb = k + (long long)b * Sk * ks + (long long)hk * D;
  const float* vb = v + (long long)b * Sk * ks + (long long)hk * D;

  auto issue = [&](int i) {
    float* st = ring + (i % T_STAGES) * TB_STAGE;
    const int j = i / per, r = i % per;
    if (r < nc) {
      load_chunk(st, qb, qs, q0, TB_ROWS, S, r * CW, D);
      load_chunk(st + TB_ROWS * LDF, ob, qs, q0, TB_ROWS, S, r * CW, D);
      load_chunk(st + 2 * TB_ROWS * LDF, kb, ks, j * TB_TILE, TB_TILE, Sk,
                 r * CW, D);
      load_chunk(st + (2 * TB_ROWS + TB_TILE) * LDF, vb, ks, j * TB_TILE,
                 TB_TILE, Sk, r * CW, D);
    } else {
      load_chunk(st, kb, ks, j * TB_TILE, TB_TILE, Sk, (a0 + r - nc) * CW, D);
    }
  };

  const bool active = q0 + 16 * warp < S;
  const int w_last = min(q0 + 16 * warp + 15, S - 1);
  const int w_end = causal ? min(Sk, w_last + off + 1) : Sk;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  const float L0 = r0 < S ? lse[(long long)bh * S + r0] : INFINITY;
  const float L1 = r1 < S ? lse[(long long)bh * S + r1] : INFINITY;
  const float D0 = r0 < S ? delta[(long long)bh * S + r0] : 0.f;
  const float D1 = r1 < S ? delta[(long long)bh * S + r1] : 0.f;

  float dqa[16][4];
#pragma unroll
  for (int x = 0; x < 16; ++x) zero(dqa[x]);

  ring_start(total, issue);
  int it = 0;
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * TB_TILE;
    const bool on = active && k0 < w_end;
    float sacc[2][4], dacc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      zero(sacc[n]);
      zero(dacc[n]);
    }
    // S = Q K^T and dP = dO V^T, chunk by chunk
    for (int c = 0; c < nc; ++c, ++it) {
      ring_begin(it, total, issue);
      if (on) {
        const float* Qs = ring + (it % T_STAGES) * TB_STAGE;
        const float* Os = Qs + TB_ROWS * LDF;
        const float* Ks = Os + TB_ROWS * LDF;
        const float* Vs = Ks + TB_TILE * LDF;
        Acc s[2], dp[2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          s[n].zero();
          dp[n].zero();
        }
#pragma unroll
        for (int kk = 0; kk < CW; kk += 16) {
          FragA aq, ao;
          load_a(aq, Qs, 16 * warp, kk, g, t);
          load_a(ao, Os, 16 * warp, kk, g, t);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            FragB bk, bv;
            load_b_rows(bk, Ks, 8 * n, kk, g, t);
            mma16(s[n], aq, bk);
            load_b_rows(bv, Vs, 8 * n, kk, g, t);
            mma16(dp[n], ao, bv);
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sacc[n][e] += s[n].get(e);
            dacc[n][e] += dp[n].get(e);
          }
      }
      __syncthreads();
    }
    FragA sa;
    if (on) {
      float ds[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = k0 + 8 * n + 2 * t + (e & 1);
          const int i = e < 2 ? r0 : r1;
          const bool ok = i < S && jj < Sk && (!causal || jj <= i + off);
          const float p =
              ok ? expf(sacc[n][e] * scale - (e < 2 ? L0 : L1)) : 0.f;
          ds[n][e] = p * (dacc[n][e] - (e < 2 ? D0 : D1));
        }
      a_from_c(sa, ds[0], ds[1]);
    }
    // dQ[:, chunk a] += dS K[:, chunk a], each 8-column tile over this key
    // tile in fresh accumulators
#pragma unroll
    for (int a = 0; a < SLC; ++a) {
      if (a < ns) {
        ring_begin(it, total, issue);
        if (on) {
          const float* Ks = ring + (it % T_STAGES) * TB_STAGE;
#pragma unroll
          for (int nd = 0; nd < ND; ++nd) {
            Acc cc;
            cc.zero();
            FragB bk;
            load_b_cols(bk, Ks, 0, 8 * nd, g, t);
            mma16(cc, sa, bk);
#pragma unroll
            for (int e = 0; e < 4; ++e) dqa[ND * a + nd][e] += cc.get(e);
          }
        }
        __syncthreads();
        ++it;
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? r1 : r0;
    if (i >= S) continue;
    float* row = dq + (((long long)b * S + i) * HQ + h) * D;
#pragma unroll
    for (int a = 0; a < SLC; ++a) {
      if (a >= ns) continue;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int c = (a0 + a) * CW + 8 * nd + 2 * t;
        if (c < D)
          *reinterpret_cast<float2*>(row + c) =
              make_float2(dqa[ND * a + nd][2 * half] * scale,
                          dqa[ND * a + nd][2 * half + 1] * scale);
      }
    }
  }
}

// dk dv: 64 keys a block, query tiles of 16 rows of every head of the
// group, dk and dv columns 128 z .. 128 z + 127.  Items of a query tile:
// the nc chunks of (K, V, Q, dO), then the slice's chunks of (Q, dO).
// grid (ceil(Sk / 64), B * KH, slices)
__global__ void __launch_bounds__(T_THREADS)
flash_wide_dkdv_tf32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int S, int Sk, int HQ, int KH, int D, int causal,
                            float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / KH, hk = blockIdx.y % KH;
  const int group = HQ / KH;
  const int k0 = blockIdx.x * TB_ROWS;
  const int off = Sk - S;
  const int nc = (D + CW - 1) / CW;
  const int a0 = blockIdx.z * SLC;
  const int ns = min(SLC, nc - a0);
  const int per = nc + ns;
  const long long qs = (long long)HQ * D, ks = (long long)KH * D;
  const float* kb = k + (long long)b * Sk * ks + (long long)hk * D;
  const float* vb = v + (long long)b * Sk * ks + (long long)hk * D;
  // the query tiles whose rows see key k0, for each head of the group
  const int q_first = causal ? max(0, k0 - off) : 0;
  const int qt_first = q_first / TB_TILE;
  const int nq = max((S + TB_TILE - 1) / TB_TILE - qt_first, 0);
  const int total = group * nq * per;

  auto issue = [&](int i) {
    float* st = ring + (i % T_STAGES) * TB_STAGE;
    const int tt = i / per, r = i % per;
    const int h = hk * group + tt / nq;
    const int q0 = (qt_first + tt % nq) * TB_TILE;
    const float* qb = q + (long long)b * S * qs + (long long)h * D;
    const float* ob = dout + (long long)b * S * qs + (long long)h * D;
    if (r < nc) {
      load_chunk(st, kb, ks, k0, TB_ROWS, Sk, r * CW, D);
      load_chunk(st + TB_ROWS * LDF, vb, ks, k0, TB_ROWS, Sk, r * CW, D);
      load_chunk(st + 2 * TB_ROWS * LDF, qb, qs, q0, TB_TILE, S, r * CW, D);
      load_chunk(st + (2 * TB_ROWS + TB_TILE) * LDF, ob, qs, q0, TB_TILE, S,
                 r * CW, D);
    } else {
      const int col = (a0 + r - nc) * CW;
      load_chunk(st, qb, qs, q0, TB_TILE, S, col, D);
      load_chunk(st + TB_TILE * LDF, ob, qs, q0, TB_TILE, S, col, D);
    }
  };

  const int wk0 = k0 + 16 * warp;  // this warp's first key
  const int j0 = wk0 + g, j1 = j0 + 8;
  const bool wactive = wk0 < Sk;
  float dka[16][4], dva[16][4];
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    zero(dka[x]);
    zero(dva[x]);
  }

  ring_start(total, issue);
  int it = 0;
  for (int tt = 0; tt < group * nq; ++tt) {
    const int h = hk * group + tt / nq;
    const int q0 = (qt_first + tt % nq) * TB_TILE;
    const int row_last = min(q0 + TB_TILE, S) - 1;
    const bool on = wactive && !(causal && row_last + off < wk0);
    float sacc[2][4], dacc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      zero(sacc[n]);
      zero(dacc[n]);
    }
    // S^T = K Q^T and dP^T = V dO^T, chunk by chunk
    for (int c = 0; c < nc; ++c, ++it) {
      ring_begin(it, total, issue);
      if (on) {
        const float* Ks = ring + (it % T_STAGES) * TB_STAGE;
        const float* Vs = Ks + TB_ROWS * LDF;
        const float* Qs = Vs + TB_ROWS * LDF;
        const float* Os = Qs + TB_TILE * LDF;
        Acc s[2], dp[2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          s[n].zero();
          dp[n].zero();
        }
#pragma unroll
        for (int kk = 0; kk < CW; kk += 16) {
          FragA ak, av;
          load_a(ak, Ks, 16 * warp, kk, g, t);
          load_a(av, Vs, 16 * warp, kk, g, t);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            FragB bq, bo;
            load_b_rows(bq, Qs, 8 * n, kk, g, t);
            mma16(s[n], ak, bq);
            load_b_rows(bo, Os, 8 * n, kk, g, t);
            mma16(dp[n], av, bo);
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sacc[n][e] += s[n].get(e);
            dacc[n][e] += dp[n].get(e);
          }
      }
      __syncthreads();
    }
    FragA pa, sa;
    if (on) {
      // P^T and dS^T, masked: columns are query rows
      float p[2][4], ds[2][4];
      const long long lrow = ((long long)b * HQ + h) * S;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int i = q0 + 8 * n + 2 * t + x;
          const float Li = i < S ? lse[lrow + i] : INFINITY;
          const float Di = i < S ? delta[lrow + i] : 0.f;
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            const int e = 2 * y + x;
            const int jj = y ? j1 : j0;
            const bool ok = i < S && jj < Sk && (!causal || jj <= i + off);
            const float pv = ok ? expf(sacc[n][e] * scale - Li) : 0.f;
            p[n][e] = pv;
            ds[n][e] = pv * (dacc[n][e] - Di);
          }
        }
      a_from_c(pa, p[0], p[1]);
      a_from_c(sa, ds[0], ds[1]);
    }
    // dV[:, chunk a] += P^T dO[:, chunk a] and dK[:, chunk a] += dS^T Q[:,
    // chunk a], each 8-column tile over this query tile in fresh
    // accumulators
#pragma unroll
    for (int a = 0; a < SLC; ++a) {
      if (a < ns) {
        ring_begin(it, total, issue);
        if (on) {
          const float* Qs = ring + (it % T_STAGES) * TB_STAGE;
          const float* Os = Qs + TB_TILE * LDF;
#pragma unroll
          for (int nd = 0; nd < ND; ++nd) {
            Acc cv, ck;
            cv.zero();
            ck.zero();
            FragB bo, bq;
            load_b_cols(bo, Os, 0, 8 * nd, g, t);
            mma16(cv, pa, bo);
            load_b_cols(bq, Qs, 0, 8 * nd, g, t);
            mma16(ck, sa, bq);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dva[ND * a + nd][e] += cv.get(e);
              dka[ND * a + nd][e] += ck.get(e);
            }
          }
        }
        __syncthreads();
        ++it;
      }
    }
  }
  cp_async_wait<0>();
  if (!wactive) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int jj = half ? j1 : j0;
    if (jj >= Sk) continue;
    const long long row = (((long long)b * Sk + jj) * KH + hk) * D;
#pragma unroll
    for (int a = 0; a < SLC; ++a) {
      if (a >= ns) continue;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int c = (a0 + a) * CW + 8 * nd + 2 * t;
        if (c < D) {
          *reinterpret_cast<float2*>(dk + row + c) =
              make_float2(dka[ND * a + nd][2 * half] * scale,
                          dka[ND * a + nd][2 * half + 1] * scale);
          *reinterpret_cast<float2*>(dv + row + c) = make_float2(
              dva[ND * a + nd][2 * half], dva[ND * a + nd][2 * half + 1]);
        }
      }
    }
  }
}

// =====================================================================
// host side

// a contiguous (B, S, H, D) bf16 tensor as a (D, S, H, B) tensor map with
// boxes of (64, rows, 1, 1)
int make_map(CUtensorMap* map, const void* base, int B, int S, int H, int D,
             int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)D * 2;
  const cuuint64_t strides[3] = {row * H, row, row * H * S};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base,
                          dims, strides, box);
}

template <typename KernelFn>
cudaError_t set_smem(KernelFn fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <bool QRES>
int fwd_bf16_run(const CUtensorMap& tq, const CUtensorMap& tk,
                 const CUtensorMap& tv, bf16* o, float* lse, int B, int HQ,
                 int KH, int S, int Sk, int D, int causal, float sl2,
                 cudaStream_t cs) {
  const int nc = (D + 63) / 64;
  const int smem = fwd_layout(nc).alloc;
  const dim3 rows((S + F_BQ - 1) / F_BQ, B * HQ, 1);
  cudaError_t e;
  if (nc <= 4) {
    if ((e = set_smem(flash_wide_fwd_wgmma_kernel<ONLINE, QRES>, smem)) !=
        cudaSuccess)
      return (int)e;
    flash_wide_fwd_wgmma_kernel<ONLINE, QRES><<<rows, F_THREADS, smem, cs>>>(
        tq, tk, tv, o, lse, HQ, KH, S, Sk, D, causal, sl2);
    return (int)cudaGetLastError();
  }
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  if ((e = set_smem(flash_wide_fwd_wgmma_kernel<LSE, QRES>, smem)) !=
          cudaSuccess ||
      (e = set_smem(flash_wide_fwd_wgmma_kernel<SLICE, QRES>, smem)) !=
          cudaSuccess)
    return (int)e;
  flash_wide_fwd_wgmma_kernel<LSE, QRES><<<rows, F_THREADS, smem, cs>>>(
      tq, tk, tv, o, lse, HQ, KH, S, Sk, D, causal, sl2);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_wide_fwd_wgmma_kernel<SLICE, QRES>
      <<<dim3(rows.x, rows.y, (nc + 3) / 4), F_THREADS, smem, cs>>>(
          tq, tk, tv, o, lse, HQ, KH, S, Sk, D, causal, sl2);
  return (int)cudaGetLastError();
}

int fwd_bf16(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int HQ, int KH, int S, int Sk, int D,
             int causal, float scale, cudaStream_t cs) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, S, HQ, D, F_BQ);
  if (!err) err = make_map(&tk, k, B, Sk, KH, D, F_BK);
  if (!err) err = make_map(&tv, v, B, Sk, KH, D, F_BK);
  if (err) return err;
  bf16* o = static_cast<bf16*>(out);
  if ((D + 63) / 64 <= F_QRES_MAX)
    return fwd_bf16_run<true>(tq, tk, tv, o, lse, B, HQ, KH, S, Sk, D,
                              causal, scale * LOG2E, cs);
  return fwd_bf16_run<false>(tq, tk, tv, o, lse, B, HQ, KH, S, Sk, D, causal,
                             scale * LOG2E, cs);
}

int fwd_f32(const void* q, const void* k, const void* v, void* out,
            float* lse, int B, int HQ, int KH, int S, int Sk, int D,
            int causal, float scale, cudaStream_t cs) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = T_STAGES * TF_STAGE * 4;
  cudaError_t e;
  if ((e = set_smem(flash_wide_fwd_tf32_kernel<LSE>, smem)) != cudaSuccess ||
      (e = set_smem(flash_wide_fwd_tf32_kernel<SLICE>, smem)) != cudaSuccess)
    return (int)e;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  const int nc = (D + CW - 1) / CW;
  const int nq = (S + TF_BQ - 1) / TF_BQ;
  const int nsl = (nc + SLC - 1) / SLC;
  flash_wide_fwd_tf32_kernel<LSE><<<dim3(nq, B * HQ, 1), T_THREADS, smem,
                                    cs>>>(qf, kf, vf, of, lse, HQ, KH, S, Sk,
                                          D, causal, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_wide_fwd_tf32_kernel<SLICE>
      <<<dim3(nq, B * HQ, nsl), T_THREADS, smem, cs>>>(
          qf, kf, vf, of, lse, HQ, KH, S, Sk, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int B, int S, int HQ, int D, cudaStream_t cs) {
  const long long rows = (long long)B * HQ * S;
  flash_wide_delta_kernel<T>
      <<<(unsigned)((rows + DELTA_WARPS - 1) / DELTA_WARPS), DELTA_WARPS * 32,
         0, cs>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                  delta, S, HQ, D, rows);
  return cudaGetLastError();
}

template <bool RES>
int bwd_bf16_run(const void* q, const void* k, const void* v,
                 const void* dout, void* dq, void* dk, void* dv,
                 const float* lse, const float* delta, int B, int HQ, int KH,
                 int S, int Sk, int D, int causal, float scale,
                 cudaStream_t cs) {
  // dq reads Q and dO in 128-row boxes, K and V in 64; dk dv the reverse
  CUtensorMap q128, o128, k64, v64, q64, o64, k128, v128;
  int err = make_map(&q128, q, B, S, HQ, D, 128);
  if (!err) err = make_map(&o128, dout, B, S, HQ, D, 128);
  if (!err) err = make_map(&k64, k, B, Sk, KH, D, 64);
  if (!err) err = make_map(&v64, v, B, Sk, KH, D, 64);
  if (!err) err = make_map(&q64, q, B, S, HQ, D, 64);
  if (!err) err = make_map(&o64, dout, B, S, HQ, D, 64);
  if (!err) err = make_map(&k128, k, B, Sk, KH, D, 128);
  if (!err) err = make_map(&v128, v, B, Sk, KH, D, 128);
  if (err) return err;
  const float sl2 = scale * LOG2E;
  const int nc = (D + 63) / 64;
  const int smem = bwd_layout(RES).alloc;
  cudaError_t e;
  if ((e = set_smem(flash_wide_dq_wgmma_kernel<RES>, smem)) != cudaSuccess ||
      (e = set_smem(flash_wide_dkdv_wgmma_kernel<RES>, smem)) != cudaSuccess)
    return (int)e;
  flash_wide_dkdv_wgmma_kernel<RES>
      <<<dim3(B * KH, (Sk + 127) / 128, (nc + 1) / 2), WG_THREADS, smem,
         cs>>>(
          q64, o64, k128, v128, lse, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), S, Sk, HQ, KH, D, causal, sl2, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_wide_dq_wgmma_kernel<RES>
      <<<dim3(B * HQ, (S + 127) / 128, (nc + 3) / 4), WG_THREADS, smem,
         cs>>>(
          q128, o128, k64, v64, lse, delta, static_cast<bf16*>(dq), S, Sk,
          HQ, KH, D, causal, sl2, scale);
  return (int)cudaGetLastError();
}

int bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
             void* dq, void* dk, void* dv, const float* lse,
             const float* delta, int B, int HQ, int KH, int S, int Sk, int D,
             int causal, float scale, cudaStream_t cs) {
  if ((D + 63) / 64 <= B_RES_MAX)
    return bwd_bf16_run<true>(q, k, v, dout, dq, dk, dv, lse, delta, B, HQ,
                              KH, S, Sk, D, causal, scale, cs);
  return bwd_bf16_run<false>(q, k, v, dout, dq, dk, dv, lse, delta, B, HQ, KH,
                             S, Sk, D, causal, scale, cs);
}

int bwd_f32(const void* q, const void* k, const void* v, const void* dout,
            void* dq, void* dk, void* dv, const float* lse,
            const float* delta, int B, int HQ, int KH, int S, int Sk, int D,
            int causal, float scale, cudaStream_t cs) {
  const int smem = T_STAGES * TB_STAGE * 4;
  cudaError_t e;
  if ((e = set_smem(flash_wide_dq_tf32_kernel, smem)) != cudaSuccess ||
      (e = set_smem(flash_wide_dkdv_tf32_kernel, smem)) != cudaSuccess)
    return (int)e;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const int nsl = ((D + CW - 1) / CW + SLC - 1) / SLC;
  flash_wide_dkdv_tf32_kernel
      <<<dim3((Sk + TB_ROWS - 1) / TB_ROWS, B * KH, nsl), T_THREADS, smem,
         cs>>>(qf, kf, vf, df, lse, delta, static_cast<float*>(dk),
               static_cast<float*>(dv), S, Sk, HQ, KH, D, causal, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_wide_dq_tf32_kernel
      <<<dim3((S + TB_ROWS - 1) / TB_ROWS, B * HQ, nsl), T_THREADS, smem,
         cs>>>(qf, kf, vf, df, lse, delta, static_cast<float*>(dq), S, Sk,
               HQ, KH, D, causal, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int HQ, int KH, int S, int Sk, int D, int is_bf16) {
  return B < 1 || KH < 1 || HQ % KH || S < 1 || Sk < 1 || D <= 128 ||
         D % (is_bf16 ? 16 : 4) || (long long)B * HQ > 65535 ||
         (long long)(S + 63) / 64 > 65535 || (long long)(Sk + 63) / 64 > 65535;
}

}  // namespace

// The forward: out, and each row's L where lse is not null; bf16 selects
// bfloat16 operands (D a multiple of 16 above 128), else float32 (D a
// multiple of 4 above 128).  bfloat16 up to D 256 one launch; above it
// (and every float32 call) two, L then the output's slices, and lse must
// not be null.  Returns 0, a CUDA runtime error, cudaErrorInvalidValue
// for a shape the kernels do not take, ERR_NO_ENCODE or ERR_ENCODE_BASE +
// a CUresult.
extern "C" int flash_wide_launch(const void* q, const void* k, const void* v,
                                 void* out, float* lse, int B, int HQ,
                                 int KH, int S, int Sk, int D, int causal,
                                 int is_bf16, float scale, void* stream) {
  if (bad_shape(B, HQ, KH, S, Sk, D, is_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return fwd_bf16(q, k, v, out, lse, B, HQ, KH, S, Sk, D, causal, scale,
                    cs);
  return fwd_f32(q, k, v, out, lse, B, HQ, KH, S, Sk, D, causal, scale, cs);
}

// The backward from the forward's L: Delta (scratch, (B, HQ, S) float32),
// then dk dv, then dq, each a block per (rows, slice).  Three launches.
extern "C" int flash_wide_bwd_launch(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, void* dq, void* dk,
                                     void* dv, const float* lse,
                                     float* delta, int B, int HQ, int KH,
                                     int S, int Sk, int D, int causal,
                                     int is_bf16, float scale, void* stream) {
  if (bad_shape(B, HQ, KH, S, Sk, D, is_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch_delta<bf16>(o, dout, delta, B, S, HQ, D, cs)
              : launch_delta<float>(o, dout, delta, B, S, HQ, D, cs);
  if (e != cudaSuccess) return (int)e;
  if (is_bf16)
    return bwd_bf16(q, k, v, dout, dq, dk, dv, lse, delta, B, HQ, KH, S, Sk,
                    D, causal, scale, cs);
  return bwd_f32(q, k, v, dout, dq, dk, dv, lse, delta, B, HQ, KH, S, Sk, D,
                 causal, scale, cs);
}
