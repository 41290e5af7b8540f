// vta_wgmma: vta_gemm's instance above 16 rows on Hopper's int8 tensor
// cores (sm_90a), and the launch that quantizes quantized_linear's float
// activations once a call in front of it.
//
// Replaces: src/repro/kernels/vta_gemm/kernel.py, vta_gemm_pallas (body
// _gemm_kernel), for M > 16: every coalesced GEMM tile of the task-ISA
// engine (M = 14..3136 after T batching, N = 64..512, K = 64..4608) and
// every quantized linear of an LM prefill
// (src/repro/kernels/vta_gemm/ops.py:quantized_linear).  The operands,
// epilogues and arithmetic are vta_gemm.cu's (its note and
// vta_common.cuh); this file is the instance the host picks above 16 rows
// (kernel.py:gemm_plan).
//
// What bounds it on this card: at the LM's prefill shapes (M 512 and up,
// N and K in the thousands) the int8 tensor cores, 2 * M * N * K operations
// at 1,979 TOP/s, with the weight and output bytes close behind at M 512;
// at the engine's shapes launch latency and the serial K loop of a few
// blocks (T2 M49 N64 K4608: two output tiles).
//
// What the design does about it:
// * The product is wgmma.mma_async m64nNk32 s32.s8.s8 (N = 64, 128 or
//   256), A (T, M, Kp) and W (T, N, Kp) both K-major in shared memory with
//   the 128-byte swizzle, the int32 accumulator in registers.  A block
//   computes a BM x BN output tile (BM = 64 per consumer warpgroup, one or
//   two warpgroups; BN = 64, 128 or 256); the plan picks the tile.
// * A and W tiles arrive by TMA from 3-d tensor maps over (Kp, rows, T),
//   encoded per call (hopper.cuh:make_map), so T peer tiles are one
//   launch and rows past M or N, or columns past Kp, are zero-filled by the
//   copy engine: nothing is masked in the K loop.  The tiles flow through
//   an mbarrier ring of 128-byte K steps (4 stages at 128 rows; at 64 rows,
//   whose few blocks walk deep K, up to 8): one producer warp issues the
//   copies (one thread; full barriers completed by the transaction count,
//   empty barriers by one arrival per consumer warp), the consumer
//   warpgroups issue four k32 products a step and keep one step's group in
//   flight (wgmma.wait_group 1) before releasing the previous stage.  The
//   producer is a single warp, not a warpgroup, so setmaxnreg (a
//   warpgroup instruction) does not apply: 288 threads at up to 224
//   registers fit the register file, and the 128 accumulators of a
//   64 x 256 tile need no more.
// * K is split into slices of whole 128-byte steps where the output tiles
//   are too few to fill the card (the engine's small-M*N, deep-K tiles):
//   the slices of one tile are one thread block cluster of up to 8
//   blocks.  Each block stages its int32 partial tile in its own shared
//   memory; after a cluster barrier block q adds the rows r = q (mod
//   splits) of every block's tile through distributed shared memory
//   (integer addition wraps and is associative mod 2^32: the same bits in
//   any order) and runs their epilogue.  Nothing touches device memory
//   but the operands and the output, and nothing is left to reset.
// * The epilogue reads the accumulator tile back from shared memory (the
//   ring is idle by then): a warp a row, two adjacent columns a lane, so
//   the stores are coalesced, and the epilogue's code is one rolled loop
//   whatever the tile's width.  The grid is rastered in groups of 8 row
//   tiles, column by column, so the blocks resident together share their
//   W tiles in L2.
// * quantized_linear quantizes x once a call into an int8 scratch x_q (M,
//   Kp) (vta_gemm_quantize_kernel): launched cooperatively, its blocks
//   share one grid-wide amax (vta_common.cuh:grid_x_scale) and then
//   quantize; with a given x_scale it only quantizes.  The GEMM then reads
//   x_q by TMA like any int8 A and stores y in x's dtype: two launches a
//   call.
// * Kp, the row length in memory, is K rounded up to 16 bytes (TMA's
//   stride unit); the wrapper zero-pads an operand whose K is not a
//   multiple of 16 or whose base is not 16-byte aligned, and x_q is written
//   with zero columns past K.  Zero columns add nothing to an integer sum.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"
#include "vta_common.cuh"

namespace {

using namespace hopper;
using namespace vta;

constexpr int KSTEP = 128;  // K bytes a ring stage: one 128-byte swizzle row
constexpr int GROUP_M = 8;  // row tiles a group of the grid's raster
constexpr int MAX_SPLITS = 8;  // K slices of a tile: a portable cluster

// D += A B: A (64 x 32) and B (32 x 64) int8, both K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D += A B: A (64 x 32) and B (32 x 128) int8, both K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D += A B: A (64 x 32) and B (32 x 256) int8, both K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 64) wgmma_s8_n64(d, da, db);
  if constexpr (BN == 128) wgmma_s8_n128(d, da, db);
  if constexpr (BN == 256) wgmma_s8_n256(d, da, db);
}

// shared memory of one block: STAGES x (A tile, W tile), then the full and
// empty barriers; tiles 1024-byte aligned (the swizzle's period)
template <int WG, int BN>
struct Layout {
  static constexpr int BM = 64 * WG;
  static constexpr int A_BYTES = BM * KSTEP;
  static constexpr int W_BYTES = BN * KSTEP;
  static constexpr int STAGE = A_BYTES + W_BYTES;
  // ring stages: 4 for two warpgroups; 64-row tiles, whose few blocks
  // walk deep K serially, as many as fit 160 KB, up to 8
  static constexpr int STAGES =
      WG == 2 ? 4 : (160 * 1024 / STAGE < 8 ? 160 * 1024 / STAGE : 8);
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + 8 * 2 * STAGES;
  static constexpr int ALLOC = BYTES + 1024;  // room to align to 1024
  static constexpr int THREADS = 128 * WG + 32;  // consumers, producer warp
  // the int32 row stride of the output tile staged in the ring: 8 words
  // of padding put the 8 rows a fragment store touches on distinct banks
  static constexpr int LD = BN + 8;
  static_assert(BM * LD * 4 <= BAR_OFF, "the staged tile fits the ring");
};

// the consumer warpgroups' own barrier (the producer warp is not in it)
template <int WG>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WG) : "memory");
}

// every thread of the cluster (the blocks of one output tile's K slices)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// two int32 at `local` (this block's shared memory) in block `rank` of the
// cluster
__device__ __forceinline__ int2 ld_cluster_int2(const int* local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  int2 v;
  asm volatile("ld.shared::cluster.v2.s32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(remote)
               : "memory");
  return v;
}

// The outputs (row r, columns c and c + 1) of the tile: `two` when c + 1
// is in the tile too; `pairs` when N is even (then o is even).
template <typename OT>
__device__ __forceinline__ void store_tile_pair(
    void* out, size_t o, int2 v, bool two, bool pairs, const int32_t* bias,
    const float* scale, float xs, int col, int epilogue, int shift) {
  if (two && pairs) {
    store_out2<OT>(out, o, v.x, v.y, bias, scale, xs, col, epilogue, shift);
  } else {
    store_out<OT>(out, o, v.x, bias, scale, xs, col, epilogue, shift);
    if (two)
      store_out<OT>(out, o + 1, v.y, bias, scale, xs, col + 1, epilogue,
                    shift);
  }
}

// grid (ceil(M / BM) * ceil(N / BN), 1, T * splits); block z = t * splits
// + slice.  A slice covers `per` K steps of 128 bytes (the last what is
// left of `steps`).  With splits > 1 the launch has clusters of (1, 1,
// splits): the slices of one output tile, whose int32 partials are added
// through distributed shared memory.
template <int WG, int BN, typename OT>
__global__ void __launch_bounds__(Layout<WG, BN>::THREADS, 1)
vta_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tw,
                      const int32_t* __restrict__ bias,
                      const float* __restrict__ scale,
                      const float* __restrict__ xs_in,
                      void* __restrict__ out, int M, int N, int steps,
                      int per, int splits, int epilogue, int shift) {
  using L = Layout<WG, BN>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  int* tile = reinterpret_cast<int*>(smem);  // the ring, once it is idle

  // block x -> output tile: groups of GROUP_M row tiles, column by
  // column within a group, so the blocks resident together share the W
  // tiles they read and a few A tiles (L2 reuse)
  const int tiles_m = (M + L::BM - 1) / L::BM;
  const int tiles_n = (N + BN - 1) / BN;
  const int group = blockIdx.x / (GROUP_M * tiles_n);
  const int gsize = min(GROUP_M, tiles_m - group * GROUP_M);
  const int in_group = blockIdx.x - group * GROUP_M * tiles_n;
  const int m0 = (group * GROUP_M + in_group % gsize) * L::BM;
  const int n0 = (in_group / gsize) * BN;
  const int t = blockIdx.z / splits;
  const int slice = blockIdx.z % splits;  // the block's rank in its cluster
  const int s0 = slice * per;             // first K step of the slice
  const int ns = min(per, steps - s0);    // >= 1 (kernel.py's plan)

  // the producer warp: one thread sets up the ring and issues every copy,
  // the first STAGES before the block's first barrier
  const bool producer = threadIdx.x == 128 * WG;
  auto issue = [&](int j) {
    const int s = j % STAGES;
    uint8_t* st = smem + s * L::STAGE;
    const int k = (s0 + j) * KSTEP;
    mbar_expect_tx(&full[s], L::STAGE);
    tma_load_3d(st, &ta, &full[s], k, m0, t);
    tma_load_3d(st + L::A_BYTES, &tw, &full[s], k, n0, t);
  };
  if (producer) {
    tma_prefetch_map(&ta);
    tma_prefetch_map(&tw);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG);  // one arrival per consumer warp
    }
    mbar_fence_init();
    for (int j = 0; j < min(ns, STAGES); ++j) issue(j);
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x >= 128 * WG) {
    if (producer) {
      for (int j = STAGES; j < ns; ++j) {
        mbar_wait_bounded(&empty[j % STAGES], ((j / STAGES) & 1) ^ 1);
        issue(j);
      }
    }
  } else {
    // ---- consumers: 64 rows per warpgroup ----
    const int wg = threadIdx.x / 128;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int j = 0; j < ns; ++j) {
      const int s = j % STAGES;
      mbar_wait_bounded(&full[s], (j / STAGES) & 1);
      const uint32_t a_addr =
          smem_u32(smem + s * L::STAGE) + wg * 64 * KSTEP;
      const uint32_t w_addr = smem_u32(smem + s * L::STAGE + L::A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEP / 32; ++kk)
        wgmma_s8<BN>(acc, desc_b128(a_addr + kk * 32, 16, 1024),
                     desc_b128(w_addr + kk * 32, 16, 1024));
      wgmma_commit();
      // the previous step's products are done: its stage is free
      wgmma_wait<1>();
      fence_regs(acc);
      if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // the int32 tile into shared memory (the ring is idle once every
    // warpgroup's products are done): row r of the tile at tile + r * LD
    consumers_sync<WG>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // the fragment: rows rl and rl + 8, columns 8i + cq and 8i + cq + 1
    // of each 8-column block i in acc[4i .. 4i + 3]
    const int rl = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int cq = (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(tile + (rl + 8 * h) * L::LD + 8 * i + cq) =
            make_int2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }

  // then the output in row order: a warp a row, two adjacent columns a
  // lane, neighbouring lanes on neighbouring pairs
  const float xs = xs_in != nullptr ? *xs_in : 0.f;
  const size_t tbase = (size_t)t * M * N;
  const int rows = min(L::BM, M - m0);
  const int cols = min(BN, N - n0);
  const bool pairs = N % 2 == 0;
  if (splits == 1) {
    if (threadIdx.x >= 128 * WG) return;
    consumers_sync<WG>();
    for (int r = warp; r < rows; r += 4 * WG) {
      const size_t orow = tbase + (size_t)(m0 + r) * N + n0;
      for (int c = 2 * lane; c < cols; c += 64)
        store_tile_pair<OT>(
            out, orow + c,
            *reinterpret_cast<const int2*>(tile + r * L::LD + c),
            c + 1 < cols, pairs, bias, scale, xs, n0 + c, epilogue, shift);
    }
    return;
  }
  // the split of K: every slice's tile is staged; block `slice` adds the
  // rows r = slice (mod splits) over the cluster, in slice order (integer
  // sums wrap mod 2^32: any order gives the same bits), and stores them
  cluster_sync();
  if (threadIdx.x < 128 * WG) {
    for (int r = slice + warp * splits; r < rows; r += 4 * WG * splits) {
      const size_t orow = tbase + (size_t)(m0 + r) * N + n0;
      for (int c = 2 * lane; c < cols; c += 64) {
        uint32_t x = 0u, y = 0u;
        for (int q = 0; q < splits; ++q) {
          const int2 v = ld_cluster_int2(tile + r * L::LD + c, q);
          x += (uint32_t)v.x;
          y += (uint32_t)v.y;
        }
        store_tile_pair<OT>(out, orow + c, make_int2((int)x, (int)y),
                            c + 1 < cols, pairs, bias, scale, xs, n0 + c,
                            epilogue, shift);
      }
    }
  }
  cluster_sync();  // no block leaves while another reads its tile
}

// ==== quantized_linear's activations, quantized once ======================
constexpr int Q_THREADS = 256;
constexpr int Q_BLOCKS_PER_SM = 4;  // kernel.py:QUANT_BLOCKS_PER_SM

// x (M, K) float32 or bfloat16 -> x_q (M, Kp) int8, zero past K, with
// x_scale from xs_in or (AMAX, a cooperative launch) the grid-wide amax,
// which block 0 also writes to xs_out for the GEMM's epilogue.  A thread
// takes 16 elements at a time (VEC: K % 16 == 0 and x 16-byte aligned,
// so they are whole vectors); the wrapper keeps M * Kp below 2^31.
template <typename XT, bool AMAX, bool VEC>
__global__ void __launch_bounds__(Q_THREADS, Q_BLOCKS_PER_SM)
vta_gemm_quantize_kernel(const XT* __restrict__ x, int8_t* __restrict__ xq,
                         int M, int K, int Kp,
                         const float* __restrict__ xs_in,
                         float* __restrict__ xs_out,
                         unsigned* __restrict__ sync, float lo) {
  __shared__ unsigned red[Q_THREADS / 32];
  __shared__ float xs_sh;
  float xs;
  if constexpr (AMAX) {
    if constexpr (VEC) {
      // the amax over 16-element vectors, a contiguous share a block
      const int n16 = M * K / 16;
      const int per = (n16 + gridDim.x - 1) / gridDim.x;
      const int c1 = min(n16, (int)blockIdx.x * per + per);
      unsigned v = 0u;
      for (int c = blockIdx.x * per + threadIdx.x; c < c1; c += Q_THREADS) {
        float f[16];
        XIo<XT>::load16v(x + (size_t)c * 16, f);
#pragma unroll
        for (int i = 0; i < 16; ++i) v = max(v, abs_bits(f[i]));
      }
      xs = grid_x_scale_of<XT>(v, sync, lo, red, &xs_sh);
    } else {
      xs = grid_x_scale<XT>(x, (long long)M * K, sync, lo, red, &xs_sh);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) *xs_out = xs;
  } else {
    xs = *xs_in;
  }
  const int cpr = Kp / 16;  // 16-byte chunks a row of x_q
  const int n = M * cpr;
  for (int e = blockIdx.x * Q_THREADS + threadIdx.x; e < n;
       e += gridDim.x * Q_THREADS) {
    const int m = e / cpr;
    const int k = (e - m * cpr) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (k < K)
      v = Act<XT>::template load16<VEC>(x + (size_t)m * K + k, K - k, xs);
    *reinterpret_cast<int4*>(xq + (size_t)m * Kp + k) = v;
  }
}

// ==== host side ===========================================================
// a (Kp, rows, T) int8 tensor map with boxes of (128, box_rows, 1)
int make_map3(CUtensorMap* map, const void* base, int Kp, int rows, int T,
              int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)Kp, (cuuint64_t)rows,
                              (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)Kp, (cuuint64_t)Kp * rows};
  const cuuint32_t box[3] = {KSTEP, (cuuint32_t)box_rows, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, base, dims, strides,
                  box);
}

template <int WG, int BN, typename OT>
int launch_gemm(const void* a, const void* w, const int32_t* bias,
                const float* scale, const float* xs, void* out, int T, int M,
                int N, int Kp, int epilogue, int shift, int splits, int per,
                cudaStream_t st) {
  using L = Layout<WG, BN>;
  if (splits < 1 || splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tw;
  int err = make_map3(&ta, a, Kp, M, T, L::BM);
  if (!err) err = make_map3(&tw, w, Kp, N, T, BN);
  if (err) return err;
  auto* fn = vta_gemm_wgmma_kernel<WG, BN, OT>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
  if (e != cudaSuccess) return (int)e;
  const int steps = (Kp + KSTEP - 1) / KSTEP;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((M + L::BM - 1) / L::BM) * ((N + BN - 1) / BN), 1,
                     T * splits);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::ALLOC;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, fn, ta, tw, bias, scale, xs, out, M, N, steps,
                         per, splits, epilogue, shift);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename OT>
int dispatch_gemm(int wg, int bn, const void* a, const void* w,
                  const int32_t* bias, const float* scale, const float* xs,
                  void* out, int T, int M, int N, int Kp, int epilogue,
                  int shift, int splits, int per, cudaStream_t st) {
#define WG_LAUNCH(WG, BN)                                                  \
  if (wg == WG && bn == BN)                                                \
  return launch_gemm<WG, BN, OT>(a, w, bias, scale, xs, out, T, M, N, Kp,  \
                                 epilogue, shift, splits, per, st)
  WG_LAUNCH(1, 64);
  WG_LAUNCH(1, 128);
  WG_LAUNCH(1, 256);
  WG_LAUNCH(2, 64);
  WG_LAUNCH(2, 128);
  WG_LAUNCH(2, 256);
#undef WG_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename XT>
int launch_quantize(bool vec, const void* x, int8_t* xq, int M, int K,
                    int Kp, const float* xs_given, float* xs_out,
                    unsigned* sync, int blocks, float lo, cudaStream_t st) {
  const XT* X = static_cast<const XT*>(x);
  if (xs_given != nullptr) {
    if (vec)
      vta_gemm_quantize_kernel<XT, false, true><<<blocks, Q_THREADS, 0, st>>>(
          X, xq, M, K, Kp, xs_given, xs_out, sync, lo);
    else
      vta_gemm_quantize_kernel<XT, false, false><<<blocks, Q_THREADS, 0, st>>>(
          X, xq, M, K, Kp, xs_given, xs_out, sync, lo);
    return (int)cudaGetLastError();
  }
  void* args[] = {&X, &xq, &M, &K, &Kp, &xs_given, &xs_out, &sync, &lo};
  const void* fn = vec ? (const void*)vta_gemm_quantize_kernel<XT, true, true>
                       : (const void*)vta_gemm_quantize_kernel<XT, true, false>;
  cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(blocks),
                                              dim3(Q_THREADS), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// vta_gemm above 16 rows on int8 A.  Launch on `stream`; returns 0, the
// first CUDA error, ERR_NO_ENCODE or ERR_ENCODE_BASE + a CUresult.  The
// wrapper (kernel.py) checks dtypes and shapes, gives A (T, M, Kp) and W
// (T, N, Kp) contiguous with Kp a multiple of 16 and both bases 16-byte
// aligned (zero columns past K), allocates `out` (T, M, N), never calls
// this with T, M or N equal to 0, and takes wg (consumer warpgroups: 64
// rows each), bn, splits (1 to MAX_SPLITS) and per (K steps of 128 bytes
// a slice) from kernel.py:gemm_plan.
extern "C" int vta_wgmma_launch(const void* a, const void* w, const void* bias,
                                const void* scale, void* out, int T, int M,
                                int N, int Kp, int epilogue, int shift, int wg,
                                int bn, int splits, int per, void* stream) {
  if (epilogue < EPI_NONE || epilogue > EPI_DEQUANT)
    return (int)cudaErrorInvalidValue;
  return dispatch_gemm<float>(wg, bn, a, w, static_cast<const int32_t*>(bias),
                              static_cast<const float*>(scale), nullptr, out,
                              T, M, N, Kp, epilogue, shift, splits, per,
                              static_cast<cudaStream_t>(stream));
}

// quantized_linear above 16 rows: x (M, K) float32 (x_dtype 1) or bfloat16
// (2), contiguous, M * Kp below 2^31; w (N, Kp) int8 as above; w_scale (N,)
// float32; out (M, N) in x's dtype; xq an int8 scratch of M * Kp bytes;
// x_scale from `xs_given` (a device float) when it is not null, else from
// the amax into `xs_buf`; `sync` three zeroed words, left zeroed;
// `q_blocks` the quantize launch's blocks (at most QUANT_BLOCKS_PER_SM per
// SM: with the amax they must all be resident); `lo` is 1e-6 in x's dtype.
// Two launches.
extern "C" int vta_wgmma_qlinear(const void* x, int x_dtype, const void* w,
                                 const void* w_scale, void* out, void* xq,
                                 const void* xs_given, void* xs_buf,
                                 void* sync, int M, int N, int K, int Kp,
                                 int q_blocks, float lo, int wg, int bn,
                                 int splits, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const float* XG = static_cast<const float*>(xs_given);
  float* XB = static_cast<float*>(xs_buf);
  int8_t* XQ = static_cast<int8_t*>(xq);
  unsigned* SY = static_cast<unsigned*>(sync);
  const float* xs = XG != nullptr ? XG : XB;
  const float* S = static_cast<const float*>(w_scale);
  int err;
  if (x_dtype == A_F32) {
    err = launch_quantize<float>(vec, x, XQ, M, K, Kp, XG, XB, SY, q_blocks,
                                 lo, st);
    if (err) return err;
    return dispatch_gemm<float>(wg, bn, XQ, w, nullptr, S, xs, out, 1, M, N,
                                Kp, EPI_QLINEAR, 0, splits, per, st);
  }
  if (x_dtype == A_BF16) {
    err = launch_quantize<__nv_bfloat16>(vec, x, XQ, M, K, Kp, XG, XB, SY,
                                         q_blocks, lo, st);
    if (err) return err;
    return dispatch_gemm<__nv_bfloat16>(wg, bn, XQ, w, nullptr, S, xs, out,
                                        1, M, N, Kp, EPI_QLINEAR, 0, splits,
                                        per, st);
  }
  return (int)cudaErrorInvalidValue;
}
