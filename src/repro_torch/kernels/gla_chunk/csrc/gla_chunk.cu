// gla_chunk: the chunked gated-linear-attention scan (Mamba2's SSD, mLSTM)
// on Hopper (sm_90a), its four products on the tensor cores in 3xTF32,
// accurate to float32, with q and k in float32 or bfloat16.
//
// Replaces: src/repro/kernels/gla_chunk/kernel.py, gla_chunk_pallas (body
// _gla_kernel), the TPU kernel of the chunked scan behind Mamba2's prefill
// and the mLSTM (models/ssm.py chunked_gla).  It computes the same
// function; it is not a block by block copy.
//
// Computes, for each batch b and head h, over the S steps in order:
//   h_t = exp(la_t) h_{t-1} + k_t v_tᵀ,   y_t = q_t · h_t,   h_{-1} = h0
// T steps at a time (L the within-tile cumsum of la, L_tot its last entry):
//   y = (q kᵀ ⊙ exp(L_i − L_j) ⊙ causal) v + exp(L_i) (q h)
//   h ← exp(L_tot) h + (k ⊙ exp(L_tot − L))ᵀ v
// The scan gives the same y and h for any tile length T, up to rounding, so
// the caller's chunk is walked in tiles of T = 16, 32 or 64 rows
// (kernel.py:gla_plan picks T); a last tile shorter than T is zero-filled,
// which is exact: a zero row of k and v adds nothing to the state and
// la = 0 decays nothing.  The causal mask is applied before the
// exponential (above the diagonal L_i − L_j > 0 could overflow).
//
// Operands, each read through its own strides: q, k (B, S, H, N) float32 or
// bfloat16 (one dtype) with a contiguous last dim, the other strides and
// the start on 16 bytes (a head stride of 0 reads one q/k row for every
// head in place: Mamba2 broadcasts C and B over heads); v (B, S, H, P) and
// la (B, S, H) float32, any strides (v_vec: v's rows start on 16 bytes and
// are copied 16 bytes at a time, else element by element); h0 (B, H, N, P)
// float32 or absent (zeros).  Out: y (B, S, H, P) in float32 or bfloat16,
// written through its strides; hout (B, H, N, P) float32, contiguous.  N is
// 1..256, padded in shared memory to NP, a multiple of 8 (zero columns of
// q and k add nothing to q kᵀ or q h); P is any size.
//
// Precision: every product runs on mma.sync.m16n8k8 TF32 as 3xTF32.  An
// operand x is split in registers into hi, x rounded to TF32 to nearest
// (cvt.rna.tf32.f32: the tensor cores alone truncate), and lo = x − hi;
// a·b is hi_a·hi_b + lo_a·hi_b + hi_a·lo_b, each in its own float32
// accumulator (three independent chains), summed at the end.  The error
// against float64 is that of the plain float32 version, where one TF32
// product is ~1000x worse (tests/test_torch_gla.py models the arithmetic
// on the CPU; phase 7 of chip_smoke.py and tests/test_torch_cuda.py hold
// the kernel to 4x the plain version's error on the card).  A bfloat16 q
// or k is exact in TF32: its lo half is zero and is skipped, so the score
// tile is then one product and q h two.
//
// mma.sync, not wgmma: wgmma takes TF32 operands only K-major (its
// transpose bits are for 16-bit types), and two of the four products have
// the tile's rows as their depth (W v and the state update), whose
// operands arrive row-major: they would need v and k ⊙ exp(L_tot − L)
// transposed, and 3xTF32 would need every operand split into hi and lo
// halves, in shared memory, for the tensor cores to read.  A version of
// this kernel that staged the halves in shared memory (the fragments then
// plain loads) measured no faster than splitting in registers (PERF.md),
// and at N 256 the staging does not fit beside a two-stage ring.
// mma.sync fragments are read from shared memory in either orientation,
// with row strides that keep the reads conflict-free (k alone is read both
// ways and takes a 2-way conflict in the score tile).
//
// What bounds it on this card: per tile and head 2T²N + 2T²P + 4TNP
// operations against (2N + P + 1) T words read and T P written.  At
// T = N = P = 64 that is about 130 operations per byte; in 3xTF32 on the
// tensor cores the operations and the bytes would take about as long.
// What bounds this kernel is neither: the four products of a tile run one
// after another inside a block (the state update feeds the next tile), on
// small 16 x 8 tiles whose fragments, splits and 3 products per depth step
// cost about 6 instructions a tensor-core operation; per-phase clock64
// counts on the card show the tensor cores busy about a fifth of the time
// (PERF.md).  xlstm's N 256, P 1025, bf16 q/k recomputes the score tile in
// each of its 33 slices of P.
//
// What the design does: the TPU kernel keeps h in VMEM across an ordered
// grid axis of chunks.  Here one block of 8 warps owns one (batch, head)
// pair and a slice of PB = 16, 32 or 64 columns of P (gla_plan sizes it to
// fill the 132 SMs against the score tile's recompute), and walks the tiles
// itself in order.  Each column of y and h depends only on the same column
// of v and h, so cutting P across blocks is exact.  The block's slice of
// the state lives in float32 registers, transposed (hᵀ: PB x NP, in runs
// of 16 x 8 tiles over the warps); each tile's vᵀ (k ⊙ exp(L_tot − L)) is
// summed in fresh accumulators and added on the CUDA cores, hᵀ ←
// exp(L_tot) hᵀ + that, and hᵀ is copied to shared memory after each tile
// for the next tile's q h.  The next tiles' q, k, v
// and la arrive through a ring of cp.async stages (gla_plan picks one to
// three, and T, to fit 227 KB) while the current tile computes.  Per tile:
// q h (it needs only the last state) while warp 0 scans la (a fixed-order
// warp scan); then the causal 16 x 8 tiles of the score q kᵀ, weighted and
// masked into shared memory, and the state update; then y = exp(L_i) (q h)
// + W v.  Each warp takes a run of 16 x 8 tiles in one row strip, so that
// it reads an A fragment once for the run.  Every sum runs in a fixed
// order and nothing is atomic, so two calls are bitwise equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

using namespace hopper;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_N = 256;
constexpr int MAXS = 3;    // 16 x 8 tiles of one warp's run of the score
constexpr int SMEM_MAX = 232448;

struct Strides {
  long long q[3], k[3];   // b, s, h (n contiguous)
  long long v[4];         // b, s, h, p
  long long la[3];        // b, s, h
  long long h0[4];        // b, h, n, p
  long long y[4];         // b, s, h, p
};

constexpr int align16(int x) { return (x + 15) & ~15; }

// The shared-memory layout of one plan; kernel.py:smem_bytes computes the
// same byte count and the launcher refuses a plan whose count differs.
// Row strides in elements: q, k and hᵀ are read as pairs of columns by 8
// lanes walking rows (a stride of 8 mod 16 words keeps 64-bit reads
// conflict-free), v and k also by 4 lanes walking rows (8 mod 16 again),
// w by 8 lanes walking rows (4 mod 8).
struct Layout {
  int T, np, pb, stages;
  int qs, vs, ws;
  int q_off, k_off, v_off, la_off, stage_bytes;
  int w_off, h_off, l_off, total;
};

Layout make_layout(int T, int N, int pb, int stages, int esz) {
  Layout L;
  L.T = T;
  L.np = (N + 7) / 8 * 8;
  L.pb = pb;
  L.stages = stages;
  L.qs = L.np + (L.np % 16 == 0 ? 8 : 0);
  L.vs = pb + 8;
  L.ws = T + 4;
  L.q_off = 0;
  L.k_off = align16(T * L.qs * esz);
  L.v_off = 2 * L.k_off;
  L.la_off = L.v_off + T * L.vs * 4;
  L.stage_bytes = L.la_off + align16(T * 4);
  L.w_off = stages * L.stage_bytes;
  L.h_off = L.w_off + T * L.ws * 4;
  L.l_off = L.h_off + pb * L.qs * 4;
  L.total = L.l_off + (3 * T + 4) * 4;
  return L;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// two neighbouring elements (an even column and the next) as float32
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ void zero(float (&x)[4]) {
  x[0] = x[1] = x[2] = x[3] = 0.f;
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8) holds
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8) holds (t, g),
// (t + 4, g); C holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// The products whose depth is N (q kᵀ and q h) take depth index t from
// column 2t and t + 4 from column 2t + 1 in both operands: the sum is the
// same, and each lane reads a pair of neighbouring columns at once.
// Each loader takes p at this lane's first element (its row or column g and
// depth t, or 2t where paired) and the row stride S.
// A[r][k] = M[r * S + k], depth paired
template <typename E>
__device__ __forceinline__ void frag_a_pk(const E* p, int S, float (&x)[4]) {
  const float2 u = ld2(p);
  const float2 w = ld2(p + 8 * S);
  x[0] = u.x;
  x[1] = w.x;
  x[2] = u.y;
  x[3] = w.y;
}

// B[k][c] = M[c * S + k], depth paired
template <typename E>
__device__ __forceinline__ void frag_b_pk(const E* p, float (&x)[2]) {
  const float2 u = ld2(p);
  x[0] = u.x;
  x[1] = u.y;
}

// A[r][k] = M[r * S + k]
__device__ __forceinline__ void frag_a(const float* p, int S, float (&x)[4]) {
  x[0] = p[0];
  x[1] = p[8 * S];
  x[2] = p[4];
  x[3] = p[8 * S + 4];
}

// A[r][k] = M[k * S + r]
__device__ __forceinline__ void frag_a_t(const float* p, int S,
                                         float (&x)[4]) {
  x[0] = p[0];
  x[1] = p[8];
  x[2] = p[4 * S];
  x[3] = p[4 * S + 8];
}

// B[k][c] = M[k * S + c]
template <typename E>
__device__ __forceinline__ void frag_b_t(const E* p, int S, float (&x)[2]) {
  x[0] = ld(p);
  x[1] = ld(p + 4 * S);
}

// A warp's run of 16 x 8 tiles of one product: row strip m (16 rows) and
// tiles n0 .. n0 + cnt - 1 of it (8 columns each).  The warp reads each
// fragment of the strip once per depth step and uses it for every tile of
// the run.
struct Run {
  int m, n0, cnt;
};

// `rows` strips (1, 2 or 4) of `per` tiles each, WARPS / rows warps to a
// strip, each taking an equal share of it.
__device__ __forceinline__ Run grid_run(int warp, int rows, int per) {
  const int ws = WARPS / rows;
  const int part = warp % ws, c = (per + ws - 1) / ws;
  const int n0 = min(per, part * c);
  return {warp / ws, n0, min(per, n0 + c) - n0};
}

// The causal score tile: strip m holds the 2m + 2 tiles on or below the
// diagonal; each strip is cut into runs of at most ceil(total / WARPS)
// tiles, one run a warp (8 runs at T = 64: 2, 2 + 2, 3 + 3, 3 + 3 + 2).
__device__ __forceinline__ Run score_run(int warp, int rows) {
  const int per = (rows * (rows + 1) + WARPS - 1) / WARPS;
  int w = 0;
  for (int m = 0; m < rows; ++m) {
    const int c = 2 * m + 2, k = (c + per - 1) / per;
    if (warp < w + k) {
      const int i = warp - w, a = i * c / k, b = (i + 1) * c / k;
      return {m, a, b - a};
    }
    w += k;
  }
  return {0, 0, 0};
}

// grid (B * H, P slices of PB columns); T in {16, 32, 64}; HU >= the tiles
// of hᵀ in one warp's run; YJ = the tiles of y in a warp's run (0 or YJ).
template <typename TQ, int HU, int YJ>
__global__ void __launch_bounds__(THREADS, 1)
gla_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ la,
           const float* __restrict__ h0, void* __restrict__ y, int y_bf16,
           float* __restrict__ hout, int H, int S, int N, int P, int v_vec,
           Layout L, Strides st) {
  constexpr bool QX = sizeof(TQ) == 2;   // q and k exact in TF32
  constexpr int CHUNK = 16 / (int)sizeof(TQ);   // q/k elements a copy
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ws = reinterpret_cast<float*>(smem + L.w_off);
  float* Hs = reinterpret_cast<float*>(smem + L.h_off);   // hᵀ [p][n]
  float* Ls = reinterpret_cast<float*>(smem + L.l_off);
  float* eL = Ls + L.T;
  float* eK = eL + L.T;
  float* eTot = eK + L.T;

  const int T = L.T, np = L.np, pb = L.pb, qs = L.qs, vs = L.vs, ws = L.ws;
  const int b = blockIdx.x / H;
  const int hd = blockIdx.x % H;
  const int p0 = blockIdx.y * pb;
  const int tid = threadIdx.x;
  // the warp index from lane 0, so that the compiler sees it (and every
  // count derived from it) as uniform across the warp
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const TQ* qb = q + b * st.q[0] + hd * st.q[2];
  const TQ* kb = k + b * st.k[0] + hd * st.k[2];
  const float* vb = v + b * st.v[0] + hd * st.v[2] + p0 * st.v[3];
  const float* lb = la + b * st.la[0] + hd * st.la[2];

  auto issue = [&](int tile, int stage) {
    unsigned char* base = smem + stage * L.stage_bytes;
    TQ* Qd = reinterpret_cast<TQ*>(base + L.q_off);
    TQ* Kd = reinterpret_cast<TQ*>(base + L.k_off);
    float* Vd = reinterpret_cast<float*>(base + L.v_off);
    float* Ad = reinterpret_cast<float*>(base + L.la_off);
    const int s0 = tile * T;
    const int nrow = min(T, S - s0);
    // q and k: lanes walk a row's 16-byte chunks; v: its 16-byte chunks
    // (v_vec) or its elements
    const int qc = np / CHUNK;
    for (int r = tid / qc, c = tid % qc; r < T;) {
      const int n = r < nrow ? min(CHUNK, max(0, N - c * CHUNK)) : 0;
      const long long oq = n ? (s0 + r) * st.q[1] + c * CHUNK : 0;
      const long long ok = n ? (s0 + r) * st.k[1] + c * CHUNK : 0;
      cp_async<16>(Qd + r * qs + c * CHUNK, qb + oq, n * (int)sizeof(TQ));
      cp_async<16>(Kd + r * qs + c * CHUNK, kb + ok, n * (int)sizeof(TQ));
      r += THREADS / qc;
      c += THREADS % qc;
      if (c >= qc) {
        c -= qc;
        ++r;
      }
    }
    const int vc = v_vec ? pb / 4 : pb;
    for (int r = tid / vc, c = tid % vc; r < T;) {
      if (v_vec) {
        const int n = r < nrow ? min(4, max(0, P - p0 - 4 * c)) : 0;
        cp_async<16>(Vd + r * vs + 4 * c,
                     n ? vb + (s0 + r) * st.v[1] + 4 * c : vb, 4 * n);
      } else {
        const bool ok = r < nrow && p0 + c < P;
        cp_async<4>(Vd + r * vs + c,
                    ok ? vb + (s0 + r) * st.v[1] + c * st.v[3] : vb,
                    ok ? 4 : 0);
      }
      r += THREADS / vc;
      c += THREADS % vc;
      if (c >= vc) {
        c -= vc;
        ++r;
      }
    }
    for (int r = tid; r < T; r += THREADS)
      cp_async<4>(Ad + r, r < nrow ? lb + (s0 + r) * st.la[1] : lb,
                  r < nrow ? 4 : 0);
  };

  // this warp's runs: the score, y (q h, then W v) and hᵀ (rows p,
  // columns n)
  const Run sr = score_run(warp, T / 16);
  const Run yr = grid_run(warp, T / 16, pb / 8);
  const Run hr = grid_run(warp, pb / 16, np / 8);

  float hacc[HU][4];
#pragma unroll
  for (int j = 0; j < HU; ++j) {
    zero(hacc[j]);
    if (j < hr.cnt && h0 != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 16 * hr.m + g + (e / 2) * 8;
        const int c = 8 * (hr.n0 + j) + 2 * t + e % 2;
        if (c < N && p < P)
          hacc[j][e] = h0[b * st.h0[0] + hd * st.h0[1] + c * st.h0[2] +
                          p * st.h0[3]];
      }
    }
  }
  float* const h_dst = Hs + (16 * hr.m + g) * qs + 8 * hr.n0 + 2 * t;
  auto store_h = [&]() {
#pragma unroll
    for (int j = 0; j < HU; ++j) {
      if (j < hr.cnt) {
        *reinterpret_cast<float2*>(h_dst + 8 * j) =
            make_float2(hacc[j][0], hacc[j][1]);
        *reinterpret_cast<float2*>(h_dst + 8 * j + 8 * qs) =
            make_float2(hacc[j][2], hacc[j][3]);
      }
    }
  };
  store_h();

  const int ntiles = (S + T - 1) / T;
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
    __syncthreads();  // this tile's operands and the last tile's hᵀ are in

    unsigned char* base = smem + (tile % L.stages) * L.stage_bytes;
    const TQ* Qs = reinterpret_cast<const TQ*>(base + L.q_off);
    const TQ* Ks = reinterpret_cast<const TQ*>(base + L.k_off);
    const float* Vs = reinterpret_cast<const float*>(base + L.v_off);
    const float* As = reinterpret_cast<const float*>(base + L.la_off);
    const int s0 = tile * T;
    const int nrow = min(T, S - s0);

    // L = cumsum(la) over the tile: warp 0, two rows a lane, a fixed-order
    // scan of the pair sums (rows past the tile read as 0)
    if (warp == 0) {
      const int r0 = 2 * lane, r1 = 2 * lane + 1;
      const float a0 = r0 < T ? As[r0] : 0.f;
      const float a1 = r1 < T ? As[r1] : 0.f;
      float incl = a0 + a1;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const float o = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float ltot = __shfl_sync(0xffffffffu, incl, 31);
      const float l0 = excl + a0;
      if (r0 < T) {
        Ls[r0] = l0;
        eL[r0] = expf(l0);
        eK[r0] = expf(ltot - l0);
      }
      if (r1 < T) {
        Ls[r1] = incl;
        eL[r1] = expf(incl);
        eK[r1] = expf(ltot - incl);
      }
      if (lane == 0) eTot[0] = expf(ltot);
    }

    // q h for this warp's run of y: it needs neither L nor the weights
    float qh[YJ][4], ys1[YJ][4], ys2[YJ][4];
#pragma unroll
    for (int j = 0; j < YJ; ++j) {
      zero(qh[j]);
      zero(ys1[j]);
      zero(ys2[j]);
    }
    if (yr.cnt > 0) {
      const TQ* pa = Qs + (16 * yr.m + g) * qs + 2 * t;
      const float* pbh = Hs + (8 * yr.n0 + g) * qs + 2 * t;
#pragma unroll 2
      for (int kk = 0; kk < np; kk += 8) {
        float x[4], z[YJ][2];
        Frag<4> fa;
        Frag<2> fb[YJ];
        frag_a_pk(pa + kk, qs, x);
#pragma unroll
        for (int j = 0; j < YJ; ++j) frag_b_pk(pbh + 8 * j * qs + kk, z[j]);
        split<QX>(x, fa);
#pragma unroll
        for (int j = 0; j < YJ; ++j) {
          split<false>(z[j], fb[j]);
          mma3<QX, false>(true, qh[j], ys1[j], ys2[j], fa, fb[j]);
        }
      }
    }
    __syncthreads();  // L is in

    // score tile, weighted and masked: W[i][j] = (q_i . k_j) exp(L_i - L_j)
    // for j <= i, else 0; only the 16 x 8 tiles on or below the diagonal
    if (sr.cnt > 0) {
      float bg[MAXS][4], s1[MAXS][4], s2[MAXS][4];
#pragma unroll
      for (int j = 0; j < MAXS; ++j) {
        zero(bg[j]);
        zero(s1[j]);
        zero(s2[j]);
      }
      const TQ* pa = Qs + (16 * sr.m + g) * qs + 2 * t;
      const TQ* pbk = Ks + (8 * sr.n0 + g) * qs + 2 * t;
#pragma unroll 2
      for (int kk = 0; kk < np; kk += 8) {
        float x[4], z[MAXS][2];
        Frag<4> fa;
        Frag<2> fb[MAXS];
        frag_a_pk(pa + kk, qs, x);
#pragma unroll
        for (int j = 0; j < MAXS; ++j)
          frag_b_pk(pbk + 8 * min(j, sr.cnt - 1) * qs + kk, z[j]);
        split<QX>(x, fa);
#pragma unroll
        for (int j = 0; j < MAXS; ++j) {
          split<QX>(z[j], fb[j]);
          mma3<QX, QX>(j < sr.cnt, bg[j], s1[j], s2[j], fa, fb[j]);
        }
      }
      const int r0 = 16 * sr.m + g, r1 = r0 + 8;
      const float l0 = Ls[r0], l1 = Ls[r1];
#pragma unroll
      for (int j = 0; j < MAXS; ++j) {
        if (j < sr.cnt) {
          const int c = 8 * (sr.n0 + j) + 2 * t;
          const float lc0 = Ls[c], lc1 = Ls[c + 1];
          float a[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = bg[j][e] + (s1[j][e] + s2[j][e]);
          *reinterpret_cast<float2*>(Ws + r0 * ws + c) = make_float2(
              c <= r0 ? a[0] * expf(l0 - lc0) : 0.f,
              c + 1 <= r0 ? a[1] * expf(l0 - lc1) : 0.f);
          *reinterpret_cast<float2*>(Ws + r1 * ws + c) = make_float2(
              c <= r1 ? a[2] * expf(l1 - lc0) : 0.f,
              c + 1 <= r1 ? a[3] * expf(l1 - lc1) : 0.f);
        }
      }
    }

    // hᵀ <- exp(Ltot) hᵀ + vᵀ (k exp(Ltot - L)), depth the tile's rows:
    // the tile's product in fresh accumulators, added to the carried
    // state on the CUDA cores (a float32 sum chained across the tiles
    // on the tensor cores truncates one-signed, as the float32 flash
    // kernel's did: over 32768 slowly decaying steps y's error was 7x the
    // plain version's, PERF.md)
    if (hr.cnt > 0) {
      const float et = eTot[0];
      float big[HU][4], s1[HU][4], s2[HU][4];
#pragma unroll
      for (int j = 0; j < HU; ++j) {
        zero(big[j]);
        zero(s1[j]);
        zero(s2[j]);
      }
      const float* pa = Vs + t * vs + 16 * hr.m + g;
      const TQ* pbk = Ks + t * qs + 8 * hr.n0 + g;
#pragma unroll 2
      for (int kk = 0; kk < T; kk += 8) {
        const float e0 = eK[kk + t], e1 = eK[kk + t + 4];
        float x[4], z[HU][2];
        Frag<4> fa;
        Frag<2> fb[HU];
        frag_a_t(pa + kk * vs, vs, x);
#pragma unroll
        for (int j = 0; j < HU; ++j)
          frag_b_t(pbk + kk * qs + 8 * min(j, hr.cnt - 1), qs, z[j]);
        split<false>(x, fa);
#pragma unroll
        for (int j = 0; j < HU; ++j) {
          z[j][0] *= e0;
          z[j][1] *= e1;
          split<false>(z[j], fb[j]);
          mma3<false, false>(j < hr.cnt, big[j], s1[j], s2[j], fa, fb[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < HU; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hacc[j][e] = et * hacc[j][e] + (big[j][e] + (s1[j][e] + s2[j][e]));
    }
    __syncthreads();  // W is in

    // y = exp(L_i) (q h) + W v: W is causal, so strip m needs the first
    // 16 (m + 1) rows of v
    if (yr.cnt > 0) {
      const int r0 = 16 * yr.m + g;
      const float e0 = eL[r0], e1 = eL[r0 + 8];
#pragma unroll
      for (int j = 0; j < YJ; ++j) {
        qh[j][0] = (qh[j][0] + (ys1[j][0] + ys2[j][0])) * e0;
        qh[j][1] = (qh[j][1] + (ys1[j][1] + ys2[j][1])) * e0;
        qh[j][2] = (qh[j][2] + (ys1[j][2] + ys2[j][2])) * e1;
        qh[j][3] = (qh[j][3] + (ys1[j][3] + ys2[j][3])) * e1;
        zero(ys1[j]);
        zero(ys2[j]);
      }
      const float* pa = Ws + r0 * ws + t;
      const float* pbv = Vs + t * vs + 8 * yr.n0 + g;
#pragma unroll 2
      for (int kk = 0; kk < 16 * (yr.m + 1); kk += 8) {
        float x[4], z[YJ][2];
        Frag<4> fa;
        Frag<2> fb[YJ];
        frag_a(pa + kk, ws, x);
#pragma unroll
        for (int j = 0; j < YJ; ++j) frag_b_t(pbv + kk * vs + 8 * j, vs, z[j]);
        split<false>(x, fa);
#pragma unroll
        for (int j = 0; j < YJ; ++j) {
          split<false>(z[j], fb[j]);
          mma3<false, false>(true, qh[j], ys1[j], ys2[j], fa, fb[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < YJ; ++j) {
        {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + (e / 2) * 8;
            const int p = p0 + 8 * (yr.n0 + j) + 2 * t + e % 2;
            if (r < nrow && p < P) {
              const long long o = b * st.y[0] + hd * st.y[2] +
                                  (s0 + r) * st.y[1] + p * st.y[3];
              const float val = qh[j][e] + (ys1[j][e] + ys2[j][e]);
              if (y_bf16)
                static_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16(val);
              else
                static_cast<float*>(y)[o] = val;
            }
          }
        }
      }
    }
    __syncthreads();  // every read of the old hᵀ and of this stage is done
    store_h();
  }

  float* ho = hout + (size_t)blockIdx.x * N * P;
#pragma unroll
  for (int j = 0; j < HU; ++j) {
    if (j < hr.cnt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 16 * hr.m + g + (e / 2) * 8;
        const int c = 8 * (hr.n0 + j) + 2 * t + e % 2;
        if (c < N && p < P) ho[(size_t)c * P + p] = hacc[j][e];
      }
    }
  }
}

template <typename TQ, int HU, int YJ>
int launch(const void* q, const void* k, const void* v, const void* la,
           const void* h0, void* y, int y_bf16, void* hout, int B, int H,
           int S, int N, int P, int v_vec, const Layout& L,
           const Strides& st, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gla_kernel<TQ, HU, YJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L.total);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (P + L.pb - 1) / L.pb);
  gla_kernel<TQ, HU, YJ><<<grid, THREADS, L.total, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k),
      static_cast<const float*>(v), static_cast<const float*>(la),
      static_cast<const float*>(h0), y, y_bf16, static_cast<float*>(hout),
      H, S, N, P, v_vec, L, st);
  return (int)cudaGetLastError();
}

template <typename TQ, int HU>
int dispatch_yj(int yj, const void* q, const void* k, const void* v,
                const void* la, const void* h0, void* y, int y_bf16,
                void* hout, int B, int H, int S, int N, int P, int v_vec,
                const Layout& L, const Strides& st, cudaStream_t stream) {
  if (yj == 1)
    return launch<TQ, HU, 1>(q, k, v, la, h0, y, y_bf16, hout, B, H, S, N, P,
                             v_vec, L, st, stream);
  if (yj == 2)
    return launch<TQ, HU, 2>(q, k, v, la, h0, y, y_bf16, hout, B, H, S, N, P,
                             v_vec, L, st, stream);
  return launch<TQ, HU, 4>(q, k, v, la, h0, y, y_bf16, hout, B, H, S, N, P,
                           v_vec, L, st, stream);
}

// the instance whose HU holds one warp's run of hᵀ tiles and whose YJ is
// a warp's run of y tiles (grid_run's share)
template <typename TQ>
int dispatch_hu(const void* q, const void* k, const void* v, const void* la,
                const void* h0, void* y, int y_bf16, void* hout, int B,
                int H, int S, int N, int P, int v_vec, const Layout& L,
                const Strides& st, cudaStream_t stream) {
  const int wh = WARPS / (L.pb / 16), per = L.np / 8;
  const int hu = (per + wh - 1) / wh;
  const int wy = WARPS / (L.T / 16), yper = L.pb / 8;
  const int yj = (yper + wy - 1) / wy;
  if (hu <= 2)
    return dispatch_yj<TQ, 2>(yj, q, k, v, la, h0, y, y_bf16, hout, B, H, S,
                              N, P, v_vec, L, st, stream);
  if (hu <= 4)
    return dispatch_yj<TQ, 4>(yj, q, k, v, la, h0, y, y_bf16, hout, B, H, S,
                              N, P, v_vec, L, st, stream);
  if (hu <= 8)
    return dispatch_yj<TQ, 8>(yj, q, k, v, la, h0, y, y_bf16, hout, B, H, S,
                              N, P, v_vec, L, st, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (or the error of
// cudaFuncSetAttribute), or cudaErrorInvalidValue for an unknown dtype
// code (0 float32, 1 bfloat16), N outside 1..256, a tile T not 16, 32 or
// 64, a P slice PB not 16, 32 or 64, more than 64 tiles of hᵀ
// (PB / 16 * NP / 8), `stages` not 1 or 2, or `smem` that is not this
// plan's shared-memory byte count (kernel.py:smem_bytes) or is over
// 232,448.  `strides` holds 21 element strides: q (b, s, h), k (b, s, h),
// v (b, s, h, p), la (b, s, h), h0 (b, h, n, p), y (b, s, h, p).  h0 may
// be null (zeros).  The wrapper checks shapes, strides and alignment,
// allocates y and hout, and never calls this with B, H, S or P equal to 0.
extern "C" int gla_chunk_launch(const void* q, const void* k, const void* v,
                                const void* la, const void* h0, void* y,
                                void* hout, int q_dtype, int y_dtype, int B,
                                int H, int S, int N, int P, int T, int pb,
                                int stages, int smem, int v_vec,
                                const long long* strides, void* stream) {
  if (N < 1 || N > MAX_N || (T != 16 && T != 32 && T != 64) ||
      (pb != 16 && pb != 32 && pb != 64) || stages < 1 || stages > 3 ||
      q_dtype < 0 || q_dtype > 1 || y_dtype < 0 || y_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(T, N, pb, stages, q_dtype == 0 ? 4 : 2);
  if (L.total != smem || L.total > SMEM_MAX)
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
    return dispatch_hu<float>(q, k, v, la, h0, y, y_dtype, hout, B, H, S, N,
                              P, v_vec, L, st, cs);
  return dispatch_hu<__nv_bfloat16>(q, k, v, la, h0, y, y_dtype, hout, B, H,
                                    S, N, P, v_vec, L, st, cs);
}
