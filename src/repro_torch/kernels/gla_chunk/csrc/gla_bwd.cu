// gla_bwd: the gradient of the chunked gated-linear-attention scan
// (gla_chunk.cu's function) on Hopper (sm_90a), every product on the tensor
// cores in 3xTF32, accurate to float32.
//
// Replaces no TPU kernel: the reference differentiates its jnp
// chunked_gla (src/repro/models/ssm.py) with jax.value_and_grad
// (src/repro/launch/train.py), and has no backward Pallas kernel.  It is
// the port's own, added so that a loss through Mamba2 and the mLSTM can
// run on the card: gla_chunk.cu writes through ctypes, which autograd does
// not see, and a CUDA tensor launches a kernel or raises.
//
// Computes, per batch b and head h, from the forward's operands and the
// output gradients dy (B, S, H, P) and dh (B, H, N, P) or none, with L the
// cumsum of la within a tile of T rows, L_tot its last entry, h_c the
// state entering tile c and G_c its gradient (G after the last tile = dh):
//   G_c  = exp(L_tot,c) G_{c+1} + Σ_i exp(L_i) q_i dy_iᵀ
//   dq_i = Σ_{j≤i} (dy_i·v_j) e^{L_i−L_j} k_j + e^{L_i} h_c dy_i
//   dk_j = Σ_{i≥j} (dy_i·v_j) e^{L_i−L_j} q_i + e^{L_tot−L_j} G_{c+1} v_j
//   dv_j = Σ_{i≥j} (q_i·k_j) e^{L_i−L_j} dy_i + e^{L_tot−L_j} G_{c+1}ᵀ k_j
//   dΛ_t = q_t·dq_t − k_t·dk_t (+ ⟨dh, h_final⟩ at the last step), and
//   dla_t = Σ_{u≥t} dΛ_u;  dh0 = G_0.
// dla is summed tile by tile: for a step of tile c, the later steps' dΛ
// in tile c plus ⟨G_{c+1}, h_{c+1}⟩ (h_{c+1} the state leaving tile c),
// which equals the rest of the sequence's sum; a sum carried along the
// whole sequence would give every step the rounding of all later steps.
// These do not depend on the tile length, up to rounding, so the caller's
// chunk is walked in tiles of T = 64 rows (ref.py:gla_chunk_bwd_ref writes
// the same formulas at the caller's chunk); a last tile shorter than T is
// zero-filled, which is exact (zero rows of q, k, v and dy add nothing,
// and la = 0 decays nothing).  The causal mask is applied before the
// exponential.
//
// Operands, each read element by element through its own strides: q, k
// (B, S, Hq, N) float32 or bfloat16 (one dtype; a head stride of 0 reads
// one row for every head: Mamba2's C and B), v (B, S, H, P), la (B, S, H),
// h0 (B, H, N, P) or none, dy (B, S, H, P), dh (B, H, N, P) or none, all
// float32.  N is 1..256 and P any size, both walked in chunks of 64.
// Out, contiguous float32: dq and dk per head (B, S, H, N), summed over
// the heads into (B, S, N) where q and k are broadcast; dv (B, S, H, P);
// dla (B, S, H); dh0 (B, H, N, P).
//
// Five launches, one after another on the caller's stream:
//   (a) gla_bwd_state_kernel: each tile's own contribution to the state,
//       U_c = kᵀ (v ⊙ e^{L_tot − L}), and to its gradient, qᵀ (dy ⊙
//       e^{L}), every tile at once (one block a tile and direction,
//       walking P, each 64 columns read once), written into the tile's
//       slot of the stored states (B H, tiles, N, P); and each tile's
//       e^{L_tot};
//   (b) gla_bwd_carry_kernel: one element of a state a thread, its tiles
//       walked in order, each slot turned into the state entering the
//       tile, h ← e^{L_tot} h + U_c (from h0; the last h kept), and,
//       walked from the last tile, into the gradient leaving it, G ←
//       e^{L_tot} G + U_c (from dh; G_0 = dh0).  The walk is the only
//       sequential work, and it is a pass over memory;
//   (c) gla_bwd_tile_kernel: one block a (batch, head, tile, 64 columns of
//       P), in parallel over the tiles and P (two blocks an SM where q
//       and k are bfloat16 and kept so in shared memory; at the 128
//       registers that leaves a thread it spills a few hundred bytes, and
//       one block an SM without spills measured no faster), from the stored
//       h_c and G_{c+1}.  This P chunk's part of the output-gradient tile
//       D = dy vᵀ; then, 64 columns of N at a time, the score tile q kᵀ,
//       this chunk's part of dq and dk (D is a sum over P, and so are the
//       state terms dy h_cᵀ and v G_{c+1}ᵀ) and the k G_{c+1} of its dv
//       columns; then the weighted score tile W, dv's columns whole, and
//       this chunk's part of each row's dΛ in float64.  The first chunk
//       writes dq, dk and dΛ in place, each later one a scratch partial;
//   (d) gla_bwd_dla_kernel: blocks a (batch, head, tile): the chunks'
//       partials of dq, dk and dΛ summed in chunk order, then dla, the
//       tile's reverse cumsum of dΛ plus ⟨G_{c+1}, h_{c+1}⟩;
//   (e) gla_bwd_head_sum_kernel, where q and k are broadcast: dq and dk
//       summed over the heads, head 0 first.
// Every sum runs in a fixed order and nothing is atomic, so two calls are
// bitwise equal.
//
// Precision: every product runs on mma.sync.m16n8k8 TF32 as 3xTF32
// (hopper.cuh: split, mma3; gla_chunk.cu's scheme): an operand is split in
// registers into hi, rounded to TF32, and lo = x − hi, and hi·hi, lo·hi,
// hi·lo go into three float32 accumulators, as accurate as float32 FMAs.
// A bfloat16 q or k is exact in TF32: its lo half is not formed (so the
// state pass scales v and dy by the decay, not k and q).  dΛ's dot products and
// the sums that make dla from them run in float64, and dΛ's causal part is
// summed from the score tiles' small terms (dla's errors add up in
// Mamba2's A_log gradient, a weighted sum of it over every position).
// Each tile's contribution to h and G is summed in fresh accumulators and
// then added to the carried state on the CUDA cores (X ← e^{L_tot} X +
// U_c, the carry pass), so no sum is chained across the tiles on the
// tensor cores, whose float32 accumulation truncates one-signed (PERF.md).
//
// mma.sync, not wgmma: wgmma takes TF32 operands only K-major, and most of
// these products read one operand along its rows and the other along its
// columns (gla_chunk.cu:45-52).
//
// What bounds it on this card: per tile and head about 2T²(3N + 2P) +
// 10TNP operations (the scans 4TNP, dq dk dv 6TNP, the two score tiles
// and their products) against (2N + 2P + 1) T words read, (2N + P + 1) T
// written and the two stored states (2NP a tile, written once and read
// once): at zamba2's N = P = 64 about 30 operations per byte, at xlstm's
// N 256, P 1025 about 200.  So the operations bound it, at the tensor
// cores' peak; in 3xTF32 on mma.sync each costs three TF32 products (two
// for an exact bf16 operand).  What holds this design back is elsewhere:
// the tile kernel's products run on 16 x 8 tiles whose fragment loads and
// splits cost several instructions a product, so it issues far below the
// tensor cores' rate, and the stored states (N P floats a tile and
// direction, 1 MB at xlstm's N 256, P 1025) are written, carried and read
// again, several times the bytes of the operands themselves.  Cutting P
// across blocks costs the score tile q kᵀ once per 64 columns of P, 2T²N
// more a chunk, and the scratch of the partials
// (kernel.py:gla_chunk_bwd_cuda says how much); it gives xlstm's P 1025
// 17 times the blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/hopper.cuh"

namespace {

using namespace hopper;

constexpr int T = 64;          // rows of a tile
constexpr int C = 64;          // columns of an operand chunk (of N or P)
constexpr int LD = C + 4;      // row stride of a shared T x C tile (floats)
constexpr int MAX_N = 256;
constexpr int TILE_WORDS = T * LD;
// 8 warps, each a 16 x 32 strip of a 64 x 64 output
constexpr int THREADS = 256;
// blocks that share a tile's sum of the P chunks' partials of dq and dk
constexpr int DLA_SPLIT = 4;
// gla_bwd_state_kernel's tiles: rows of SLD floats, both of its operands
// read down their columns (8 mod 32 words keeps those reads
// conflict-free); its dynamic shared memory: the a tiles of all of N, two
// m tiles, la, L, e^L, e^{L_tot − L}, e^{L_tot}
constexpr int SLD = C + 8;
constexpr int STATE_WORDS = T * SLD;
inline int state_smem(int N) {
  return (((N + C - 1) / C + 2) * STATE_WORDS + 4 * T + 4) * 4;
}
// gla_bwd_tile_kernel's: five float32 T x C tiles (dy, v, D, h_c or W,
// G), the q and k chunks (bfloat16 q and k as bfloat16, rows of LDH, so
// that two blocks fit an SM), la, L, e^L, e^{L_tot − L}, e^{L_tot}, then
// the float64 row and column partials of dΛ
constexpr int LDH = C + 8;
template <typename E>
struct TileSmem {
  // the row stride of a stored q or k chunk
  static constexpr int QL = std::is_same<E, float>::value ? LD : LDH;
  static constexpr int QK_BYTES =
      std::is_same<E, float>::value ? TILE_WORDS * 4 : T * LDH * 2;
  static constexpr int QK_OFF = 5 * TILE_WORDS * 4;
  static constexpr int L_OFF = QK_OFF + 2 * QK_BYTES;
  static constexpr int D_OFF = L_OFF + (4 * T + 4) * 4;
  static constexpr int BYTES = D_OFF + 6 * T * 8;
};
struct Strides {
  long long q[4], k[4];   // b, s, h, n
  long long v[4];         // b, s, h, p
  long long la[3];        // b, s, h
  long long h0[4];        // b, h, n, p
  long long dy[4];        // b, s, h, p
  long long dh[4];        // b, h, n, p
};

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// rows s0 .. s0 + T − 1 (those at or past S read as 0) and columns c0 ..
// c0 + C − 1 (those at or past `width` read as 0) of one (b, h) slice of
// a (B, S, H, width) operand, `base` at (b, 0, h, 0), into dst[r][c] (row
// stride DLD) by the block's NTH threads: float32 by cp.async, 4 bytes an
// element (the caller commits the group and waits for it), bfloat16 by
// plain loads, all issued before the first is stored, as float32 or (D
// bfloat16) as they are
template <int NTH, int DLD = LD, typename E, typename D = float>
__device__ __forceinline__ void load_rows(D* dst, const E* base,
                                          long long s_stride,
                                          long long c_stride, int s0, int S,
                                          int c0, int width) {
  constexpr int PER = T * C / NTH;
  if constexpr (std::is_same<E, float>::value) {
#pragma unroll 4
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * NTH, r = e / C, c = e % C;
      const bool ok = s0 + r < S && c0 + c < width;
      cp_async<4>(dst + r * DLD + c,
                  ok ? base + (long long)(s0 + r) * s_stride +
                           (long long)(c0 + c) * c_stride
                     : base,
                  ok ? 4 : 0);
    }
  } else {
    D x[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * NTH, r = e / C, c = e % C;
      const bool ok = s0 + r < S && c0 + c < width;
      const E* src = base + (long long)(s0 + r) * s_stride +
                     (long long)(c0 + c) * c_stride;
      if constexpr (std::is_same<D, float>::value)
        x[i] = ok ? ldf(src) : 0.f;
      else
        x[i] = ok ? *src : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * NTH;
      dst[(e / C) * DLD + e % C] = x[i];
    }
  }
}

// rows n0 .. n0 + C − 1 and columns p0 .. p0 + C − 1 of a contiguous
// (N, P) state into dst[n][p], zeros past N and P, by cp.async
template <int NTH>
__device__ __forceinline__ void load_state(float* dst, const float* st,
                                           int n0, int p0, int N, int P) {
#pragma unroll 4
  for (int i = 0; i < T * C / NTH; ++i) {
    const int e = threadIdx.x + i * NTH, r = e / C, c = e % C;
    const bool ok = n0 + r < N && p0 + c < P;
    cp_async<4>(dst + r * LD + c, ok ? st + (size_t)(n0 + r) * P + p0 + c : st,
                ok ? 4 : 0);
  }
}

// the la of one tile of (b, h), zeros past S, by cp.async
__device__ __forceinline__ void load_la(float* la_s, const float* lb,
                                        long long s_stride, int s0, int S) {
  if (threadIdx.x < T) {
    const bool ok = s0 + threadIdx.x < S;
    cp_async<4>(la_s + threadIdx.x,
                ok ? lb + (long long)(s0 + threadIdx.x) * s_stride : lb,
                ok ? 4 : 0);
  }
}

// issued loads in and visible to the block
__device__ __forceinline__ void loads_done() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// A warp's strip of a 64 x 64 output: NJ = 4 16 x 8 tiles of m16n8k8 in
// one row strip, each as its hi·hi, lo·hi and hi·lo sums.  WPR = 2 warps
// share a row strip: rows m0 .. m0 + 15, m0 = 16 (warp / 2), columns n0 ..
// n0 + 31, n0 = 32 (warp % 2).  Element e of tile j is at row m0 + g + 8
// (e / 2), column n0 + 8j + 2t + e % 2 (g = lane / 4, t = lane % 4).
struct Strip {
  static constexpr int NJ = 4;
  static constexpr int WPR = 8 / NJ;
  float c[NJ][4], s1[NJ][4], s2[NJ][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = s1[j][e] = s2[j][e] = 0.f;
  }
  __device__ __forceinline__ float get(int j, int e) const {
    return c[j][e] + (s1[j][e] + s2[j][e]);
  }
  // the strip holds x (a value summed on the CUDA cores) and the next
  // product adds to it
  __device__ __forceinline__ void set(int j, int e, float x) {
    c[j][e] = x;
    s1[j][e] = s2[j][e] = 0.f;
  }
  static __device__ __forceinline__ int m0() {
    return 16 * ((threadIdx.x / 32) / WPR);
  }
  static __device__ __forceinline__ int n0() {
    return 8 * NJ * ((threadIdx.x / 32) % WPR);
  }
  static __device__ __forceinline__ int row(int e) {
    return m0() + (threadIdx.x % 32) / 4 + 8 * (e / 2);
  }
  static __device__ __forceinline__ int col(int j, int e) {
    return n0() + 8 * j + 2 * (threadIdx.x % 4) + e % 2;
  }

  // += A B over depth k < K (a multiple of 8) in 3xTF32, with A(m, k) =
  // a[m * ar + k * ak] over the strip's rows and B(k, n) = b[k * bk + n *
  // bc] over its columns, both in shared memory, float32 or bfloat16 (the
  // strides give either orientation of a stored tile); AX / BX: the
  // operand is exact in TF32 (a bfloat16 q or k) and its lo half is not
  // formed
  template <bool AX, bool BX, typename TA, typename TB>
  __device__ __forceinline__ void mma(const TA* a, int ar, int ak,
                                      const TB* b, int bk, int bc, int K) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const TA* pa = a + (m0() + g) * ar + t * ak;
    const TB* pb = b + t * bk + (n0() + g) * bc;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 8) {
      const float xa[4] = {ldf(pa + k0 * ak), ldf(pa + 8 * ar + k0 * ak),
                           ldf(pa + (k0 + 4) * ak),
                           ldf(pa + 8 * ar + (k0 + 4) * ak)};
      Frag<4> fa;
      split<AX>(xa, fa);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float xb[2] = {ldf(pb + k0 * bk + 8 * j * bc),
                             ldf(pb + (k0 + 4) * bk + 8 * j * bc)};
        Frag<2> fb;
        split<BX>(xb, fb);
        mma3<AX, BX>(true, c[j], s1[j], s2[j], fa, fb);
      }
    }
  }
};

// L = cumsum(la) over the tile (warp 0, in a fixed order: every kernel
// here forms the same L: each lane sums its two rows, then an inclusive
// warp scan), then e^{L}, e^{L_tot − L} and e^{L_tot}
__device__ void tile_scales(const float* la_s, float* Ls, float* eL,
                            float* eK, float* eTot) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float a = la_s[2 * lane], b = la_s[2 * lane + 1];
    float x = a + b;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x = y + x;
    }
    float ex = __shfl_up_sync(0xffffffffu, x, 1);  // the rows before
    if (lane == 0) ex = 0.f;
    Ls[2 * lane] = ex + a;
    Ls[2 * lane + 1] = (ex + a) + b;
  }
  __syncthreads();
  if (threadIdx.x < T) {
    eL[threadIdx.x] = expf(Ls[threadIdx.x]);
    eK[threadIdx.x] = expf(Ls[T - 1] - Ls[threadIdx.x]);
  }
  if (threadIdx.x == 0) *eTot = expf(Ls[T - 1]);
  __syncthreads();
}

struct StateArgs {
  const void* a[2];       // k (h, direction 0) and q (G, direction 1)
  long long as[2][4];
  const float* m[2];      // v and dy, (B, S, H, P)
  long long ms[2][4];
  const float* la;
  long long ls[3];
  float* states[2];       // hs and gs, (B H, tiles, N, P)
  float* dtot;            // (B H, tiles): e^{L_tot} of each tile
  int H, S, N, P, nt;
};

// grid (B H tiles, 1, 2): each tile's own contribution to the state and
// to its gradient, every tile at once, for every 64 columns of P in turn:
// U_c[n][p] = Σ_j a_j[n] s_j m_j[p] in fresh accumulators, 64 rows of N
// at a time, with a = k, m = v, s = e^{L_tot − L} for h (direction 0) and
// a = q, m = dy, s = e^{L} for G (direction 1), written into the slot of
// the tile's state; gla_bwd_carry_kernel then turns the slots into the
// states.  The tile's a stays in shared memory (all of N) and each 64
// columns of m are read once, the next ones by cp.async into the other of
// two buffers while these compute.
template <typename E>
__global__ void __launch_bounds__(THREADS)
gla_bwd_state_kernel(StateArgs g) {
  constexpr bool EX = std::is_same<E, __nv_bfloat16>::value;
  using St = Strip;
  extern __shared__ __align__(16) float ssm[];
  const int nb = (g.N + C - 1) / C, npb = (g.P + C - 1) / C;
  float* As = ssm;                      // [nb][T][SLD]
  float* Ms = As + nb * STATE_WORDS;    // two buffers
  float* la_s = Ms + 2 * STATE_WORDS;
  float* Ls = la_s + T;
  float* eL = Ls + T;
  float* eK = eL + T;
  float* eTot = eK + T;
  const int bh = blockIdx.x / g.nt, c = blockIdx.x % g.nt;
  const int dir = blockIdx.z;
  const int b = bh / g.H, h = bh % g.H, s0 = c * T;
  const long long* as = g.as[dir];
  const long long* ms = g.ms[dir];
  const E* ab = static_cast<const E*>(g.a[dir]) + b * as[0] + h * as[2];
  const float* mb = g.m[dir] + b * ms[0] + h * ms[2];
  float* st = g.states[dir] + ((size_t)bh * g.nt + c) * g.N * g.P;
  load_la(la_s, g.la + b * g.ls[0] + h * g.ls[2], g.ls[1], s0, g.S);
  load_rows<THREADS, SLD>(Ms, mb, ms[1], ms[3], s0, g.S, 0, g.P);
  for (int i = 0; i < nb; ++i)
    load_rows<THREADS, SLD>(As + i * STATE_WORDS, ab, as[1], as[3], s0, g.S,
                            i * C, g.N);
  loads_done();
  tile_scales(la_s, Ls, eL, eK, eTot);
  const float* scale = dir ? eL : eK;
  if (threadIdx.x == 0 && dir == 0) g.dtot[blockIdx.x] = eTot[0];
  for (int pb = 0; pb < npb; ++pb) {
    float* Mc = Ms + (pb & 1) * STATE_WORDS;
    __syncthreads();   // the other buffer's last reads are done
    if (pb + 1 < npb) {
      load_rows<THREADS, SLD>(Ms + ((pb + 1) & 1) * STATE_WORDS, mb, ms[1],
                              ms[3], s0, g.S, (pb + 1) * C, g.P);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // these columns are in
    for (int e = threadIdx.x; e < T * C; e += THREADS)
      Mc[(e / C) * SLD + e % C] *= scale[e / C];
    __syncthreads();   // and scaled
    for (int i = 0; i < nb; ++i) {
      // Aᵀ (M ⊙ s): A(n, t) = As[t][n], B(t, p) = Mc[t][p]
      St acc;
      acc.zero();
      acc.mma<EX, false>(As + i * STATE_WORDS, 1, SLD, Mc, SLD, 1, T);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = i * C + St::row(e), p = pb * C + St::col(j, e);
          if (n < g.N && p < g.P) st[(size_t)n * g.P + p] = acc.get(j, e);
        }
    }
  }
}

// grid (ceil(B H N P / THREADS), 2): one element of a state a thread, its
// tiles walked in order: forward (direction 0) from h0, each slot U_c
// replaced by the state entering tile c, h ← e^{L_tot,c} h + U_c, the last
// into hfin; backward (1) from dh, the tiles last to first, each slot
// replaced by the gradient leaving tile c, G ← e^{L_tot,c} G + U_c, the
// last into dh0.  The tile's sum is added on the CUDA cores, so no sum is
// chained across the tiles on the tensor cores.  Sixteen tiles' slots are
// read at once, then written.
__global__ void __launch_bounds__(THREADS)
gla_bwd_carry_kernel(float* __restrict__ hs, float* __restrict__ gs,
                     const float* __restrict__ dtot,
                     const float* __restrict__ h0,
                     const float* __restrict__ dh, long long h0s0,
                     long long h0s1, long long h0s2, long long h0s3,
                     long long dhs0, long long dhs1, long long dhs2,
                     long long dhs3, float* __restrict__ hfin,
                     float* __restrict__ dh0, int H, int N, int P, int nt,
                     long long total) {
  constexpr int U = 16;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int rev = blockIdx.y;
  const long long np = (long long)N * P, bh = e / np, w = e % np;
  const long long b = bh / H, h = bh % H, n = w / P, p = w % P;
  const float* x0 = rev ? dh : h0;
  float x = 0.f;
  if (x0 != nullptr)
    x = rev ? x0[b * dhs0 + h * dhs1 + n * dhs2 + p * dhs3]
            : x0[b * h0s0 + h * h0s1 + n * h0s2 + p * h0s3];
  float* st = (rev ? gs : hs) + bh * nt * np + w;
  const float* d = dtot + bh * nt;
  for (int s0 = 0; s0 < nt; s0 += U) {
    float u[U], dd[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int c = rev ? nt - 1 - (s0 + i) : s0 + i;
      if (s0 + i < nt) {
        u[i] = st[c * np];
        dd[i] = d[c];
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int c = rev ? nt - 1 - (s0 + i) : s0 + i;
      if (s0 + i < nt) {
        st[c * np] = x;
        x = dd[i] * x + u[i];
      }
    }
  }
  (rev ? dh0 : hfin)[e] = x;
}

struct TileArgs {
  const void* q;
  const void* k;
  const float* v;
  const float* la;
  const float* dy;
  const float* hs;        // (B H, tiles, N, P): h_c
  const float* gs;        // (B H, tiles, N, P): G_{c+1}
  float* dq;              // (B, S, H, N), per head: P chunk 0's part
  float* dk;
  float* dq_part;         // (P chunks − 1, B, S, H, N): the later chunks'
  float* dk_part;
  float* dv;              // (B, S, H, P)
  double* dlam;           // (B H, S): P chunk 0's part of dΛ
  double* dl_part;        // (P chunks − 1, B H, S)
  Strides st;
  int B, H, S, N, P, nt;
};

// grid (B H tiles, ceil(P / C)): one block a (b, h, tile) and 64 columns
// of P; two blocks an SM where q and k are bfloat16
template <typename E>
__global__ void __launch_bounds__(THREADS, 2)
gla_bwd_tile_kernel(TileArgs g) {
  constexpr bool EX = std::is_same<E, __nv_bfloat16>::value;
  using St = Strip;
  using L = TileSmem<E>;
  constexpr int QL = L::QL;
  extern __shared__ __align__(16) float sm[];
  float* Ys = sm;                      // dy of the P chunk
  float* Vs = Ys + TILE_WORDS;         // v of the P chunk
  float* Dm = Vs + TILE_WORDS;         // D[i][j] = (dy_i·v_j) e^{L_i−L_j}
  float* Hs = Dm + TILE_WORDS;         // h_c: 64 N x 64 P; then W[i][j] =
  float* Wm = Hs;                      //   (q_i·k_j) e^{L_i−L_j}
  float* Gs = Hs + TILE_WORDS;         // G_{c+1}: 64 N x 64 P
  E* Qc = reinterpret_cast<E*>(reinterpret_cast<uint8_t*>(sm) + L::QK_OFF);
  E* Kc = reinterpret_cast<E*>(reinterpret_cast<uint8_t*>(sm) + L::QK_OFF +
                               L::QK_BYTES);
  float* la_s = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(sm) +
                                         L::L_OFF);
  float* Ls = la_s + T;
  float* eL = Ls + T;
  float* eK = eL + T;
  float* eTot = eK + T;
  double* rowp = reinterpret_cast<double*>(reinterpret_cast<uint8_t*>(sm) +
                                           L::D_OFF);          // [2][T]
  double* colp = rowp + 2 * T;                                 // [4][T]

  const int bh = blockIdx.x / g.nt, c = blockIdx.x % g.nt;
  const int pc = blockIdx.y, p0 = pc * C;
  const int b = bh / g.H, h = bh % g.H, s0 = c * T;
  const int nrow = min(T, g.S - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Strides& st = g.st;
  const E* qb = static_cast<const E*>(g.q) + b * st.q[0] + h * st.q[2];
  const E* kb = static_cast<const E*>(g.k) + b * st.k[0] + h * st.k[2];
  const float* vb = g.v + b * st.v[0] + h * st.v[2];
  const float* yb = g.dy + b * st.dy[0] + h * st.dy[2];
  const float* lb = g.la + b * st.la[0] + h * st.la[2];
  const float* hc = g.hs + ((size_t)bh * g.nt + c) * g.N * g.P;
  const float* gc = g.gs + ((size_t)bh * g.nt + c) * g.N * g.P;
  const size_t part = (size_t)g.B * g.S * g.H * g.N;
  float* dq = pc == 0 ? g.dq : g.dq_part + (pc - 1) * part;
  float* dk = pc == 0 ? g.dk : g.dk_part + (pc - 1) * part;
  double* dl = pc == 0 ? g.dlam
                       : g.dl_part + (size_t)(pc - 1) * g.B * g.H * g.S;
  auto load_chunk = [&](int n0) {
    load_rows<THREADS, QL>(Qc, qb, st.q[1], st.q[3], s0, g.S, n0, g.N);
    load_rows<THREADS, QL>(Kc, kb, st.k[1], st.k[3], s0, g.S, n0, g.N);
    load_state<THREADS>(Hs, hc, n0, p0, g.N, g.P);
    load_state<THREADS>(Gs, gc, n0, p0, g.N, g.P);
  };

  // every operand's first chunk at once: la, dy and v of the P chunk, h_c
  // and G_{c+1} there, q and k of N's first 64 columns
  load_la(la_s, lb, st.la[1], s0, g.S);
  load_rows<THREADS>(Ys, yb, st.dy[1], st.dy[3], s0, g.S, p0, g.P);
  load_rows<THREADS>(Vs, vb, st.v[1], st.v[3], s0, g.S, p0, g.P);
  load_chunk(0);
  loads_done();
  tile_scales(la_s, Ls, eL, eK, eTot);

  // this chunk's D = dy vᵀ, causal (masked before the exponential)
  {
    St dacc;
    dacc.zero();
    dacc.mma<false, false>(Ys, LD, 1, Vs, 1, LD, C);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = St::row(e), cc = St::col(j, e);
        Dm[r * LD + cc] =
            cc <= r ? dacc.get(j, e) * expf(Ls[r] - Ls[cc]) : 0.f;
      }
  }

  // over N, 64 columns at a time: S = q kᵀ; dq and dk (the states' parts
  // first, with their parts of dΛ in float64, then D k and Dᵀ q); the
  // state part of dv, k G_{c+1}
  St sacc, vacc;
  sacc.zero();
  vacc.zero();
  double dlr[2] = {0.0, 0.0};  // dΛ of rows row(0) and row(2), this thread
  for (int n0 = 0; n0 < g.N; n0 += C) {
    __syncthreads();   // D is in; the last chunk's reads are done
    if (n0 > 0) {
      load_chunk(n0);
      loads_done();
    }
    sacc.mma<EX, EX>(Qc, QL, 1, Kc, 1, QL, C);
    // dq: e^{L_i} Σ_p dy_i[p] h_c[n][p], its part of dΛ, then + D k
    St acc;
    acc.zero();
    acc.mma<false, false>(Ys, LD, 1, Hs, 1, LD, C);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = St::row(e), cc = St::col(j, e);
        const float x = acc.get(j, e) * eL[r];
        dlr[e / 2] += (double)ldf(Qc + r * QL + cc) * x;
        acc.set(j, e, x);
      }
    acc.mma<false, EX>(Dm, LD, 1, Kc, QL, 1, T);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = St::row(e), n = n0 + St::col(j, e);
        if (r < nrow && n < g.N)
          dq[(((size_t)b * g.S + s0 + r) * g.H + h) * g.N + n] =
              acc.get(j, e);
      }
    // dk: e^{L_tot − L_j} Σ_p v_j[p] G[n][p], its part of dΛ, then + Dᵀ q
    acc.zero();
    acc.mma<false, false>(Vs, LD, 1, Gs, 1, LD, C);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = St::row(e), cc = St::col(j, e);
        const float x = acc.get(j, e) * eK[r];
        dlr[e / 2] -= (double)ldf(Kc + r * QL + cc) * x;
        acc.set(j, e, x);
      }
    acc.mma<false, EX>(Dm, 1, LD, Qc, QL, 1, T);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = St::row(e), n = n0 + St::col(j, e);
        if (r < nrow && n < g.N)
          dk[(((size_t)b * g.S + s0 + r) * g.H + h) * g.N + n] =
              acc.get(j, e);
      }
    // dv's state part over this chunk of N: A(j, n) = k_j[n], B(n, p) = G
    vacc.mma<EX, false>(Kc, QL, 1, Gs, LD, 1, C);
  }
  __syncthreads();   // every read of h_c is done: W takes its place

  // W, causal, into shared memory; dΛ's causal part, Σ_j A_ij − Σ_j A_ji
  // with A_ij = (dy_i·v_j)(q_i·k_j) e^{L_i−L_j} (j ≤ i): sums of small
  // terms in float64, as autograd of the forward forms them (q_i·dq_i −
  // k_i·dk_i would dot rounded sums).  Row sums per thread, column sums
  // over the lanes of a column, then the four row strips through shared
  // memory
  double dlc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dlc[i] = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = St::row(e), cc = St::col(j, e);
      const bool on = cc <= r;
      const float sv = sacc.get(j, e);
      Wm[r * LD + cc] = on ? sv * expf(Ls[r] - Ls[cc]) : 0.f;
      const double a = on ? (double)Dm[r * LD + cc] * sv : 0.0;
      dlr[e / 2] += a;
      dlc[2 * j + e % 2] += a;
    }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    dlc[i] += __shfl_xor_sync(0xffffffffu, dlc[i], 4);
    dlc[i] += __shfl_xor_sync(0xffffffffu, dlc[i], 8);
    dlc[i] += __shfl_xor_sync(0xffffffffu, dlc[i], 16);
  }
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      colp[(warp / St::WPR) * T + St::col(i / 2, i % 2)] = dlc[i];
  }
  __syncthreads();   // W is in

  // dv = e^{L_tot − L_j} Σ_n k_j[n] G[n][p] + Wᵀ dy
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      vacc.set(j, e, vacc.get(j, e) * eK[St::row(e)]);
  vacc.mma<false, false>(Wm, 1, LD, Ys, LD, 1, T);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = St::row(e), p = p0 + St::col(j, e);
      if (r < nrow && p < g.P)
        g.dv[(((size_t)b * g.S + s0 + r) * g.H + h) * g.P + p] =
            vacc.get(j, e);
    }

  // this chunk's dΛ of each row: the row sums over the quad (a fixed
  // butterfly) and the two warps of the row strip, less the column sums
  // of the four row strips, in order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dlr[i] += __shfl_xor_sync(0xffffffffu, dlr[i], 1);
    dlr[i] += __shfl_xor_sync(0xffffffffu, dlr[i], 2);
  }
  if (lane % 4 == 0) {
    rowp[(warp % St::WPR) * T + St::row(0)] = dlr[0];
    rowp[(warp % St::WPR) * T + St::row(2)] = dlr[1];
  }
  __syncthreads();
  if (threadIdx.x < nrow) {
    const int r = threadIdx.x;
    const double cs = ((colp[r] + colp[T + r]) + colp[2 * T + r]) +
                      colp[3 * T + r];
    dl[(size_t)bh * g.S + s0 + r] = (rowp[r] + rowp[T + r]) - cs;
  }
}

// grid (B H, tiles, DLA_SPLIT or 1): the tile's rows of dq and dk (P
// chunk 0's, in place) plus the later chunks' partials, in chunk order,
// shared by the blocks of blockIdx.z; then, in block z = 0, dΛ likewise in
// float64;
// then dla[b, t, h] for the tile's rows t = the tile's Σ_{u ≥ t} dΛ_u plus
// ⟨G_{c+1}, h_{c+1}⟩ (gs[c], and hs[c + 1] or the final state), in a
// fixed order
__global__ void __launch_bounds__(THREADS)
gla_bwd_dla_kernel(double* dlam, const double* dl_part, float* dq, float* dk,
                   const float* dq_part, const float* dk_part,
                   const float* hs, const float* gs, const float* fin,
                   float* dla, int B, int H, int S, int N, int P, int nt,
                   int chunks) {
  __shared__ double part[THREADS / 32];
  const int bh = blockIdx.x, c = blockIdx.y, b = bh / H, h = bh % H;
  const int s0 = c * T, nrow = min(T, S - s0);
  const size_t np = (size_t)N * P, dq_stride = (size_t)B * S * H * N;
  if (chunks > 1) {
    for (int e = blockIdx.z * THREADS + threadIdx.x; e < nrow * N;
         e += gridDim.z * THREADS) {
      const size_t i = (((size_t)b * S + s0 + e / N) * H + h) * N + e % N;
      float x = dq[i], y = dk[i];
#pragma unroll 4
      for (int pc = 1; pc < chunks; ++pc) {
        x += dq_part[(pc - 1) * dq_stride + i];
        y += dk_part[(pc - 1) * dq_stride + i];
      }
      dq[i] = x;
      dk[i] = y;
    }
    if (blockIdx.z > 0) return;
    if (threadIdx.x < nrow) {
      const size_t i = (size_t)bh * S + s0 + threadIdx.x;
      double x = dlam[i];
      for (int pc = 1; pc < chunks; ++pc)
        x += dl_part[(pc - 1) * (size_t)B * H * S + i];
      dlam[i] = x;
    }
  }
  const float* gt = gs + ((size_t)bh * nt + c) * np;
  const float* x = c + 1 < nt ? hs + ((size_t)bh * nt + c + 1) * np
                              : fin + (size_t)bh * np;
  double dot = 0.0;
  for (size_t e = threadIdx.x; e < np; e += THREADS)
    dot += (double)gt[e] * x[e];
  for (int o = 16; o > 0; o /= 2)
    dot += __shfl_xor_sync(0xffffffffu, dot, o);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = dot;
  __syncthreads();   // and dΛ of the tile is summed
  if (threadIdx.x == 0) {
    double acc = 0.0;
    for (int w = 0; w < THREADS / 32; ++w) acc += part[w];
    double suf = 0.0;
    for (int t = s0 + nrow - 1; t >= s0; --t) {
      suf += dlam[(size_t)bh * S + t];
      dla[((size_t)b * S + t) * H + h] = (float)(suf + acc);
    }
  }
}

// out[r][n] = Σ_h part[r][h][n], head 0 first, for dq (blockIdx.y 0) and
// dk (1) of q and k broadcast over the heads
__global__ void gla_bwd_head_sum_kernel(const float* dq, const float* dk,
                                        float* dq_sum, float* dk_sum, int H,
                                        int N, long long rows) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * N) return;
  const float* part = blockIdx.y ? dk : dq;
  const long long r = e / N, n = e % N;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += part[(r * H + h) * N + n];
  (blockIdx.y ? dk_sum : dq_sum)[e] = s;
}

template <typename E>
int run(const void* q, const void* k, const float* v, const float* la,
        const float* h0, const float* dy, const float* dh, float* hs,
        float* gs, float* hfin, float* dtot, double* dlam, double* dl_part,
        float* dq, float* dk, float* dq_part, float* dk_part, float* dv,
        float* dla, float* dh0, float* dq_sum, float* dk_sum, int B, int H,
        int S, int N, int P, const Strides& st, cudaStream_t stream) {
  const int nt = (S + T - 1) / T, chunks = (P + C - 1) / C;
  const int ssmem = state_smem(N);
  cudaError_t e = cudaFuncSetAttribute(
      gla_bwd_state_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ssmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gla_bwd_tile_kernel<E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TileSmem<E>::BYTES);
  if (e != cudaSuccess) return (int)e;
  StateArgs sa{{k, q},
               {{st.k[0], st.k[1], st.k[2], st.k[3]},
                {st.q[0], st.q[1], st.q[2], st.q[3]}},
               {v, dy},
               {{st.v[0], st.v[1], st.v[2], st.v[3]},
                {st.dy[0], st.dy[1], st.dy[2], st.dy[3]}},
               la,
               {st.la[0], st.la[1], st.la[2]},
               {hs, gs},
               dtot,
               H, S, N, P, nt};
  gla_bwd_state_kernel<E>
      <<<dim3(B * H * nt, 1, 2), THREADS, ssmem, stream>>>(sa);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long total = (long long)B * H * N * P;
  gla_bwd_carry_kernel<<<dim3((unsigned)((total + THREADS - 1) / THREADS), 2),
                         THREADS, 0, stream>>>(
      hs, gs, dtot, h0, dh, st.h0[0], st.h0[1], st.h0[2], st.h0[3], st.dh[0],
      st.dh[1], st.dh[2], st.dh[3], hfin, dh0, H, N, P, nt, total);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  TileArgs ta{q,       k,       v,  la,   dy,      hs, gs, dq, dk,
              dq_part, dk_part, dv, dlam, dl_part, st, B,  H,  S,  N,
              P,       nt};
  gla_bwd_tile_kernel<E>
      <<<dim3(B * H * nt, chunks), THREADS, TileSmem<E>::BYTES, stream>>>(
          ta);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  gla_bwd_dla_kernel<<<dim3(B * H, nt, chunks > 1 ? DLA_SPLIT : 1), THREADS,
                       0, stream>>>(
      dlam, dl_part, dq, dk, dq_part, dk_part, hs, gs, hfin, dla, B, H, S, N,
      P, nt, chunks);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (dq_sum != nullptr) {
    const long long n = (long long)B * S * N;
    const dim3 grid((unsigned)((n + 255) / 256), 2);
    gla_bwd_head_sum_kernel<<<grid, 256, 0, stream>>>(
        dq, dk, dq_sum, dk_sum, H, N, (long long)B * S);
    e = cudaGetLastError();
  }
  return (int)e;
}

}  // namespace

// Launch on `stream`; returns the first launch's CUDA error, or
// cudaErrorInvalidValue for an unknown dtype code (0 float32, 1 bfloat16)
// or N outside 1..256.  `strides` holds 27 element strides: q (b, s, h,
// n), k (b, s, h, n), v (b, s, h, p), la (b, s, h), h0 (b, h, n, p), dy
// (b, s, h, p), dh (b, h, n, p); h0 and dh may be null (zeros).  Scratch
// the wrapper allocates: hs and gs (B H, ceil(S / 64), N, P), hfin (B H,
// N, P), dtot (B H, ceil(S / 64)), dlam (B H, S) float64; with C =
// ceil(P / 64) chunks of P above one, dq_part and dk_part (C − 1, B, S,
// H, N) float32 and dl_part (C − 1, B H, S) float64 (null at one chunk);
// outputs, contiguous float32: dq and dk (B, S, H, N) per head, dv (B, S,
// H, P), dla (B, S, H), dh0 (B, H, N, P), and, where dq_sum and dk_sum
// are not null, the head sums (B, S, N).  The wrapper checks shapes and
// dtypes and never calls this with B, H, S or P equal to 0.
extern "C" int gla_bwd_launch(const void* q, const void* k, const void* v,
                              const void* la, const void* h0, const void* dy,
                              const void* dh, void* hs, void* gs, void* hfin,
                              void* dtot, void* dlam, void* dl_part, void* dq,
                              void* dk, void* dq_part, void* dk_part,
                              void* dv, void* dla, void* dh0, void* dq_sum,
                              void* dk_sum, int qk_dtype, int B, int H,
                              int S, int N, int P, const long long* strides,
                              void* stream) {
  if (N < 1 || N > MAX_N || qk_dtype < 0 || qk_dtype > 1)
    return (int)cudaErrorInvalidValue;
  Strides st;
  const long long* s = strides;
  for (int i = 0; i < 4; ++i) st.q[i] = *s++;
  for (int i = 0; i < 4; ++i) st.k[i] = *s++;
  for (int i = 0; i < 4; ++i) st.v[i] = *s++;
  for (int i = 0; i < 3; ++i) st.la[i] = *s++;
  for (int i = 0; i < 4; ++i) st.h0[i] = *s++;
  for (int i = 0; i < 4; ++i) st.dy[i] = *s++;
  for (int i = 0; i < 4; ++i) st.dh[i] = *s++;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  auto d = [](void* p) { return static_cast<double*>(p); };
  if (qk_dtype == 0)
    return run<float>(q, k, f(v), f(la), f(h0), f(dy), f(dh), w(hs), w(gs),
                      w(hfin), w(dtot), d(dlam), d(dl_part), w(dq), w(dk),
                      w(dq_part), w(dk_part), w(dv), w(dla), w(dh0),
                      w(dq_sum), w(dk_sum), B, H, S, N, P, st, cs);
  return run<__nv_bfloat16>(q, k, f(v), f(la), f(h0), f(dy), f(dh), w(hs),
                            w(gs), w(hfin), w(dtot), d(dlam), d(dl_part),
                            w(dq), w(dk), w(dq_part), w(dk_part), w(dv),
                            w(dla), w(dh0), w(dq_sum), w(dk_sum), B, H, S, N,
                            P, st, cs);
}
