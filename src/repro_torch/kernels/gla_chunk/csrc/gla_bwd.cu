// gla_bwd: the gradient of the chunked gated-linear-attention scan
// (gla_chunk.cu's function) on Hopper (sm_90a), accurate to float32.
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
//   (a) gla_bwd_scan_kernel<E, 0>: the state entering each tile, the
//       forward's own tile walk (h ← e^{L_tot} h + (k ⊙ e^{L_tot − L})ᵀ
//       v), stored (B H, tiles, N, P), and the final state;
//   (b) gla_bwd_scan_kernel<E, 1>: G, the tiles walked from the last,
//       G ← e^{L_tot} G + (q ⊙ e^{L})ᵀ dy, the gradient leaving each tile
//       stored the same way, and G_0 = dh0.  Each element of a state
//       evolves on its own, so both walks are cut into blocks of 64 x 64
//       elements of (N, P), each walking every tile in order;
//   (c) gla_bwd_tile_kernel: one block a (batch, head, tile), in parallel
//       over the tiles, from the stored h_c and G_{c+1}: the weighted
//       causal score tile W and the output-gradient tile D, then dq and dk
//       in chunks of 64 columns of N (each a sum over all of P, looped
//       inside the block, so no partial sums leave it), then dv in chunks
//       of 64 columns of P, and each row's dΛ;
//   (d) gla_bwd_dla_kernel: dla, one block a (batch, head, tile): the
//       tile's reverse cumsum of dΛ plus ⟨G_{c+1}, h_{c+1}⟩;
//   (e) gla_bwd_head_sum_kernel, where q and k are broadcast: dq and dk
//       summed over the heads, head 0 first.
// Every sum runs in a fixed order and nothing is atomic, so two calls are
// bitwise equal.
//
// Precision: every product runs in float32 on the CUDA cores (fmaf), each
// term rounded as the plain float32 version rounds it, up to the order of
// the sums; dΛ's dot products and the sums that make dla from them run in
// float64, and dΛ's causal part is summed from the score tiles' small
// terms (dla's errors add up in Mamba2's A_log gradient, a weighted sum
// of it over every position).  Each tile's contribution to h and G
// is summed in fresh registers and then added to the carried state (X ←
// e^{L_tot} X + tile), so no sum is chained across the tiles in one
// accumulator (a float32 sum chained across tiles on the tensor cores
// truncates one-signed, PERF.md).
//
// What bounds it on this card: per tile and head about 2T²(3N + 2P) +
// 10TNP operations (the scans 4TNP, dq dk dv 6TNP, the two score tiles
// and their products) against (2N + 2P + 1) T words read, (2N + P + 1) T
// written and the two stored states (2NP a tile, written once and read
// once): at zamba2's N = P = 64 about 30 operations per byte, at xlstm's
// N 256, P 1025 about 200.  So the operations bound it, at the tensor
// cores' peak.  This kernel is a first, simple design: its products run
// on the CUDA cores (67 TFLOP/s of float32 at best, 4 x 4 register tiles
// fed from shared memory, two shared loads a multiply-add pair), so it
// runs well above that bound; tensor cores (3xTF32 on mma.sync, as
// gla_chunk.cu does) are its redesign.  The design keeps the stored
// states the one large cost of memory (h and G, 4 NP bytes a tile each).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 64;          // rows of a tile
constexpr int C = 64;          // columns of an operand chunk (of N or P)
constexpr int LD = C + 1;      // row stride of a shared T x C tile: reads
                               // along a row or a column are conflict-free
constexpr int THREADS = 256;   // 16 x 16 threads, each a 4 x 4 output tile
constexpr int MAX_N = 256;
constexpr int TILE_WORDS = T * LD;
// gla_bwd_tile_kernel's dynamic shared memory: W, D, four operand tiles,
// then la, L, e^L, e^{L_tot − L}, e^{L_tot}
constexpr int TILE_SMEM = (6 * TILE_WORDS + 4 * T + 4) * 4;

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
// a (B, S, H, width) operand, `base` at (b, 0, h, 0), into dst[r][c]
template <typename E>
__device__ void load_rows(float* dst, const E* base, long long s_stride,
                          long long c_stride, int s0, int S, int c0,
                          int width) {
  for (int e = threadIdx.x; e < T * C; e += THREADS) {
    const int r = e / C, c = e % C;
    float x = 0.f;
    if (s0 + r < S && c0 + c < width)
      x = ldf(base + (long long)(s0 + r) * s_stride +
              (long long)(c0 + c) * c_stride);
    dst[r * LD + c] = x;
  }
}

// rows n0 .. n0 + C − 1 and columns p0 .. p0 + C − 1 of a contiguous
// (N, P) state into dst[n][p], zeros past N and P
__device__ void load_state(float* dst, const float* st, int n0, int p0,
                           int N, int P) {
  for (int e = threadIdx.x; e < C * C; e += THREADS) {
    const int r = e / C, c = e % C;
    dst[r * LD + c] = (n0 + r < N && p0 + c < P)
                          ? st[(size_t)(n0 + r) * P + p0 + c]
                          : 0.f;
  }
}

// acc[i][j] += Σ_{kk < K} A(r_i, kk) B(kk, c_j) over this thread's rows
// r_i = ty + 16 i and columns c_j = tx + 16 j of a 64 x 64 output, with
// A(r, kk) = a[r * ar + kk * ak] and B(kk, c) = b[kk * bk + c * bc] in
// shared memory (the strides give either orientation of a stored tile)
__device__ __forceinline__ void gemm(float (&acc)[4][4], const float* a,
                                     int ar, int ak, const float* b, int bk,
                                     int bc, int K) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * ar + kk * ak];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[kk * bk + (tx + 16 * j) * bc];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// L = cumsum(la) over the tile (one thread, in order: every kernel here
// forms the same L), then e^{L}, e^{L_tot − L} and e^{L_tot}
__device__ void tile_scales(const float* la_s, float* Ls, float* eL,
                            float* eK, float* eTot) {
  if (threadIdx.x == 0) {
    float l = 0.f;
    for (int r = 0; r < T; ++r) {
      l += la_s[r];
      Ls[r] = l;
    }
  }
  __syncthreads();
  if (threadIdx.x < T) {
    eL[threadIdx.x] = expf(Ls[threadIdx.x]);
    eK[threadIdx.x] = expf(Ls[T - 1] - Ls[threadIdx.x]);
  }
  if (threadIdx.x == 0) *eTot = expf(Ls[T - 1]);
  __syncthreads();
}

// the la of one tile of (b, h), zeros past S
__device__ void load_la(float* la_s, const float* lb, long long s_stride,
                        int s0, int S) {
  if (threadIdx.x < T)
    la_s[threadIdx.x] = s0 + threadIdx.x < S
                            ? lb[(long long)(s0 + threadIdx.x) * s_stride]
                            : 0.f;
}

struct ScanArgs {
  const void* a;          // k (forward) or q (backward), (B, S, Hq, N)
  long long as[4];
  const float* m;         // v (forward) or dy (backward), (B, S, H, P)
  long long ms[4];
  const float* la;
  long long ls[3];
  const float* x0;        // h0 (forward) or dh (backward), or null (zeros)
  long long xs[4];
  float* states;          // (B H, tiles, N, P)
  float* fin;             // (B H, N, P): the last state, or G_0
  int H, S, N, P, nt;
};

// grid (B H, ceil(N / C), ceil(P / C)): one 64 x 64 block of the state of
// one (b, h), walked over every tile: forward (REV 0) from h0, storing the
// state entering each tile; backward (REV 1) from dh, the tiles last to
// first, storing the gradient leaving each tile.  X[n][p] ← e^{L_tot}
// X[n][p] + Σ_j s_j a_j[n] m_j[p], s = e^{L_tot − L} forward, e^{L}
// backward, the tile's sum in fresh registers.
template <typename E, int REV>
__global__ void __launch_bounds__(THREADS)
gla_bwd_scan_kernel(ScanArgs g) {
  __shared__ float As[TILE_WORDS], Ms[TILE_WORDS];
  __shared__ float la_s[T], Ls[T], eL[T], eK[T], eTot[1];
  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int n0 = blockIdx.y * C, p0 = blockIdx.z * C;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const E* ab = static_cast<const E*>(g.a) + b * g.as[0] + h * g.as[2];
  const float* mb = g.m + b * g.ms[0] + h * g.ms[2];
  const float* lb = g.la + b * g.ls[0] + h * g.ls[2];
  const float* scale = REV ? eL : eK;

  float X[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + ty + 16 * i, p = p0 + tx + 16 * j;
      X[i][j] = (g.x0 != nullptr && n < g.N && p < g.P)
                    ? g.x0[b * g.xs[0] + h * g.xs[1] + n * g.xs[2] +
                           p * g.xs[3]]
                    : 0.f;
    }

  for (int step = 0; step < g.nt; ++step) {
    const int c = REV ? g.nt - 1 - step : step, s0 = c * T;
    __syncthreads();   // the last tile's reads of As and Ms are done
    load_rows(As, ab, g.as[1], g.as[3], s0, g.S, n0, g.N);
    load_rows(Ms, mb, g.ms[1], g.ms[3], s0, g.S, p0, g.P);
    load_la(la_s, lb, g.ls[1], s0, g.S);
    __syncthreads();
    tile_scales(la_s, Ls, eL, eK, eTot);
    for (int e = threadIdx.x; e < T * C; e += THREADS)
      As[(e / C) * LD + e % C] *= scale[e / C];
    float* st = g.states + ((size_t)bh * g.nt + c) * g.N * g.P;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + ty + 16 * i, p = p0 + tx + 16 * j;
        if (n < g.N && p < g.P) st[(size_t)n * g.P + p] = X[i][j];
      }
    __syncthreads();   // the scaled rows are in
    float acc[4][4];
    zero(acc);
    gemm(acc, As, 1, LD, Ms, LD, 1, T);
    const float d = eTot[0];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) X[i][j] = d * X[i][j] + acc[i][j];
  }
  float* fo = g.fin + (size_t)bh * g.N * g.P;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + ty + 16 * i, p = p0 + tx + 16 * j;
      if (n < g.N && p < g.P) fo[(size_t)n * g.P + p] = X[i][j];
    }
}

struct TileArgs {
  const void* q;
  const void* k;
  const float* v;
  const float* la;
  const float* dy;
  const float* hs;        // (B H, tiles, N, P): h_c
  const float* gs;        // (B H, tiles, N, P): G_{c+1}
  float* dq;              // (B, S, H, N), per head
  float* dk;
  float* dv;              // (B, S, H, P)
  double* dlam;           // (B H, S)
  Strides st;
  int H, S, N, P, nt;
};

// causal (j <= i) tile e^{L_i − L_j} acc into dst[i][j], zeros above the
// diagonal (masked before the exponential)
__device__ __forceinline__ void store_causal(float* dst,
                                             const float (&acc)[4][4],
                                             const float* Ls) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      dst[r * LD + c] = c <= r ? acc[i][j] * expf(Ls[r] - Ls[c]) : 0.f;
    }
}

// one block a (b, h, tile): grid B H tiles
template <typename E>
__global__ void __launch_bounds__(THREADS)
gla_bwd_tile_kernel(TileArgs g) {
  extern __shared__ __align__(16) float sm[];
  float* Wm = sm;                      // W[i][j] = (q_i·k_j) e^{L_i−L_j}
  float* Dm = Wm + TILE_WORDS;         // D[i][j] = (dy_i·v_j) e^{L_i−L_j}
  float* b0 = Dm + TILE_WORDS;
  float* b1 = b0 + TILE_WORDS;
  float* b2 = b1 + TILE_WORDS;
  float* b3 = b2 + TILE_WORDS;
  float* la_s = b3 + TILE_WORDS;
  float* Ls = la_s + T;
  float* eL = Ls + T;
  float* eK = eL + T;
  float* eTot = eK + T;

  const int bh = blockIdx.x / g.nt, c = blockIdx.x % g.nt;
  const int b = bh / g.H, h = bh % g.H, s0 = c * T;
  const int nrow = min(T, g.S - s0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const Strides& st = g.st;
  const E* qb = static_cast<const E*>(g.q) + b * st.q[0] + h * st.q[2];
  const E* kb = static_cast<const E*>(g.k) + b * st.k[0] + h * st.k[2];
  const float* vb = g.v + b * st.v[0] + h * st.v[2];
  const float* yb = g.dy + b * st.dy[0] + h * st.dy[2];
  const float* lb = g.la + b * st.la[0] + h * st.la[2];
  const float* hc = g.hs + ((size_t)bh * g.nt + c) * g.N * g.P;
  const float* gc = g.gs + ((size_t)bh * g.nt + c) * g.N * g.P;

  load_la(la_s, lb, st.la[1], s0, g.S);
  __syncthreads();
  tile_scales(la_s, Ls, eL, eK, eTot);

  float acc[4][4];
  // W: q kᵀ over N
  zero(acc);
  for (int n0 = 0; n0 < g.N; n0 += C) {
    __syncthreads();
    load_rows(b0, qb, st.q[1], st.q[3], s0, g.S, n0, g.N);
    load_rows(b1, kb, st.k[1], st.k[3], s0, g.S, n0, g.N);
    __syncthreads();
    gemm(acc, b0, LD, 1, b1, 1, LD, C);
  }
  store_causal(Wm, acc, Ls);
  float sraw[4][4];   // q_i·k_j, for dΛ's causal part
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sraw[i][j] = acc[i][j];
  // D: dy vᵀ over P
  zero(acc);
  for (int p0 = 0; p0 < g.P; p0 += C) {
    __syncthreads();
    load_rows(b0, yb, st.dy[1], st.dy[3], s0, g.S, p0, g.P);
    load_rows(b1, vb, st.v[1], st.v[3], s0, g.S, p0, g.P);
    __syncthreads();
    gemm(acc, b0, LD, 1, b1, 1, LD, C);
  }
  store_causal(Dm, acc, Ls);

  // dΛ's causal part, Σ_j A_ij − Σ_j A_ji with A_ij = (dy_i·v_j)(q_i·k_j)
  // e^{L_i−L_j} (j ≤ i): sums of small terms, as autograd of the forward
  // forms them (q_i·dq_i − k_i·dk_i would dot rounded sums); row sums
  // per thread (finished by the row's butterfly below), column sums over
  // the 16 thread rows through shared memory (b2, free until the loops)
  double dl[4], col[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dl[i] = 0.0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c2 = tx + 16 * j;
      const double a = c2 <= r ? (double)acc[i][j] * sraw[i][j] *
                                     expf(Ls[r] - Ls[c2])
                               : 0.0;
      dl[i] += a;
      col[j] += a;
    }
  }
  double* csum = reinterpret_cast<double*>(b2);   // [16][T]
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) csum[ty * T + tx + 16 * j] = col[j];
  __syncthreads();
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      double cs = 0.0;
      for (int y = 0; y < 16; ++y) cs += csum[y * T + r];
      dl[i] -= cs;
    }
  }

  // dq and dk, 64 columns of N at a time; their states' parts of dΛ
  for (int n0 = 0; n0 < g.N; n0 += C) {
    __syncthreads();
    load_rows(b0, qb, st.q[1], st.q[3], s0, g.S, n0, g.N);
    load_rows(b1, kb, st.k[1], st.k[3], s0, g.S, n0, g.N);
    // dq: e^{L_i} Σ_p dy_i[p] h_c[n][p], then + D k
    zero(acc);
    for (int p0 = 0; p0 < g.P; p0 += C) {
      __syncthreads();
      load_rows(b2, yb, st.dy[1], st.dy[3], s0, g.S, p0, g.P);
      load_state(b3, hc, n0, p0, g.N, g.P);
      __syncthreads();
      gemm(acc, b2, LD, 1, b3, 1, LD, C);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] *= eL[ty + 16 * i];
        dl[i] += (double)b0[(ty + 16 * i) * LD + tx + 16 * j] * acc[i][j];
      }
    gemm(acc, Dm, LD, 1, b1, LD, 1, T);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, n = n0 + tx + 16 * j;
        if (r < nrow && n < g.N)
          g.dq[(((size_t)b * g.S + s0 + r) * g.H + h) * g.N + n] = acc[i][j];
      }
    // dk: e^{L_tot − L_j} Σ_p v_j[p] G[n][p], then + Dᵀ q
    zero(acc);
    for (int p0 = 0; p0 < g.P; p0 += C) {
      __syncthreads();
      load_rows(b2, vb, st.v[1], st.v[3], s0, g.S, p0, g.P);
      load_state(b3, gc, n0, p0, g.N, g.P);
      __syncthreads();
      gemm(acc, b2, LD, 1, b3, 1, LD, C);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] *= eK[ty + 16 * i];
        dl[i] -= (double)b1[(ty + 16 * i) * LD + tx + 16 * j] * acc[i][j];
      }
    gemm(acc, Dm, 1, LD, b0, LD, 1, T);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, n = n0 + tx + 16 * j;
        if (r < nrow && n < g.N)
          g.dk[(((size_t)b * g.S + s0 + r) * g.H + h) * g.N + n] = acc[i][j];
      }
  }
  // dΛ of each row: the 16 threads of a row (one half-warp) in a fixed
  // butterfly
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o /= 2)
      dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], o);
    const int r = ty + 16 * i;
    if (tx == 0 && r < nrow) g.dlam[(size_t)bh * g.S + s0 + r] = dl[i];
  }

  // dv, 64 columns of P at a time: e^{L_tot − L_j} Σ_n k_j[n] G[n][p],
  // then + Wᵀ dy
  for (int p0 = 0; p0 < g.P; p0 += C) {
    zero(acc);
    for (int n0 = 0; n0 < g.N; n0 += C) {
      __syncthreads();
      load_rows(b0, kb, st.k[1], st.k[3], s0, g.S, n0, g.N);
      load_state(b1, gc, n0, p0, g.N, g.P);
      __syncthreads();
      gemm(acc, b0, LD, 1, b1, LD, 1, C);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= eK[ty + 16 * i];
    __syncthreads();
    load_rows(b2, yb, st.dy[1], st.dy[3], s0, g.S, p0, g.P);
    __syncthreads();
    gemm(acc, Wm, 1, LD, b2, LD, 1, T);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, p = p0 + tx + 16 * j;
        if (r < nrow && p < g.P)
          g.dv[(((size_t)b * g.S + s0 + r) * g.H + h) * g.P + p] = acc[i][j];
      }
  }
}

// grid (B H, tiles): dla[b, t, h] for the rows t of one tile c = the
// tile's Σ_{u ≥ t} dlam[bh, u] plus ⟨G_{c+1}, h_{c+1}⟩ (gs[c], and
// hs[c + 1] or the final state), all in float64 in a fixed order
__global__ void __launch_bounds__(THREADS)
gla_bwd_dla_kernel(const double* dlam, const float* hs, const float* gs,
                   const float* fin, float* dla, int H, int S, int N, int P,
                   int nt) {
  __shared__ double part[THREADS / 32];
  const int bh = blockIdx.x, c = blockIdx.y, b = bh / H, h = bh % H;
  const size_t np = (size_t)N * P;
  const float* g = gs + ((size_t)bh * nt + c) * np;
  const float* x = c + 1 < nt ? hs + ((size_t)bh * nt + c + 1) * np
                              : fin + (size_t)bh * np;
  double dot = 0.0;
  for (size_t e = threadIdx.x; e < np; e += THREADS)
    dot += (double)g[e] * x[e];
  for (int o = 16; o > 0; o /= 2)
    dot += __shfl_xor_sync(0xffffffffu, dot, o);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = dot;
  __syncthreads();
  if (threadIdx.x == 0) {
    double acc = 0.0;
    for (int w = 0; w < THREADS / 32; ++w) acc += part[w];
    const int s0 = c * T, last = min(S, s0 + T) - 1;
    double suf = 0.0;
    for (int t = last; t >= s0; --t) {
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
        float* gs, float* hfin, double* dlam, float* dq, float* dk,
        float* dv, float* dla, float* dh0, float* dq_sum, float* dk_sum,
        int B, int H, int S, int N, int P, const Strides& st,
        cudaStream_t stream) {
  const int nt = (S + T - 1) / T;
  const dim3 sgrid(B * H, (N + C - 1) / C, (P + C - 1) / C);
  ScanArgs fwd{k, {st.k[0], st.k[1], st.k[2], st.k[3]}, v,
               {st.v[0], st.v[1], st.v[2], st.v[3]}, la,
               {st.la[0], st.la[1], st.la[2]}, h0,
               {st.h0[0], st.h0[1], st.h0[2], st.h0[3]}, hs, hfin, H, S, N, P,
               nt};
  gla_bwd_scan_kernel<E, 0><<<sgrid, THREADS, 0, stream>>>(fwd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ScanArgs rev{q, {st.q[0], st.q[1], st.q[2], st.q[3]}, dy,
               {st.dy[0], st.dy[1], st.dy[2], st.dy[3]}, la,
               {st.la[0], st.la[1], st.la[2]}, dh,
               {st.dh[0], st.dh[1], st.dh[2], st.dh[3]}, gs, dh0, H, S, N, P,
               nt};
  gla_bwd_scan_kernel<E, 1><<<sgrid, THREADS, 0, stream>>>(rev);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(gla_bwd_tile_kernel<E>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           TILE_SMEM);
  if (e != cudaSuccess) return (int)e;
  TileArgs ta{q, k, v, la, dy, hs, gs, dq, dk, dv, dlam, st, H, S, N, P, nt};
  gla_bwd_tile_kernel<E><<<B * H * nt, THREADS, TILE_SMEM, stream>>>(ta);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gla_bwd_dla_kernel<<<dim3(B * H, nt), THREADS, 0, stream>>>(
      dlam, hs, gs, hfin, dla, H, S, N, P, nt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
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
// N, P), dlam (B H, S) float64; outputs, contiguous float32: dq and dk (B,
// S, H, N) per head, dv (B, S, H, P), dla (B, S, H), dh0 (B, H, N, P), and, where
// dq_sum and dk_sum are not null, the head sums (B, S, N).  The wrapper
// checks shapes and dtypes and never calls this with B, H, S or P equal
// to 0.
extern "C" int gla_bwd_launch(const void* q, const void* k, const void* v,
                              const void* la, const void* h0, const void* dy,
                              const void* dh, void* hs, void* gs, void* hfin,
                              void* dlam, void* dq, void* dk, void* dv,
                              void* dla, void* dh0, void* dq_sum,
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
  double* dl = static_cast<double*>(dlam);
  if (qk_dtype == 0)
    return run<float>(q, k, f(v), f(la), f(h0), f(dy), f(dh), w(hs), w(gs),
                      w(hfin), dl, w(dq), w(dk), w(dv), w(dla), w(dh0),
                      w(dq_sum), w(dk_sum), B, H, S, N, P, st, cs);
  return run<__nv_bfloat16>(q, k, f(v), f(la), f(h0), f(dy), f(dh), w(hs),
                            w(gs), w(hfin), dl, w(dq), w(dk), w(dv), w(dla),
                            w(dh0), w(dq_sum), w(dk_sum), B, H, S, N, P, st,
                            cs);
}
