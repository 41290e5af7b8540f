// decode_attention: single-token GQA decode over a KV cache
// (flash-decoding), on Hopper (sm_90a), for float32 and bfloat16.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
// decode_attention_pallas (body _decode_kernel), the TPU kernel behind the
// quantized decoder's attention="kernel" host segment and the LM substrate's
// decode step.  It computes the same function; it is not a block by block
// copy.
//
// Computes, per kv head row bh = b*KH + h and each of its G query heads:
//   out[bh, g] = softmax_s(q[bh, g] / sqrt(D) . k[b, s, h]) @ v[b, s, h]
// over the positions s < kv_len, in float32, output in q's dtype.  q may
// be of another dtype than the caches (a bfloat16 model over float32
// caches): it is read and upcast exactly, as the TPU kernel upcasts both.
// Positions at or past kv_len take no part (the TPU kernel gives them
// NEG_INF = -1e30 and skips their blocks: the same result), and l is
// clamped at 1e-30, so kv_len = 0 gives zeros.  kv_len is read on the
// device when the caller passes a device pointer, so no host sync is
// needed.
//
// Operands: q is (B*KH, G, D) contiguous; k and v are strided views of the
// caches, element (b, s, h, d) at b*sb + s*ss + h*sh + d (the cache-native
// (B, S, KH, D) layout needs no transpose); both caches share the strides.
//
// What bounds it on this card: every K and V row up to kv_len is read once
// for all G query heads (about 2 operations per byte), so the bound is the
// cache bytes at 3.35 TB/s.
//
// What the design does about it: split-KV, one launch.  Grid (B*KH, splits,
// head blocks); the host (kernel.py:decode_plan) picks the split count
// from the SM count and the rows actually read (kv_len when the host knows
// it, else S, and blocks wholly past a device kv_len do no work), so the
// grid comes to about two blocks per SM at the LM step shapes.  A block
// takes at most 8 of the G query heads (more would not fit in registers):
// G > 8 is cut into ceil(G / 8) blocks of (nearly) equal size, each
// reading the rows again.  In a block, each row of a K or V position is
// read by a group of lanes with 16-byte loads (D*sizeof(T)/16 lanes, a
// power of two), and the heads of the block share that read.  The rows
// stream through a 4-stage cp.async ring in shared memory (each lane
// reads back only the bytes of K and V it copied, so no barrier guards
// the ring): three steps are in flight while one is consumed.  A lane
// group takes R = 4 positions a step (2 for more than 4 heads a block):
// their dot products and shuffle reductions interleave, and one rescale
// of the group's online softmax (m, l, acc, float32 registers) serves
// all R; the groups of a block are merged in shared memory (over the
// dead ring).  With one split the block normalizes and writes the output;
// otherwise it writes its partial (m, l, acc[heads, D]) to a float32
// workspace, and the last block of its (kv head row, head block) to finish
// (a ticket counter, reset by that block) merges the splits in split order
// and writes the output.  Every merge runs in a fixed order and no float
// is added atomically, so the result is bitwise reproducible from call to
// call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 4;
// positions a lane group takes per step: R rows' reductions interleave,
// and one rescale of the running softmax serves them all
// (a stage holds a lane's 16 bytes of K and of V for each of R rows)
template <int MAXG>
struct Rows {
  static constexpr int R = MAXG <= 4 ? 4 : 2;
  static constexpr int STAGE_BYTES = THREADS * 32 * R;
};
constexpr float NEG_INF = -1e30f;

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
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int VEC = 4;
  __device__ static void load(const float* p, float (&f)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
  __device__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

template <typename T>
__device__ float to_float(T x);
template <>
__device__ float to_float<float>(float x) { return x; }
template <>
__device__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The last block of a (kv head row, head block) to arrive merges the
// partials of the splits that hold rows below L, in split order, and
// writes the normalized output.
template <typename TQ>
__device__ void merge_splits(const float* ws_m, const float* ws_l,
                             const float* ws_acc, unsigned* ticket,
                             TQ* out, float* smem, int bh, int splits,
                             int split_len, int L, int G, int g0, int GB,
                             int D) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == (unsigned)splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int np = min(splits, (L + split_len - 1) / split_len);
  // the splits' m and l for this block's heads, all loads in flight at once
  float* sm_m = smem;              // [np][GB]
  float* sm_l = smem + np * GB;    // [np][GB]
  for (int i = threadIdx.x; i < np * GB; i += THREADS) {
    const size_t part = ((size_t)bh * splits + i / GB) * G + g0 + i % GB;
    sm_m[i] = __ldcg(ws_m + part);
    sm_l[i] = __ldcg(ws_l + part);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < GB * D; e += THREADS) {
    const int g = e / D;
    const int d = e % D;
    float M = NEG_INF;
    for (int p = 0; p < np; ++p) M = fmaxf(M, sm_m[p * GB + g]);
    float Ls = 0.f, A = 0.f;
#pragma unroll 8
    for (int p = 0; p < np; ++p) {
      const float w = expf(sm_m[p * GB + g] - M);
      Ls += sm_l[p * GB + g] * w;
      A += __ldcg(ws_acc + (((size_t)bh * splits + p) * G + g0 + g) * D + d)
           * w;
    }
    Io<TQ>::store(out + ((size_t)bh * G + g0 + g) * D + d,
                  A / fmaxf(Ls, 1e-30f));
  }
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next call
}

// One block per (kv head row, split, head block): the block takes heads
// g0 = blockIdx.z * per up to g0 + per (fewer in the last block), with
// per <= MAXG.  `lpr` lanes read one position's D elements; 32 / lpr
// positions per warp step, WARPS * 32 / lpr per block step.
template <typename T, typename TQ, int MAXG>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ len_dev, int len_host,
                        float* __restrict__ ws_m, float* __restrict__ ws_l,
                        float* __restrict__ ws_acc,
                        unsigned* __restrict__ tickets, TQ* __restrict__ out,
                        int KH, int G, int per, int D, int S, int split_len,
                        int lpr, long long sb, long long ss, long long sh,
                        float scale) {
  constexpr int VEC = Io<T>::VEC;
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int g0 = blockIdx.z * per;           // this block's first head
  const int GB = min(per, G - g0);           // and its head count
  const int b = bh / KH;
  const int h = bh % KH;
  int L = len_dev != nullptr ? *len_dev : len_host;
  L = L < 0 ? 0 : (L > S ? S : L);
  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, L);
  unsigned* ticket = tickets + (size_t)bh * gridDim.z + blockIdx.z;
  if (splits > 1 && s0 >= L) {  // wholly past kv_len: only the ticket
    merge_splits<TQ>(ws_m, ws_l, ws_acc, ticket, out, smem, bh, splits,
                     split_len, L, G, g0, GB, D);
    return;
  }

  constexpr int R = Rows<MAXG>::R;
  constexpr int SB = Rows<MAXG>::STAGE_BYTES;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rpw = 32 / lpr;
  const int rows = WARPS * rpw;          // lane groups in the block
  const int rid = warp * rpw + lane / lpr;
  const int d0 = (lane % lpr) * VEC;
  const bool d_ok = d0 < D;
  // a step covers rows * R positions: group rid takes s0 + (j R + r) rows
  // + rid for r < R
  const int nsteps = s1 > s0 ? (s1 - s0 + rows * R - 1) / (rows * R) : 0;

  // the ring: row r's 16 bytes of K at (r THREADS + tid) 16, of V at
  // ((R + r) THREADS + tid) 16
  char* ring = reinterpret_cast<char*>(smem);
  const size_t off = (size_t)b * sb + (size_t)h * sh + d0;
  auto load_stage = [&](int j) {
    char* dst = ring + (j % STAGES) * SB + threadIdx.x * 16;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = s0 + (j * R + r) * rows + rid;
      const bool ok = s < s1 && d_ok;
      cp_async16(dst + r * THREADS * 16, ok ? k + off + (size_t)s * ss : k,
                 ok ? 16 : 0);
      cp_async16(dst + (R + r) * THREADS * 16,
                 ok ? v + off + (size_t)s * ss : v, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nsteps) load_stage(j);
    cp_async_commit();
  }

  float qf[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < GB && d_ok) {
      const TQ* qg = q + ((size_t)bh * G + g0 + g) * D + d0;
#pragma unroll
      for (int i = 0; i < VEC; ++i) qf[g][i] = to_float(qg[i]) * scale;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qf[g][i] = 0.f;
    }
  }
  float m[MAXG], l[MAXG], acc[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  for (int j = 0; j < nsteps; ++j) {  // uniform in the block
    cp_async_wait<STAGES - 2>();
    const char* src = ring + (j % STAGES) * SB + threadIdx.x * 16;
    float kf[R][VEC], vf[R][VEC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Io<T>::load(reinterpret_cast<const T*>(src + r * THREADS * 16), kf[r]);
      Io<T>::load(reinterpret_cast<const T*>(src + (R + r) * THREADS * 16),
                  vf[r]);
    }
    if (j + STAGES - 1 < nsteps) load_stage(j + STAGES - 1);
    cp_async_commit();
    float sc[R][MAXG];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot += qf[g][i] * kf[r][i];
        sc[r][g] = dot;
      }
    // the lane group's sums, all R * MAXG of them interleaved
#pragma unroll
    for (int lvl = 4; lvl >= 0; --lvl) {
      const int o = 1 << lvl;
      if (o >= lpr) continue;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          sc[r][g] += __shfl_xor_sync(0xffffffffu, sc[r][g], o);
    }
    bool ok[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ok[r] = s0 + (j * R + r) * rows + rid < s1;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= GB) continue;
      float mx = m[g];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (ok[r]) mx = fmaxf(mx, sc[r][g]);
      const float alpha = expf(m[g] - mx);  // 1 when the max held
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!ok[r]) continue;
        const float p = expf(sc[r][g] - mx);
        l[g] += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] += p * vf[r][i];
      }
      m[g] = mx;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is dead: its space takes the merge

  // merge the block's lane groups in a fixed order
  float* sm_m = smem;                       // [rows][GB]
  float* sm_l = sm_m + rows * GB;           // [rows][GB]
  float* sm_acc = sm_l + rows * GB;         // [rows][GB][D]
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= GB) continue;
    if (lane % lpr == 0) {
      sm_m[rid * GB + g] = m[g];
      sm_l[rid * GB + g] = l[g];
    }
    if (d_ok) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        sm_acc[(rid * GB + g) * D + d0 + i] = acc[g][i];
    }
  }
  __syncthreads();
  const size_t part = (size_t)bh * splits + split;
  for (int e = threadIdx.x; e < GB * D; e += THREADS) {
    const int g = e / D;
    const int d = e % D;
    float M = NEG_INF;
    for (int r = 0; r < rows; ++r) M = fmaxf(M, sm_m[r * GB + g]);
    float Ls = 0.f, A = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float w = expf(sm_m[r * GB + g] - M);
      Ls += sm_l[r * GB + g] * w;
      A += sm_acc[(r * GB + g) * D + d] * w;
    }
    if (splits == 1) {
      Io<TQ>::store(out + ((size_t)bh * G + g0 + g) * D + d,
                    A / fmaxf(Ls, 1e-30f));
      continue;
    }
    ws_acc[(part * G + g0 + g) * D + d] = A;
    if (d == 0) {
      ws_m[part * G + g0 + g] = M;
      ws_l[part * G + g0 + g] = Ls;
    }
  }
  if (splits > 1)
    merge_splits<TQ>(ws_m, ws_l, ws_acc, ticket, out, smem, bh, splits,
                     split_len, L, G, g0, GB, D);
}

template <typename T, typename TQ, int MAXG>
int launch(const void* q, const void* k, const void* v, const int* len_dev,
           int len_host, float* ws, unsigned* tickets, void* out, int BH,
           int KH, int G, int per, int D, int S, int split_len, int splits,
           int lpr, long long sb, long long ss, long long sh, float scale,
           cudaStream_t st) {
  const int rows = WARPS * (32 / lpr);
  const int hblocks = (G + per - 1) / per;
  const size_t merge = (size_t)rows * per * (D + 2) * sizeof(float);
  const size_t ring = (size_t)STAGES * Rows<MAXG>::STAGE_BYTES;
  const size_t splitm = (size_t)2 * splits * per * sizeof(float);
  size_t smem = merge > ring ? merge : ring;
  smem = splitm > smem ? splitm : smem;
  auto* fn = decode_attention_kernel<T, TQ, MAXG>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  float* ws_m = ws;
  float* ws_l = ws_m + (size_t)BH * splits * G;
  float* ws_acc = ws_l + (size_t)BH * splits * G;
  fn<<<dim3(BH, splits, hblocks), THREADS, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len_dev, len_host, ws_m, ws_l, ws_acc,
      tickets, static_cast<TQ*>(out), KH, G, per, D, S, split_len, lpr, sb,
      ss, sh, scale);
  return (int)cudaGetLastError();
}

// Heads per block: G itself up to 8, else ceil(G / ceil(G / 8)) (G = 9:
// blocks of 5 and 4).
template <typename T, typename TQ>
int dispatch_g(const void* q, const void* k, const void* v,
               const int* len_dev, int len_host, float* ws,
               unsigned* tickets, void* out, int BH, int KH, int G, int D,
               int S, int split_len, int splits, int lpr, long long sb,
               long long ss, long long sh, float scale, cudaStream_t st) {
  const int nb = (G + 7) / 8;
  const int per = (G + nb - 1) / nb;
#define DA_LAUNCH(MG)                                                     \
  return launch<T, TQ, MG>(q, k, v, len_dev, len_host, ws, tickets, out,  \
                           BH, KH, G, per, D, S, split_len, splits, lpr,  \
                           sb, ss, sh, scale, st)
  if (per <= 1) DA_LAUNCH(1);
  if (per <= 2) DA_LAUNCH(2);
  if (per <= 4) DA_LAUNCH(4);
  DA_LAUNCH(8);
#undef DA_LAUNCH
}

template <typename T>
int dispatch_q(int q_dtype, const void* q, const void* k, const void* v,
               const int* len_dev, int len_host, float* ws,
               unsigned* tickets, void* out, int BH, int KH, int G, int D,
               int S, int split_len, int splits, int lpr, long long sb,
               long long ss, long long sh, float scale, cudaStream_t st) {
  if (q_dtype == 0)
    return dispatch_g<T, float>(q, k, v, len_dev, len_host, ws, tickets, out,
                                BH, KH, G, D, S, split_len, splits, lpr, sb,
                                ss, sh, scale, st);
  if (q_dtype == 1)
    return dispatch_g<T, __nv_bfloat16>(q, k, v, len_dev, len_host, ws,
                                        tickets, out, BH, KH, G, D, S,
                                        split_len, splits, lpr, sb, ss, sh,
                                        scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch the kernel on `stream`; returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for an unknown dtype code (0 float32, 1
// bfloat16): `kv_dtype` for k and v, `q_dtype` for q and the output.  The
// wrapper checks shapes, strides and alignment, picks the split
// (kernel.py:decode_plan), allocates `out` and, for splits > 1, `ws` (BH *
// splits * G * (D + 2) floats) and `tickets` (BH * ceil(G / 8) zeroed
// words, left zeroed), and never calls this with BH, G or D equal to 0.
// `len_dev` is a device pointer to one int32, or null to use `len_host`.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* len_dev,
    int len_host, void* ws, void* tickets, void* out, int kv_dtype,
    int q_dtype, int BH, int KH, int G, int D, int S, int split_len,
    int splits, int lpr, long long sb, long long ss, long long sh,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ld = static_cast<const int*>(len_dev);
  float* w = static_cast<float*>(ws);
  unsigned* tk = static_cast<unsigned*>(tickets);
  if (kv_dtype == 0)
    return dispatch_q<float>(q_dtype, q, k, v, ld, len_host, w, tk, out, BH,
                             KH, G, D, S, split_len, splits, lpr, sb, ss, sh,
                             scale, st);
  if (kv_dtype == 1)
    return dispatch_q<__nv_bfloat16>(q_dtype, q, k, v, ld, len_host, w, tk,
                                     out, BH, KH, G, D, S, split_len, splits,
                                     lpr, sb, ss, sh, scale, st);
  return (int)cudaErrorInvalidValue;
}
