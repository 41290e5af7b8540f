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
// What the design does about it: split-KV.  Grid (B*KH, splits, head
// blocks), with the split count fixed by S (one split per SPLIT positions),
// so long caches fill the card even at B = 1.  A block takes at most 8 of
// the G query heads (more would not fit in registers): G > 8 is cut into
// ceil(G / 8) blocks of (nearly) equal size, each reading the rows again.
// In a block, each row of a K or V position is read by a group of lanes
// with 16-byte loads (D*sizeof(T)/16 lanes, a power of two), and the heads
// of the block share that read.  Each lane group keeps an online softmax
// (m, l, acc) in float32 registers; the groups of a block are merged in
// shared memory, and the block writes its partial (m, l, acc[heads, D]) to
// a float32 workspace.  A second kernel combines the splits.  Both merges
// run in a fixed order and nothing is atomic, so the result is bitwise
// reproducible from call to call.  Not done yet: cp.async
// or TMA pipelining of the cache stream, and more rows in flight per block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

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

// One block per (kv head row, split, head block): the block takes heads
// g0 = blockIdx.z * per up to g0 + per (fewer in the last block), with
// per <= MAXG.  `lpr` lanes read one position's D elements; 32 / lpr
// positions per warp step, WARPS * 32 / lpr per block.
template <typename T, typename TQ, int MAXG>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ len_dev,
                    int len_host, float* __restrict__ ws_m,
                    float* __restrict__ ws_l, float* __restrict__ ws_acc,
                    int KH, int G, int per, int D, int S, int split_len,
                    int lpr, long long sb, long long ss, long long sh,
                    float scale) {
  constexpr int VEC = Io<T>::VEC;
  extern __shared__ float smem[];
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

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rpw = 32 / lpr;
  const int rows = WARPS * rpw;          // positions in flight per block
  const int rid = warp * rpw + lane / lpr;
  const int d0 = (lane % lpr) * VEC;
  const bool d_ok = d0 < D;

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

  const size_t off = (size_t)b * sb + (size_t)h * sh + d0;
  for (int base = s0; base < s1; base += rows) {  // uniform in the block
    const int s = base + rid;
    const bool ok = s < s1;
    float kf[VEC];
    if (ok && d_ok) {
      Io<T>::load(k + off + (size_t)s * ss, kf);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = 0.f;
    }
    float sc[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) dot += qf[g][i] * kf[i];
      for (int o = lpr >> 1; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      sc[g] = dot;
    }
    if (ok) {
      float vf[VEC];
      if (d_ok) {
        Io<T>::load(v + off + (size_t)s * ss, vf);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) vf[i] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= GB) continue;
        if (sc[g] > m[g]) {  // new max: rescale what came before
          const float alpha = expf(m[g] - sc[g]);
          l[g] = l[g] * alpha + 1.f;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] = acc[g][i] * alpha + vf[i];
          m[g] = sc[g];
        } else {
          const float p = expf(sc[g] - m[g]);
          l[g] += p;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] += p * vf[i];
        }
      }
    }
  }

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
    ws_acc[(part * G + g0 + g) * D + d] = A;
    if (d == 0) {
      ws_m[part * G + g0 + g] = M;
      ws_l[part * G + g0 + g] = Ls;
    }
  }
}

// One block per kv head row: combine the splits in order, normalize.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ ws_m,
                      const float* __restrict__ ws_l,
                      const float* __restrict__ ws_acc, T* __restrict__ out,
                      int G, int D, int splits) {
  const int bh = blockIdx.x;
  for (int e = threadIdx.x; e < G * D; e += THREADS) {
    const int g = e / D;
    const int d = e % D;
    float M = NEG_INF;
    for (int p = 0; p < splits; ++p)
      M = fmaxf(M, ws_m[((size_t)bh * splits + p) * G + g]);
    float Ls = 0.f, A = 0.f;
    for (int p = 0; p < splits; ++p) {
      const size_t part = (size_t)bh * splits + p;
      const float w = expf(ws_m[part * G + g] - M);
      Ls += ws_l[part * G + g] * w;
      A += ws_acc[(part * G + g) * D + d] * w;
    }
    Io<T>::store(out + ((size_t)bh * G + g) * D + d, A / fmaxf(Ls, 1e-30f));
  }
}

template <typename T, typename TQ, int MAXG>
int launch(const void* q, const void* k, const void* v, const int* len_dev,
           int len_host, float* ws, void* out, int BH, int KH, int G,
           int per, int D, int S, int split_len, int splits, int lpr,
           long long sb, long long ss, long long sh, float scale,
           cudaStream_t st) {
  const int rows = WARPS * (32 / lpr);
  const int hblocks = (G + per - 1) / per;
  const size_t smem = (size_t)rows * per * (D + 2) * sizeof(float);
  float* ws_m = ws;
  float* ws_l = ws_m + (size_t)BH * splits * G;
  float* ws_acc = ws_l + (size_t)BH * splits * G;
  decode_split_kernel<T, TQ, MAXG>
      <<<dim3(BH, splits, hblocks), THREADS, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len_dev, len_host, ws_m, ws_l, ws_acc, KH, G,
      per, D, S, split_len, lpr, sb, ss, sh, scale);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  decode_combine_kernel<TQ><<<BH, THREADS, 0, st>>>(
      ws_m, ws_l, ws_acc, static_cast<TQ*>(out), G, D, splits);
  return (int)cudaGetLastError();
}

// Heads per block: G itself up to 8, else ceil(G / ceil(G / 8)) (G = 9:
// blocks of 5 and 4).
template <typename T, typename TQ>
int dispatch_g(const void* q, const void* k, const void* v,
               const int* len_dev, int len_host, float* ws, void* out,
               int BH, int KH, int G, int D, int S, int split_len,
               int splits, int lpr, long long sb, long long ss, long long sh,
               float scale, cudaStream_t st) {
  const int nb = (G + 7) / 8;
  const int per = (G + nb - 1) / nb;
#define DA_LAUNCH(MG)                                                   \
  return launch<T, TQ, MG>(q, k, v, len_dev, len_host, ws, out, BH, KH, \
                           G, per, D, S, split_len, splits, lpr, sb, ss, \
                           sh, scale, st)
  if (per <= 1) DA_LAUNCH(1);
  if (per <= 2) DA_LAUNCH(2);
  if (per <= 4) DA_LAUNCH(4);
  DA_LAUNCH(8);
#undef DA_LAUNCH
}

template <typename T>
int dispatch_q(int q_dtype, const void* q, const void* k, const void* v,
               const int* len_dev, int len_host, float* ws, void* out,
               int BH, int KH, int G, int D, int S, int split_len,
               int splits, int lpr, long long sb, long long ss, long long sh,
               float scale, cudaStream_t st) {
  if (q_dtype == 0)
    return dispatch_g<T, float>(q, k, v, len_dev, len_host, ws, out, BH, KH,
                                G, D, S, split_len, splits, lpr, sb, ss, sh,
                                scale, st);
  if (q_dtype == 1)
    return dispatch_g<T, __nv_bfloat16>(q, k, v, len_dev, len_host, ws, out,
                                        BH, KH, G, D, S, split_len, splits,
                                        lpr, sb, ss, sh, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch both kernels on `stream`; returns the first cudaGetLastError() that
// is not 0, or cudaErrorInvalidValue for an unknown dtype code (0 float32,
// 1 bfloat16): `kv_dtype` for k and v, `q_dtype` for q and the output.  The
// wrapper checks shapes, strides and alignment, allocates `ws` (BH * splits
// * G * (D + 2) floats) and `out`, and never calls this with BH, G or D
// equal to 0.  `len_dev` is a device pointer to one int32, or null to use
// `len_host`.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* len_dev,
    int len_host, void* ws, void* out, int kv_dtype, int q_dtype, int BH,
    int KH, int G, int D, int S, int split_len, int splits, int lpr,
    long long sb, long long ss, long long sh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ld = static_cast<const int*>(len_dev);
  float* w = static_cast<float*>(ws);
  if (kv_dtype == 0)
    return dispatch_q<float>(q_dtype, q, k, v, ld, len_host, w, out, BH, KH,
                             G, D, S, split_len, splits, lpr, sb, ss, sh,
                             scale, st);
  if (kv_dtype == 1)
    return dispatch_q<__nv_bfloat16>(q_dtype, q, k, v, ld, len_host, w, out,
                                     BH, KH, G, D, S, split_len, splits, lpr,
                                     sb, ss, sh, scale, st);
  return (int)cudaErrorInvalidValue;
}
