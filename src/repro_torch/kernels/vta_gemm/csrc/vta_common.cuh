// Device helpers shared by vta_gemm's two sources (vta_gemm.cu: the skinny
// instance and the amax launch; vta_wgmma.cu: the wgmma instance and the
// quantize launch): activation loads and their int8 quantization, the
// x_scale steps, the grid-wide amax, and the epilogue of one output.
// Every step is the plain chain's (ref.py), in its order; built without
// fast math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vta {

enum { EPI_NONE = 0, EPI_REQUANT = 1, EPI_DEQUANT = 2, EPI_QLINEAR = 3 };
enum { A_INT8 = 0, A_F32 = 1, A_BF16 = 2 };

constexpr unsigned SPIN_LIMIT = 1u << 26;  // ~4 s at 64 ns: a hang traps

// ---- activations: int8 as they are, or float quantized on the way in ----
template <typename AT>
struct Act;

template <>
struct Act<int8_t> {
  // 16 int8 from p: one 16-byte load (VEC: K % 16 == 0 and aligned
  // rows, so a chunk is all in or all out), else bytes, zero past `n`
  template <bool VEC>
  __device__ static int4 load16(const int8_t* p, int n, float) {
    if (VEC) return *reinterpret_cast<const int4*>(p);
    alignas(16) int8_t b[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) b[i] = i < n ? p[i] : (int8_t)0;
    return *reinterpret_cast<const int4*>(b);
  }
};

template <typename XT>
struct XIo;
template <>
struct XIo<float> {
  __device__ static float f(float v) { return v; }
  // a float32 result is already in x's dtype
  __device__ static float in_dtype(float v) { return v; }
  __device__ static void store(float* p, float v) { *p = v; }
  // two adjacent results (p 8-byte aligned)
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  // 16 elements a thread: four 16-byte loads
  __device__ static void load16v(const float* p, float (&f)[16]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      f[4 * i] = v.x; f[4 * i + 1] = v.y; f[4 * i + 2] = v.z;
      f[4 * i + 3] = v.w;
    }
  }
};
template <>
struct XIo<__nv_bfloat16> {
  __device__ static float f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static float in_dtype(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  // each rounded to nearest even on its own, as store() rounds
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  __device__ static void load16v(const __nv_bfloat16* p, float (&f)[16]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 t = __bfloat1622float2(h[j]);
        f[8 * i + 2 * j] = t.x;
        f[8 * i + 2 * j + 1] = t.y;
      }
    }
  }
};

// clip(rint(x / xs), -128, 127) of the IEEE quotient
__device__ __forceinline__ int8_t quant1(float x, float xs) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(x, xs)), -128.f), 127.f);
  return (int8_t)(int)q;
}

// float activations, quantized with x_scale as they are loaded
template <typename XT>
struct Act {
  template <bool VEC>
  __device__ static int4 load16(const XT* p, int n, float xs) {
    float f[16];
    if (VEC) {
      XIo<XT>::load16v(p, f);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) f[i] = i < n ? XIo<XT>::f(p[i]) : 0.f;
    }
    alignas(16) int8_t b[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) b[i] = quant1(f[i], xs);
    return *reinterpret_cast<const int4*>(b);
  }
};

// x_scale from amax (the bits of max|x|): clamp, divide, round in x's dtype
template <typename XT>
__device__ __forceinline__ float x_scale_of(unsigned amax_bits, float lo) {
  const float a = fmaxf(__uint_as_float(amax_bits), lo);
  return XIo<XT>::in_dtype(__fdiv_rn(a, 127.0f));
}

template <typename XT>
__device__ __forceinline__ unsigned abs_bits(XT v) {
  return __float_as_uint(XIo<XT>::f(v)) & 0x7fffffffu;
}

// max over the block of each thread's `v`; every thread gets the result
__device__ __forceinline__ unsigned block_max(unsigned v, unsigned* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  unsigned r = 0u;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) r = max(r, red[w]);
  return r;
}

// The grid-wide amax of a cooperative launch, from each thread's max of
// |x| bits `v`: sync[0] the bits of max|x|, sync[1] arrivals, sync[2]
// departures; the last to depart zeroes all three.  Every block waits for
// every other; all get x_scale.
template <typename XT>
__device__ float grid_x_scale_of(unsigned v, unsigned* sync, float lo,
                                 unsigned* red, float* xs_sh) {
  const unsigned nb = gridDim.x * gridDim.y;
  v = block_max(v, red);
  if (threadIdx.x == 0) {
    atomicMax(sync, v);
    __threadfence();
    atomicAdd(sync + 1, 1u);
    unsigned spins = 0;
    while (*reinterpret_cast<volatile unsigned*>(sync + 1) < nb) {
      __nanosleep(64);
      if (++spins > SPIN_LIMIT) __trap();
    }
    __threadfence();
    const unsigned a = *reinterpret_cast<volatile unsigned*>(sync);
    *xs_sh = x_scale_of<XT>(a, lo);
    if (atomicAdd(sync + 2, 1u) == nb - 1) {
      sync[0] = 0u;
      sync[1] = 0u;
      sync[2] = 0u;
    }
  }
  __syncthreads();
  return *xs_sh;
}

// the same over x's n elements: each block reduces a contiguous share
template <typename XT>
__device__ float grid_x_scale(const XT* x, long long n, unsigned* sync,
                              float lo, unsigned* red, float* xs_sh) {
  const long long nb = (long long)gridDim.x * gridDim.y;
  const long long b = blockIdx.x + (long long)gridDim.x * blockIdx.y;
  const long long per = (n + nb - 1) / nb;
  const long long i0 = b * per;
  const long long i1 = min(n, i0 + per);
  unsigned v = 0u;
  for (long long i = i0 + threadIdx.x; i < i1; i += blockDim.x)
    v = max(v, abs_bits(x[i]));
  return grid_x_scale_of<XT>(v, sync, lo, red, xs_sh);
}

// ---- the epilogue of one output element --------------------------------
// quantized_linear: float(acc) * (w_scale * x_scale), each product rounded
// once, in float32
__device__ __forceinline__ float qlinear_of(int v, float w_scale, float xs) {
  return __fmul_rn(__int2float_rn(v), __fmul_rn(w_scale, xs));
}
// the bias add wraps like the reference's int32 add
__device__ __forceinline__ int add_bias(int v, const int32_t* bias, int col) {
  return bias != nullptr ? (int)((uint32_t)v + (uint32_t)bias[col]) : v;
}
// clip(acc >> shift): arithmetic shift; 32 or more fills with the sign bit
__device__ __forceinline__ int8_t requant_of(int v, int shift) {
  int s = shift >= 32 ? (v < 0 ? -1 : 0) : (v >> shift);
  s = s < -128 ? -128 : (s > 127 ? 127 : s);
  return (int8_t)s;
}
__device__ __forceinline__ float dequant_of(int v, float scale) {
  return __fmul_rn(__int2float_rn(v), scale);
}

// OT: quantized_linear's output type (x's); the other epilogues store
// int32, int8 or float32 whatever OT is
template <typename OT>
__device__ __forceinline__ void store_out(void* out, size_t o, int v,
                                          const int32_t* bias,
                                          const float* scale, float xs,
                                          int col, int epilogue, int shift) {
  if (epilogue == EPI_QLINEAR) {
    XIo<OT>::store(static_cast<OT*>(out) + o, qlinear_of(v, scale[col], xs));
    return;
  }
  v = add_bias(v, bias, col);
  if (epilogue == EPI_NONE)
    static_cast<int32_t*>(out)[o] = v;
  else if (epilogue == EPI_REQUANT)
    static_cast<int8_t*>(out)[o] = requant_of(v, shift);
  else
    static_cast<float*>(out)[o] = dequant_of(v, scale[col]);
}

// outputs o and o + 1 (columns col and col + 1) in one store of two; o is
// even, so the pair is aligned to its size
template <typename OT>
__device__ __forceinline__ void store_out2(void* out, size_t o, int v0,
                                           int v1, const int32_t* bias,
                                           const float* scale, float xs,
                                           int col, int epilogue, int shift) {
  if (epilogue == EPI_QLINEAR) {
    XIo<OT>::store2(static_cast<OT*>(out) + o, qlinear_of(v0, scale[col], xs),
                    qlinear_of(v1, scale[col + 1], xs));
    return;
  }
  v0 = add_bias(v0, bias, col);
  v1 = add_bias(v1, bias, col + 1);
  if (epilogue == EPI_NONE) {
    *reinterpret_cast<int2*>(static_cast<int32_t*>(out) + o) =
        make_int2(v0, v1);
  } else if (epilogue == EPI_REQUANT) {
    char2 q;
    q.x = requant_of(v0, shift);
    q.y = requant_of(v1, shift);
    *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + o) = q;
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
        make_float2(dequant_of(v0, scale[col]), dequant_of(v1, scale[col + 1]));
  }
}

// the output type of quantized_linear: x's; int8 A never takes EPI_QLINEAR
template <typename AT>
struct QOut { using T = AT; };
template <>
struct QOut<int8_t> { using T = float; };

}  // namespace vta
