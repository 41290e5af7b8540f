// tensor_alu: a chain of VTA tensor-ALU ops over an int32 tensor, on Hopper.
//
// Replaces: src/repro/kernels/tensor_alu/kernel.py, tensor_alu_pallas (body
// _alu_kernel, op semantics _apply), the TPU kernel behind the engine's
// unfused epilogues (relu, bias add) and the dense vector-ALU path.
//
// Semantics, per element, for each step (op, y) with y the immediate or
// the element of `src`:
//   min, max  signed;
//   add, mul  wrap (computed in uint32);
//   shr       y in [0, 31]: arithmetic shift right; y >= 32: the sign
//             fill; y < 0: shift left by -y, where an amount of 32 or
//             more (including -INT_MIN) gives 0.
//
// What bounds it on this card: HBM bytes.  It does a handful of integer
// ops per 4-byte element read (and 4 bytes written), far below the ~300
// ops per byte where the card's compute would start to matter.
//
// What the design does about it: the whole chain (up to MAX_OPS steps,
// passed by value as a small struct of op codes) runs in one pass, so each
// element is read once and written once; loads and stores are 16 bytes a
// thread (int4) where the pointers allow it, with a scalar tail.  The
// engine row-stacks peer tiles so one launch covers them all.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_OPS = 8;
constexpr int THREADS = 256;

enum { OP_MIN = 0, OP_MAX = 1, OP_ADD = 2, OP_SHR = 3, OP_MUL = 4 };

struct AluChain {
  int n;
  int op[MAX_OPS];
  int imm[MAX_OPS];
  int use_src[MAX_OPS];
};

__device__ __forceinline__ int alu_apply(int op, int x, int y) {
  switch (op) {
    case OP_MIN:
      return x < y ? x : y;
    case OP_MAX:
      return x > y ? x : y;
    case OP_ADD:
      return (int)((uint32_t)x + (uint32_t)y);
    case OP_MUL:
      return (int)((uint32_t)x * (uint32_t)y);
    default: {  // OP_SHR
      if (y >= 0) return y >= 32 ? (x < 0 ? -1 : 0) : (x >> y);
      const uint32_t s = 0u - (uint32_t)y;  // -y; INT_MIN gives 2^31
      return s >= 32u ? 0 : (int)((uint32_t)x << s);
    }
  }
}

__device__ __forceinline__ int run_chain(const AluChain& c, int x, int s) {
#pragma unroll
  for (int i = 0; i < MAX_OPS; ++i) {
    if (i >= c.n) break;
    x = alu_apply(c.op[i], x, c.use_src[i] ? s : c.imm[i]);
  }
  return x;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
tensor_alu_kernel(const int32_t* __restrict__ dst,
                  const int32_t* __restrict__ src, int32_t* __restrict__ out,
                  long long n, AluChain chain) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long n4 = n / 4;
    for (long long j = i; j < n4; j += stride) {
      int4 x = reinterpret_cast<const int4*>(dst)[j];
      int4 s = src ? reinterpret_cast<const int4*>(src)[j]
                   : make_int4(0, 0, 0, 0);
      x.x = run_chain(chain, x.x, s.x);
      x.y = run_chain(chain, x.y, s.y);
      x.z = run_chain(chain, x.z, s.z);
      x.w = run_chain(chain, x.w, s.w);
      reinterpret_cast<int4*>(out)[j] = x;
    }
    done = n4 * 4;
  }
  for (long long j = done + i; j < n; j += stride)
    out[j] = run_chain(chain, dst[j], src ? src[j] : 0);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  ops,
// imms and use_src are host arrays of n_ops (1..MAX_OPS) entries; the
// wrapper splits longer chains and never calls this with n equal to 0.
extern "C" int tensor_alu_launch(const void* dst, const void* src, void* out,
                                 long long n, int n_ops, const int* ops,
                                 const int* imms, const int* use_src,
                                 void* stream) {
  if (n_ops < 1 || n_ops > MAX_OPS) return (int)cudaErrorInvalidValue;
  AluChain c;
  c.n = n_ops;
  for (int i = 0; i < MAX_OPS; ++i) {
    c.op[i] = i < n_ops ? ops[i] : 0;
    c.imm[i] = i < n_ops ? imms[i] : 0;
    c.use_src[i] = i < n_ops ? use_src[i] : 0;
  }
  const bool vec = (reinterpret_cast<uintptr_t>(dst) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                   (src == nullptr ||
                    reinterpret_cast<uintptr_t>(src) % 16 == 0);
  const long long work = vec ? (n / 4 > 0 ? n / 4 : n) : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* D = static_cast<const int32_t*>(dst);
  const int32_t* S = static_cast<const int32_t*>(src);
  int32_t* O = static_cast<int32_t*>(out);
  if (vec)
    tensor_alu_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(D, S, O, n, c);
  else
    tensor_alu_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(D, S, O, n,
                                                                  c);
  return (int)cudaGetLastError();
}
