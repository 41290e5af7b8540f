// tensor_alu: a chain of VTA tensor-ALU ops over an int32 tensor, on Hopper,
// in two instances: the standalone chain, and the task-ISA engine's tile
// epilogue with the scatter of the GEMM's blocks in the same launch.
//
// Replaces: src/repro/kernels/tensor_alu/kernel.py, tensor_alu_pallas (body
// _alu_kernel, op semantics _apply), the TPU kernel behind the engine's
// unfused epilogues (relu, bias add) and the dense vector-ALU path; the
// scatter instance also replaces the reference engine's host-side scatter
// of a tile's GEMM parts (src/repro/core/backend.py, _scatter).
//
// Semantics, per element, for each step (op, y) with y the immediate or
// the element of `src`:
//   min, max  signed;
//   add, mul  wrap (computed in uint32);
//   shr       y in [0, 31]: arithmetic shift right; y >= 32: the sign
//             fill; y < 0: shift left by -y, where an amount of 32 or
//             more (including -INT_MIN) gives 0.
//
// The scatter instance computes, for each tile t of a batch and each
// destination block d of the tile (batch x block_out int32, one
// accumulator-SRAM entry; the tile is an (io x ii) grid of them):
//   out[t, d] = chain(sum over s in map[d] of gemm[t, s], src[t, d])
// with the sum in int32 wraparound, 0 where map[d] is empty.  map is a CSR
// list of source blocks per destination block (a weight group and the
// element offset of the block's first row in that group's GEMM output),
// built once per tile structure on the host and kept on the device
// (tensor_alu/block_map.py); several weight groups summed into one block
// are exact.  The GEMM outputs (int32, or int8 after a fused requant) are
// read in place, one pointer per tile and weight group, and each tile's
// tensor operand through its own pointer; out is (T, io * batch, ii *
// block_out), the matrices the engine writes back.
//
// What bounds it on this card: HBM bytes.  It does a handful of integer
// ops per 4-byte element read (and 4 bytes written), far below the ~300
// ops per byte where the card's compute would start to matter; at the
// engine's tile sizes (8-16 x 448-1792 int32) a launch is far below even
// that, and what it saves is the work around it: before the scatter
// instance, a tile batch ran a zero fill, a widening copy, a host-to-device
// copy of the positions and an index_add_ per part, a narrowing copy, two
// concatenations and then the chain.
//
// What the design does about it: the whole chain (up to MAX_OPS steps,
// passed by value as a small struct of op codes) runs in one pass, so each
// element is read once and written once; loads and stores are 16 bytes a
// thread (int4; 4 bytes of int8 sources) where the pointers allow it, with
// a scalar tail (standalone) or a scalar instance (scatter).  The engine
// row-stacks peer tiles so one launch covers them all.
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


// ---- the scatter instance --------------------------------------------
constexpr int MAX_T = 16;     // tiles one launch writes
constexpr int MAX_SRC = 64;   // GEMM outputs one launch reads (tiles x groups)

struct ScatterArgs {
  const void* src[MAX_SRC];     // [t * G + g]: tile t's GEMM output of group g
  const int32_t* bias[MAX_T];   // tile t's tensor operand (R x C), or null
  int width[MAX_SRC];           // row stride (elements) of group g's output
  int G, n_dst, ii, batch, block_out, nvec;
  long long C, tile_elems;      // row length and R * C of a tile
};

__device__ __forceinline__ void load_w(const int32_t* p, uint32_t (&x)[4]) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  x[0] = (uint32_t)v.x; x[1] = (uint32_t)v.y;
  x[2] = (uint32_t)v.z; x[3] = (uint32_t)v.w;
}
__device__ __forceinline__ void load_w(const int8_t* p, uint32_t (&x)[4]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  x[0] = (uint32_t)(int)v.x; x[1] = (uint32_t)(int)v.y;
  x[2] = (uint32_t)(int)v.z; x[3] = (uint32_t)(int)v.w;
}

// one thread per (tile, destination block, block row, W elements of it)
template <typename TS, bool VEC>
__global__ void __launch_bounds__(THREADS)
tensor_alu_scatter_kernel(const int* __restrict__ row_ptr,
                          const int2* __restrict__ ent,
                          int32_t* __restrict__ out, long long n_work,
                          ScatterArgs a, AluChain chain) {
  constexpr int W = VEC ? 4 : 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_work; i += stride) {
    const int c = (int)(i % a.nvec);
    long long rest = i / a.nvec;
    const int r = (int)(rest % a.batch);
    rest /= a.batch;
    const int d = (int)(rest % a.n_dst);
    const int t = (int)(rest / a.n_dst);
    uint32_t acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0u;
    const int e1 = row_ptr[d + 1];
    for (int e = row_ptr[d]; e < e1; ++e) {
      const int2 en = ent[e];
      const TS* p = static_cast<const TS*>(a.src[t * a.G + en.x]) + en.y +
                    (long long)r * a.width[en.x] + c * W;
      if constexpr (VEC) {
        uint32_t x[4];
        load_w(p, x);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] += x[j];
      } else {
        acc[0] += (uint32_t)(int)p[0];
      }
    }
    const long long o = ((long long)(d / a.ii) * a.batch + r) * a.C +
                        (long long)(d % a.ii) * a.block_out + c * W;
    const int32_t* bs = a.bias[t];
    int32_t* po = out + t * a.tile_elems + o;
    if constexpr (VEC) {
      const int4 s = bs ? *reinterpret_cast<const int4*>(bs + o)
                        : make_int4(0, 0, 0, 0);
      int4 x;
      x.x = run_chain(chain, (int)acc[0], s.x);
      x.y = run_chain(chain, (int)acc[1], s.y);
      x.z = run_chain(chain, (int)acc[2], s.z);
      x.w = run_chain(chain, (int)acc[3], s.w);
      *reinterpret_cast<int4*>(po) = x;
    } else {
      po[0] = run_chain(chain, (int)acc[0], bs ? bs[o] : 0);
    }
  }
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

// Launch the scatter instance on `stream`; returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for T outside 1..MAX_T, T * G over
// MAX_SRC, n_ops outside 0..MAX_OPS, or vec with a block_out that is not a
// multiple of 4.  row_ptr (n_dst + 1 ints) and ent (pairs of ints: weight
// group, element offset) are the block map on the device; srcs (T * G
// pointers, tile-major), widths (G) and bias (T pointers, or null for no
// tensor operand) are host arrays; src_int8 selects int8 GEMM outputs
// (else int32).  vec: every pointer, width and offset allows 16-byte
// int32 access (the wrapper checks).  ops, imms and use_src are host
// arrays of n_ops entries.
extern "C" int tensor_alu_scatter_launch(
    const void* row_ptr, const void* ent, const void* const* srcs,
    int src_int8, int T, int G, const int* widths, const void* const* bias,
    void* out, int n_dst, int ii, int batch, int block_out, int vec,
    int n_ops, const int* ops, const int* imms, const int* use_src,
    void* stream) {
  if (T < 1 || T > MAX_T || G < 1 || T * G > MAX_SRC || n_ops < 0 ||
      n_ops > MAX_OPS || (vec && block_out % 4))
    return (int)cudaErrorInvalidValue;
  ScatterArgs a;
  for (int i = 0; i < MAX_SRC; ++i) {
    a.src[i] = i < T * G ? srcs[i] : nullptr;
    a.width[i] = i < G ? widths[i] : 0;
  }
  for (int i = 0; i < MAX_T; ++i)
    a.bias[i] = (bias != nullptr && i < T)
                    ? static_cast<const int32_t*>(bias[i]) : nullptr;
  a.G = G;
  a.n_dst = n_dst;
  a.ii = ii;
  a.batch = batch;
  a.block_out = block_out;
  a.nvec = vec ? block_out / 4 : block_out;
  a.C = (long long)ii * block_out;
  a.tile_elems = (long long)n_dst * batch * block_out;
  AluChain c;
  c.n = n_ops;
  for (int i = 0; i < MAX_OPS; ++i) {
    c.op[i] = i < n_ops ? ops[i] : 0;
    c.imm[i] = i < n_ops ? imms[i] : 0;
    c.use_src[i] = i < n_ops ? use_src[i] : 0;
  }
  const long long n_work = (long long)T * n_dst * batch * a.nvec;
  long long blocks = (n_work + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(row_ptr);
  const int2* en = static_cast<const int2*>(ent);
  int32_t* O = static_cast<int32_t*>(out);
  const unsigned nb = (unsigned)blocks;
  if (src_int8 && vec)
    tensor_alu_scatter_kernel<int8_t, true><<<nb, THREADS, 0, s>>>(
        rp, en, O, n_work, a, c);
  else if (src_int8)
    tensor_alu_scatter_kernel<int8_t, false><<<nb, THREADS, 0, s>>>(
        rp, en, O, n_work, a, c);
  else if (vec)
    tensor_alu_scatter_kernel<int32_t, true><<<nb, THREADS, 0, s>>>(
        rp, en, O, n_work, a, c);
  else
    tensor_alu_scatter_kernel<int32_t, false><<<nb, THREADS, 0, s>>>(
        rp, en, O, n_work, a, c);
  return (int)cudaGetLastError();
}
