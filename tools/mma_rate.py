#!/usr/bin/env python3
"""The card's mma.sync rate for TF32 and bf16 products, on registers.

    python3 tools/mma_rate.py [--iters N]

Builds a small kernel with the port's nvcc flags (into build/mma_rate/)
whose warps issue mma.sync.m16n8k8 TF32 (and, for comparison,
m16n8k16 bf16) products on register operands only, with 8 independent
accumulators a warp, nothing loaded and nothing split, and times it with
CUDA events at 4, 8 and 16 warps an SM on every SM.  Prints one JSON line
per (type, warps an SM): the dense rate in TFLOP/s, the ceiling that the
3xTF32 kernels (gla_chunk, flash_attention's float32 kernel) can reach
with mma.sync, at three products per float32 product.  Needs a CUDA card
and nvcc; it imports no JAX.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <bool TF32>
__global__ void rate_kernel(float* out, int iters) {
  float d[8][4];
  for (int i = 0; i < 8; ++i)
    for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 977u + i;
  for (int i = 0; i < 2; ++i) b[i] = threadIdx.x * 131u + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int i = 0; i < 8; ++i)
    for (int e = 0; e < 4; ++e) s += d[i][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int rate_launch(float* out, int blocks, int threads, int iters,
                           int tf32) {
  if (tf32)
    rate_kernel<true><<<blocks, threads>>>(out, iters);
  else
    rate_kernel<false><<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "mma_rate.cu"
    src.write_text(SOURCE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    lib_path = out_dir / "libmma_rate.so"
    subprocess.run([_build.nvcc(), *flags, "-o", str(lib_path), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.rate_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    lib.rate_launch.restype = ctypes.c_int
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = torch.cuda.get_device_name(0)
    for tf32, flop in ((1, 2 * 16 * 8 * 8), (0, 2 * 16 * 8 * 16)):
        for warps in (4, 8, 16):
            threads = 128
            blocks = sms * warps // 4
            out = torch.empty(blocks * threads, device=dev)
            lib.rate_launch(out.data_ptr(), blocks, threads, 10, tf32)
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            err = lib.rate_launch(out.data_ptr(), blocks, threads,
                                  args.iters, tf32)
            e.record()
            e.synchronize()
            if err:
                print(f"mma_rate: launch failed: CUDA error {err}",
                      file=sys.stderr)
                return 1
            ms = s.elapsed_time(e)
            n_mma = blocks * (threads // 32) * args.iters * 8
            print(json.dumps(dict(
                card=card, type="tf32 m16n8k8" if tf32 else "bf16 m16n8k16",
                warps_per_sm=warps, ms=ms,
                tflops=n_mma * flop / (ms * 1e-3) / 1e12)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
