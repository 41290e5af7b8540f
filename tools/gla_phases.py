#!/usr/bin/env python3
"""Where a tile's time goes inside the gla_chunk kernel, on the card.

    python3 tools/gla_phases.py [--src DIR]

Copies ``kernels/gla_chunk/csrc/gla_chunk.cu`` into ``build/gla_phases/``
with ``clock64()`` reads added at the kernel's phase boundaries, builds
it with the port's nvcc flags, runs it through the ``gla_chunk`` op at
zamba2-1.2b's S 4096 prefill (float32 q and k broadcast over 64 heads)
and xlstm-1.3b's (N 256, P 1025, bf16 q and k per head, chunk 512), and
prints one JSON line per shape: the SM cycles per tile that warps 0, 3
and 6 of block (0, 0) spent in each phase (the cp.async issue and wait
for the tile, q h with warp 0's scan of la, the score tile, the state
update, y, and the barriers between), averaged over the tiles.  The
instrumented copy is not the kernel the port runs; its times say where
the cycles go, not how long the kernel takes.  Needs a CUDA card and
nvcc; it imports no JAX.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (marker in the source, text put in its place); the phases are the
#: cycles between consecutive reads
PROBES = [
    ("namespace {\n", "namespace {\n__device__ long long g_cycles[8][8];\n"),
    ("  for (int tile = 0; tile < ntiles; ++tile) {\n",
     "  long long acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  for (int tile = 0; tile < ntiles; ++tile) {\n"
     "    const long long c0 = clock64();\n"),
    ("    __syncthreads();  // this tile's operands and the last tile's hᵀ "
     "are in\n",
     "    const long long c1 = clock64();\n    __syncthreads();\n"
     "    const long long c2 = clock64();\n"),
    ("    __syncthreads();  // L is in\n",
     "    const long long c3 = clock64();\n    __syncthreads();\n"
     "    const long long c4 = clock64();\n"),
    ("    // hᵀ <- exp(Ltot)", "    const long long c5 = clock64();\n"
     "    // hᵀ <- exp(Ltot)"),
    ("    __syncthreads();  // W is in\n",
     "    const long long c6 = clock64();\n    __syncthreads();\n"
     "    const long long c7 = clock64();\n"),
    ("    __syncthreads();  // every read of the old hᵀ and of this stage is "
     "done\n    store_h();\n  }\n",
     "    __syncthreads();\n    store_h();\n"
     "    const long long c8 = clock64();\n"
     "    const long long c_[9] = {c0, c1, c2, c3, c4, c5, c6, c7, c8};\n"
     "    for (int i = 0; i < 8; ++i) acc_[i] += c_[i + 1] - c_[i];\n  }\n"
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && lane == 0)\n"
     "    for (int i = 0; i < 8; ++i) g_cycles[warp][i] = acc_[i];\n"),
    ("}  // namespace\n", "}  // namespace\nextern \"C\" int read_cycles("
     "long long* out) {\n  return (int)cudaMemcpyFromSymbol(out, g_cycles, "
     "sizeof(g_cycles));\n}\n"),
]
PHASES = ["issue_and_wait", "barrier_1", "q_h_and_scan", "barrier_2",
          "score", "state_update", "barrier_3", "y_and_last_barrier"]
#: (B, S, H, N, P, chunk, q/k dtype, heads broadcast)
SHAPES = [(1, 4096, 64, 64, 64, 64, "float32", True),
          (1, 4096, 4, 256, 1025, 512, "bfloat16", False)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("gla_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.gla_chunk import gla_chunk
    from repro_torch.kernels.gla_chunk import kernel as kmod
    text = (args.src / "repro_torch/kernels/gla_chunk/csrc/gla_chunk.cu"
            ).read_text()
    for marker, probe in PROBES:
        if text.count(marker) != 1:
            print(f"gla_phases: the kernel has no single {marker!r}",
                  file=sys.stderr)
            return 1
        text = text.replace(marker, probe)
    out = ROOT / "build" / "gla_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "gla_chunk.cu").write_text(text)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.nvcc(), *flags, "-o", str(out / "lib.so"),
                    str(out / "gla_chunk.cu")], check=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    launch = lib.gla_chunk_launch
    launch.argtypes = kmod._launcher().argtypes   # builds the port's kernels
    launch.restype = ctypes.c_int
    kmod._launcher = lambda: launch
    card = torch.cuda.get_device_name(0)
    for B, S, H, N, P, Q, dt, bc in SHAPES:
        q, k, v, la, h0 = cs.gla_inputs(B, S, H, N, P, 1, dt, bc, h0=False)
        for _ in range(3):
            gla_chunk(q, k, v, la, chunk=Q, y_dtype=torch.float32)
        torch.cuda.synchronize()
        cyc = np.zeros((8, 8), dtype=np.int64)
        if lib.read_cycles(ctypes.c_void_p(cyc.ctypes.data)) != 0:
            print("gla_phases: could not read the cycle counts",
                  file=sys.stderr)
            return 1
        plan = kmod.gla_plan(B, H, N, P, min(Q, kmod.MAX_TILE),
                             getattr(torch, dt))
        tiles = -(-S // plan.tile)
        print(json.dumps(dict(
            card=card, B=B, S=S, H=H, N=N, P=P, chunk=Q, qk_dtype=dt,
            heads_broadcast=bc, tile=plan.tile, p_block=plan.p_block,
            stages=plan.stages, cycles_per_tile={
                f"warp{w}": dict(zip(PHASES, (cyc[w] / tiles).round(0)
                                     .tolist())) for w in (0, 3, 6)})),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
