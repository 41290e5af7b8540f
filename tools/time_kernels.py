#!/usr/bin/env python3
"""Time the port's lut_gemm and flash_attention kernels of one checkout.

    python3 tools/time_kernels.py [--src DIR] [--label NAME] [--big]
                                  [--ops lut_gemm,flash_attention]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``),
builds its CUDA kernels, and times each op at the shapes ``chip_smoke.py``
phase 7 times (the int4 decoder's lut_gemm launches, Llama-3.2-3B's
lut_gemm at M 1 and 16 for bits 1, 2 and 4, flash_attention at the Llama
and zamba2 prefill shapes), with ``chip_smoke.kernel_ms`` (torch.profiler
device time of every kernel whose name holds "lut_gemm" or "flash", per
call).  With --big, flash_attention also at S 32768; --ops picks the
ops.  One JSON line per shape on stdout.  Run it once per checkout, each
in its own process, to hold two versions of the port against each other
on one card, in turns (parent, change, change, parent): unpack the other
version with `git archive` into a directory .gitignore lists (build/)
and pass its src.  Needs a CUDA card; it imports no JAX.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (T, M, N, K, bits, epilogue, shift): the decoder's launches, then Llama
LUT_SHAPES = [(1, 2, 192, 64, 4, "requant", 7),
              (1, 2, 64, 64, 4, "requant", 7),
              (1, 2, 128, 64, 4, "none", 0),
              (1, 2, 64, 128, 4, "requant", 7),
              (1, 2, 32, 64, 4, "requant", 7),
              (1, 1, 192, 64, 4, "requant", 7),
              (1, 1, 64, 128, 4, "requant", 7)] + [
    (1, m, 8192, 3072, b, "none", 0) for m in (1, 16) for b in (1, 2, 4)]
#: (B, S, HQ, KH, D, dtype): Llama's 16-token prefill, zamba2's 16- and
#: 512-token prefills, Llama at S 4096 (both dtypes); all causal, Sk = S
FLASH_SHAPES = [(1, 16, 24, 8, 128, "bfloat16"),
                (1, 16, 32, 32, 64, "bfloat16"),
                (1, 512, 32, 32, 64, "bfloat16"),
                (1, 16, 32, 32, 64, "float32"),
                (1, 4096, 24, 8, 128, "bfloat16"),
                (1, 4096, 24, 8, 128, "float32")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--ops", default="lut_gemm,flash_attention",
                    help="comma-separated ops to time")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lut_gemm import lut_gemm
    _build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    card = torch.cuda.get_device_name(0)
    ops = args.ops.split(",")
    for T, M, N, K, bits, epi, shift in LUT_SHAPES * ("lut_gemm" in ops):
        lo = -(1 << (bits - 1))
        a = torch.randint(-128, 128, (T, M, K), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(lo, -lo, (T, N, K), generator=g, device=dev,
                          dtype=torch.int8).transpose(1, 2)
        call = lambda: lut_gemm(a, w, bits=bits, epilogue=epi,  # noqa
                                shift=shift)
        call_ms = cs.cuda_time_ms(call)
        ms = cs.kernel_ms(call, "lut_gemm", call_ms)
        print(json.dumps(dict(label=args.label, card=card, op="lut_gemm",
                              T=T, M=M, N=N, K=K, bits=bits, epilogue=epi,
                              ms=ms, call_ms=call_ms)), flush=True)
    shapes = FLASH_SHAPES + ([(1, 32768, 24, 8, 128, "bfloat16")]
                             if args.big else [])
    shapes *= "flash_attention" in ops
    for B, S, HQ, KH, D, dt in shapes:
        dtype = getattr(torch, dt)
        q = torch.randn((B, S, HQ, D), generator=g, device=dev).to(dtype)
        k = torch.randn((B, S, KH, D), generator=g, device=dev).to(dtype)
        v = torch.randn((B, S, KH, D), generator=g, device=dev).to(dtype)
        reps = 3 if S > 8192 else 20
        call = lambda: flash_attention(q, k, v, causal=True)  # noqa
        call_ms = cs.cuda_time_ms(call, reps=reps, warmup=1)
        ms = cs.kernel_ms(call, "flash", call_ms, reps=reps)
        print(json.dumps(dict(label=args.label, card=card,
                              op="flash_attention", B=B, S=S, HQ=HQ, KH=KH,
                              D=D, dtype=dt, ms=ms, call_ms=call_ms)),
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
