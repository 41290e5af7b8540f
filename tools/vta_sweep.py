#!/usr/bin/env python3
"""Time every tile and split of vta_gemm's wgmma instance on the card.

    python3 tools/vta_sweep.py [--shapes engine,prefill] [--max-splits N]
        [--max-splits-prefill N] [--reps N]

For each shape (the task-ISA engine's launches above 16 rows, the LM
prefill linears; tests/torch_cases.py), each (rows, channels) tile of
``kernel.WGMMA_TILES`` not mostly past the output's edge, and each split
of K into whole 128-byte steps (SPLITS, up to --max-splits slices: one
thread block cluster a tile), it forces that plan, checks the result
bitwise against the plain version (and a second call bitwise against
the first), and times the kernel with ``chip_smoke.kernel_ms``
(torch.profiler device time per call).  One JSON line per (shape, tile,
split) on stdout, marking the plan ``gemm_plan`` picks, so that its rule
can be checked against the card.  Needs a CUDA card; imports no JAX.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the numbers of K slices tried (those up to the shape's K steps)
SPLITS = (1, 2, 3, 4, 6, 8)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="engine,prefill")
    ap.add_argument("--max-splits", type=int, default=8,
                    help="the most K slices tried at the engine's shapes")
    ap.add_argument("--max-splits-prefill", type=int, default=4,
                    help="the most K slices tried at the prefill shapes")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("vta_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    sys.path.insert(2, str(ROOT / "tests"))
    import chip_smoke as cs
    import repro_torch.kernels.vta_gemm.kernel as kmod
    from repro_torch.kernels import _build
    from repro_torch.kernels.vta_gemm import vta_gemm, vta_gemm_ref
    from torch_cases import ENGINE_SHAPES, PREFILL_SHAPES
    _build.build_all()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = torch.cuda.get_device_name(0)
    shapes = []
    if "engine" in args.shapes:
        shapes += [(T, M, N, K, e, s) for T, M, N, K, e, s in ENGINE_SHAPES]
    if "prefill" in args.shapes:
        shapes += [(1, M, N, K, "dequant", 0) for M, N, K in PREFILL_SHAPES]
    planner = kmod._wgmma_plan
    bad = 0
    g = torch.Generator(device=dev).manual_seed(0)
    for T, M, N, K, epi, shift in shapes:
        a = torch.randint(-128, 128, (T, M, K), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (T, N, K), generator=g, device=dev,
                          dtype=torch.int8).transpose(1, 2)
        sc = torch.rand(N, generator=g, device=dev) * 1e-3
        want = vta_gemm_ref(a, w, scale=sc, epilogue=epi, shift=shift)
        chosen = planner(T, M, N, K, sms)
        steps = -(-kmod.padded_k(K) // kmod.WGMMA_KSTEP)
        most = args.max_splits if M < 512 else args.max_splits_prefill
        pers = sorted({-(-steps // s) for s in SPLITS
                       if s <= min(steps, most)}, reverse=True)
        lib = None
        if T == 1 and epi == "dequant":
            a2, b2 = a[0].contiguous(), w[0]
            lib = cs.cuda_time_ms(lambda: torch._int_mm(a2, b2))
        for bm, bn in kmod.WGMMA_TILES:
            if bm > 64 and M <= 64 or bn > 64 and N <= 64 \
                    or bn > 128 and N <= 128:
                continue                   # a tile mostly past the edge
            for per in pers:
                plan = kmod.GemmPlan("wgmma", -(-steps // per),
                                     per * kmod.WGMMA_KSTEP, bm, bn)
                kmod._wgmma_plan = lambda *_, p=plan: p
                try:
                    call = lambda: vta_gemm(a, w, scale=sc,  # noqa: E731
                                            epilogue=epi, shift=shift)
                    got, again = call(), call()
                    torch.cuda.synchronize()
                    ok = torch.equal(got, want) and torch.equal(again, got)
                    call_ms = cs.cuda_time_ms(call, reps=args.reps,
                                              warmup=1)
                    ms = cs.kernel_ms(call, "vta_gemm_", call_ms,
                                      reps=args.reps)
                finally:
                    kmod._wgmma_plan = planner
                print(json.dumps(dict(
                    card=card, T=T, M=M, N=N, K=K, epilogue=epi, bm=bm,
                    bn=bn, splits=plan.splits, per=per, bitwise=ok, ms=ms,
                    call_ms=call_ms, planned=(chosen.bm, chosen.bn, chosen.splits) == (
                        bm, bn, plan.splits), library_ms=lib)), flush=True)
                if not ok:
                    bad += 1
                    print(f"vta_sweep: {(T, M, N, K, epi, bm, bn, per)} "
                          f"differs from the plain version", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
