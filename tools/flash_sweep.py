#!/usr/bin/env python3
"""Time every plan of flash_attention's float32 kernel on the card.

    python3 tools/flash_sweep.py [--reps N]

At the float32 shapes chip_smoke.py times (zamba2-1.2b's served 16-token
prompt, whisper's cross-attention, Llama-3.2-3B's 4096-token prefill) and
for each plan the kernel takes (64- or 128-row blocks, 1 to 3 ring stages
where they fit in shared memory), it forces that plan, checks the result
against the plain version (1e-5) and a second call bitwise against the
first, and times the kernel with ``chip_smoke.kernel_ms`` (torch.profiler
device time per call).  One JSON line per (shape, plan) on stdout,
marking the plan ``flash_f32_plan`` picks.  Needs a CUDA card; imports no
JAX.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (B, S, Sk, HQ, KH, D, causal)
SHAPES = [(1, 16, 16, 32, 32, 64, True), (2, 1000, 1500, 20, 20, 64, False),
          (1, 4096, 4096, 24, 8, 128, True)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch.kernels.flash_attention.kernel as kmod
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    _build.build_all()
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    planner = kmod.flash_f32_plan
    g = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    for B, S, Sk, HQ, KH, D, causal in SHAPES:
        q = torch.randn((B, S, HQ, D), generator=g, device=dev)
        k = torch.randn((B, Sk, KH, D), generator=g, device=dev)
        v = torch.randn((B, Sk, KH, D), generator=g, device=dev)
        want = flash_attention_plain(q, k, v, causal=causal)
        chosen = planner(B, S, Sk, HQ, KH, D, causal)
        for bq in (64, 128):
            for stages in (1, 2, 3):
                smem = kmod.flash_f32_smem(bq, chosen.bk, chosen.dp, stages)
                if smem > kmod.SMEM_MAX:
                    continue
                plan = kmod.FlashF32Plan(bq, chosen.bk, chosen.dp, stages,
                                         smem)
                kmod.flash_f32_plan = lambda *a, plan=plan: plan
                try:
                    got = flash_attention(q, k, v, causal=causal)
                    again = flash_attention(q, k, v, causal=causal)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    ok = err <= 1e-5 and torch.equal(got, again)
                    bad += not ok
                    call = lambda: flash_attention(  # noqa: E731
                        q, k, v, causal=causal)
                    call_ms = cs.cuda_time_ms(call, reps=args.reps)
                    ms = cs.kernel_ms(call, "flash_tf32x3", call_ms,
                                      reps=args.reps)
                finally:
                    kmod.flash_f32_plan = planner
                print(json.dumps(dict(
                    card=card, B=B, S=S, Sk=Sk, HQ=HQ, KH=KH, D=D,
                    causal=causal, bq=bq, bk=plan.bk, stages=stages,
                    smem=smem, chosen=plan == chosen, ok=ok, max_abs_err=err,
                    ms=ms, call_ms=call_ms)), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
