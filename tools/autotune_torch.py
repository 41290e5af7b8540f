"""Design-space autotuner CLI of the PyTorch/CUDA port.

Runs the two-stage seeded search of ``repro_torch.core.autotune`` (calibrated
TimingModel replay as the cheap oracle over every candidate, measured
wall time + cross-engine byte validation for the top-N) over a conv
and/or matmul workload, prints the trajectory, diffs the winner against
a stored baseline JSON (the old hillclimb-style report), and persists
the winning decisions into a TuningCache file that ``Program.compile``
auto-loads via ``REPRO_TUNE_CACHE`` — in either package: the file's
JSON is the same.  Candidate programs compile onto ``--device`` (default
the card, where stage 2 validates and times the CUDA kernels' engine);
``--device cpu`` runs the kernels' plain versions.

Usage:
  python tools/autotune_torch.py conv --seed 0 --candidates 24
  python tools/autotune_torch.py matmul --m 128 --k 256 --n 256
  python tools/autotune_torch.py both --device cpu \\
      --cache tuning_cache.json --baseline benchmarks/BENCH_autotune.json
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import autotune, hwspec               # noqa: E402
from repro_torch.core.conv import ConvShape                 # noqa: E402


def _diff_vs_baseline(result_json: dict, baseline_path: str) -> None:
    """Hillclimb-style report: percent deltas of the winner's predicted
    cycles and measured wall against the stored trajectory JSON."""
    if not os.path.exists(baseline_path):
        print(f"(no baseline at {baseline_path} — skipping diff)")
        return
    with open(baseline_path) as f:
        base = json.load(f)
    base_by_name = {w["workload"]: w for w in base.get("workloads", [])}
    print("\n=== delta vs baseline ===")
    for w in result_json["workloads"]:
        b = base_by_name.get(w["workload"])
        if b is None or b.get("winner") is None or w["winner"] is None:
            print(f"{w['workload']:24s}: no comparable baseline winner")
            continue
        for k, scale, unit in (("predicted_cycles", 1, "cyc"),
                               ("measured_s", 1e3, "ms")):
            bv, cv = b["winner"].get(k), w["winner"].get(k)
            if not bv or not cv:
                continue
            pct = (cv - bv) / bv * 100
            print(f"{w['workload']:24s} {k:16s}: {bv * scale:10.2f} -> "
                  f"{cv * scale:10.2f} {unit}  ({pct:+.1f}%)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload", choices=("conv", "matmul", "both"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--candidates", type=int, default=24,
                    help="sampled design points (oracle stage)")
    ap.add_argument("--top", type=int, default=4,
                    help="candidates measured + validated (stage 2)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--conv-hw", type=int, default=14,
                    help="conv spatial size (H=W)")
    ap.add_argument("--conv-c", type=int, default=32,
                    help="conv channels (ic=oc)")
    ap.add_argument("--conv-khw", type=int, default=3,
                    help="conv kernel size (kh=kw), stride 1, same pad")
    ap.add_argument("--spec", choices=("pynq", "calibrated"),
                    default="calibrated",
                    help="base template instance to search around")
    ap.add_argument("--cache", default=None,
                    help="TuningCache JSON to merge winners into "
                         "(load+save; point REPRO_TUNE_CACHE here)")
    ap.add_argument("--baseline", default=None,
                    help="stored trajectory JSON to diff the winner "
                         "against (e.g. benchmarks/BENCH_autotune.json)")
    ap.add_argument("--out", default=None,
                    help="write this run's trajectory JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the candidates' DRAM images "
                         "(default: the card, where stage 2 times the "
                         "CUDA engine; elsewhere it times the simulator)")
    args = ap.parse_args(argv)

    base_spec = (hwspec.calibrated() if args.spec == "calibrated"
                 else hwspec.pynq())
    cache = autotune.global_cache()
    if args.cache and os.path.exists(args.cache):
        print(f"loaded {cache.load(args.cache)} record(s) from "
              f"{args.cache}")

    workloads = []
    if args.workload in ("conv", "both"):
        khw, hw, c = args.conv_khw, args.conv_hw, args.conv_c
        workloads.append(autotune.conv_workload(
            ConvShape(n=1, h=hw, w=hw, ic=c, oc=c, kh=khw, kw=khw,
                      stride=1, pad=khw // 2), seed=args.seed))
    if args.workload in ("matmul", "both"):
        workloads.append(autotune.matmul_workload(
            args.m, args.k, args.n, seed=args.seed))

    backend = "cuda" if args.device.startswith("cuda") else "simulator"
    out = {"seed": args.seed, "base_spec": autotune.spec_key(base_spec),
           "device": args.device, "backend": backend, "workloads": []}
    for wl in workloads:
        res = autotune.search(wl, base_spec=base_spec, seed=args.seed,
                              n_candidates=args.candidates,
                              top_n=args.top, repeats=args.repeats,
                              cache=cache, log=print, backend=backend,
                              torch_device=args.device)
        out["workloads"].append(res.to_json())
        if res.winner is not None:
            cfg = res.sched_config()
            print(f"  serving knobs: gang_width={cfg.gang_width} "
                  f"window_us={cfg.window_us:.0f}")

    if args.cache:
        cache.save(args.cache)
        print(f"saved {len(cache)} record(s) to {args.cache}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
        print(f"trajectory written to {args.out}")
    if args.baseline:
        _diff_vs_baseline(out, args.baseline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
