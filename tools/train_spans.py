#!/usr/bin/env python3
"""Device time of a benchmark cell's training step by the program's spans.

    python3 tools/train_spans.py --workload zamba2-1.2b.train_4k.b4 \\
        --seed 2147483901 [--steps 2] [--timed 5] [--out FILE]

Builds the cell's ``Trainer`` as ``portbench/drivers/train.py`` does (the
benchmark's weights and token stream), warms it with the cell's checked
steps, times `timed` steps untraced (host clock; each step ends in the
host's read of the loss), then runs `steps` steps under ``torch.profiler``
inside the benchmark's ``portbench.profiled`` span and places every
device event under the spans that launched it
(``portbench/harness/spans.py``).  Prints one JSON line: the device time
by span path, each path's kernels, the seven per-layer figures of the
spans (device ms a step), the share of device time a span holds, the idle
gaps by the span open at their middle, the untraced and traced step
seconds, and checks of the trace (device events with a span's name,
kernels tied to no launch).  ``--out`` writes the same JSON with every
path.  Needs a CUDA card; ``--device cpu`` runs the cell at the tests'
reduced size to rehearse the script (no device events there).
"""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GC = "python.gc"


def largest_gaps(ev, at, trec, top: int = 12) -> list:
    """The `top` longest idle gaps of the device: [seconds, the spans open
    at the gap's middle, the op that launched the kernel ending the gap,
    the longest host ops (ms) inside the gap on the launching thread]."""
    from portbench.harness import trace
    busy = trace.busy_intervals(trec["device"], trec["range"])
    # from one busy interval's end to the next one's start
    gaps = [(end, start) for (_, end), (start, _) in zip(busy, busy[1:])
            if start > end]
    device = sorted((e for e in ev if e.kind == "device"
                     and e.name != trace.SPAN), key=lambda e: e.start)
    starts = [e.start for e in device]
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        d = device[bisect.bisect_left(starts, b)]
        anc = at.anchor(d)
        launched, host = None, []
        if anc is not None:
            thread, r, _ = anc
            ops = [o for o in at.ops.get(d.linked, [])
                   if o.start <= r <= o.end]
            launched = ops[0].name if ops else None
            host = sorted(((o.end - o.start) / 1e6, o.name)
                          for e in at.ops.values() for o in e
                          if o.thread == thread and a <= o.start
                          and o.end <= b)[-3:]
        out.append([(b - a) / 1e9, at.path(None, (a + b) // 2, (a + b) // 2),
                    launched, host])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=0,
                    help="profiled steps (default: the traffic's)")
    ap.add_argument("--timed", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    build_dir = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build_dir / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build_dir / "triton"))
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from torch._C._profiler import _RecordFunctionFast

    from portbench.drivers.train import build, power_limit_w
    from portbench.harness import spans, trace
    from portbench.harness.cell import load_cell

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("train_spans: no CUDA card", file=sys.stderr)
        return 2
    if cuda:
        cell = load_cell(args.workload)
    else:
        from portbench.conftest import small_cell
        cell = small_cell(args.workload)
    dev = torch.device(args.device)
    tr = build(cell, args.seed, dev)
    for _ in range(cell.traffic["checked_steps"]):
        tr.train(1, log_every=10 ** 9)
    timed = []
    for _ in range(args.timed):
        t0 = time.perf_counter()
        tr.train(1, log_every=10 ** 9)
        timed.append(time.perf_counter() - t0)
    out = {"cell": cell.name, "seed": args.seed,
           "untraced_step_s": statistics.median(timed),
           "untraced_steps_s": timed}

    n = args.steps or cell.traffic.get("profiled_steps", 2)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    # the interpreter's garbage collections, as spans of their own
    collecting = []

    def on_gc(phase, info):
        if phase == "start":
            collecting.append(_RecordFunctionFast(GC))
            collecting[-1].__enter__()
        elif collecting:
            collecting.pop().__exit__(None, None, None)
    gc.callbacks.append(on_gc)
    try:
        with profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])) as prof:
            with record_function(trace.SPAN):
                for _ in range(n):
                    tr.train(1, log_every=10 ** 9)
                sync()
    finally:
        gc.callbacks.remove(on_gc)
    ev = spans.events_of(prof.profiler.kineto_results.events())
    rng = next((e.start, e.end) for e in ev
               if e.name == trace.SPAN and e.kind != "device")
    names = spans.SPANS + (GC,)
    rec = spans.record(ev, rng, exclude=(trace.SPAN,), names=names)
    # the record trace.profile makes, for busy, idle and the breakdown
    device = [(e.name, e.start, e.end) for e in ev
              if e.kind == "device" and e.name != trace.SPAN]
    host = [(e.name, e.start, e.end) for e in ev if e.kind != "device"]
    trec = {"device": device, "host": host, "range": rng}

    at = spans.Attribution(ev, names)
    lo, hi = rng
    kernels: dict = {}
    checks = {"device_events": 0, "with_runtime_call": 0,
              "with_linked_op": 0, "call_inside_its_op": 0,
              "tied_to_nothing": 0}
    lags = []
    for d in ev:
        if d.kind != "device" or d.name == trace.SPAN \
                or d.end <= lo or d.start >= hi:
            continue
        checks["device_events"] += 1
        checks["with_runtime_call"] += d.corr in at.runtime
        checks["with_linked_op"] += bool(at.ops.get(d.linked))
        rt = at.runtime.get(d.corr)
        if rt is not None:
            lags.append((d.start - rt.start) / 1e6)
            checks["call_inside_its_op"] += any(
                o.start <= rt.start and rt.end <= o.end
                for o in at.ops.get(d.linked, []))
        anc = at.anchor(d)
        checks["tied_to_nothing"] += anc is None
        p = at.path(*anc) if anc is not None else spans.UNATTRIBUTED
        k = kernels.setdefault(p, {})
        kid = trace.kernel_id(d.name)
        k[kid] = k.get(kid, 0.0) + (min(d.end, hi) - max(d.start, lo)) / 1e9
    checks["device_events_named_as_spans"] = sorted(
        {e.name for e in ev if e.kind == "device" and e.name in spans.SPANS})
    checks["span_kinds"] = sorted({e.kind for e in ev
                                   if e.name in spans.SPANS})
    runtime_names: dict = {}
    for e in at.runtime.values():
        runtime_names[e.name] = runtime_names.get(e.name, 0) + 1
    checks["runtime_calls"] = sorted(runtime_names.items(),
                                     key=lambda kv: -kv[1])[:12]
    checks["gc_collections"] = sum(e.name == GC for e in ev)
    # ms from each launch call's start to its kernel's start
    lags.sort()
    checks["launch_to_start_ms"] = [
        lags[int(q * (len(lags) - 1))] for q in (0, 0.001, 0.5, 1)] \
        if lags else []

    window = trace.window_seconds(trec)
    by_path = sorted(rec["device_s"].items(), key=lambda kv: -kv[1])
    out.update(
        device=torch.cuda.get_device_name(0) if cuda else "cpu",
        power_limit_w=power_limit_w() if cuda else None,
        steps=rec["steps"], traced_range_s=window,
        traced_step_s=window / n, busy_s=trace.busy_seconds(trec),
        idle_share=1.0 - trace.busy_seconds(trec) / window,
        attributed_share=spans.attributed_share(rec),
        metrics={m: spans.per_step_ms(rec, m)
                 for m in list(spans.SUMS) + ["input_idle_ms"]},
        device_s=dict(by_path),
        kernels={p: sorted(k.items(), key=lambda kv: -kv[1])
                 for p, k in kernels.items()},
        input_idle_s=rec["input_idle_s"],
        idle_s=dict(sorted(rec["idle_s"].items(), key=lambda kv: -kv[1])),
        breakdown=trace.breakdown(trec), gaps=largest_gaps(ev, at, trec),
        checks=checks)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    short = dict(out, device_s=dict(by_path[:30]),
                 kernels={p: out["kernels"][p][:5] for p, _ in by_path[:14]},
                 idle_s=dict(list(out["idle_s"].items())[:10]))
    print(json.dumps(short), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
