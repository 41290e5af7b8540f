"""The traced part of a run: a few steps under ``torch.profiler``, and the
reduction of its events to what the per-layer readers and the result's
``breakdown`` take.

The record holds the device's events (kernels, copies, sets) and the
host's (operators and runtime calls) as (name, start ns, end ns), the
profiled range on the trace's own clock (the benchmark's
``portbench.profiled`` span), and each op's launch counters over the
range.  Busy time is the union of the device's intervals inside the
range, so that nothing is counted twice (the arithmetic of
``chip_smoke.py:profiled_step``); idle time is the rest of the range.
Each idle gap is named by the innermost host event open at its middle.
"""
from __future__ import annotations

import heapq
import re
from typing import Callable, Dict, List, Tuple

SPAN = "portbench.profiled"

Event = Tuple[str, int, int]


def kernel_id(name: str) -> str:
    """A device event's kernel identifier: the demangled name without its
    return type, namespace, template arguments and parameters (a copy or
    a set by its whole name)."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


def profile(step: Callable[[], None], n: int,
            counters: Callable[[], dict]) -> dict:
    """n calls of `step` under the profiler: {"device": [Event], "host":
    [Event], "range": (start, end) ns, "counters": launches by op in the
    range}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile, \
        record_function
    before = counters()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            for _ in range(n):
                step()
            torch.cuda.synchronize()
    after = counters()
    device: List[Event] = []
    host: List[Event] = []
    span = None
    for e in prof.profiler.kineto_results.events():
        ev = (e.name(), e.start_ns(), e.end_ns())
        if e.name() == SPAN:
            # the span is on the host's timeline and, as an annotation,
            # on the device's: the host's is the range
            if e.device_type() != DeviceType.CUDA:
                span = (ev[1], ev[2])
        elif e.device_type() == DeviceType.CUDA:
            device.append(ev)
        else:
            host.append(ev)
    if span is None:
        raise RuntimeError(f"the profiler recorded no {SPAN} span")
    return {"device": device, "host": host, "range": span,
            "counters": {op: {ph: _diff(after[op][ph], before[op][ph])
                              for ph in after[op]} for op in after}}


def _diff(a: dict, b: dict) -> dict:
    out = {k: n - b.get(k, 0) for k, n in a.items()}
    return {k: n for k, n in out.items() if n}


def busy_intervals(device: List[Event], rng: Tuple[int, int]
                   ) -> List[Tuple[int, int]]:
    """The union of the device's intervals, clipped to `rng`, sorted."""
    lo, hi = rng
    spans = sorted((max(a, lo), min(b, hi)) for _, a, b in device
                   if b > lo and a < hi)
    out: List[Tuple[int, int]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_seconds(rec: dict) -> float:
    return sum(b - a for a, b in busy_intervals(rec["device"],
                                                rec["range"])) / 1e9


def window_seconds(rec: dict) -> float:
    lo, hi = rec["range"]
    return (hi - lo) / 1e9


def idle_gaps(rec: dict) -> List[Tuple[str, float]]:
    """[(host event open at the gap's middle, seconds)] for every idle
    gap of the device inside the range."""
    lo, hi = rec["range"]
    gaps, at = [], lo
    for a, b in busy_intervals(rec["device"], rec["range"]):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    host = sorted((a, b, name) for name, a, b in rec["host"])
    out, heap, i = [], [], 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out.append((heap[0][2] if heap else "no host event",
                    (b - a) / 1e9))
    return out


def breakdown(rec: dict, top: int = 10) -> dict:
    """{"device_ops": [[kernel, seconds]], "idle_gaps": [[host event,
    seconds]]}: the device operations with the most time and the host
    events with the most idle device time under them, `top` of each."""
    lo, hi = rec["range"]
    ops: Dict[str, float] = {}
    for name, a, b in rec["device"]:
        if b > lo and a < hi:
            k = kernel_id(name)
            ops[k] = ops.get(k, 0.0) + (min(b, hi) - max(a, lo)) / 1e9
    gaps: Dict[str, float] = {}
    for name, s in idle_gaps(rec):
        gaps[name] = gaps.get(name, 0.0) + s
    return {"device_ops": [[k, v] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:top]]}
