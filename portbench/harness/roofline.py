"""A kernel op's share of its roofline in a traced run, and the check of
the profiler's records against the op's launch counters."""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

from .cell import ROOT
from .trace import kernel_id


def work_modules() -> list:
    """Each kernel op's module under work/ (those that name an ``OP``),
    in name order."""
    mods = [importlib.import_module(f"portbench.work.{p.stem}")
            for p in sorted((ROOT / "work").glob("*.py"))
            if not p.stem.startswith("_")]
    return [m for m in mods if hasattr(m, "OP")]


def op_counters() -> Dict[str, dict]:
    """Every kernel op's launch counters now, by op."""
    return {w.OP: w.counters() for w in work_modules()}


def device_seconds(rec: dict, kernels: Dict[str, str]) -> Tuple[float,
                                                                Dict[str,
                                                                     int]]:
    """(seconds, {kernel: events}) of the device events inside the
    traced range whose kernel is in `kernels`."""
    lo, hi = rec["range"]
    total, seen = 0.0, {}
    for name, a, b in rec["device"]:
        k = kernel_id(name)
        if k in kernels and b > lo and a < hi:
            total += (min(b, hi) - max(a, lo)) / 1e9
            seen[k] = seen.get(k, 0) + 1
    return total, seen


def shortfall(rec: dict, work) -> List[Tuple[str, int, int]]:
    """[(kernel, events seen, launches counted)] where the trace holds
    another number of a kernel's launches than the op's counters make."""
    c = rec["counters"][work.OP]
    _, seen = device_seconds(rec, work.KERNELS)
    want = work.expected_launches(c["fwd"], c["bwd"])
    return [(k, seen.get(k, 0), n) for k, n in sorted(want.items())
            if seen.get(k, 0) != n]


def share(rec: dict, work) -> Optional[float]:
    """100 x (the least time of the op's counted calls) / (the device time
    of its kernels), or None where the op launched nothing."""
    c = rec["counters"].get(work.OP)
    if not c or not (c["fwd"] or c["bwd"]):
        return None
    least = sum(n * work.least_seconds(k, ph) for ph in ("fwd", "bwd")
                for k, n in c[ph].items())
    spent, _ = device_seconds(rec, work.KERNELS)
    if spent <= 0:
        return None
    return 100.0 * least / spent
