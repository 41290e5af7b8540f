"""Seeded fault injection for the self-healing serving plane.

A :class:`FaultPlan` is a deterministic script of failures keyed on the
pool's accelerator-gang sequence number: *kill this slot at gang k*,
*flip a constant byte before gang k*, *delay gang k by d seconds*.
:class:`serve.DevicePool` consumes the plan at the top of every gang
execution, so a given (workload, seed) pair replays the exact same
failure history run after run — the property the chaos fuzzer flavor
and ``benchmarks/bench_chaos.py`` rely on to byte-diff every surviving
request against a fault-free serial run.

Faults model the three failure classes the recovery machinery handles:

  * ``kill``  — the slot dies mid-flight (process crash / device reset).
    Exercises slot respawn, session checkpoint/restore and stateless
    request retry.
  * ``flip``  — one bit of a constant DRAM region is corrupted
    (bit-rot, DMA scribble).  Exercises the integrity checksums and
    restage-from-pristine.
  * ``delay`` — the gang stalls for ``delay_s`` (wedged kernel, host
    hiccup).  Exercises the segment watchdog when the stall exceeds the
    TimingModel-derived deadline, and plain tail latency otherwise.

The plan records what actually fired in ``fired`` (the pool appends a
log entry per applied fault) so harnesses can reconcile injected vs
observed failures — losses must be typed and accounted, never silent.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

FAULT_KINDS = ("kill", "flip", "delay")


@dataclass(frozen=True)
class Fault:
    """One scripted failure.  ``gang`` is the pool's gang-execution
    sequence number the fault fires at; ``slot`` targets a specific
    slot id (None: the first slot of the gang it fires on)."""
    kind: str                     # kill | flip | delay
    gang: int
    slot: Optional[int] = None
    delay_s: float = 0.0          # kind == "delay"
    byte: int = 0                 # kind == "flip": offset into the
    #                               program's constant image (mod size)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in "
                             f"{FAULT_KINDS}")
        if self.gang < 0:
            raise ValueError("fault gang index must be >= 0")


@dataclass
class FaultPlan:
    """A deterministic failure script, consumed gang by gang.

        plan = FaultPlan.random(seed=7, n_gangs=200, slots=4, rate=0.10)
        pool = DevicePool(compiled, size=4, max_respawns=8, retries=3,
                          integrity=True, fault_plan=plan)

    ``take(idx)`` hands the pool every fault scheduled for gang `idx`
    (each at most once); the pool logs applied faults into ``fired``."""

    faults: List[Fault] = field(default_factory=list)
    fired: List[Dict] = field(default_factory=list)   # pool-appended log

    def __post_init__(self):
        self._by_gang: Dict[int, List[Fault]] = {}
        for f in self.faults:
            self._by_gang.setdefault(f.gang, []).append(f)

    def __len__(self) -> int:
        return len(self.faults)

    def take(self, gang_idx: int) -> List[Fault]:
        """Faults scheduled for this gang execution (consumed: a second
        call for the same index returns nothing)."""
        return self._by_gang.pop(gang_idx, [])

    def counts(self) -> Dict[str, int]:
        """Scheduled fault count by kind."""
        return dict(Counter(f.kind for f in self.faults))

    def fired_counts(self) -> Dict[str, int]:
        """Applied fault count by kind (filled in by the pool)."""
        return dict(Counter(e["kind"] for e in self.fired))

    @classmethod
    def random(cls, seed: int, n_gangs: int, slots: int,
               rate: float = 0.10,
               kinds: Sequence[str] = FAULT_KINDS,
               max_delay_s: float = 0.02) -> "FaultPlan":
        """Seeded plan: each of the first `n_gangs` gang executions
        independently draws one fault with probability `rate`, uniform
        over `kinds`, targeting a uniform slot.  Gang 0 is always left
        fault-free so every run completes at least one clean gang (jit
        warm-up / baseline sanity)."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault rate {rate} not in [0, 1]")
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"fault kind {k!r} not in {FAULT_KINDS}")
        rng = np.random.default_rng(seed)
        faults: List[Fault] = []
        for g in range(1, n_gangs):
            if rng.random() >= rate:
                continue
            kind = str(rng.choice(list(kinds)))
            slot = int(rng.integers(slots))
            faults.append(Fault(
                kind=kind, gang=g, slot=slot,
                delay_s=float(rng.uniform(0.0, max_delay_s))
                if kind == "delay" else 0.0,
                byte=int(rng.integers(1 << 30)) if kind == "flip" else 0))
        return cls(faults=faults)

    def describe(self) -> str:
        sched = self.counts()
        fired = self.fired_counts()
        parts = [f"{k}:{sched.get(k, 0)} scheduled/{fired.get(k, 0)} fired"
                 for k in FAULT_KINDS]
        return f"faultplan[{len(self.faults)} faults: " \
               f"{', '.join(parts)}]"
