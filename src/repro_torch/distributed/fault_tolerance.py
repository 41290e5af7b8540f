"""Fault-tolerance runtime: straggler watchdog, elastic mesh
reconfiguration.

The port of the reference's ``distributed/fault_tolerance.py``:
  * `StepWatchdog` — flags steps exceeding `deadline = k *
    EMA(step_time)` (straggler mitigation: the launcher can preempt the
    slow host, shrink the mesh, and restart from the last checkpoint);
  * `ElasticPlan` — given surviving device count, picks the largest
    valid (pod, data, model) mesh <= survivors and rescales batch/LR;
  * `simulate_failure` — test hook that drops devices deterministically.

The decision code (what to do on failure) is the production code path;
only the failure *source* is simulated.  The restart itself is
``restore_checkpoint(..., shardings=)`` onto the new mesh.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple


class StepWatchdog:
    """EMA-based straggler detector with a hard deadline multiplier."""

    def __init__(self, slack: float = 3.0, ema: float = 0.9,
                 min_deadline_s: float = 1.0):
        self.slack = slack
        self.ema = ema
        self.min_deadline_s = min_deadline_s
        self.mean_step_s: Optional[float] = None
        self.straggler_events: List[Tuple[int, float]] = []
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    @property
    def deadline_s(self) -> float:
        if self.mean_step_s is None:
            return float("inf")
        return max(self.min_deadline_s, self.slack * self.mean_step_s)

    def end_step(self, step: int, elapsed: Optional[float] = None) -> bool:
        """Returns True if this step was a straggler."""
        dt = elapsed if elapsed is not None else time.monotonic() - self._t0
        straggler = (self.mean_step_s is not None
                     and dt > self.deadline_s)
        if straggler:
            self.straggler_events.append((step, dt))
        else:
            # only healthy steps update the EMA (stragglers would poison it)
            self.mean_step_s = (dt if self.mean_step_s is None
                                else self.ema * self.mean_step_s
                                + (1 - self.ema) * dt)
        return straggler


@dataclass
class ElasticPlan:
    """Mesh + batch decision after a membership change."""
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    global_batch: int
    lr_scale: float
    dropped_devices: int


def plan_elastic_restart(n_devices: int, model_parallel: int,
                         target_batch: int,
                         pods: int = 1) -> ElasticPlan:
    """Largest (pod, data, model) mesh that fits the survivors, keeping TP
    intact (model groups must stay whole — TP shards are not recoverable
    piecemeal) and shrinking data parallelism; batch shrinks with DP and
    LR scales linearly (the standard recipe)."""
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot keep model_parallel={model_parallel} with only "
            f"{n_devices} devices — restore needs resharding to smaller TP")
    groups = n_devices // model_parallel
    # keep pod axis only if groups divide evenly across surviving pods
    if pods > 1 and groups % pods == 0:
        shape = (pods, groups // pods, model_parallel)
        names = ("pod", "data", "model")
    else:
        shape = (groups, model_parallel)
        names = ("data", "model")
    dp = groups
    # per-replica batch stays fixed; global batch scales with DP
    per_replica = max(1, target_batch // max(1, dp))
    new_batch = per_replica * dp
    return ElasticPlan(mesh_shape=shape, axis_names=names,
                       global_batch=new_batch,
                       lr_scale=new_batch / target_batch,
                       dropped_devices=0)


def simulate_failure(n_devices: int, n_failures: int, seed: int = 0) -> int:
    """Deterministic survivor count for tests."""
    if not 0 <= n_failures < n_devices:
        raise ValueError(f"{n_failures} failures of {n_devices} devices")
    return n_devices - n_failures
