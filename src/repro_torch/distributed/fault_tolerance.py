"""Fault-tolerance runtime: the straggler watchdog.

The port of ``StepWatchdog`` from the reference's
``distributed/fault_tolerance.py``: it flags steps exceeding ``deadline
= k * EMA(step_time)`` (straggler mitigation: the launcher can preempt
the slow host, shrink the mesh, and restart from the last checkpoint).
The elastic plan and the failure simulation wait for the mesh (ROADMAP
Queue 1 item 6).
"""
from __future__ import annotations

import time
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
