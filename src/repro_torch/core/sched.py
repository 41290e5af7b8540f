"""Continuous-batching control plane on top of :class:`DevicePool`.

The pool (``core.serve``) gangs requests that happen to sit at the same
program's same accelerator segment — but greedy ``submit()`` fires the
moment a slot frees, so open-loop arrivals stagger the slots' step
offsets and, because the pool advances round by round, the stagger
persists for the whole program: gangs almost never form under real
traffic.  This module adds the classic LM-serving admission layer that
makes them form on purpose:

  * **bounded admission window** — requests park in per-program queues;
    a batch is released when it reaches the gang width K *or* its oldest
    request has waited T µs (so a lone request still runs after one
    window: the gang-of-1 path).  A released batch lands on distinct
    idle slots together, stays lockstep for every segment, and therefore
    gangs end to end.

  * **gang-width auto-tuning** — :func:`auto_gang_width` prices a
    program's streams on the calibrated :class:`TimingModel` and picks
    the width where predicted per-call cycles stop improving (< 5 %
    marginal gain), respecting the tile-batching knee of the reference
    package's cost model (per-launch tile count beyond
    ~:data:`VMAP_INTERPRET_CLIFF` stops amortizing).  DMA setup latency is the amortizable term — a
    gang's batched launches pay it once per launch instead of once per
    request — while compute cycles replicate per member.

  * **multi-program pools** — co-staged programs
    (``program.compile_multi``) occupy disjoint DRAM ranges of one
    resident image; the scheduler keeps one admission queue per program
    and never releases a mixed batch, so only same-program requests
    gang (their streams are identical; a mixed gang would be
    semantically wrong and the pool refuses it anyway).

  * **backpressure, typed and loud** — queues are bounded
    (``queue_cap``).  On overflow the ``"reject"`` policy raises
    :class:`QueueFull` at submit; ``"shed_oldest"`` admits the newcomer
    and fails the oldest parked future with :class:`Shed`.  A per-
    request (or config-default) deadline fails a still-parked request
    with :class:`DeadlineExpired` the moment it lapses.  Nothing is ever
    dropped silently: every outcome is a typed exception on a future or
    at the submit site.

Determinism contract: admission changes WHEN a request runs, never what
it computes — every released request executes the same pre-staged stream
on its own slot device, so results are byte-identical to serial
execution.  The fuzzer's ``sched`` flavor byte-diffs random graphs
through randomized window/backpressure configs against serial runs.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from queue import Queue as _Queue
from dataclasses import dataclass, replace
from typing import Any, Deque, Dict, List, Optional, Tuple, Union

import numpy as np

from .isa import GemmInsn, IsaLayout, LoadStoreInsn
from .program import CompiledProgram
from .serve import (DevicePool, PoolClosed, PoolFuture, Session, SlotDied,
                    WaitTimeout)
from .simulator import TimingModel, replay_timing

#: the reference package's tile-batching knee: batching more than ~24
#: tiles into one launch stopped amortizing dispatch overhead on its
#: interpreted engine.  Kept as the cost model's constant (same name, same
#: value) so gang widths equal the reference's on the same program; the
#: CUDA kernels' own knee is not measured yet.  The auto-tuner penalizes
#: gang widths that push a segment's tiles-per-launch past this knee.
VMAP_INTERPRET_CLIFF = 24

SCHED_POLICIES = ("reject", "shed_oldest")


class QueueFull(RuntimeError):
    """``policy="reject"``: the program's admission queue is at
    ``queue_cap``; the submit is refused (raised at the submit site,
    nothing was enqueued)."""
    pass


class Shed(RuntimeError):
    """``policy="shed_oldest"``: this parked request was evicted to
    admit a newer one; raised by the shed request's ``wait()``."""
    pass


class DeadlineExpired(RuntimeError):
    """The request's deadline lapsed while it was still parked in the
    admission queue; raised by its ``wait()``."""
    pass


# ----------------------------------------------------------------------
# gang-width auto-tuning
# ----------------------------------------------------------------------
def _stream_costs(compiled: CompiledProgram,
                  timing: Optional[TimingModel] = None
                  ) -> List[Tuple[int, int, int]]:
    """Per accelerator segment: (amortizable_cycles, lockstep_cycles,
    gemm_tiles).  Amortizable = fixed DMA setup latency, paid once per
    batched launch by a gang instead of once per member; lockstep =
    everything else (compute + streaming bytes), replicated per member."""
    spec = compiled.spec
    tm = timing or TimingModel(spec)
    isa = IsaLayout(spec)
    out = []
    for step in compiled.accel_steps:
        insns = isa.decode_stream(np.ascontiguousarray(step.stream))
        total = replay_timing(spec, insns, tm).total_cycles
        fixed = sum(spec.dram_latency_cycles for i in insns
                    if isinstance(i, LoadStoreInsn)
                    and i.y_size * i.x_size > 0)
        fixed = min(fixed, total)   # pipeline overlap can hide setup
        tiles = sum(1 for i in insns if isinstance(i, GemmInsn))
        out.append((fixed, total - fixed, tiles))
    return out


def stream_costs(compiled: CompiledProgram,
                 timing: Optional[TimingModel] = None
                 ) -> List[Tuple[int, int, int]]:
    """Memoized :func:`_stream_costs`.  A TimingModel's latencies are
    fully determined by its class and its (frozen, hashable) spec, so
    the memo key is exactly that pair — a fresh ``TimingModel(spec)``
    per call still hits.  The cache lives on the CompiledProgram
    (``_cost_cache``), so the Scheduler's gang-width tuner and the
    autotuner's cycle oracle share ONE decode + replay per program."""
    tm = timing or TimingModel(compiled.spec)
    key = (type(tm).__name__, tm.spec)
    got = compiled._cost_cache.get(key)
    if got is None:
        got = _stream_costs(compiled, tm)
        compiled._cost_cache[key] = got
    return got


def predict_gang_cycles(compiled: CompiledProgram, width: int,
                        timing: Optional[TimingModel] = None,
                        cliff: int = VMAP_INTERPRET_CLIFF,
                        costs: Optional[List[Tuple[int, int, int]]] = None
                        ) -> float:
    """Predicted per-call cycles when `width` requests run as one gang.
    Fixed DMA setup amortizes across the gang (one batched launch per
    segment); lockstep cycles replicate, degraded by the interpret-mode
    penalty once a segment's tiles-per-launch exceed the cliff.  Pass
    precomputed ``costs`` when sweeping widths — the costs depend only
    on the program, not the width."""
    cost = 0.0
    for fixed, lockstep, tiles in (costs if costs is not None
                                   else stream_costs(compiled, timing)):
        penalty = max(1.0, (tiles * width) / cliff) if tiles else 1.0
        cost += lockstep * penalty + fixed / width
    return cost


def auto_gang_width(compiled: CompiledProgram, max_width: int,
                    timing: Optional[TimingModel] = None,
                    cliff: int = VMAP_INTERPRET_CLIFF,
                    eps: float = 0.05) -> int:
    """Widest gang that still pays: walk the width up from 1 and stop
    at the first step whose predicted per-call cycles improve by less
    than `eps` (the knee), never exceeding `max_width` (the pool size —
    a gang wider than the pool cannot be scheduled in one round).

    One alignment override: gangs NARROWER than the pool can never
    double-buffer behind each other (a partial-width release strands the
    remaining slots and would desync the next batch), so if full width
    is predicted no worse per call than the knee, take full width — the
    only reason to stay narrow is the vmap recompile cliff actually
    making wider gangs more expensive."""
    if max_width <= 1:
        return max(1, max_width)
    # one decode + replay for the whole sweep: the per-segment costs do
    # not depend on the candidate width
    costs = stream_costs(compiled, timing)
    best = 1
    prev = predict_gang_cycles(compiled, 1, timing, cliff, costs=costs)
    for w in range(2, max_width + 1):
        cur = predict_gang_cycles(compiled, w, timing, cliff, costs=costs)
        if cur >= prev * (1.0 - eps):
            break
        best, prev = w, cur
    if best < max_width:
        full = predict_gang_cycles(compiled, max_width, timing, cliff,
                                   costs=costs)
        if full <= prev:
            return max_width
    return best


# ----------------------------------------------------------------------
# config / stats / futures
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class SchedConfig:
    """Admission-control knobs.  ``gang_width=None`` auto-tunes per
    program from the TimingModel; an explicit width is clamped to the
    pool size."""
    window_us: float = 500.0            # max parking time before release
    gang_width: Optional[int] = None    # None -> auto_gang_width per prog
    queue_cap: int = 256                # per-program parked-request bound
    policy: str = "reject"              # overflow: reject | shed_oldest
    default_deadline_us: Optional[float] = None  # parked-request deadline
    vmap_cliff: int = VMAP_INTERPRET_CLIFF
    autotune_eps: float = 0.05
    # released gangs in flight at once: 2 double-buffers the pool (one
    # gang executing while the next parks on the slot queues — still
    # lockstep, since the pool admits at round boundaries); 1 serializes
    # releases (simplest to reason about, idle pool between gangs)
    pipeline_depth: int = 2

    def __post_init__(self):
        if self.policy not in SCHED_POLICIES:
            raise ValueError(
                f"policy {self.policy!r} not in {SCHED_POLICIES}")
        if self.window_us <= 0:
            raise ValueError("window_us must be > 0")
        if self.gang_width is not None and self.gang_width < 1:
            raise ValueError("gang_width must be >= 1 (or None to "
                             "auto-tune)")
        if self.queue_cap < 1:
            raise ValueError("queue_cap must be >= 1")
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")


@dataclass
class ProgStats:
    """Admission counters for one program's queue (dispatcher-thread
    owned; read via :meth:`Scheduler.stats`)."""
    submitted: int = 0
    completed: int = 0
    failed: int = 0             # released but the pool run errored
    rejected: int = 0           # QueueFull at submit
    shed: int = 0               # evicted by shed_oldest
    expired: int = 0            # deadline lapsed while parked
    releases: int = 0           # batches handed to the pool
    full_releases: int = 0      # released because gang width was reached
    window_timeouts: int = 0    # released because the window expired
    flush_releases: int = 0     # released by flush()/close()
    max_gang: int = 0           # widest observed executed gang
    queue_hiwater: int = 0


class SchedFuture:
    """Handle to one admitted request.  Resolves when the pool finishes
    the released batch; fails with :class:`Shed` /
    :class:`DeadlineExpired` if backpressure claimed it while parked, or
    with the worker's error if execution failed."""

    def __init__(self, seq: int, prog_idx: int):
        self.seq = seq
        self.prog_idx = prog_idx
        self.submit_at = time.perf_counter()
        self.released_at: Optional[float] = None
        self.done_at: Optional[float] = None
        self.gang_size = 0              # widest gang this request rode
        self.pool_future: Optional[PoolFuture] = None
        self._done = threading.Event()
        self._outputs: Any = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def latency_s(self) -> Optional[float]:
        """Arrival-to-completion latency (open-loop: includes parking)."""
        if self.done_at is None:
            return None
        return self.done_at - self.submit_at

    def wait(self, timeout: Optional[float] = None
             ) -> Union[np.ndarray, Dict[str, np.ndarray]]:
        if not self._done.wait(timeout):
            raise WaitTimeout(
                f"sched request #{self.seq} not done within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._outputs

    result = wait

    def _finish(self, outputs: Any) -> None:
        if self._done.is_set():
            return
        self._outputs = outputs
        self.done_at = time.perf_counter()
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        if self._done.is_set():
            return
        if hasattr(exc, "add_note"):
            try:
                exc.add_note(f"[sched request #{self.seq}, program "
                             f"{self.prog_idx}]")
            except TypeError:               # pragma: no cover
                pass
        self._exc = exc
        self.done_at = time.perf_counter()
        self._done.set()


@dataclass
class _Parked:
    future: SchedFuture
    inputs: Dict[str, np.ndarray]
    session: Optional[Session] = None
    deadline_at: Optional[float] = None   # perf_counter absolute


class SchedSession:
    """A pool :class:`Session` whose submits go through the admission
    window: token-step submits of concurrent sessions park together and
    release as one gang (same program, same segment, distinct slots —
    the continuous-batching decode pattern)."""

    def __init__(self, scheduler: "Scheduler", session: Session,
                 prog_idx: int):
        self.scheduler = scheduler
        self.session = session
        self._prog_idx = prog_idx

    @property
    def sid(self) -> int:
        return self.session.sid

    @property
    def slot_id(self) -> int:
        return self.session.slot_id

    def submit(self, deadline_us: Optional[float] = None,
               **inputs: np.ndarray) -> SchedFuture:
        return self.scheduler._submit(self._prog_idx, inputs,
                                      session=self.session,
                                      deadline_us=deadline_us)

    def state(self, name: str) -> np.ndarray:
        return self.session.state(name)

    def reset(self) -> None:
        self.session.reset()


# ----------------------------------------------------------------------
# the scheduler
# ----------------------------------------------------------------------
class Scheduler:
    """Continuous-batching admission control over one DevicePool.

        pool = DevicePool(compile_multi([p1, p2]), size=4)
        sched = Scheduler(pool, SchedConfig(window_us=800))
        fut = sched.submit(x=arr)                  # default program
        fut2 = sched.submit(program=1, x=arr2)     # co-staged peer
        y = fut.wait()

    The scheduler OWNS pool submission: callers must not call
    ``pool.submit*`` directly while a Scheduler is attached, or released
    batches would interleave with stragglers and desync the gangs.
    ``close()`` drains the admission queues; the pool itself stays open
    (the caller created it, the caller closes it)."""

    def __init__(self, pool: DevicePool,
                 config: Optional[SchedConfig] = None,
                 timing: Optional[TimingModel] = None):
        self.pool = pool
        self.config = config or SchedConfig()
        nprog = len(pool.programs)
        self._timing = timing               # retained: re-tune on death
        self._fixed_width = self.config.gang_width
        self._tuned_alive = len(pool)       # widths tuned for this many
        if self.config.gang_width is not None:
            w = max(1, min(self.config.gang_width, len(pool)))
            self.gang_widths = [w] * nprog
            self._autotuned = False
        else:
            self.gang_widths = [
                auto_gang_width(c, len(pool), timing=timing,
                                cliff=self.config.vmap_cliff,
                                eps=self.config.autotune_eps)
                for c in pool.programs]
            self._autotuned = True
        self._queues: List[Deque[_Parked]] = [deque()
                                              for _ in range(nprog)]
        self._stats = [ProgStats() for _ in range(nprog)]
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._pending = 0           # parked + released-but-unfinished
        self._flush = False
        self._closed = False
        self._outstanding = 0       # released gangs not yet retired
        self._last_aligned = True   # was the last release full-width?
        # completer thread: waits out released gangs and resolves their
        # futures, so the dispatcher can pipeline the next release while
        # the previous one executes (pipeline_depth throttles it)
        self._done_q: "_Queue" = _Queue()
        self._completer = threading.Thread(
            target=self._run_completer, name="repro-sched-completer",
            daemon=True)
        self._completer.start()
        self._dispatcher = threading.Thread(
            target=self._run_dispatcher, name="repro-sched-dispatcher",
            daemon=True)
        self._dispatcher.start()

    # ------------------------------------------------------------------
    def __enter__(self) -> "Scheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _prog_idx(self, program: Union[None, int, CompiledProgram]) -> int:
        if program is None:
            return 0
        if isinstance(program, int):
            if not 0 <= program < len(self.pool.programs):
                raise ValueError(f"program index {program} out of range")
            return program
        for i, c in enumerate(self.pool.programs):
            if c is program:
                return i
        raise ValueError("program was not staged on this scheduler's "
                         "pool (co-stage it with program.compile_multi)")

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, program: Union[None, int, CompiledProgram] = None,
               deadline_us: Optional[float] = None,
               **inputs: np.ndarray) -> SchedFuture:
        """Park one request in its program's admission queue.  Raises
        :class:`QueueFull` immediately under the reject policy when the
        queue is at cap; otherwise returns a future that resolves when
        the released gang finishes (or fails typed under backpressure)."""
        return self._submit(self._prog_idx(program), inputs,
                            session=None, deadline_us=deadline_us)

    def session(self, program: Union[None, int, CompiledProgram] = None,
                slot: Optional[int] = None) -> SchedSession:
        """Open a persistent-state session whose submits go through the
        admission window (see :class:`SchedSession`)."""
        pi = self._prog_idx(program)
        return SchedSession(self, self.pool.session(slot=slot,
                                                    program=pi), pi)

    def _submit(self, pi: int, inputs: Dict[str, np.ndarray],
                session: Optional[Session],
                deadline_us: Optional[float]) -> SchedFuture:
        self.pool.programs[pi].check_inputs(inputs)   # fail in caller
        if deadline_us is None:
            deadline_us = self.config.default_deadline_us
        with self._lock:
            if self._closed:
                raise PoolClosed("submit() on a closed Scheduler")
            q = self._queues[pi]
            st = self._stats[pi]
            if len(q) >= self.config.queue_cap:
                if self.config.policy == "reject":
                    st.rejected += 1
                    raise QueueFull(
                        f"program {pi} admission queue at cap "
                        f"{self.config.queue_cap} (policy=reject)")
                victim = q.popleft()        # shed_oldest
                st.shed += 1
                self._pending -= 1
                victim.future._fail(Shed(
                    f"request #{victim.future.seq} shed: program {pi} "
                    f"queue hit cap {self.config.queue_cap} and a newer "
                    f"request arrived (policy=shed_oldest)"))
            fut = SchedFuture(seq=next(self._seq), prog_idx=pi)
            deadline_at = (fut.submit_at + deadline_us * 1e-6
                           if deadline_us is not None else None)
            q.append(_Parked(future=fut, inputs=dict(inputs),
                             session=session, deadline_at=deadline_at))
            st.submitted += 1
            st.queue_hiwater = max(st.queue_hiwater, len(q))
            self._pending += 1
            self._work.notify_all()
        return fut

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Release every parked request now (in gang-width batches)
        without waiting for windows to fill — e.g. before a drain."""
        with self._lock:
            self._flush = True
            self._work.notify_all()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Flush, then block until every admitted request resolved."""
        self.flush()
        with self._lock:
            if not self._idle.wait_for(lambda: self._pending == 0,
                                       timeout=timeout):
                raise TimeoutError("Scheduler.drain timed out")

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Reject new submits, release and finish everything parked,
        stop the dispatcher.  The pool is left open."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._flush = True
            self._work.notify_all()
        self._dispatcher.join(timeout)
        self._done_q.put(None)              # stop the completer
        self._completer.join(timeout)
        if self._dispatcher.is_alive():     # wedged release: fail loudly
            err = PoolClosed(
                f"Scheduler.close: dispatcher did not drain within "
                f"{timeout}s; failing parked futures")
            with self._lock:
                for q in self._queues:
                    while q:
                        p = q.popleft()
                        self._pending -= 1
                        p.future._fail(err)
                self._idle.notify_all()

    # ------------------------------------------------------------------
    # the dispatcher
    # ------------------------------------------------------------------
    def _run_dispatcher(self) -> None:
        try:
            self._dispatch_loop()
        except BaseException as e:
            # a dead dispatcher must not strand parked waiters
            with self._lock:
                for pi, q in enumerate(self._queues):
                    while q:
                        p = q.popleft()
                        self._pending -= 1
                        self._stats[pi].failed += 1
                        p.future._fail(PoolClosed(
                            f"request #{p.future.seq} lost: scheduler "
                            f"dispatcher died: {e!r}"))
                self._idle.notify_all()
            raise

    def _next_wakeup(self, now: float) -> Optional[float]:
        """Seconds until the earliest FUTURE window or deadline event
        (lock held); None = sleep until notified.  Timers that already
        fired are excluded on purpose: an expired head that stays parked
        is blocked on pool occupancy, and the completer notifies on
        every batch completion — re-arming its lapsed timer would spin
        the dispatcher on the GIL and strangle the very gangs it is
        waiting out."""
        window_s = self.config.window_us * 1e-6
        t: Optional[float] = None
        for q in self._queues:
            if not q:
                continue
            head = q[0].future.submit_at + window_s
            if head > now:
                t = head if t is None else min(t, head)
            for p in q:
                if p.deadline_at is not None and p.deadline_at > now:
                    t = p.deadline_at if t is None else min(t, p.deadline_at)
        for q in self._queues:
            if q and len(self._eligible_of(q)) != len(q):
                # someone is parked for a dead slot: poll so a respawn
                # (which the pool does not signal us about) is noticed
                poll = now + max(window_s, 0.005)
                t = poll if t is None else min(t, poll)
                break
        return None if t is None else t - now

    def _expire_deadlines(self, now: float) -> None:
        """Fail parked requests whose deadline lapsed (lock held)."""
        for pi, q in enumerate(self._queues):
            if not q:
                continue
            keep: Deque[_Parked] = deque()
            for p in q:
                if p.deadline_at is not None and p.deadline_at <= now:
                    self._stats[pi].expired += 1
                    self._pending -= 1
                    p.future._fail(DeadlineExpired(
                        f"request #{p.future.seq} deadline lapsed after "
                        f"{(now - p.future.submit_at) * 1e6:.0f}us parked "
                        f"in program {pi}'s admission queue"))
                else:
                    keep.append(p)
            if len(keep) != len(q):
                q.clear()
                q.extend(keep)

    def _retune_if_needed(self) -> None:
        """Re-tune gang widths when the alive-slot count changed (lock
        held): a pool degraded by a slot death must not stall full-width
        releases waiting for a width it can no longer co-schedule, and a
        respawn restores the original widths.  Auto widths re-run
        :func:`auto_gang_width` against the surviving count; fixed
        widths re-clamp."""
        alive = sum(1 for s in self.pool.slots if not s.dead)
        if alive == self._tuned_alive or alive < 1:
            return
        self._tuned_alive = alive
        if self._autotuned:
            self.gang_widths = [
                auto_gang_width(c, alive, timing=self._timing,
                                cliff=self.config.vmap_cliff,
                                eps=self.config.autotune_eps)
                for c in self.pool.programs]
        else:
            w = max(1, min(self._fixed_width, alive))
            self.gang_widths = [w] * len(self.pool.programs)

    def _eligible_of(self, q: Deque[_Parked]) -> List[_Parked]:
        """Servable-now members of one queue (lock held).  A request
        pinned to a dead slot (or a lost session) stays PARKED — its
        deadline keeps counting toward DeadlineExpired while a respawn
        races to revive the slot — instead of poisoning a released
        batch with the SlotDied the whole gang would then share."""
        if all(s.dead for s in self.pool.slots):
            return []
        out: List[_Parked] = []
        for p in q:
            if p.session is not None:
                st = p.session._state
                if st.lost or self.pool.slots[st.slot_id].dead:
                    continue
            out.append(p)
        return out

    def _sweep_unservable(self) -> None:
        """Flush/close is final: a parked request whose slot never came
        back (or whose session state is lost, or with every slot dead)
        fails typed :class:`SlotDied` now instead of parking forever on
        a drain that would otherwise never finish (lock held)."""
        for pi, q in enumerate(self._queues):
            if not q:
                continue
            keep: Deque[_Parked] = deque()
            swept = False
            for p in q:
                why = None
                if all(s.dead for s in self.pool.slots):
                    why = "every pool slot is dead"
                elif p.session is not None:
                    st = p.session._state
                    if st.lost:
                        why = (f"session {st.sid}'s state was lost when "
                               f"its slot died")
                    elif self.pool.slots[st.slot_id].dead:
                        why = (f"session {st.sid}'s slot {st.slot_id} "
                               f"is dead")
                if why is None:
                    keep.append(p)
                    continue
                swept = True
                self._stats[pi].failed += 1
                self._pending -= 1
                p.future._fail(SlotDied(
                    f"request #{p.future.seq} unservable at flush: "
                    f"{why}"))
            if swept:
                q.clear()
                q.extend(keep)
                self._idle.notify_all()

    def _pick_batch(self, now: float
                    ) -> Optional[Tuple[int, List[_Parked], str]]:
        """FIFO-fair batch selection (lock held): among programs whose
        queue is ready (width reached, window expired, or flushing),
        release the one with the oldest head.  Readiness and membership
        consider only ELIGIBLE requests (see :meth:`_eligible_of`):
        requests parked for a down slot neither release nor block their
        queue-mates."""
        window_s = self.config.window_us * 1e-6
        best: Optional[Tuple[float, int, str]] = None
        for pi, q in enumerate(self._queues):
            if not q:
                continue
            elig = self._eligible_of(q)
            if not elig:
                continue
            width = self.gang_widths[pi]
            if len(elig) >= width:
                reason = "full"
            elif self._flush or self._closed:
                reason = "flush"
            elif (now - elig[0].future.submit_at >= window_s
                    and self._outstanding == 0):
                # window expired AND the pool is idle: releasing a
                # partial gang while gangs are still executing would
                # only park it on busy slot queues — keep collecting
                # instead (continuous batching; deadlines still apply)
                reason = "window"
            else:
                continue
            head = elig[0].future.submit_at
            if best is None or head < best[0]:
                best = (head, pi, reason)
        if best is None:
            return None
        _, pi, reason = best
        q = self._queues[pi]
        elig = self._eligible_of(q)
        batch = elig[:min(self.gang_widths[pi], len(elig))]
        chosen = {id(p) for p in batch}
        keep = [p for p in q if id(p) not in chosen]
        q.clear()
        q.extend(keep)
        return pi, batch, reason

    def _dispatch_loop(self) -> None:
        while True:
            with self._lock:
                while True:
                    if self._closed and self._pending == 0:
                        return
                    now = time.perf_counter()
                    self._retune_if_needed()
                    self._expire_deadlines(now)
                    if self._flush or self._closed:
                        self._sweep_unservable()
                    picked = self._pick_batch(now)
                    if picked is not None:
                        break
                    if self._flush and not any(self._queues):
                        self._flush = False
                    if self._closed and self._pending == 0:
                        return
                    self._work.wait(timeout=self._next_wakeup(now))
                pi, batch, reason = picked
                st = self._stats[pi]
                st.releases += 1
                if reason == "full":
                    st.full_releases += 1
                elif reason == "window":
                    st.window_timeouts += 1
                else:
                    st.flush_releases += 1
                # throttle: at most pipeline_depth released gangs in
                # flight — one executing, the rest parked lockstep on
                # the slot queues awaiting the next round boundary.
                # Only FULL-width batches behind full-width batches may
                # pipeline: a partial gang occupies a slot subset, and
                # piling the next batch behind it would split that
                # batch across idle and busy slots (permanent desync) —
                # so anything partial waits for an idle pool.
                aligned = self._batch_aligned(batch)
                if aligned and self._last_aligned:
                    self._work.wait_for(
                        lambda: self._outstanding <
                        self.config.pipeline_depth)
                else:
                    self._work.wait_for(
                        lambda: self._outstanding == 0)
                self._last_aligned = aligned
                self._outstanding += 1
            self._release(pi, batch)

    def _batch_aligned(self, batch: List[_Parked]) -> bool:
        """True when the batch covers every live slot exactly once —
        the only shape that can pile behind an in-flight gang and still
        co-admit at one round boundary (lock held)."""
        alive = sum(1 for s in self.pool.slots if not s.dead)
        if len(batch) != alive:
            return False
        pinned = [p.session.slot_id for p in batch
                  if p.session is not None]
        return len(set(pinned)) == len(pinned)

    def _release(self, pi: int, batch: List[_Parked]) -> None:
        """Hand one same-program batch to the pool in one burst — the
        members land on distinct slots together and stay lockstep for
        every segment (that is the whole point of the window) — then
        pass it to the completer, which resolves the futures while the
        dispatcher pipelines the next release."""
        prog = self.pool.programs[pi]
        released_at = time.perf_counter()
        pairs: List[Tuple[_Parked, Optional[PoolFuture]]] = []
        try:
            # one atomic enqueue: the pool admits the whole batch at the
            # same round boundary, so it stays lockstep end to end
            pfs = self.pool._enqueue_batch(
                [(p.inputs,
                  p.session._state if p.session is not None else None,
                  prog) for p in batch])
            for p, pf in zip(batch, pfs):
                p.future.released_at = released_at
                p.future.pool_future = pf
                pairs.append((p, pf))
        except BaseException as e:          # dead slot / closed pool
            for p in batch:
                p.future.released_at = released_at
                p.future._fail(e)
                pairs.append((p, None))
        self._done_q.put((pi, pairs))

    def _run_completer(self) -> None:
        while True:
            item = self._done_q.get()
            if item is None:
                return
            pi, pairs = item
            st = self._stats[pi]
            for p, pf in pairs:
                done = 0
                if pf is not None:
                    try:
                        out = pf.wait()
                        p.future.gang_size = max(
                            (s.gang_size for s in pf.stats), default=1)
                        st.max_gang = max(st.max_gang,
                                          p.future.gang_size)
                        p.future._finish(out)
                        done = 1
                    except BaseException as e:
                        p.future._fail(e)
                with self._lock:
                    self._pending -= 1
                    st.completed += done
                    st.failed += 0 if done else 1
                    self._idle.notify_all()
            with self._lock:
                self._outstanding -= 1
                self._work.notify_all()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def stats(self) -> List[ProgStats]:
        return [replace(s) for s in self._stats]

    def queue_depths(self) -> List[int]:
        with self._lock:
            return [len(q) for q in self._queues]

    def describe(self) -> str:
        """Config + per-program admission state + the pool's own
        describe() — the ops-console dump."""
        c = self.config
        widths = ",".join(str(w) for w in self.gang_widths)
        lines = [
            f"sched[window {c.window_us:g}us, gang widths [{widths}]"
            f"{' (auto)' if self._autotuned else ''}, cap {c.queue_cap}, "
            f"policy {c.policy}"
            + (f", deadline {c.default_deadline_us:g}us"
               if c.default_deadline_us is not None else "")
            + f", vmap cliff {c.vmap_cliff}]"]
        with self._lock:
            depths = [len(q) for q in self._queues]
        for pi, st in enumerate(self._stats):
            lines.append(
                f"  prog{pi}: width {self.gang_widths[pi]}, "
                f"q{depths[pi]} (hiwater {st.queue_hiwater}), "
                f"{st.submitted} submitted, {st.completed} completed, "
                f"{st.releases} releases ({st.full_releases} full, "
                f"{st.window_timeouts} window, {st.flush_releases} "
                f"flush), max gang {st.max_gang}, "
                f"{st.rejected} rejected, {st.shed} shed, "
                f"{st.expired} expired, {st.failed} failed")
        lines.append(self.pool.describe())
        return "\n".join(lines)
