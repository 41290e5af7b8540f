"""Async multi-stream serving: device pools, submit/wait futures, and
sharded batch dispatch.

The paper's task-ISA "explicitly orchestrates concurrent compute and
memory tasks" inside one device; this module orchestrates concurrency
ACROSS devices, which is how the runtime the paper sketches (and TVM's,
arXiv 1802.04799) serves real traffic: a compiled program is staged once,
cloned onto a pool of devices, and requests stream through an async
submit()/wait() API.

  * :class:`DevicePool` — N cloned, pre-staged devices serving one
    CompiledProgram **or a co-staged program mix**
    (``program.compile_multi``: every program occupies a disjoint
    ``ImageRange`` of ONE resident image, so a single slot clone holds
    the whole heterogeneous mix with every baked address valid).
    ``Device.clone(trim=True)`` of the staged image means streams,
    constants and the recycled intermediate arenas are already in DRAM,
    and a slot can never allocate — the zero-per-call-DRAM serving
    contract, enforced per slot by construction.  Requests are assigned
    to slot queues at submit time by a round-robin or least-loaded
    policy.

  * a **worker-scheduler** (one thread) that advances every in-flight
    request step by step: host segments are dispatched to a host
    executor thread FIRST, then the accelerator segments of the other
    requests run — so one request's host work overlaps another's
    accelerator work — and requests sitting at the SAME program's SAME
    accelerator segment execute as one lockstep **gang**
    (:meth:`CudaBackend.execute_gang`): every kernel launch batches
    the peer tiles of all gang members, so aggregate calls/sec scales
    with pool size instead of with the GIL.  Different programs never
    gang (their streams differ); the continuous-batching admission
    layer (``core.sched``) exists to park and release same-program
    requests together so gangs actually form under open-loop traffic.

  * :class:`BatchServer` — shards a batch of requests across the pool
    and gathers results in submission order.

  * :class:`Session` — persistent-state serving (``Program.persistent``
    buffers: KV caches, recurrent state).  ``pool.session()`` pins a
    session to one slot; its submits run in order on that slot, each
    call advancing the session's state in the slot's DRAM.  When several
    sessions share a slot the scheduler swaps the resident state — raw
    DRAM reads/writes at the stable persistent addresses, never an
    allocation, so the trimmed-clone zero-alloc contract survives
    arbitrary session interleavings.  Residency is tracked per program:
    sessions of co-staged programs live at disjoint addresses and never
    evict each other.

Failure is loud, never a hang: a worker exception or a dead slot fails
the waiting future (the error carries the request id), the scheduler and
host-worker threads are watchdogged against each other, and
:meth:`DevicePool.kill_slot` is the chaos hook the regression suite uses
to prove it — every request parked on or active in a killed slot raises
:class:`SlotDied` immediately.

Failure is also RECOVERABLE (the self-healing plane), opt-in per pool:

  * **slot respawn** (``max_respawns``) — a killed slot is rebuilt from
    the CompiledProgram's pristine staged image (the same
    ``Device.clone(trim=True)`` path used at construction) and rejoins
    the rotation; ``SlotStats.deaths``/``respawns`` account every event.
    Past the cap the slot stays dead and its recoverable sessions are
    re-homed to a surviving slot.
  * **session checkpoint/restore** (``checkpoint_every``) — every N
    completed calls a session's persistent bytes are snapshotted to host
    memory via ``persistent_image``; when its slot dies the session
    transparently restores the last snapshot onto the respawned (or
    re-homed) slot, and ``SessionStats.restored_from_step`` makes the
    replayed steps visible — never silent.  A session with no snapshot
    to fall back on is marked lost and fails typed at the next submit.
  * **stateless request retry** (``retries``) — a sessionless request
    killed by :class:`SlotDied` or the segment watchdog is re-submitted
    to a surviving slot with exponential backoff (idempotent: staging is
    per-request, inputs are retained).  Exhaustion surfaces the ORIGINAL
    typed error annotated with the attempt count
    (``PoolFuture.attempts``).
  * **segment watchdog** (``watchdog=WatchdogConfig(...)``) — every
    scheduler round gets a wall-clock deadline derived from the
    calibrated TimingModel (cycles / freq, times a generous multiplier,
    floored); a hung gang or host fn gets its slot killed — and the
    requests failed or retried — rather than hanging ``wait()`` forever.
  * **DRAM integrity** (``integrity=True``) — CRC32 checksums over the
    constant regions are verified before every gang (and over persistent
    regions after every stateful call); a mismatch — e.g. an injected
    bit-flip — triggers restage-from-pristine / restore-from-checkpoint
    instead of computing on corrupted bits.
  * **fault injection** (``fault_plan=chaos.FaultPlan(...)``) — a seeded
    script of kills / bit-flips / delays applied at gang boundaries, the
    hook the chaos fuzzer flavor and ``benchmarks/bench_chaos.py`` drive.

The simulator engine has no gang mode; a pool over ``backend=
"simulator"`` runs its slots serially and acts as the concurrency
oracle: the differential suite byte-diffs every pooled execution against
serial single-device runs on both engines.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .backend import BackendLike, resolve_backend
from .chaos import FaultPlan
from .compiler import AccelStep, CpuStep
from .isa import IsaLayout
from .program import CompiledProgram
from .simulator import TimingModel, replay_timing

POLICIES = ("round_robin", "least_loaded")


class PoolClosed(RuntimeError):
    pass


class SlotDied(RuntimeError):
    """A pool slot died (killed or crashed) with requests parked on or
    active in it; every affected future raises this, carrying the
    request id — never a silent hang."""
    pass


class WaitTimeout(TimeoutError):
    """``PoolFuture.wait(timeout=)`` lapsed before the request resolved
    — e.g. a forgotten future whose dispatcher died.  Carries the
    request id; a TimeoutError subclass, so callers catching the plain
    type keep working."""
    pass


class WatchdogTimeout(RuntimeError):
    """A scheduler round overran its TimingModel-derived wall-clock
    deadline: the hung slot was killed and its requests failed (or
    retried) with this — ``wait()`` never hangs on a wedged gang or
    host fn."""
    pass


class IntegrityError(RuntimeError):
    """A DRAM integrity checksum mismatched: a constant or persistent
    region was corrupted (e.g. an injected bit-flip) and could not be
    repaired from the pristine image or a session checkpoint."""
    pass


@dataclass(frozen=True)
class WatchdogConfig:
    """Segment-watchdog knobs.  The per-round deadline is
    ``floor_s + mult * predicted_wall`` where predicted_wall prices each
    distinct accelerator segment in the round on the calibrated
    TimingModel (``replay_timing`` cycles / spec frequency).  `mult` is
    deliberately generous — the engines (a host-bound stream interpreter
    in Python) run far behind the hardware model — and `floor_s` bounds
    it below so host segments (unpriceable) and first-use costs never
    false-positive.  A CUDA kernel built at first use inside a pooled
    round can take longer than the floor: build the kernels
    (``kernels._build.build_all``) before the pool exists."""
    mult: float = 50.0
    floor_s: float = 5.0
    poll_s: float = 0.05

    def __post_init__(self):
        if self.mult <= 0 or self.floor_s <= 0 or self.poll_s <= 0:
            raise ValueError("watchdog mult/floor_s/poll_s must be > 0")


# ----------------------------------------------------------------------
# futures
# ----------------------------------------------------------------------
class PoolFuture:
    """Handle to one submitted request.  ``wait()`` blocks until the
    scheduler finishes the request (in any order relative to other
    futures — waits may be out of submission order) and returns the
    program outputs; request-local stats ride on the future, never on
    shared CompiledProgram state.  Errors propagate: a worker exception
    or slot death raises here (annotated with the request id), it never
    strands the waiter."""

    def __init__(self, slot_id: int, seq: int):
        self.slot_id = slot_id          # which pool slot serves it
        #                                 (re-homed if the request retries)
        self.seq = seq                  # global submission order
        self.stats: List[RunStats] = []  # per accel segment, this request
        self.staging_bytes = 0
        self.attempts = 1               # submissions tried (retries + 1)
        self.done_at: Optional[float] = None  # perf_counter at completion
        self._done = threading.Event()
        self._outputs: Any = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None
             ) -> Union[np.ndarray, Dict[str, np.ndarray]]:
        if not self._done.wait(timeout):
            raise WaitTimeout(
                f"request #{self.seq} (slot {self.slot_id}) not done "
                f"within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._outputs

    result = wait

    # scheduler side; first outcome wins — a request can be failed by
    # kill_slot while its last gang is still retiring, and the late
    # result must not overwrite the death notice (or vice versa)
    def _finish(self, outputs: Any) -> bool:
        if self._done.is_set():
            return False
        self._outputs = outputs
        self.done_at = time.perf_counter()
        self._done.set()
        return True

    def _fail(self, exc: BaseException) -> bool:
        if self._done.is_set():
            return False
        if hasattr(exc, "add_note"):             # 3.11+: carry the id
            try:
                exc.add_note(f"[pool request #{self.seq} on slot "
                             f"{self.slot_id}]")
            except TypeError:                    # pragma: no cover
                pass
        self._exc = exc
        self.done_at = time.perf_counter()
        self._done.set()
        return True


@dataclass
class SlotStats:
    """Cumulative serving counters of one pool slot (touched only by the
    scheduler thread — per-slot by construction, so concurrent requests
    cannot cross-contaminate them)."""
    calls: int = 0
    staging_bytes: int = 0
    accel_steps: int = 0
    cpu_steps: int = 0
    ganged_steps: int = 0           # accel steps executed in a gang > 1
    max_gang: int = 0               # widest gang this slot took part in
    queue_hiwater: int = 0          # deepest the slot's submit queue got
    tiles_resolved: int = 0
    tile_batches: int = 0
    # persistent-state serving: resident-session swaps performed on this
    # slot, and the high-water of persistent bytes this slot has held
    # for its sessions (resident + swapped-out store)
    session_swaps: int = 0
    persist_hiwater: int = 0
    # self-healing: kill_slot/watchdog/integrity events on this slot
    deaths: int = 0                 # times this slot was declared dead
    respawns: int = 0               # times it was rebuilt from pristine
    watchdog_kills: int = 0         # deaths caused by the watchdog
    integrity_restages: int = 0     # corrupted regions repaired


@dataclass
class SessionStats:
    """Recovery counters of one session (scheduler/kill paths only).
    ``restored_from_step`` makes replayed decode steps VISIBLE: after a
    restore the caller must re-drive steps restored_from_step..lost-1 —
    silent replay would double-advance external state."""
    checkpoints: int = 0            # snapshots taken
    checkpoint_step: int = -1       # calls-count the last snapshot holds
    restores: int = 0               # times state was restored after death
    restored_from_step: Optional[int] = None  # step the last restore hit
    rehomes: int = 0                # moved to a new slot (old one stayed
    #                                 dead past the respawn cap)


@dataclass
class _Slot:
    id: int
    device: Any
    stats: SlotStats = field(default_factory=SlotStats)
    queue: List["_Request"] = field(default_factory=list)
    active: Optional["_Request"] = None
    dead: bool = False
    # per-program residency: prog key -> sid of the session whose
    # persistent state is materialized in this slot's DRAM (absent:
    # virgin init state / slot-resident mode).  Co-staged programs have
    # disjoint persistent addresses, so their residents never collide.
    resident: Dict[int, int] = field(default_factory=dict)
    # serializes session swap-in/swap-out against kill/respawn: a swap
    # holds it for the whole read-modify-write, kill_slot's respawn
    # acquires it before yanking the device — no half-swapped sessions.
    # Lock order: pool._lock may be held when taking swap_lock, never
    # the reverse.
    swap_lock: threading.Lock = field(default_factory=threading.Lock)
    # integrity: last recorded post-call checksum of each program's
    # persistent regions (prog key -> crc), when the pool records them
    persist_crc: Dict[int, int] = field(default_factory=dict)

    @property
    def load(self) -> int:
        return len(self.queue) + (1 if self.active is not None else 0)


@dataclass
class _SessionState:
    """Pool-internal record of one session: its program, sticky slot
    and, when NOT resident there, the swapped-out raw persistent
    image.  `ckpt` is the periodic host-memory snapshot the recovery
    path restores from when the slot dies with the state resident."""
    sid: int
    slot_id: int
    prog: CompiledProgram
    image: Optional[Dict[str, np.ndarray]] = None
    calls: int = 0
    ckpt: Optional[Dict[str, np.ndarray]] = None
    ckpt_step: int = -1
    lost: bool = False              # died resident with no checkpoint
    stats: SessionStats = field(default_factory=SessionStats)


@dataclass
class _Request:
    future: PoolFuture
    inputs: Dict[str, np.ndarray]
    prog: CompiledProgram
    step_idx: int = -1              # -1: inputs not yet staged
    session: Optional[_SessionState] = None
    retired: bool = False           # future resolved + inflight released
    # stateless-retry bookkeeping: original inputs kept for restaging
    # (only when the pool retries), first typed error to surface on
    # exhaustion, and submissions tried so far
    saved_inputs: Optional[Dict[str, np.ndarray]] = None
    first_error: Optional[BaseException] = None
    attempts: int = 1


class Session:
    """Handle to one persistent-state serving session on a DevicePool.

        sess = pool.session()
        for tok in prompt:
            y = sess.submit(x=tok).wait()    # state advances in DRAM

    Submits are sticky to one slot and run in submission order there;
    sessions sharing a slot are transparently swapped by the scheduler.
    ``state()``/``reset()`` inspect or rewind the session — call them
    only while the session has no in-flight requests (``pool.drain()``)."""

    def __init__(self, pool: "DevicePool", state: _SessionState):
        self.pool = pool
        self._state = state

    @property
    def sid(self) -> int:
        return self._state.sid

    @property
    def slot_id(self) -> int:
        return self._state.slot_id

    @property
    def calls(self) -> int:
        return self._state.calls

    @property
    def stats(self) -> SessionStats:
        """Recovery counters — ``restored_from_step`` is not None iff
        the session came back from a checkpoint after its slot died, in
        which case the caller must replay steps from there."""
        return self._state.stats

    def submit(self, **inputs: np.ndarray) -> PoolFuture:
        return self.pool._enqueue(inputs, session=self._state,
                                  prog=self._state.prog)

    def state(self, name: str) -> np.ndarray:
        """Logical value of one persistent buffer as this session sees it
        (resident slot DRAM, swapped-out image, or the init image if the
        session never ran)."""
        return self.pool._session_state(self._state, name)

    def reset(self) -> None:
        """Rewind to the compile-time init images (a fresh dialogue on
        the same session handle)."""
        self.pool._session_reset(self._state)


# ----------------------------------------------------------------------
# the pool
# ----------------------------------------------------------------------
class DevicePool:
    """N cloned pre-staged devices serving one CompiledProgram — or a
    co-staged mix of them — through an async submit()/wait() API.

    Parameters
    ----------
    compiled: the staged artifact (``prestage=True`` recommended —
        trimmed slot clones cannot allocate DRAM), or a SEQUENCE of
        artifacts produced by ``program.compile_multi``: they share one
        device image at disjoint DRAM ranges, and the pool serves the
        whole mix.  ``submit()`` targets the first program;
        ``submit_to(program, ...)`` targets any of them.  Only
        same-program same-segment requests gang.
    size: number of device slots.
    backend: engine every request runs on ("cuda" gangs lockstep
        requests; "simulator" is the serial oracle).  One engine
        instance is shared by the whole pool so its decode cache warms
        once.
    policy: "round_robin" assigns submits to slots cyclically;
        "least_loaded" picks the slot with the fewest queued + running
        requests (ties to the lowest slot id).
    trim: clone only the allocated DRAM image per slot (MemoryError on
        any per-call allocation instead of silent growth).  Defaults to
        every program being prestaged — a restaging (prestage=False)
        program legitimately allocates its stream every call and needs
        the full address space.
    max_respawns: per-slot cap on automatic rebuilds after kill_slot /
        watchdog death (0: deaths are terminal, the pre-recovery
        behavior).  A respawned slot is a fresh ``clone(trim)`` of the
        pristine staged image; resident session state is restored from
        checkpoints (see ``checkpoint_every``).
    retries: bounded automatic re-submission of STATELESS requests
        failed by SlotDied/WatchdogTimeout (0: fail immediately).
        Exponential backoff from ``retry_backoff_s``; exhaustion raises
        the original error annotated with the attempt count.
    checkpoint_every: snapshot each session's persistent bytes to host
        memory every N completed calls (0: never).  The snapshot is what
        a dead slot's resident session restores from.
    integrity: verify constant-region CRCs before every gang (repairing
        from the pristine image) and record/verify persistent-region
        CRCs across stateful calls.
    watchdog: a :class:`WatchdogConfig` arms the segment watchdog —
        rounds that overrun their TimingModel-derived deadline get the
        offending slots killed instead of hanging ``wait()``.
    fault_plan: a seeded :class:`chaos.FaultPlan` applied at gang
        boundaries (kills, constant bit-flips, delays) — the chaos
        harness hook.
    """

    def __init__(self, compiled: Union[CompiledProgram,
                                       Sequence[CompiledProgram]],
                 size: int = 2,
                 backend: BackendLike = "cuda",
                 policy: str = "round_robin", timing: Any = None,
                 trim: Optional[bool] = None,
                 max_respawns: int = 0,
                 retries: int = 0,
                 retry_backoff_s: float = 0.05,
                 checkpoint_every: int = 0,
                 integrity: bool = False,
                 watchdog: Optional[WatchdogConfig] = None,
                 fault_plan: Optional[FaultPlan] = None):
        if size < 1:
            raise ValueError(f"pool size must be >= 1, got {size}")
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        if max_respawns < 0 or retries < 0 or checkpoint_every < 0:
            raise ValueError("max_respawns/retries/checkpoint_every "
                             "must be >= 0")
        if retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be >= 0")
        progs = (list(compiled)
                 if isinstance(compiled, (list, tuple)) else [compiled])
        if not progs:
            raise ValueError("DevicePool of zero programs")
        dev = progs[0].device
        for c in progs[1:]:
            if c.device is not dev:
                raise ValueError(
                    "multi-program pools require co-staged programs "
                    "(program.compile_multi) — these were compiled onto "
                    "different devices, their DRAM images cannot merge")
        if trim is None:
            trim = all(c.prestage for c in progs)
        self.programs: List[CompiledProgram] = progs
        self.compiled = progs[0]            # default-submit target
        self._prog_key = {id(c): i for i, c in enumerate(progs)}
        self.engine = resolve_backend(backend)
        self.policy = policy
        self.timing = timing
        self.max_respawns = max_respawns
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        self.checkpoint_every = checkpoint_every
        self.integrity = integrity
        self.watchdog = watchdog
        self.fault_plan = fault_plan
        self.fault_log: List[Dict[str, Any]] = []
        self._dev = dev                 # pristine staged image: the
        self._trim = trim               # respawn + restage source
        self.slots = [_Slot(id=i, device=dev.clone(trim=trim))
                      for i in range(size)]
        self._rr = itertools.cycle(range(size))
        self._seq = itertools.count()
        self._gang_seq = itertools.count()  # fault-plan clock
        self._sessions: Dict[int, _SessionState] = {}
        self._session_seq = itertools.count()
        self._session_rr = itertools.cycle(range(size))
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._inflight = 0
        self._idle = threading.Condition(self._lock)
        # stateless retries awaiting their backoff: (due_at, request)
        self._retries: List[Tuple[float, _Request]] = []
        # pristine constant-region checksums (identical for every slot
        # by construction — clones of one image)
        self._const_crc: List[Optional[int]] = [
            (c.integrity_checksum(device=dev)
             if integrity and c.integrity_regions() else None)
            for c in progs]
        # watchdog round state (written by the scheduler thread, read by
        # the watchdog thread; transitions re-checked under _lock)
        self._round_id = 0
        self._round_deadline: Optional[float] = None
        self._round_watch: set = set()      # slot ids still owing work
        self._round_had_host = False
        self._round_abandoned = -1          # last round the watchdog shot
        self._budget_cache: Dict[Tuple[int, int], float] = {}
        # persistent host worker: one long-lived thread consuming host
        # segment batches, so the hot serving path never pays per-round
        # thread creation
        self._host_q: "queue.Queue[Any]" = queue.Queue()
        self._host_thread = threading.Thread(
            target=self._run_host_worker, name="repro-pool-host",
            daemon=True)
        self._host_thread.start()
        self._scheduler = threading.Thread(
            target=self._run_scheduler, name="repro-pool-scheduler",
            daemon=True)
        self._scheduler.start()
        if watchdog is not None:
            self._watchdog_thread = threading.Thread(
                target=self._run_watchdog, name="repro-pool-watchdog",
                daemon=True)
            self._watchdog_thread.start()

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.slots)

    def __enter__(self) -> "DevicePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _resolve_prog(self, program: Union[None, int, CompiledProgram]
                      ) -> CompiledProgram:
        if program is None:
            return self.compiled
        if isinstance(program, int):
            return self.programs[program]
        if id(program) not in self._prog_key:
            raise ValueError("program was not staged on this pool "
                             "(co-stage it with program.compile_multi)")
        return program

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, **inputs: np.ndarray) -> PoolFuture:
        """Enqueue one request against the pool's first (default)
        program; returns immediately with a future.  Thread-safe: any
        thread may submit, waits may happen in any order.  Input arrays
        are validated here (fail fast, in the caller) and staged into
        the slot's DRAM by the scheduler.  For a program with persistent
        state, sessionless submits run in slot-resident mode (each slot
        IS one implicit session); use :meth:`session` for explicit,
        swappable sessions."""
        return self._enqueue(inputs, session=None, prog=self.compiled)

    def submit_to(self, program: Union[int, CompiledProgram],
                  **inputs: np.ndarray) -> PoolFuture:
        """Enqueue one request against a specific co-staged program
        (index into ``self.programs`` or the artifact itself)."""
        return self._enqueue(inputs, session=None,
                             prog=self._resolve_prog(program))

    def _pick_slot(self, session: Optional[_SessionState],
                   avoid: frozenset = frozenset()) -> _Slot:
        """Pick the serving slot (lock held).  Dead slots are skipped;
        a session stays pinned and raises if its slot died.  `avoid`
        lists slots already claimed by the same atomic batch — prefer
        spreading a batch over distinct slots (so it can gang), falling
        back to doubling up only when the batch outsizes the pool."""
        if session is not None:
            if session.lost:
                raise SlotDied(
                    f"session {session.sid}'s state was lost when slot "
                    f"{session.slot_id} died with no checkpoint to "
                    f"restore from (checkpoint_every=0?)")
            slot = self.slots[session.slot_id]   # sticky: state lives
            if slot.dead:                        # (or swaps) there
                raise SlotDied(f"session {session.sid}'s slot "
                               f"{slot.id} died")
            return slot
        alive = [s for s in self.slots if not s.dead]
        if not alive:
            raise PoolClosed("every pool slot is dead")
        if self.policy == "round_robin":
            for prefer_fresh in (True, False):
                for _ in range(len(self.slots)):
                    slot = self.slots[next(self._rr)]
                    if slot.dead:
                        continue
                    if prefer_fresh and slot.id in avoid:
                        continue
                    return slot
            raise PoolClosed("every pool slot is dead")  # pragma: no cover
        fresh = [s for s in alive if s.id not in avoid] or alive
        return min(fresh, key=lambda s: (s.load, s.id))

    def _enqueue(self, inputs: Dict[str, np.ndarray],
                 session: Optional[_SessionState],
                 prog: CompiledProgram) -> PoolFuture:
        return self._enqueue_batch([(inputs, session, prog)])[0]

    def submit_batch(self, program: Union[None, int, CompiledProgram],
                     requests: Sequence[Dict[str, np.ndarray]]
                     ) -> List[PoolFuture]:
        """Enqueue several requests of one program ATOMICALLY: the
        scheduler observes all of them at the same admission point, so
        on an idle pool they land on distinct slots in the same round
        and stay lockstep (a gang) for the whole program.  Sequential
        ``submit()`` calls race the scheduler's round loop and can
        stagger — this is the release primitive the admission window
        (``core.sched``) is built on."""
        prog = self._resolve_prog(program)
        return self._enqueue_batch([(dict(r), None, prog)
                                    for r in requests])

    def _enqueue_batch(self, items: Sequence[Tuple[Dict[str, np.ndarray],
                                                   Optional[_SessionState],
                                                   CompiledProgram]]
                       ) -> List[PoolFuture]:
        for inputs, _, prog in items:
            prog.check_inputs(inputs)
        futs: List[PoolFuture] = []
        with self._lock:
            if self._closed:
                raise PoolClosed("submit() on a closed DevicePool")
            # validate before enqueuing anything: a mid-batch failure
            # must not leave a half-admitted gang behind
            for _, session, _ in items:
                if session is not None:
                    if session.lost:
                        raise SlotDied(
                            f"session {session.sid}'s state was lost "
                            f"when slot {session.slot_id} died with no "
                            f"checkpoint to restore from")
                    if self.slots[session.slot_id].dead:
                        raise SlotDied(f"session {session.sid}'s slot "
                                       f"{session.slot_id} died")
            if all(s.dead for s in self.slots):
                raise PoolClosed("every pool slot is dead")
            used: set = set()
            for inputs, session, prog in items:
                slot = self._pick_slot(session, avoid=frozenset(used))
                used.add(slot.id)
                fut = PoolFuture(slot_id=slot.id, seq=next(self._seq))
                slot.queue.append(_Request(
                    future=fut, inputs=dict(inputs), prog=prog,
                    session=session,
                    # stateless retry needs the original inputs back for
                    # idempotent restaging on a fresh slot; slot-resident
                    # stateful submits never retry (a replay would
                    # double-advance the implicit per-slot state)
                    saved_inputs=(dict(inputs)
                                  if self.retries and session is None
                                  and not prog.persistent_ids
                                  else None)))
                slot.stats.queue_hiwater = max(slot.stats.queue_hiwater,
                                               len(slot.queue))
                self._inflight += 1
                futs.append(fut)
            self._wake.notify_all()
        return futs

    # ------------------------------------------------------------------
    # sessions (persistent-state serving)
    # ------------------------------------------------------------------
    def session(self, slot: Optional[int] = None,
                program: Union[None, int, CompiledProgram] = None
                ) -> Session:
        """Open a new session: an independent copy of one program's
        persistent state, pinned to one slot (round-robin by default).
        Same-slot sessions are swapped in and out of the slot's DRAM by
        the scheduler; same-step submits of different sessions still
        gang across slots."""
        prog = self._resolve_prog(program)
        with self._lock:
            if self._closed:
                raise PoolClosed("session() on a closed DevicePool")
            sid = next(self._session_seq)
            slot_id = slot if slot is not None else next(self._session_rr)
            if not 0 <= slot_id < len(self.slots):
                raise ValueError(f"slot {slot_id} out of range")
            if self.slots[slot_id].dead:
                raise SlotDied(f"slot {slot_id} is dead")
            st = _SessionState(sid=sid, slot_id=slot_id, prog=prog)
            self._sessions[sid] = st
        return Session(self, st)

    def _ensure_resident(self, slot: _Slot, req: _Request) -> None:
        """Make `req`'s session state resident in `slot` before the
        request stages.  Swaps are raw DRAM reads/writes at the stable
        persistent addresses — NEVER an allocation, so trimmed clones
        stay within the zero-alloc contract.  Residency is per program
        (disjoint address ranges under compile_multi).  Scheduler-thread
        only.

        The whole swap-out/swap-in runs under the slot's swap lock:
        ``kill_slot``'s respawn takes the same lock before yanking the
        device, so a kill landing mid-swap either waits for a COMPLETE
        swap (then recovers the now-resident session from its
        checkpoint) or finishes first (then this raises SlotDied before
        touching any byte) — a session can never end up half-swapped or
        marked resident on a device that does not hold its state."""
        sess = req.session
        if sess is None or not sess.prog.persistent_ids:
            return
        with slot.swap_lock:
            if slot.dead:
                raise SlotDied(f"session {sess.sid}'s slot {slot.id} "
                               f"died before its state could swap in")
            if sess.lost:
                raise SlotDied(
                    f"session {sess.sid}'s state was lost when its slot "
                    f"died with no checkpoint to restore from")
            key = self._prog_key[id(sess.prog)]
            if slot.resident.get(key) == sess.sid:
                return
            old_sid = slot.resident.get(key)
            if old_sid is not None:
                old = self._sessions.get(old_sid)
                if old is not None:
                    old.image = old.prog.persistent_image(
                        device=slot.device)
            if sess.image is not None:
                sess.prog.load_persistent_image(sess.image,
                                                device=slot.device)
                sess.image = None                  # resident now
            else:
                sess.prog.reset_persistent(device=slot.device)
            slot.resident[key] = sess.sid
            slot.persist_crc.pop(key, None)    # snapshot was the OLD
            slot.stats.session_swaps += 1      # resident's bytes
            held = sess.prog.persistent_bytes + sum(
                sum(a.nbytes for a in s.image.values())
                for s in self._sessions.values()
                if s.slot_id == slot.id and s.image is not None)
            slot.stats.persist_hiwater = max(slot.stats.persist_hiwater,
                                             held)

    def _session_state(self, st: _SessionState, name: str) -> np.ndarray:
        prog = st.prog
        key = self._prog_key[id(prog)]
        with self._lock:
            slot = self.slots[st.slot_id]
            if slot.resident.get(key) == st.sid:
                return prog.read_persistent(name, device=slot.device)
            nid = prog.input_ids[name]
            node = prog.nodes[nid]
            if st.image is None:                   # never ran
                return np.array(node.const)
            raw = st.image[name]
            blocked = raw.view(node.meta.np_dtype()).reshape(
                node.meta.blocked_shape(prog.spec))
            return node.meta.unpack(blocked, prog.spec)

    def _session_reset(self, st: _SessionState) -> None:
        key = self._prog_key[id(st.prog)]
        with self._lock:
            slot = self.slots[st.slot_id]
            if slot.resident.get(key) == st.sid:
                st.prog.reset_persistent(device=slot.device)
            else:
                st.image = None
            st.calls = 0

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted request has completed."""
        with self._lock:
            if not self._idle.wait_for(lambda: self._inflight == 0,
                                       timeout=timeout):
                raise TimeoutError("DevicePool.drain timed out")

    def kill_slot(self, slot_id: int) -> int:
        """Chaos/ops hook: declare one slot dead NOW.  The mid-flight
        request fails immediately with :class:`SlotDied` (the error
        names the request) — or, with ``retries`` enabled, re-submits
        to a surviving slot after backoff.  QUEUED stateless requests
        never touched the device, so they transplant to a surviving (or
        respawned) slot without burning a retry attempt; queued
        session-bound / implicit-state requests fail typed with their
        state.  The slot leaves the submit rotation and the scheduler
        discards any in-flight result it may still produce.  With ``max_respawns`` the slot is then rebuilt from
        the pristine staged image and rejoins the rotation; resident
        session state restores from checkpoints.  Returns the number of
        requests affected (failed or scheduled for retry).  The
        regression suite kills a slot mid-flight to prove waits raise
        instead of hanging."""
        with self._lock:
            slot = self.slots[slot_id]
            return self._kill_slot_locked(
                slot,
                lambda req: SlotDied(
                    f"request #{req.future.seq} lost: slot {slot_id} "
                    f"died mid-flight"))

    def _kill_slot_locked(self, slot: _Slot, exc_for,
                          watchdog: bool = False) -> int:
        """Shared death path (pool lock held): fail-or-retry every
        victim, recover the slot's sessions, then respawn under the cap
        (else re-home recoverable sessions to a survivor)."""
        if slot.dead:
            return 0
        slot.dead = True
        slot.stats.deaths += 1
        if watchdog:
            slot.stats.watchdog_kills += 1
        queued = list(slot.queue)
        slot.queue.clear()
        active = None
        if slot.active is not None and not slot.active.retired:
            active = slot.active
        slot.active = None
        # recover sessions and respawn FIRST so a rebuilt slot can take
        # transplanted queue entries back
        self._recover_sessions(slot)
        if self.max_respawns and slot.stats.respawns < self.max_respawns:
            self._respawn_locked(slot)
        else:
            self._rehome_sessions(slot)
        n = 0
        now = time.perf_counter()
        # the active request was mid-execution on the dead device: that
        # work is lost, so it burns a retry attempt (or fails typed)
        if active is not None:
            n += 1
            self._fail_or_retry(active, exc_for(active), now)
        # queued requests never touched the device — fully stateless
        # ones keep their place without consuming a retry attempt: on a
        # respawned slot the queue simply survives (balance preserved),
        # on a permanently dead slot they transplant to a survivor.
        # Session-bound and implicit-state requests stay on the death
        # path (their state lived here and may have rolled back)
        for req in queued:
            if req.retired:
                continue
            n += 1
            if req.session is None and not req.prog.persistent_ids:
                if not slot.dead:               # respawned
                    slot.queue.append(req)
                    continue
                try:
                    target = self._pick_slot(None)
                except PoolClosed:
                    self._fail_or_retry(req, exc_for(req), now)
                    continue
                req.future.slot_id = target.id
                target.queue.append(req)
                target.stats.queue_hiwater = max(
                    target.stats.queue_hiwater, len(target.queue))
            else:
                self._fail_or_retry(req, exc_for(req), now)
        self._idle.notify_all()
        self._wake.notify_all()
        return n

    def _fail_or_retry(self, req: _Request, exc: BaseException,
                       now: float) -> None:
        """Fail one victim — or park it for a backoff retry when it is
        stateless, retries remain, and the pool is still open (lock
        held).  Exhaustion surfaces the FIRST typed error, annotated
        with the attempt count."""
        if req.first_error is None:
            req.first_error = exc
        if (req.session is None and req.saved_inputs is not None
                and req.attempts <= self.retries and not self._closed):
            delay = self.retry_backoff_s * (2 ** (req.attempts - 1))
            req.attempts += 1
            req.future.attempts = req.attempts
            req.retired = False
            req.step_idx = -1               # restage from scratch
            req.inputs = dict(req.saved_inputs)
            self._retries.append((now + delay, req))
            return                          # _inflight stays claimed
        req.retired = True
        self._inflight -= 1
        err = req.first_error
        err.attempts = req.attempts         # first-class attempt count
        if req.attempts > 1 and hasattr(err, "add_note"):
            try:
                err.add_note(f"[failed after {req.attempts} attempts]")
            except TypeError:               # pragma: no cover
                pass
        req.future.attempts = req.attempts
        req.future._fail(err)

    def _promote_retries(self, now: float) -> None:
        """Move due retries onto surviving slots' queues (lock held;
        scheduler thread).  A closing pool promotes everything
        immediately — close() waits for in-flight work, and backoff
        would only delay the inevitable."""
        if not self._retries:
            return
        keep: List[Tuple[float, _Request]] = []
        for due, req in self._retries:
            if due > now and not self._closed:
                keep.append((due, req))
                continue
            try:
                slot = self._pick_slot(None)
            except PoolClosed:
                req.retired = True
                self._inflight -= 1
                err = req.first_error or PoolClosed(
                    f"request #{req.future.seq}: every slot died before "
                    f"its retry could run")
                err.attempts = req.attempts
                if hasattr(err, "add_note"):
                    try:
                        err.add_note(
                            f"[failed after {req.attempts} attempts]")
                    except TypeError:       # pragma: no cover
                        pass
                req.future.attempts = req.attempts
                req.future._fail(err)
                self._idle.notify_all()
                continue
            req.future.slot_id = slot.id    # re-home the handle
            slot.queue.append(req)
            slot.stats.queue_hiwater = max(slot.stats.queue_hiwater,
                                           len(slot.queue))
        self._retries = keep

    def _recover_sessions(self, slot: _Slot) -> None:
        """Death handling for the slot's sessions (lock held).  Swapped-
        out sessions keep their host-memory image untouched; RESIDENT
        sessions lose their live DRAM state with the slot and fall back
        to the last checkpoint (visible via ``restored_from_step``), to
        virgin init if they never ran, or are marked lost — a typed
        SlotDied at their next submit, never silently-wrong state."""
        for sess in self._sessions.values():
            if sess.slot_id != slot.id or sess.lost:
                continue
            key = self._prog_key[id(sess.prog)]
            if slot.resident.get(key) != sess.sid:
                continue                    # swapped out: image survives
            if sess.ckpt is not None:
                sess.image = {k: v.copy() for k, v in sess.ckpt.items()}
                sess.calls = sess.ckpt_step
                sess.stats.restores += 1
                sess.stats.restored_from_step = sess.ckpt_step
            elif sess.calls == 0:
                sess.image = None           # virgin: reinit on next use
            else:
                sess.lost = True
        slot.resident.clear()
        slot.persist_crc.clear()

    def _respawn_locked(self, slot: _Slot) -> None:
        """Rebuild a dead slot from the pristine staged image (lock
        held).  Takes the swap lock so an in-flight session swap fully
        completes on the old device before it is replaced."""
        with slot.swap_lock:
            slot.device = self._dev.clone(trim=self._trim)
            slot.active = None
            slot.dead = False
            slot.stats.respawns += 1

    def _rehome_sessions(self, slot: _Slot) -> None:
        """The slot stayed dead (respawn cap exhausted): move its
        recoverable sessions to the least-loaded survivor so their
        checkpoint/image state keeps serving (lock held)."""
        alive = [s for s in self.slots if not s.dead]
        if not alive:
            return
        for sess in self._sessions.values():
            if sess.slot_id != slot.id or sess.lost:
                continue
            target = min(alive, key=lambda s: (s.load, s.id))
            sess.slot_id = target.id
            sess.stats.rehomes += 1

    def respawn_slot(self, slot_id: int) -> bool:
        """Ops hook: explicitly rebuild a dead slot from the pristine
        image, ignoring the automatic ``max_respawns`` cap (an operator
        deciding to revive is not a crash loop).  Returns True if the
        slot was dead and came back."""
        with self._lock:
            slot = self.slots[slot_id]
            if not slot.dead:
                return False
            self._respawn_locked(slot)
            self._wake.notify_all()
            return True

    # ------------------------------------------------------------------
    # segment watchdog
    # ------------------------------------------------------------------
    def _accel_step_seconds(self, prog: CompiledProgram, pk: int,
                            idx: int) -> float:
        """Predicted wall seconds of one accelerator segment: decode the
        stream, replay it on the TimingModel, convert cycles at the
        PROGRAM's spec frequency — replayed cycles are in the spec's
        clock domain, so any other rate is off by the frequency ratio
        (a re-fitted/calibrated spec would get spuriously tight or
        never-firing deadlines).  The engines' host-bound slowdown is what
        ``WatchdogConfig.mult``/``floor_s`` pad for.  Cached per
        (program, step): decode + replay run once per pool lifetime."""
        key = (pk, idx)
        got = self._budget_cache.get(key)
        if got is not None:
            return got
        step = prog.steps[idx]
        tm = (self.timing if isinstance(self.timing, TimingModel)
              else TimingModel(prog.spec))
        insns = IsaLayout(prog.spec).decode_stream(
            np.ascontiguousarray(step.stream))
        cycles = replay_timing(prog.spec, insns, tm).total_cycles
        sec = cycles / (prog.spec.freq_mhz * 1e6)
        self._budget_cache[key] = sec
        return sec

    def _run_watchdog(self) -> None:
        """Watchdog thread: when a scheduler round overruns its
        TimingModel-derived deadline, kill every slot still owing work
        (failing or retrying its requests and respawning under the cap)
        and — if the round had host segments — replace the host worker,
        whose thread may be wedged inside a user host fn.  Waiters get
        typed :class:`WatchdogTimeout` errors; nothing hangs."""
        cfg = self.watchdog
        while True:
            time.sleep(cfg.poll_s)
            with self._lock:
                if self._closed and self._inflight == 0:
                    return
                deadline = self._round_deadline
                if deadline is None or time.perf_counter() < deadline:
                    continue
                rid = self._round_id
                self._round_deadline = None
                self._round_abandoned = rid
                stuck = [self.slots[i] for i in set(self._round_watch)]
                for slot in stuck:
                    self._kill_slot_locked(
                        slot,
                        lambda req, _sid=slot.id: WatchdogTimeout(
                            f"request #{req.future.seq}: segment "
                            f"watchdog deadline exceeded on slot "
                            f"{_sid}; slot killed"),
                        watchdog=True)
                if self._round_had_host:
                    # the old worker may be wedged inside a host fn:
                    # orphan it (daemon) and start a fresh one
                    self._host_q = queue.Queue()
                    self._host_thread = threading.Thread(
                        target=self._run_host_worker,
                        name="repro-pool-host", daemon=True)
                    self._host_thread.start()

    # ------------------------------------------------------------------
    # DRAM integrity
    # ------------------------------------------------------------------
    def verify_integrity(self, slot_id: Optional[int] = None,
                         repair: bool = True) -> List[str]:
        """Audit the constant and persistent DRAM regions of every (or
        one) alive slot against their recorded CRC32 checksums.  With
        ``repair`` (the default) corrupted constants restage from the
        pristine image and a corrupted resident session restores from
        its last checkpoint — or is marked lost, failing typed at its
        next submit, never computing on silently-wrong state.  With
        ``repair=False`` a non-empty audit raises
        :class:`IntegrityError`.  Returns the findings (empty = clean).
        Requires the pool to have been built with ``integrity=True``
        (otherwise there are no recorded checksums and the audit is
        vacuous)."""
        findings: List[str] = []
        with self._lock:
            slots = ([self.slots[slot_id]] if slot_id is not None
                     else self.slots)
            for slot in slots:
                if slot.dead:
                    continue
                with slot.swap_lock:
                    for pk, prog in enumerate(self.programs):
                        want = self._const_crc[pk]
                        if want is not None and prog.integrity_checksum(
                                device=slot.device) != want:
                            findings.append(
                                f"slot{slot.id}/prog{pk}: constant "
                                f"region checksum mismatch")
                            if repair:
                                prog.restage_constants(
                                    slot.device, pristine=self._dev)
                                slot.stats.integrity_restages += 1
                        rec = slot.persist_crc.get(pk)
                        if rec is not None and prog.persistent_ids and \
                                prog.integrity_checksum(
                                    device=slot.device,
                                    persistent=True) != rec:
                            findings.append(
                                f"slot{slot.id}/prog{pk}: persistent "
                                f"region checksum mismatch")
                            if repair:
                                self._repair_persistent(slot, pk, prog)
        if findings and not repair:
            raise IntegrityError("; ".join(findings))
        return findings

    def _repair_persistent(self, slot: _Slot, pk: int,
                           prog: CompiledProgram) -> None:
        """Corrupted persistent bytes (lock + swap lock held): restore
        the resident session from its checkpoint, mark it lost if it has
        none, or — slot-resident mode, no session — reset to the
        program's initial state."""
        slot.persist_crc.pop(pk, None)
        sid = slot.resident.get(pk)
        sess = self._sessions.get(sid) if sid is not None else None
        if sess is not None:
            slot.resident.pop(pk, None)
            if sess.ckpt is not None:
                sess.image = {k: v.copy() for k, v in sess.ckpt.items()}
                sess.calls = sess.ckpt_step
                sess.stats.restores += 1
                sess.stats.restored_from_step = sess.ckpt_step
            else:
                sess.lost = True
        else:
            prog.reset_persistent(device=slot.device)

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Reject new submits, let in-flight requests finish, stop the
        scheduler and host-worker threads.  If the scheduler fails to
        drain within `timeout` (a wedged host fn or kernel), every
        still-pending future is FAILED with PoolClosed so no waiter
        blocks forever on a pool that will never answer."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._wake.notify_all()
        self._scheduler.join(timeout)
        if self._scheduler.is_alive():
            err = PoolClosed(
                f"DevicePool.close: scheduler did not drain within "
                f"{timeout}s; failing all pending futures")
            with self._lock:
                for slot in self.slots:
                    pending = list(slot.queue)
                    slot.queue.clear()
                    if slot.active is not None:
                        pending.append(slot.active)
                    for req in pending:
                        if not req.future.done():
                            req.future._fail(err)
                for _, req in self._retries:
                    if not req.future.done():
                        req.future._fail(req.first_error or err)
                self._retries.clear()
        self._host_q.put(None)                  # stop the host worker
        self._host_thread.join(timeout)

    # ------------------------------------------------------------------
    # the worker-scheduler
    # ------------------------------------------------------------------
    def _run_host_worker(self) -> None:
        """Long-lived host-segment executor: the scheduler hands it the
        round's CpuStep batch, then runs the accelerator gangs while the
        host fns execute here — one request's host work overlaps other
        requests' accelerator work (the GIL drops inside the gangs' XLA
        kernels).  ``done.set()`` is unconditional: a raising host fn
        must never leave the scheduler waiting on the round."""
        while True:
            item = self._host_q.get()
            if item is None:
                return
            jobs, host_errs, done = item
            try:
                for slot, device, req, step_idx in jobs:
                    try:
                        if req.retired or req.step_idx != step_idx:
                            continue              # killed/retried
                        step = req.prog.steps[step_idx]
                        try:
                            req.prog.exec_step(step, device, self.engine,
                                               timing=self.timing)
                            slot.stats.cpu_steps += 1
                        except BaseException as e:
                            host_errs[slot.id] = e
                    finally:
                        if self.watchdog is not None:
                            self._round_watch.discard(slot.id)
            finally:
                done.set()

    def _run_scheduler(self) -> None:
        try:
            self._scheduler_loop()
        except BaseException as e:
            # nothing may escape the loop silently: a dead scheduler
            # thread would strand every current AND future waiter, so
            # fail everything in flight loudly before the thread exits
            with self._lock:
                for slot in self.slots:
                    victims = list(slot.queue)
                    slot.queue.clear()
                    if slot.active is not None:
                        victims.append(slot.active)
                        slot.active = None
                    for req in victims:
                        if req.retired:
                            continue
                        req.retired = True
                        self._inflight -= 1
                        req.future._fail(PoolClosed(
                            f"request #{req.future.seq} lost: pool "
                            f"scheduler died: {e!r}"))
                for _, req in self._retries:
                    if not req.retired:
                        req.retired = True
                        self._inflight -= 1
                        req.future._fail(req.first_error or PoolClosed(
                            f"request #{req.future.seq} lost: pool "
                            f"scheduler died: {e!r}"))
                self._retries.clear()
                self._idle.notify_all()
            raise

    def _scheduler_loop(self) -> None:
        while True:
            with self._lock:
                active: List[_Slot] = []
                while True:
                    now = time.perf_counter()
                    self._promote_retries(now)
                    if self._closed and self._inflight == 0:
                        return
                    # admit queued requests to their slots (dead slots
                    # are drained by kill_slot, never admitted)
                    for slot in self.slots:
                        if slot.dead:
                            continue
                        if slot.active is None and slot.queue:
                            slot.active = slot.queue.pop(0)
                    active = [s for s in self.slots
                              if s.active is not None and not s.dead]
                    if active:
                        break
                    if (self._inflight > 0 and not self._retries
                            and not any(s.active or s.queue
                                        for s in self.slots)):
                        # inflight counter leaked (should be impossible)
                        self._inflight = 0
                        self._idle.notify_all()
                    # idle until new work, close, or the earliest retry
                    # backoff comes due
                    timeout = None
                    if self._retries:
                        timeout = max(0.0, min(due for due, _
                                               in self._retries) - now)
                    self._wake.wait(timeout=timeout)
            try:
                self._advance(active)
            except BaseException as e:          # defensive: fail loudly
                for slot in active:
                    if slot.active is not None:
                        self._retire(slot, error=e)

    def _advance(self, active: List[_Slot]) -> None:
        """One scheduler round: stage fresh requests, overlap host
        segments with accelerator segments, gang same-program
        same-segment requests, then retire finished ones."""
        # stage inputs of freshly admitted requests (swapping the slot's
        # resident session state first when the request belongs to a
        # different session than the last one served here).  step_idx is
        # COMMITTED under the pool lock only while the request still owns
        # the slot: a kill landing mid-staging retried/failed it already,
        # and its bytes went to a device the pool no longer serves from.
        for slot in active:
            req = slot.active
            if req is None or req.retired:
                continue
            if req.step_idx < 0:
                with self._lock:
                    if slot.dead or slot.active is not req or req.retired:
                        continue
                    device = slot.device
                try:
                    self._ensure_resident(slot, req)
                    staged = req.prog.stage_inputs(req.inputs,
                                                   device=device)
                except BaseException as e:
                    self._retire(slot, error=e)
                    continue
                with self._lock:
                    if slot.active is not req or req.retired:
                        continue          # killed/retried mid-staging
                    req.future.staging_bytes = staged
                    slot.stats.staging_bytes += staged
                    req.inputs = {}
                    req.step_idx = 0

        # split this round's work: host segments first (dispatched to a
        # worker thread so they overlap the accel gangs below — the GIL
        # drops while the gang's kernels run inside XLA)
        def step_of(s: _Slot):
            req = s.active
            if req is None or req.retired or req.step_idx < 0 or \
                    req.step_idx >= len(req.prog.steps):
                return None
            return req.prog.steps[req.step_idx]

        # accelerator work grouped up front: SAME-PROGRAM same-step
        # requests gang (streams must be identical for lockstep
        # execution; different programs never gang)
        host_slots: List[_Slot] = []
        by_key: Dict[Tuple[int, int], Tuple[CompiledProgram,
                                            List[_Slot]]] = {}
        for slot in active:
            st = step_of(slot)
            if isinstance(st, CpuStep):
                host_slots.append(slot)
            elif isinstance(st, AccelStep):
                req = slot.active
                key = (self._prog_key[id(req.prog)], req.step_idx)
                by_key.setdefault(key, (req.prog, []))[1].append(slot)

        # arm the segment watchdog: the round's budget sums the
        # TimingModel-predicted wall time of its DISTINCT accel segments
        # (a gang runs lockstep — one prediction covers it), padded by a
        # generous multiplier + floor so the slowest legitimate gang
        # never trips it
        rid = 0
        if self.watchdog is not None:
            budget = self.watchdog.floor_s
            for (pk, idx), (prog, _) in by_key.items():
                budget += self.watchdog.mult * \
                    self._accel_step_seconds(prog, pk, idx)
            with self._lock:
                self._round_id += 1
                rid = self._round_id
                self._round_watch = {s.id for s in host_slots} | {
                    s.id for _, grp in by_key.values() for s in grp}
                self._round_had_host = bool(host_slots)
                self._round_deadline = time.perf_counter() + budget

        host_errs: Dict[int, BaseException] = {}
        host_done: Optional[threading.Event] = None
        host_thread = self._host_thread   # watchdog may replace it
        if host_slots:
            host_done = threading.Event()
            with self._lock:
                # capture (device, step) per job NOW: a retried request
                # resets step_idx, a respawned slot replaces its device —
                # the worker must never chase either
                jobs = [(s, s.device, s.active, s.active.step_idx)
                        for s in host_slots
                        if not s.dead and s.active is not None
                        and not s.active.retired]
                if self.watchdog is not None:
                    self._round_watch.difference_update(
                        s.id for s in host_slots
                        if s.id not in {j[0].id for j in jobs})
            self._host_q.put((jobs, host_errs, host_done))

        accel_errs: Dict[int, BaseException] = {}
        try:
            for (_, idx), (prog, group) in by_key.items():
                try:
                    self._exec_accel(prog, prog.steps[idx], group)
                except BaseException as e:
                    # fail ONLY the gang that raised; other requests in
                    # this round proceed untouched
                    for slot in group:
                        accel_errs[slot.id] = e
                finally:
                    if self.watchdog is not None:
                        self._round_watch.difference_update(
                            s.id for s in group)
        finally:
            if host_done is not None:
                # a dead host worker must fail the round's host
                # requests, not deadlock the whole pool; a watchdog
                # abandonment already failed/retried them
                poll = 0.05 if self.watchdog is not None else 1.0
                while not host_done.wait(poll):
                    if self.watchdog is not None and \
                            self._round_abandoned >= rid:
                        break
                    if not host_thread.is_alive():
                        dead = PoolClosed(
                            "pool host worker died mid-round")
                        for slot in host_slots:
                            host_errs.setdefault(slot.id, dead)
                        break
            if self.watchdog is not None:
                with self._lock:
                    if self._round_id == rid:
                        self._round_deadline = None

        # advance + retire
        for slot in list(active):
            req = slot.active
            if req is None:
                continue
            if req.retired:                      # killed mid-round
                slot.active = None
                continue
            if req.step_idx < 0:                 # staging never landed
                continue
            err = host_errs.get(slot.id) or accel_errs.get(slot.id)
            if err is not None:
                self._retire(slot, error=err)
                continue
            req.step_idx += 1
            if req.step_idx >= len(req.prog.steps):
                self._retire(slot)

    def _exec_accel(self, prog: CompiledProgram, step: AccelStep,
                    group: List[_Slot]) -> None:
        """Run one accelerator segment for every slot in `group` — as a
        lockstep gang when the engine supports it (identical pre-staged
        stream on every slot), serially otherwise.  This is the pool's
        gang clock: scripted chaos faults fire here, integrity checks
        run before the gang touches DRAM, and the executing set is
        filtered + device-captured under the pool lock so a slot killed
        or respawned mid-round is never scribbled on."""
        gang_idx = next(self._gang_seq)
        if self.fault_plan is not None:
            self._apply_faults(gang_idx, prog, group)
        if self.integrity:
            self._check_constants(prog, group)
        with self._lock:
            trios = [(s, s.device, s.active) for s in group
                     if not s.dead and s.active is not None
                     and not s.active.retired]
        if not trios:
            return
        gang = getattr(self.engine, "execute_gang", None)
        prestaged = prog.prestage and step.staged_addr >= 0
        if gang is not None and len(trios) > 1 and prestaged:
            statss = gang(prog.spec, [d for _, d, _ in trios],
                          step.stream, timing=self.timing,
                          staged_addr=step.staged_addr)
            for (slot, _, req), stats in zip(trios, statss):
                stats.n_join_barriers = step.n_barriers
                stats.n_buffer_fences = step.n_fences
                stats.staging_bytes_per_call = req.future.staging_bytes
                req.future.stats.append(stats)
                slot.stats.accel_steps += 1
                slot.stats.ganged_steps += 1
                slot.stats.max_gang = max(slot.stats.max_gang, len(trios))
                slot.stats.tiles_resolved += stats.tiles_resolved
                slot.stats.tile_batches += stats.tile_batches
            return
        for slot, device, req in trios:
            stats = prog.exec_step(step, device, self.engine,
                                   timing=self.timing)
            stats.staging_bytes_per_call = req.future.staging_bytes
            req.future.stats.append(stats)
            slot.stats.accel_steps += 1
            slot.stats.max_gang = max(slot.stats.max_gang, 1)
            slot.stats.tiles_resolved += stats.tiles_resolved
            slot.stats.tile_batches += stats.tile_batches

    def _apply_faults(self, gang_idx: int, prog: CompiledProgram,
                      group: List[_Slot]) -> None:
        """Fire every scripted fault scheduled for this gang execution
        and log what actually happened (losses are accounted, never
        silent)."""
        for f in self.fault_plan.take(gang_idx):
            entry: Dict[str, Any] = {"kind": f.kind, "gang": gang_idx,
                                     "slot": f.slot}
            if f.kind == "delay":
                entry["delay_s"] = f.delay_s
                time.sleep(f.delay_s)
            elif f.kind == "kill":
                target = (f.slot if f.slot is not None
                          and 0 <= f.slot < len(self.slots)
                          else group[0].id)
                entry["slot"] = target
                entry["failed_or_retried"] = self.kill_slot(target)
            elif f.kind == "flip":
                slot = (self.slots[f.slot] if f.slot is not None
                        and 0 <= f.slot < len(self.slots) else group[0])
                if slot.dead:
                    slot = group[0]
                entry["slot"] = slot.id
                regions = prog.integrity_regions()
                total = sum(nb for _, _, nb in regions)
                if total == 0 or slot.dead:
                    entry["skipped"] = ("no constant regions"
                                        if total == 0 else "slot dead")
                else:
                    off = f.byte % total
                    for _, addr, nb in regions:
                        if off < nb:
                            # in the slot's DRAM tensor itself (on the
                            # card for a cuda image): no host mirror
                            slot.device.dram.mem[addr + off] ^= 0x55
                            slot.device.flush_cache(addr + off, 1)
                            entry["addr"] = int(addr + off)
                            break
                        off -= nb
            self.fault_log.append(entry)
            self.fault_plan.fired.append(entry)

    def _check_constants(self, prog: CompiledProgram,
                         group: List[_Slot]) -> None:
        """Pre-gang audit: constant regions of every executing slot must
        match the pristine image's checksum; a mismatch (bit-rot, DMA
        scribble, injected flip) restages the constants from the
        pristine device before the gang reads them."""
        want = self._const_crc[self._prog_key[id(prog)]]
        if want is None:
            return
        for slot in group:
            if slot.dead:
                continue
            if prog.integrity_checksum(device=slot.device) != want:
                prog.restage_constants(slot.device, pristine=self._dev)
                slot.stats.integrity_restages += 1

    def _retire(self, slot: _Slot, error: Optional[BaseException] = None
                ) -> None:
        req = slot.active
        with self._lock:
            slot.active = None
            if req is None or req.retired:
                return                          # killed while executing
            req.retired = True
        if error is not None:
            req.future._fail(error)
        else:
            try:
                outs = req.prog.read_outputs(device=slot.device)
                slot.stats.calls += 1
                # checkpoint BEFORE resolving the future: once wait()
                # returns under checkpoint_every=1 the call is durable —
                # a kill racing the caller can only roll back to it,
                # never behind it
                if req.session is not None:
                    sess = req.session
                    sess.calls += 1
                    if (self.checkpoint_every
                            and sess.calls % self.checkpoint_every == 0):
                        self._checkpoint(slot, sess)
                if self.integrity and req.prog.persistent_ids:
                    # record the post-call persistent snapshot so later
                    # audits can tell corruption from legitimate updates
                    slot.persist_crc[self._prog_key[id(req.prog)]] = \
                        req.prog.integrity_checksum(device=slot.device,
                                                    persistent=True)
                req.future._finish(outs)
            except BaseException as e:
                req.future._fail(e)
        with self._lock:
            self._inflight -= 1
            self._idle.notify_all()

    def _checkpoint(self, slot: _Slot, sess: _SessionState) -> None:
        """Snapshot the session's persistent bytes to host memory (the
        restore source when its slot dies).  Under the swap lock so the
        snapshot can never interleave with a swap or respawn."""
        with slot.swap_lock:
            if slot.dead:
                return
            key = self._prog_key[id(sess.prog)]
            if slot.resident.get(key) != sess.sid:
                return                       # swapped out: image IS the
            sess.ckpt = sess.prog.persistent_image(   # state already
                device=slot.device)
            sess.ckpt_step = sess.calls
            sess.stats.checkpoints += 1
            sess.stats.checkpoint_step = sess.calls

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def slot_stats(self) -> List[SlotStats]:
        return [s.stats for s in self.slots]

    def describe(self) -> str:
        """``CompiledProgram.describe()`` of every staged program
        (per-device invariants hold per slot) plus one serving line per
        slot, including live queue depth."""
        lines = [c.describe() for c in self.programs]
        lines.append(f"pool[{len(self.slots)} slots, {self.engine.name}, "
                     f"{self.policy}, {len(self.programs)} program(s)]")
        stateful = any(c.persistent_ids for c in self.programs)
        for s in self.slots:
            st = s.stats
            line = (
                f"  slot{s.id}: {st.calls} calls, {st.staging_bytes}B "
                f"staged, {st.accel_steps} accel steps "
                f"({st.ganged_steps} ganged, max gang {st.max_gang}), "
                f"{st.cpu_steps} host steps, "
                f"{st.tiles_resolved} tiles / {st.tile_batches} launches, "
                f"q{len(s.queue)} (hiwater {st.queue_hiwater})")
            if s.dead:
                line += " [DEAD]"
            if st.deaths:
                line += (f", {st.deaths} death(s)/"
                         f"{st.respawns} respawn(s)")
            if st.watchdog_kills:
                line += f", {st.watchdog_kills} watchdog kill(s)"
            if st.integrity_restages:
                line += f", {st.integrity_restages} integrity restage(s)"
            if stateful:
                homed = [x for x in self._sessions.values()
                         if x.slot_id == s.id]
                res = ",".join(f"sid{sid}" for sid in s.resident.values()) \
                    or "-"
                line += (f", {len(homed)} sessions ({res} resident, "
                         f"{st.session_swaps} swaps, "
                         f"{st.persist_hiwater}B hiwater)")
                restores = sum(x.stats.restores for x in homed)
                rehomes = sum(x.stats.rehomes for x in homed)
                lost = sum(1 for x in homed if x.lost)
                if restores or rehomes or lost:
                    line += (f", {restores} restore(s)/"
                             f"{rehomes} rehome(s)/{lost} lost")
            lines.append(line)
        return "\n".join(lines)


# ----------------------------------------------------------------------
# batch serving
# ----------------------------------------------------------------------
class BatchServer:
    """Shards a batch of requests across a DevicePool and gathers the
    results in submission order.

        server = BatchServer(pool)
        outs = server([{"x": x0}, {"x": x1}, ...])   # outs[i] <-> req i

    Construction can also own the pool: ``BatchServer.build(compiled,
    size=4, policy="least_loaded")``."""

    def __init__(self, pool: DevicePool):
        self.pool = pool

    @classmethod
    def build(cls, compiled: CompiledProgram, size: int = 2,
              **pool_kw) -> "BatchServer":
        return cls(DevicePool(compiled, size=size, **pool_kw))

    def __call__(self, requests: Sequence[Dict[str, np.ndarray]],
                 timeout: Optional[float] = None
                 ) -> List[Union[np.ndarray, Dict[str, np.ndarray]]]:
        futures = [self.pool.submit(**req) for req in requests]
        return [f.wait(timeout=timeout) for f in futures]

    def submit_all(self, requests: Sequence[Dict[str, np.ndarray]]
                   ) -> List[PoolFuture]:
        return [self.pool.submit(**req) for req in requests]

    def close(self) -> None:
        self.pool.close()

    def __enter__(self) -> "BatchServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_batch(compiled: CompiledProgram,
                requests: Sequence[Dict[str, np.ndarray]],
                size: int = 2, **pool_kw
                ) -> List[Union[np.ndarray, Dict[str, np.ndarray]]]:
    """One-shot convenience: pool up, shard `requests`, gather in order,
    tear down."""
    with BatchServer.build(compiled, size=size, **pool_kw) as server:
        return server(requests)
