"""Graph-to-stream compiler support: SRAM liveness, cross-op dependence
tokens, and stream segmentation.

The paper's JIT runtime lowers whole model graphs into task-ISA streams
(§3, Fig. 16) instead of synchronizing per op.  The pieces that make that
safe live here:

  * a **liveness pass** over scratchpad regions: each lowered op gets a
    :class:`~repro_torch.core.scheduler.SramPartition`; ops whose partitions are
    disjoint *and* that exchange no data through DRAM stay in flight
    together (their load/compute/store phases interleave in one stream);

  * **cross-op dependence tokens**: dependent ops — or ops forced to reuse
    scratchpad — are separated by a *buffer-granular fence*
    (``Runtime.buffer_fence``): only the consumer's loads of the produced
    buffer wait on the producer's final store, so the consumer's first
    weight tile DMAs while the producer's epilogue and store tail drain —
    dependent layers double-buffer across the op boundary.
    ``fence_mode="barrier"`` keeps the old full ``join_barrier``
    rendezvous as the A/B baseline.  Overlapping independent ops still get
    a ``drain_dep_tokens`` partial fence, because VTA tokens are
    information-less: a predecessor's unconsumed tokens would shift the
    successor's push/pop pairing one generation early and silently break
    its own WAR protocol;

  * **segmentation**: ``cpu_only`` graph nodes split the stream into
    accelerator segments with host steps between them — real heterogeneous
    execution, the Fig. 16 offload split executed rather than modelled.

Every fence and barrier is also a **DRAM liveness point**: all earlier
ops' loads are complete once it retires, so the program builder's arena
allocator (:class:`ArenaAllocator` below, driven by ``program._build``)
recycles dead intermediate buffers exactly at these placements —
``out_alloc(sync=True)``.

The arena serves *intermediates only*.  Buffers in the **persistent**
liveness class — graph inputs, program outputs, and
``Program.persistent()`` state that survives across calls (KV caches,
recurrent state) — are allocated once at stable addresses outside the
arena and are never recycled: a persistent buffer's bytes written by
call N must still be there when call N+1's stream reads them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Set, Tuple

import numpy as np

from .isa import COMPUTE_Q, LOAD_Q
from .runtime import Runtime
from .scheduler import SramPartition

FENCE_MODES = ("buffer", "barrier")


@dataclass(frozen=True)
class ImageRange:
    """The half-open DRAM span ``[lo, hi)`` one compiled program's staged
    image occupies: buffers, constants, arena, persistent state and
    pre-staged streams all land inside it.  Co-staged programs
    (``program.compile_multi``) compile against ONE shared device whose
    bump allocator hands each program a disjoint range — the property
    that lets a single pool slot hold a heterogeneous program mix in one
    resident image with every baked address still valid."""
    lo: int
    hi: int

    @property
    def nbytes(self) -> int:
        return self.hi - self.lo

    def overlaps(self, other: "ImageRange") -> bool:
        return self.lo < other.hi and other.lo < self.hi


@dataclass
class AccelStep:
    """One finalized accelerator segment: a single encoded task-ISA stream
    any execution backend can run.  ``staged_addr`` is the stream's
    pre-staged DRAM address (-1 = not pre-staged); ``fence_edges`` are the
    (producer_node, consumer_node) pairs joined by a buffer fence."""
    stream: np.ndarray
    insn_count: int
    n_barriers: int
    n_drains: int
    node_ids: Tuple[int, ...]
    n_fences: int = 0
    fence_edges: Tuple[Tuple[int, int], ...] = ()
    staged_addr: int = -1


@dataclass
class CpuStep:
    """One host-side op executed between accelerator segments."""
    node_id: int


class ArenaAllocator:
    """DRAM liveness arena for intermediate buffers.

    Best-fit over the free list with **block splitting**: when a dead
    block is larger than the request, only the aligned prefix is handed
    out and the tail returns to the free pool immediately — long-lived
    residents (e.g. a graph whose early layers produced one huge
    intermediate) no longer pin their whole birth size against later
    small allocations.  All sizes are rounded up to ``align`` at birth so
    a split tail is itself a valid, aligned block.

    The caller drives liveness: :meth:`alloc` records each block's last
    reader, :meth:`release_dead` (called only at fence / barrier /
    segment sync points, where every earlier op's loads are ordered
    before any later op's stores) returns expired blocks to the free
    list.  Persistent buffers never enter the arena — they are allocated
    by the program builder directly at stable addresses.
    """

    def __init__(self, alloc_fn: Callable[[int, int], int], align: int):
        self.align = align
        self._alloc = alloc_fn                  # (nbytes, align) -> addr
        self.free: List[Tuple[int, int]] = []           # (size, addr)
        # (last_use, size, addr): allocated, awaiting its last reader
        self.pending: List[Tuple[int, int, int]] = []
        self.bytes = 0            # fresh DRAM backing the arena
        self.blocks = 0
        self.reuse_hits = 0       # requests served from a dead block
        self.splits = 0           # dead blocks split on best-fit reuse
        self.intermediates = 0    # total requests

    def release_dead(self, before_idx: int) -> None:
        """Return blocks whose last reader precedes `before_idx` to the
        free pool.  Only call at sync points — recycling a buffer whose
        reader is still in flight would race through DRAM."""
        still = []
        for lu, size, addr in self.pending:
            if lu < before_idx:
                self.free.append((size, addr))
            else:
                still.append((lu, size, addr))
        self.pending[:] = still

    def alloc(self, nbytes: int, last_use: int) -> int:
        """One intermediate buffer of `nbytes`, live until `last_use`."""
        self.intermediates += 1
        need = -(-nbytes // self.align) * self.align
        best = None
        for bi, (size, _) in enumerate(self.free):
            if size >= need and (best is None
                                 or size < self.free[best][0]):
                best = bi
        if best is not None:
            size, addr = self.free.pop(best)
            self.reuse_hits += 1
            if size - need >= self.align:
                # split: hand out the aligned prefix, free the tail
                self.free.append((size - need, addr + need))
                self.splits += 1
                size = need
            self.pending.append((last_use, size, addr))
            return addr
        addr = self._alloc(need, self.align)
        self.bytes += need
        self.blocks += 1
        self.pending.append((last_use, need, addr))
        return addr


def _largest_gap(depth: int, taken: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Largest free (base, size) interval in [0, depth) given taken
    (base, size) intervals."""
    ivs = sorted((b, b + s) for b, s in taken)
    best = (0, 0)
    cur = 0
    for b, e in ivs:
        if b - cur > best[1]:
            best = (cur, b - cur)
        cur = max(cur, e)
    if depth - cur > best[1]:
        best = (cur, depth - cur)
    return best


class SegmentBuilder:
    """Accumulates lowered ops into one instruction stream, deciding per op
    whether it can overlap the ops still in flight (liveness), ride a
    buffer fence off a producer, or needs a full barrier first."""

    def __init__(self, rt: Runtime, fence_mode: str = "buffer"):
        if fence_mode not in FENCE_MODES:
            raise ValueError(f"fence_mode {fence_mode!r} not in {FENCE_MODES}")
        self.rt = rt
        self.fence_mode = fence_mode
        # (partition, out_addr, node_id) per op still in flight
        self.live: List[Tuple[SramPartition, int, int]] = []
        self.n_barriers = 0
        self.n_drains = 0
        self.n_fences = 0
        self.node_ids: List[int] = []
        self.fence_edges: List[Tuple[int, int]] = []

    # ------------------------------------------------------------------
    def _gap_partition(self, parts: Optional[Sequence[SramPartition]] = None
                       ) -> Optional[SramPartition]:
        spec = self.rt.spec
        if parts is None:
            parts = [p for p, _, _ in self.live]
        gi = _largest_gap(spec.inp_depth, [(p.inp_base, p.inp_depth)
                                           for p in parts])
        gw = _largest_gap(spec.wgt_depth, [(p.wgt_base, p.wgt_depth)
                                           for p in parts])
        ga = _largest_gap(spec.acc_depth, [(p.acc_base, p.acc_depth)
                                           for p in parts])
        if min(gi[1], gw[1], ga[1]) == 0:
            return None
        return SramPartition(gi[0], gi[1], gw[0], gw[1], ga[0], ga[1])

    @staticmethod
    def _half_partition(spec) -> SramPartition:
        return SramPartition(0, spec.inp_depth // 2, 0, spec.wgt_depth // 2,
                             0, spec.acc_depth // 2)

    @staticmethod
    def _wgt_hedged(spec) -> SramPartition:
        """Full inp/acc, first half of the weight buffer: what a producer
        takes when its *successor depends on it* in fence mode, so the
        successor can pre-stage its first weight tile into the other half
        while this op's store tail drains (cross-boundary
        double-buffering of the weight scratchpad)."""
        return SramPartition(0, spec.inp_depth, 0, spec.wgt_depth // 2,
                             0, spec.acc_depth)

    def _wgt_gap_partition(self, parts: Sequence[SramPartition]
                           ) -> Optional[SramPartition]:
        """Full inp/acc plus the largest free weight-buffer interval not
        claimed by `parts` — the fenced consumer's partition.  Only the
        weight region must be disjoint from the retiring producers: the
        consumer's single pre-fence instruction is its first weight-tile
        load, while its inp/acc traffic is ordered behind the fence token
        (load queue) or the fence noops (compute queue)."""
        spec = self.rt.spec
        gw = _largest_gap(spec.wgt_depth, [(p.wgt_base, p.wgt_depth)
                                           for p in parts])
        if gw[1] == 0:
            return None
        return SramPartition(0, spec.inp_depth, gw[0], gw[1],
                             0, spec.acc_depth)

    # ------------------------------------------------------------------
    def place(self, node_id: int, *, reads: Set[int],
              out_alloc: Callable[[bool], int],
              lower: Callable[..., None],
              wants_overlap: bool = False,
              succ_dependent: bool = False,
              uses_load_queue: bool = True) -> None:
        """Emit one op into the open stream.

        reads: DRAM buffer addresses produced by earlier ops (graph inputs
        are excluded — they are staged before the stream runs and cannot
        race with it).  out_alloc(sync) assigns the op's output DRAM
        buffer and returns its address; sync=True is passed exactly when a
        fence/barrier orders this op's stores after every earlier op's
        loads, so the arena may recycle dead intermediates.  lower(sram,
        fenced=...) must choose its tiles *before* emitting any
        instruction and raise ValueError if the partition is too small, so
        a failed attempt leaves the stream unchanged.  succ_dependent
        marks ops whose in-segment successor reads their output: in fence
        mode they hedge half the weight buffer so the successor's first
        weight tile can pre-stage into the other half.  uses_load_queue is
        False for ops whose operand traffic rides the compute queue (ACC
        loads, e.g. vector binops): compute-FIFO order behind the fence
        noops already serializes them, no c2l token needed."""
        rt = self.rt
        spec = rt.spec
        self.node_ids.append(node_id)
        live_outs = {a for _, a, _ in self.live}
        if not (reads & live_outs):
            if self.live:
                part = self._gap_partition()
                if part is not None:
                    try:
                        # stale-token fence: predecessors' unconsumed
                        # tokens must not alias this op's own pairing
                        rt.drain_dep_tokens()
                        self.n_drains += 1
                        out = out_alloc(False)
                        lower(part, fenced=False)
                        self.live.append((part, out, node_id))
                        return
                    except ValueError:
                        pass  # minimum tile does not fit the gap
            elif wants_overlap:
                # first op of an overlappable pair: take half of each
                # scratchpad so the independent successor has a region
                part = self._half_partition(spec)
                try:
                    out = out_alloc(False)
                    lower(part, fenced=False)
                    self.live.append((part, out, node_id))
                    return
                except ValueError:
                    pass
            else:
                out = out_alloc(False)
                if self.fence_mode == "buffer" and succ_dependent:
                    try:
                        part = self._wgt_hedged(spec)
                        lower(part, fenced=False)
                        self.live.append((part, out, node_id))
                        return
                    except ValueError:
                        pass  # does not fit half the wgt buffer
                part = SramPartition.full(spec)
                lower(part, fenced=False)
                self.live.append((part, out, node_id))
                return
        # dependent op, or no usable disjoint region
        if self.fence_mode == "buffer" and rt.stream_len:
            self._place_fenced(node_id, reads, out_alloc, lower,
                               uses_load_queue, succ_dependent)
            return
        # full rendezvous; the whole scratchpad is ours again
        if rt.stream_len:
            rt.join_barrier()
            self.n_barriers += 1
        part = SramPartition.full(spec)
        out = out_alloc(True)
        lower(part, fenced=False)
        self.live = [(part, out, node_id)]

    # ------------------------------------------------------------------
    def _place_fenced(self, node_id: int, reads: Set[int],
                      out_alloc: Callable[[bool], int],
                      lower: Callable[..., None],
                      uses_load_queue: bool,
                      succ_dependent: bool = False) -> None:
        """Dependent-op placement, fence mode: emit a buffer fence, then
        try to lower the consumer with its weight region disjoint from
        the retiring producers' so its first weight tile can DMA *before*
        the fence token (overlapping the producer's epilogue and store
        tail).  If no such region fits, the fence token gates the
        consumer's very first load instead and it gets the full
        scratchpad — still cheaper than a barrier (stores never gated, no
        load/compute rendezvous)."""
        rt = self.rt
        self.fence_edges.extend(
            (nid, node_id) for _, a, nid in self.live if a in reads)
        rt.buffer_fence(consumer_loads=uses_load_queue)
        self.n_fences += 1
        old_parts = [p for p, _, _ in self.live]
        self.live = []
        out = out_alloc(True)
        if uses_load_queue and old_parts:
            part = self._wgt_gap_partition(old_parts)
            if part is not None:
                try:
                    lower(part, fenced=True)
                    self.live = [(part, out, node_id)]
                    return
                except ValueError:
                    pass  # minimum tile does not fit the gap
        if uses_load_queue:
            # no preload region: claim the fence token on the very first
            # load (whatever it is) — everything after it is ordered
            rt.dep_pop(COMPUTE_Q, LOAD_Q)
        if succ_dependent:
            try:
                part = self._wgt_hedged(rt.spec)
                lower(part, fenced=False)
                self.live = [(part, out, node_id)]
                return
            except ValueError:
                pass  # does not fit half the wgt buffer
        part = SramPartition.full(rt.spec)
        try:
            lower(part, fenced=False)
        except ValueError:
            # full-scratchpad lowering failed (op genuinely does not
            # fit); leave no dangling fence pop behind
            rt.clear_pending_pop(LOAD_Q)
            raise
        self.live = [(part, out, node_id)]

    # ------------------------------------------------------------------
    def finish(self) -> Optional[AccelStep]:
        """Finalize the open stream (FINISH + static token validation +
        binary encoding) into an AccelStep; None if nothing was emitted."""
        if not self.rt.stream_len:
            return None
        stream = self.rt.finalize_stream()
        step = AccelStep(stream=stream, insn_count=stream.shape[0],
                         n_barriers=self.n_barriers, n_drains=self.n_drains,
                         n_fences=self.n_fences,
                         fence_edges=tuple(self.fence_edges),
                         node_ids=tuple(self.node_ids))
        self.rt.reset_stream()
        self.live = []
        self.n_barriers = 0
        self.n_drains = 0
        self.n_fences = 0
        self.node_ids = []
        self.fence_edges = []
        return step
