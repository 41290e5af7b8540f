"""Pluggable execution backends: one task-ISA stream, two engines (§3).

The paper's runtime supports *heterogeneous execution*: the identical
binary instruction stream runs on a behavioral simulator or on the FPGA,
and the simulator doubles as the differential-testing oracle for the fast
path.  This module reproduces that split on PyTorch:

  * ``SimulatorBackend`` — the cycle-capable behavioural engine
    (``simulator.run_program``), bit-exact oracle semantics;
  * ``CudaBackend``      — interprets the *decoded* task-ISA stream,
    coalescing each virtual-thread tile's LOAD/GEMM/ALU/STORE groups into
    calls to the hand-written CUDA kernels (``kernels.vta_gemm`` and
    ``kernels.tensor_alu``), honoring the same dependence-token protocol;
  * ``CrossBackendChecker`` — runs one encoded stream on every backend
    against cloned devices and diffs the resulting DRAM images, turning
    the simulator into the oracle for the fast path exactly the way the
    paper checks the FPGA against simulation.

Both engines consume the stream *after* ``IsaLayout.encode_stream`` —
there is no side channel: whatever the scheduler lowered is what runs.
Both keep their SRAM state, kernel operands and results as torch tensors
on the DRAM image's device; on a CPU image the kernel ops take their
plain PyTorch versions, on the card they launch the CUDA kernels.  The
stream is decoded on the host, and every grouping decision (which tiles
share a launch, which weights are equal) is taken on the host exactly as
the reference takes it.

Why sequential interpretation is sound: the runtime emits ``dep_push``
flags on instructions that are already in the stream and attaches each
``dep_pop`` to the next instruction it emits, so every token's producer
precedes its consumer in program order.  Program order also preserves
each module's queue order, hence it is one of the legal executions the
token protocol admits (§2.3) — the CudaBackend verifies this while it
runs and raises ``DeadlockError`` on streams that violate it.
"""
from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, Tuple, Union, \
    runtime_checkable

import numpy as np
import torch

from ..kernels.lut_gemm import lut_gemm
from ..kernels.tensor_alu import BlockMap, tensor_alu, tensor_alu_scatter
from ..kernels.tensor_alu.kernel import MAX_OPS as ALU_MAX_OPS
from ..kernels.vta_gemm import vta_gemm
from .driver import Device
from .hwspec import HardwareSpec
from .isa import (AluInsn, AluOp, DEP_IN_EDGES, DEP_OUT_EDGES, FinishInsn,
                  GemmInsn, Insn, IsaLayout, LoadStoreInsn, MemId, Opcode,
                  route_queue, LOAD_Q, COMPUTE_Q, STORE_Q)
from .simulator import (ALU_NAMES, DeadlockError, ModuleStats, RunStats,
                        Simulator, TimingModel, replay_timing, run_program,
                        _MODULE_NAMES)


# ----------------------------------------------------------------------
# the backend contract
# ----------------------------------------------------------------------
@runtime_checkable
class ExecutionBackend(Protocol):
    """Anything that can run an encoded VTA instruction stream against a
    device and report RunStats.  ``staged_addr`` (when >= 0 / not None)
    names a pre-staged DRAM copy of the same stream: the engine kicks the
    fetch registers at it instead of re-staging — the serving fast path's
    zero-allocation repeat call."""

    name: str

    def execute(self, spec: HardwareSpec, device: Device, stream: np.ndarray,
                timing: Optional[TimingModel] = None,
                staged_addr: Optional[int] = None) -> RunStats:
        ...


class SimulatorBackend:
    """The paper's behavioral/cycle-level engine (default)."""

    name = "simulator"

    def __init__(self, timing: Optional[TimingModel] = None):
        self.timing = timing

    def execute(self, spec: HardwareSpec, device: Device, stream: np.ndarray,
                timing: Optional[TimingModel] = None,
                staged_addr: Optional[int] = None) -> RunStats:
        t0 = time.perf_counter()
        stats = run_program(spec, device, stream,
                            timing=timing or self.timing,
                            staged_addr=staged_addr)
        stats.wall_time_s = time.perf_counter() - t0
        stats.backend = self.name
        return stats


# ----------------------------------------------------------------------
# CudaBackend: decoded-stream interpreter over the CUDA kernels
# ----------------------------------------------------------------------

# token FIFO name + dep flag consumed per queue / produced per queue
# (shared with the runtime's static validator)
_IN_EDGES = DEP_IN_EDGES
_OUT_EDGES = DEP_OUT_EDGES

# content-addressed decoded-stream cache (see CudaBackend._decode_cached).
# Shared across backend instances AND serving threads: the pool scheduler
# may decode concurrently with a foreground call, so every access holds
# _DECODE_LOCK (pop+reinsert is not atomic under concurrent eviction).
_DECODE_CACHE: Dict[tuple, List[Insn]] = {}
_DECODE_LOCK = threading.Lock()
# LRU bound on the shared cache: generous by default (a long-lived
# multi-program server holds a handful of streams per program), but
# configurable so it can never grow without limit.  Evictions are
# counted — cumulatively here, per run in RunStats.decode_evictions.
_DECODE_CACHE_CAP = 256
_DECODE_EVICTIONS = 0


def set_decode_cache_cap(cap: int) -> int:
    """Re-bound the process-wide decoded-stream LRU cache at `cap`
    entries (0 disables retention entirely), trimming least-recently-hit
    entries immediately if it is over the new bound.  Returns the number
    of entries trimmed by this call."""
    global _DECODE_CACHE_CAP, _DECODE_EVICTIONS
    if cap < 0:
        raise ValueError(f"decode cache cap must be >= 0, got {cap}")
    trimmed = 0
    with _DECODE_LOCK:
        _DECODE_CACHE_CAP = cap
        while len(_DECODE_CACHE) > cap:
            _DECODE_CACHE.pop(next(iter(_DECODE_CACHE)))
            trimmed += 1
        _DECODE_EVICTIONS += trimmed
    return trimmed


# the scatter instance's block maps (CudaBackend._block_map), one per tile
# structure (the plan key), each with its device copy: built on a
# structure's first tile batch, so a served request of a program seen
# before builds and uploads none.  Shared across backend instances and
# serving threads like the decode cache, and LRU-bounded the same way.
_BLOCK_MAPS: Dict[tuple, BlockMap] = {}
_BLOCK_MAP_LOCK = threading.Lock()
_BLOCK_MAP_CAP = 1024
_BLOCK_MAP_BUILDS = 0


def block_map_info() -> Dict[str, int]:
    """Live size / bound of the block-map cache, the maps built and the
    device copies made so far (ops introspection)."""
    with _BLOCK_MAP_LOCK:
        return {"size": len(_BLOCK_MAPS), "cap": _BLOCK_MAP_CAP,
                "builds": _BLOCK_MAP_BUILDS, "uploads": BlockMap.uploads}


def decode_cache_info() -> Dict[str, int]:
    """Live size / bound / lifetime eviction count of the shared
    decoded-stream cache (ops introspection)."""
    with _DECODE_LOCK:
        return {"size": len(_DECODE_CACHE), "cap": _DECODE_CACHE_CAP,
                "evictions": _DECODE_EVICTIONS}


@dataclass
class _GemmChunk:
    """One coalesced GEMM instruction: the acc-element grid it wrote and a
    snapshot of its operands.  ``grid`` may equal the owning tile's full
    (reset) grid — the blocked-matmul case — or cover a sub-region of it,
    which is the direct-conv structure: one instruction per output row
    ``oh``, each accumulating kh*kw*cbt uops into its row of the tile."""
    grid: np.ndarray                    # (iter_out, iter_in) acc element ids
    a: torch.Tensor                     # (io*batch, U*block_in) int8
    w: torch.Tensor                     # (ii*block_out, U*block_in) int8
    # host copy of ``w`` for the weight-content keys, made on first use
    # by CudaBackend._w_host
    w_host: Optional[np.ndarray] = None


@dataclass
class _PendingTile:
    """A lazily-evaluated accumulator tile: the coalesced record of one
    virtual-thread context's reset + GEMM chunks + ALU epilogue, resolved
    with batched ``vta_gemm`` launches (plus fused ALU chains) when the
    tile is stored or otherwise observed."""
    grid: np.ndarray                    # canonical (reset) grid of acc ids
    indices: np.ndarray                 # sorted unique ids (overlap queries)
    chunks: List[_GemmChunk] = field(default_factory=list)
    # epilogue: ("imm", op, imm) | ("tensor", op, (R, C) int32 tensor)
    alu_chain: List[tuple] = field(default_factory=list)
    # memo of the resolution plan: (len(chunks), len(alu_chain), plan)
    plan_memo: Optional[tuple] = None


@dataclass
class _RunState:
    """Per-execute() interpreter state, passed explicitly so one
    CudaBackend instance can be shared (and re-entered) safely."""
    sim: Simulator                          # SRAM state + eager semantics
    pending: Dict[int, _PendingTile] = field(default_factory=dict)


class CudaBackend:
    """Executes a decoded task-ISA stream through the CUDA kernels.

    LOADs update the SRAM tensors eagerly (DMA semantics are reused from
    the Simulator).  GEMM/ALU instructions whose micro-coded affine index
    pattern matches the blocked-matmul / direct-conv / tile-epilogue
    structure are *coalesced* per accumulator tile and resolved by
    ``vta_gemm`` / ``tensor_alu`` when the tile is stored; anything else
    falls back to the simulator's eager per-instruction semantics, so
    arbitrary valid streams still execute correctly — just without the
    fast path.  ``RunStats.coalesced_*`` / ``eager_*`` count which route
    each compute instruction took (see :func:`assert_fast_path`).

    Operands are gathered on the DRAM image's device from the SRAM
    tensors, and results stay there until they are written back.  Every
    grouping decision is the reference's: the same content keys (exact
    bytes of the weight operands, copied to the host once per GEMM
    instruction) and the same concat-vs-tile-axis cost model, so the
    counters ``tile_batches``, ``tiles_resolved``, ``coalesced_*`` and
    ``eager_*`` equal the reference engine's on the same stream.

    ``coalesce_subgrids=False`` restricts coalescing to instructions whose
    grid equals the tile's reset grid exactly (the pre-generalization
    behavior, which sent direct-conv schedules to the eager loop) — kept
    as an A/B switch for benchmarks and debugging.  ``batch_tiles=False``
    likewise disables the batched tile dispatch (one kernel launch per
    pending tile).  ``use_lut``: None (auto) routes a launch group through
    the ``lut_gemm`` kernel when the spec's weights are packed sub-byte and
    the group's tiles have at most :attr:`LUT_MAX_ROWS` rows; True forces
    it for every sub-byte GEMM; False pins the dense ``vta_gemm`` kernel
    over the sign-extended WGT SRAM.  int8 specs never use it.
    """

    name = "cuda"

    #: auto LUT selection: per-tile activation rows at or below this are
    #: "decode-shaped" (weight traffic dominates; the table transform is
    #: cheap) and route to the LUT-GEMM kernel when weights are sub-byte
    LUT_MAX_ROWS = 16

    def __init__(self, check_tokens: bool = True,
                 coalesce_subgrids: bool = True,
                 batch_tiles: bool = True,
                 cache_decode: bool = True,
                 use_lut: Optional[bool] = None):
        self.check_tokens = check_tokens
        self.coalesce_subgrids = coalesce_subgrids
        self.batch_tiles = batch_tiles
        self.cache_decode = cache_decode
        self.use_lut = use_lut

    def _lut_select(self, spec: HardwareSpec, rows: int) -> bool:
        """Per-shape kernel choice for one GEMM launch group: T-MAC LUT
        lookup vs dense GEMM.  Both are bit-exact; this is purely a
        roofline call, so the fuzzer sweeps it freely."""
        if not spec.wgt_packed or self.use_lut is False:
            return False
        return bool(self.use_lut) or rows <= self.LUT_MAX_ROWS

    # ------------------------------------------------------------------
    def execute(self, spec: HardwareSpec, device: Device, stream: np.ndarray,
                timing: Optional[TimingModel] = None,
                staged_addr: Optional[int] = None) -> RunStats:
        """Same control handshake as the hardware path: the stream is
        DMA'd to DRAM (or a pre-staged copy at `staged_addr` is kicked —
        zero per-call allocation), the fetch registers are set, and the
        engine runs to FINISH.  With `timing`, the same TimingModel
        cycle-accounting the simulator performs is replayed over the
        decoded stream, so RunStats.total_cycles is meaningful on both
        engines (wall_time_s stays this engine's real clock, up to the
        device's completion of the run).

        A single-device execute is a gang of one — every launch-batching
        decision below is shared with :meth:`execute_gang`."""
        return self.execute_gang(spec, [device], stream, timing=timing,
                                 staged_addr=staged_addr)[0]

    def execute_gang(self, spec: HardwareSpec, devices: Sequence[Device],
                     stream: np.ndarray,
                     timing: Optional[TimingModel] = None,
                     staged_addr: Optional[int] = None) -> List[RunStats]:
        """Run ONE encoded stream on N devices in lockstep (SPMD over a
        device pool): the stream — hence every scheduling, coalescing and
        materialization decision — is identical across devices; only the
        DRAM data differs.  Each kernel launch therefore batches the
        peer tiles of ALL gang members along the kernel's tile axis,
        paying the per-launch cost once for the pool.  Returns one
        RunStats per device (``gang_size`` records the gang width;
        ``wall_time_s`` is the shared gang window)."""
        t0 = time.perf_counter()
        isa = IsaLayout(spec)
        if staged_addr is None:
            # per-device staging may land at different addresses; the
            # staged CONTENT is identical, so decode from the first
            addr = [d.stage_stream(stream) for d in devices][0]
        else:
            addr = staged_addr
            for d in devices:
                d.kick_stream(addr, stream.shape[0])
        # one device-to-host copy of the stream words; decode on the host
        raw = devices[0].dram.read(
            addr, stream.shape[0] * isa.insn_bytes,
            dtype=np.uint64, shape=(stream.shape[0], isa.insn_words))
        insns, evicted = self._decode_cached(spec, isa, raw)
        statss = self._run_gang(spec, devices, insns)
        for tdev in {d.torch_device for d in devices}:
            if tdev.type == "cuda":
                torch.cuda.synchronize(tdev)
        wall = time.perf_counter() - t0
        rep = None
        if timing is not None:
            # cycle replay happens OUTSIDE the wall-clock window: the
            # pure-python scheduler pass prices the stream, it is not
            # part of this engine's execution time
            rep = replay_timing(spec, insns, timing)
        for d, stats in zip(devices, statss):
            d.regs.set_done()
            stats.backend = self.name
            stats.wall_time_s = wall
            stats.gang_size = len(devices)
            stats.decode_evictions = evicted
            if rep is not None:
                stats.total_cycles = rep.total_cycles
                for nm, ms in rep.modules.items():
                    stats.modules[nm].busy_cycles = ms.busy_cycles
                    stats.modules[nm].stall_on_token = ms.stall_on_token
        return statss

    def _decode_cached(self, spec: HardwareSpec, isa: IsaLayout,
                       raw: np.ndarray) -> Tuple[List[Insn], int]:
        """Decode the raw stream words, memoized by content digest: a
        serving loop re-running one pre-staged stream pays the (pure
        python) decode exactly once.  Keyed on the bytes actually read
        from DRAM, so there is still no side channel.  Returns
        ``(insns, evicted)`` where `evicted` counts LRU entries this
        call pushed out of the bounded cache (set_decode_cache_cap)."""
        import hashlib
        global _DECODE_EVICTIONS
        if not self.cache_decode:
            return isa.decode_stream(raw), 0
        key = (spec, hashlib.sha1(raw.tobytes()).hexdigest())
        with _DECODE_LOCK:
            hit = _DECODE_CACHE.pop(key, None)
            if hit is not None:
                _DECODE_CACHE[key] = hit   # re-insert: LRU order by last hit
                return hit, 0
        insns = isa.decode_stream(raw)
        evicted = 0
        with _DECODE_LOCK:
            while len(_DECODE_CACHE) >= max(1, _DECODE_CACHE_CAP):
                # evict the least-recently-used entry; hot streams survive
                _DECODE_CACHE.pop(next(iter(_DECODE_CACHE)))
                evicted += 1
            if _DECODE_CACHE_CAP > 0:
                _DECODE_CACHE[key] = insns
            _DECODE_EVICTIONS += evicted
        return insns, evicted

    # ------------------------------------------------------------------
    def _run_gang(self, spec: HardwareSpec, devices: Sequence[Device],
                  insns: List[Insn]) -> List[RunStats]:
        """Interpret one decoded stream against N per-device states in
        lockstep.  Control flow (structure detection, tile bookkeeping,
        materialization triggers) is data-independent — it derives from
        the stream and the uop SRAM, which are identical across the gang
        — so every decision is taken once on state 0 and applied to all;
        only the operand data differs per state.  Invariant: the states'
        ``pending`` dicts stay key-synchronized throughout."""
        states = [_RunState(sim=Simulator(spec, d)) for d in devices]
        statss = [RunStats(modules={n: ModuleStats()
                                    for n in _MODULE_NAMES.values()})
                  for _ in devices]
        tokens = {"l2c": 0, "c2l": 0, "c2s": 0, "s2c": 0}

        for insn in insns:
            q = route_queue(insn)
            if self.check_tokens:
                # token protocol is stream-determined: check once
                for fifo, flag in _IN_EDGES[q]:
                    if getattr(insn.dep, flag):
                        if tokens[fifo] == 0:
                            raise DeadlockError(
                                f"{type(insn).__name__} pops empty dependence"
                                f" FIFO {fifo}: stream is not a legal "
                                f"program-order execution")
                        tokens[fifo] -= 1
            for stats in statss:
                stats.modules[_MODULE_NAMES[q]].insn_count += 1

            if isinstance(insn, FinishInsn):
                pass
            elif isinstance(insn, LoadStoreInsn):
                if insn.opcode == Opcode.STORE:
                    lo = insn.sram_base
                    hi = insn.sram_base + insn.y_size * insn.x_size
                    self._materialize_range(states, lo, hi, statss)
                    for st, stats in zip(states, statss):
                        st.sim._do_store(insn, stats)
                else:
                    if insn.memory_type in (MemId.ACC, MemId.OUT):
                        # both land in tile-owned state: ACC loads overwrite
                        # accumulators, OUT loads overwrite the write-through
                        # mirror a later STORE reads
                        width = insn.x_pad_0 + insn.x_size + insn.x_pad_1
                        rows = insn.y_pad_0 + insn.y_size + insn.y_pad_1
                        self._materialize_range(
                            states, insn.sram_base,
                            insn.sram_base + rows * width, statss)
                    for st, stats in zip(states, statss):
                        st.sim._do_load(insn, stats)
            elif isinstance(insn, GemmInsn):
                self._gemm(states, insn, statss)
            elif isinstance(insn, AluInsn):
                self._alu(states, insn, statss)
            else:
                raise TypeError(type(insn))

            if self.check_tokens:
                for fifo, flag in _OUT_EDGES[q]:
                    if getattr(insn.dep, flag):
                        tokens[fifo] += 1
                        for stats in statss:
                            stats.tokens_pushed += 1

        # a well-formed stream leaves nothing pending, but flush anyway so
        # partial streams (no FINISH/store) still leave coherent SRAM
        if states[0].pending:
            self._materialize_group(states, list(states[0].pending), statss,
                                    batch_peers=False)
        return statss

    # ------------------------------------------------------------------
    # pending-tile bookkeeping
    # ------------------------------------------------------------------
    def _materialize_range(self, states: Sequence[_RunState], lo: int,
                           hi: int, statss: Sequence[RunStats]) -> None:
        st0 = states[0]
        need = []
        for base in list(st0.pending):
            t = st0.pending[base]
            if t.indices[0] < hi and lo <= t.indices[-1]:
                if np.any((t.indices >= lo) & (t.indices < hi)):
                    need.append(base)
        if need:
            # store / ACC-load trigger: peer virtual-thread tiles of the
            # same op are complete here (their epilogues precede the
            # group's first store in program order) — batch them along
            self._materialize_group(states, need, statss, batch_peers=True)

    def _materialize_indices(self, states: Sequence[_RunState],
                             idx: np.ndarray,
                             statss: Sequence[RunStats]) -> None:
        st0 = states[0]
        need = [base for base in list(st0.pending)
                if np.isin(idx, st0.pending[base].indices,
                           assume_unique=False).any()]
        if need:
            # eager-fallback trigger: other pending tiles may still be
            # mid-accumulation, resolve only what is forced
            self._materialize_group(states, need, statss, batch_peers=False)

    def _materialize_group(self, states: Sequence[_RunState],
                           keys: Sequence[int], statss: Sequence[RunStats],
                           batch_peers: bool) -> None:
        """Resolve the pending tiles at `keys` in EVERY gang state —
        plus, with batch_peers, any structurally-identical pending peers
        — grouping same-plan tiles into ONE (vmapped) kernel launch per
        GEMM stage instead of one launch per tile.  With a gang of N the
        launch batches N× the tiles: the per-launch dispatch cost is
        paid once for the pool (sharded batch dispatch)."""
        plan0: Dict[int, tuple] = {}     # state-0 plans, keyed by base
        if batch_peers and self.batch_tiles and states[0].pending:
            # peer sweep decided on state 0 by structural match; the
            # chosen KEYS are popped from every state so the pending
            # dicts stay synchronized.  A peer whose plan key diverges
            # on another state (e.g. coincidentally-equal weight bytes
            # merged there) still resolves correctly — it just lands in
            # its own launch group below.
            sigs, pre_sigs = set(), set()
            for k in keys:
                t = states[0].pending[k]
                if t.chunks:
                    plan0[k] = self._plan_tile(t, statss[0])
                    sigs.add(self._plan_key(t, plan0[k]))
                    pre_sigs.add(self._pre_key(t))
            peer_keys = []
            if sigs:
                for base in list(states[0].pending):
                    if base in keys:
                        continue
                    peer = states[0].pending[base]
                    if not peer.chunks or self._pre_key(peer) not in pre_sigs:
                        continue
                    plan = self._plan_tile(peer, statss[0])
                    if self._plan_key(peer, plan) in sigs:
                        peer_keys.append(base)
                        plan0[base] = plan
            keys = list(keys) + peer_keys
        entries: List[Tuple[int, int, _PendingTile]] = \
            [(si, k, st.pending.pop(k))
             for si, st in enumerate(states) for k in keys]
        if not self.batch_tiles:
            for si, _, t in entries:
                self._materialize(states[si], t, statss[si])
            return
        groups: Dict[tuple, List[Tuple[int, _PendingTile, tuple]]] = {}
        for si, k, t in entries:
            if t.chunks:
                plan = plan0[k] if si == 0 and k in plan0 \
                    else self._plan_tile(t, statss[si])
                groups.setdefault(self._plan_key(t, plan), []).append(
                    (si, t, plan))
            else:
                self._materialize(states[si], t, statss[si])  # reset/ALU-only
        for key, grp in groups.items():
            tiles_g = [t for _, t, _ in grp]
            plans_g = [p for _, _, p in grp]
            stats_g = [statss[si] for si, _, _ in grp]
            accs = self._resolve_tiles(tiles_g, plans_g, stats_g,
                                       states[0].sim.spec, key)
            for (si, tile, _), acc in zip(grp, accs):
                self._writeback(states[si], tile, acc, statss[si])

    @staticmethod
    def _overlaps_pending(st: _RunState, idx: np.ndarray) -> bool:
        return any(np.isin(idx, t.indices).any()
                   for t in st.pending.values())

    @staticmethod
    def _decode_structure(insn, uops, dsts, srcs, wgts):
        """Detect the 2-level-affine blocked-matmul index structure:
        dst = f(i0, i1), src = g(i0, u), wgt = h(i1, u) with all dsts
        distinct.  Returns (dst_grid, src_idx, wgt_idx) or None."""
        io, ii, U = insn.iter_out, insn.iter_in, len(uops)
        D = dsts.reshape(io, ii, U)
        S = srcs.reshape(io, ii, U)
        W = wgts.reshape(io, ii, U)
        if not (D == D[:, :, :1]).all():
            return None
        grid = D[:, :, 0]
        if np.unique(grid).size != grid.size:
            return None
        if not (S == S[:, :1, :]).all():
            return None
        if not (W == W[:1, :, :]).all():
            return None
        return grid, S[:, 0, :], W[0, :, :]

    def _find_containing(self, st: _RunState, grid: np.ndarray
                         ) -> Optional[Tuple[int, _PendingTile]]:
        """The pending tile this GEMM accumulates into: an exact grid
        match (blocked matmul / im2col), or — with sub-grid coalescing —
        any tile whose reset region contains every dst id (the direct-conv
        per-output-row structure).  Returns (pending key, tile) so a gang
        caller can fetch the same tile in every peer state."""
        base = int(grid.min())
        tile = st.pending.get(base)
        if tile is not None and tile.grid.shape == grid.shape \
                and (tile.grid == grid).all():
            return base, tile
        if not self.coalesce_subgrids:
            return None
        ids = grid.ravel()
        lo, hi = int(ids.min()), int(ids.max())
        for k, t in st.pending.items():
            if lo >= t.indices[0] and hi <= t.indices[-1] \
                    and np.isin(ids, t.indices).all():
                return k, t
        return None

    # ------------------------------------------------------------------
    # GEMM
    # ------------------------------------------------------------------
    def _gemm(self, states: Sequence[_RunState], insn: GemmInsn,
              statss: Sequence[RunStats]) -> None:
        sim0 = states[0].sim
        uops = sim0.uop_layout.decode_kernel(
            sim0.uop_sram[insn.uop_bgn:insn.uop_end])
        if not uops or insn.iter_out == 0 or insn.iter_in == 0:
            return
        dsts, srcs, wgts = sim0._affine_indices(insn, uops)
        struct = self._decode_structure(insn, uops, dsts, srcs, wgts)
        if struct is None:
            self._materialize_indices(states, np.unique(dsts), statss)
            for st, stats in zip(states, statss):
                st.sim._do_gemm(insn, stats)
                stats.eager_gemm_insns += 1
            return
        grid, src_idx, wgt_idx = struct

        if insn.reset:
            # reset opens a fresh accumulation tile; whatever overlapped
            # before is dead (never observed) for an exact-region match,
            # and must be resolved first otherwise
            base = int(grid.min())
            prev = states[0].pending.get(base)
            if prev is not None and prev.grid.shape == grid.shape \
                    and (prev.grid == grid).all():
                for st in states:
                    del st.pending[base]
            else:
                self._materialize_indices(states, np.unique(grid), statss)
            for st in states:
                st.pending[base] = _PendingTile(
                    grid=grid, indices=np.unique(grid))
            return

        found = self._find_containing(states[0], grid)
        if found is None or found[1].alu_chain:
            # accumulate-onto-existing-values, post-epilogue, or
            # partially-overlapping GEMM: resolve lazies, then run the
            # eager oracle semantics
            self._materialize_indices(states, np.unique(dsts), statss)
            for st, stats in zip(states, statss):
                st.sim._do_gemm(insn, stats)
                stats.eager_gemm_insns += 1
            return
        key = found[0]
        s = sim0.spec
        U = src_idx.shape[1]
        src_t = sim0.index(src_idx)
        wgt_t = sim0.index(wgt_idx)
        for st, stats in zip(states, statss):
            sim = st.sim
            # snapshot operands NOW: virtual threading will overwrite
            # these SRAM contexts before the tile is stored
            A = sim.inp_sram[src_t]          # (io, U, batch, block_in)
            Wm = sim.wgt_sram[wgt_t]         # (ii, U, block_out, block_in)
            A2 = A.permute(0, 2, 1, 3).reshape(grid.shape[0] * s.batch,
                                               U * s.block_in)
            W2 = Wm.permute(0, 2, 1, 3).reshape(grid.shape[1] * s.block_out,
                                                U * s.block_in)
            st.pending[key].chunks.append(_GemmChunk(grid=grid, a=A2, w=W2))
            stats.coalesced_gemm_insns += 1
            stats.gemm_macs += (grid.size * U * s.batch
                                * s.block_in * s.block_out)

    # ------------------------------------------------------------------
    # ALU
    # ------------------------------------------------------------------
    def _alu(self, states: Sequence[_RunState], insn: AluInsn,
             statss: Sequence[RunStats]) -> None:
        sim0 = states[0].sim
        uops = sim0.uop_layout.decode_kernel(
            sim0.uop_sram[insn.uop_bgn:insn.uop_end])
        if not uops or insn.iter_out == 0 or insn.iter_in == 0:
            return
        s = sim0.spec
        dsts, srcs, _ = sim0._affine_indices(insn, uops)
        if len(uops) == 1:
            # tile-epilogue shape: one uop, each dst written exactly once;
            # src may be any affine function of the loop indices (the bias
            # add reads a per-column staging row, self ops read dst)
            grid = dsts.reshape(insn.iter_out, insn.iter_in)
            src_grid = srcs.reshape(insn.iter_out, insn.iter_in)
            base = int(grid.min())
            tile0 = states[0].pending.get(base)
            if (tile0 is not None and np.unique(grid).size == grid.size
                    and tile0.grid.shape == grid.shape
                    and (tile0.grid == grid).all()):
                op = ALU_NAMES[insn.alu_opcode]
                if insn.use_imm:
                    for st, stats in zip(states, statss):
                        st.pending[base].alu_chain.append(
                            ("imm", op, int(insn.imm)))
                        stats.alu_ops += grid.size * s.batch * s.block_out
                        stats.coalesced_alu_insns += 1
                    return
                # tensor-tensor: src must be readable now (eager region)
                if not self._overlaps_pending(states[0],
                                              np.unique(src_grid)):
                    src_t = sim0.index(src_grid)
                    for st, stats in zip(states, statss):
                        src_mat = self._to_matrix(st.sim.acc_sram[src_t], s)
                        st.pending[base].alu_chain.append(
                            ("tensor", op, src_mat))
                        stats.alu_ops += grid.size * s.batch * s.block_out
                        stats.coalesced_alu_insns += 1
                    return
            # vector-ALU fast path: a dense single-uop op over the *eager*
            # region (no pending lazy tile) — e.g. the chunked
            # schedule_vector_binop stream — resolves through one
            # tensor_alu launch instead of the eager per-row loop
            if (np.unique(grid).size == grid.size
                    and not self._overlaps_pending(states[0],
                                                   np.unique(dsts))
                    and (insn.use_imm
                         or not self._overlaps_pending(states[0],
                                                       np.unique(srcs)))):
                self._alu_eager_region(states, insn, grid, src_grid, statss)
                return
        # fallback: eager semantics on materialized state
        need = np.unique(dsts if insn.use_imm
                         else np.concatenate([dsts, srcs]))
        self._materialize_indices(states, need, statss)
        for st, stats in zip(states, statss):
            st.sim._do_alu(insn, stats)
            stats.eager_alu_insns += 1

    def _alu_eager_region(self, states: Sequence[_RunState], insn: AluInsn,
                          grid: np.ndarray, src_grid: np.ndarray,
                          statss: Sequence[RunStats]) -> None:
        """Run one dense ALU instruction over already-materialized
        accumulator state through the tensor_alu kernel, keeping the §2.5
        write-through OUT mirror coherent.  Gang members row-stack into a
        single launch (the region shape is identical across the gang;
        only the data differs)."""
        sim0 = states[0].sim
        s = sim0.spec
        op = ALU_NAMES[insn.alu_opcode]
        grid_t = sim0.index(grid)
        dst_mats = [self._to_matrix(st.sim.acc_sram[grid_t], s)
                    for st in states]
        R = dst_mats[0].shape[0]
        big = torch.cat(dst_mats, dim=0)
        if insn.use_imm:
            out = tensor_alu(big, chain=((op, int(insn.imm)),))
        else:
            src_t = sim0.index(src_grid)
            big_src = torch.cat([self._to_matrix(st.sim.acc_sram[src_t], s)
                                 for st in states], dim=0)
            out = tensor_alu(big, big_src, chain=((op, None),))
        io, ii = grid.shape
        touched = sim0.index(np.unique(grid))
        for i, (st, stats) in enumerate(zip(states, statss)):
            sim = st.sim
            sim.acc_sram[grid_t] = self._from_matrix(
                out[i * R:(i + 1) * R], io, ii, s)
            sim.out_sram[touched] = sim.acc_sram[touched].to(torch.int8)
            stats.alu_ops += grid.size * s.batch * s.block_out
            stats.coalesced_alu_insns += 1

    # ------------------------------------------------------------------
    # tile resolution through the CUDA kernels
    # ------------------------------------------------------------------
    @staticmethod
    def _to_matrix(blocked: torch.Tensor, spec: HardwareSpec) -> torch.Tensor:
        """(io, ii, batch, block_out) -> (io*batch, ii*block_out)."""
        io, ii = blocked.shape[0], blocked.shape[1]
        return blocked.permute(0, 2, 1, 3).reshape(io * spec.batch,
                                                   ii * spec.block_out)

    @staticmethod
    def _from_matrix(mat: torch.Tensor, io: int, ii: int,
                     spec: HardwareSpec) -> torch.Tensor:
        """(io*batch, ii*block_out) -> (io, ii, batch, block_out)."""
        return (mat.reshape(io, spec.batch, ii, spec.block_out)
                .permute(0, 2, 1, 3))

    def _materialize(self, st: _RunState, tile: _PendingTile,
                     stats: RunStats) -> None:
        s = st.sim.spec
        io, ii = tile.grid.shape
        R, C = io * s.batch, ii * s.block_out
        if tile.chunks:
            plan = self._plan_tile(tile, stats)
            acc = self._resolve_tiles([tile], [plan], [stats], s)[0]
        else:
            acc = torch.zeros((R, C), dtype=torch.int32,
                              device=st.sim.torch_device)
            if tile.alu_chain:
                acc = self._alu_chain(acc, tile.alu_chain)
        self._writeback(st, tile, acc, stats)

    def _writeback(self, st: _RunState, tile: _PendingTile,
                   acc: torch.Tensor, stats: RunStats) -> None:
        sim = st.sim
        s = sim.spec
        io, ii = tile.grid.shape
        sim.acc_sram[sim.index(tile.grid)] = self._from_matrix(acc, io, ii, s)
        # §2.5 write-through mirror: OUT narrows with a truncating cast
        idx = sim.index(tile.indices)
        sim.out_sram[idx] = sim.acc_sram[idx].to(torch.int8)
        stats.tiles_resolved += 1

    @staticmethod
    def _requant_shift(chain: Sequence[tuple]) -> Optional[int]:
        """If the epilogue is exactly [SHR s >= 0,] MAX -128, MIN 127 it is
        the kernel's fused requant epilogue; returns s (0 when no shift)."""
        ops = list(chain)
        shift = 0
        if ops and ops[0][:2] == ("imm", "shr") and ops[0][2] >= 0:
            shift = ops[0][2]
            ops = ops[1:]
        if [o[:3] for o in ops] == [("imm", "max", -128), ("imm", "min", 127)]:
            return shift
        return None

    @staticmethod
    def _w_host(c: _GemmChunk, stats: RunStats) -> np.ndarray:
        """Host copy of a chunk's weights for the exact weight-content
        keys: a device-to-host copy on the card, made once per chunk and
        counted in ``stats.content_key_*`` (its time includes waiting for
        the work queued before it)."""
        if c.w_host is None:
            t0 = time.perf_counter()
            c.w_host = c.w.cpu().numpy()
            stats.content_key_s += time.perf_counter() - t0
            stats.content_key_copies += 1
            stats.content_key_bytes += c.w_host.nbytes
        return c.w_host

    def _plan_tile(self, tile: _PendingTile, stats: RunStats):
        """Stage 1+2 of tile resolution (bookkeeping; no kernels):
        chunks that accumulated onto the *same* grid (the reduction loop)
        concatenate along K; grids that multiplied the *same* weight tile
        — the direct-conv structure, one instruction per output row —
        row-stack into one GEMM per distinct weight tile.  Returns
        (wgroups, shift): wgroups = [(W, W_host, [(grid, A), ...]), ...];
        shift is the requant shift when the ALU chain fuses into the
        kernel epilogue (chunk grids pairwise disjoint + canonical
        shr/clip chain), else None.  Weight identity is decided on exact
        host bytes, as the reference decides it.  Memoized on the tile
        until it gains a chunk or an ALU step."""
        memo = tile.plan_memo
        if memo is not None and memo[:2] == (len(tile.chunks),
                                             len(tile.alu_chain)):
            return memo[2]
        merged: List[Tuple[np.ndarray, List[_GemmChunk]]] = []
        index: Dict[tuple, int] = {}
        for c in tile.chunks:
            key = (c.grid.shape, c.grid.tobytes())
            if key in index:
                merged[index[key]][1].append(c)
            else:
                index[key] = len(merged)
                merged.append((c.grid, [c]))
        groups = []
        for g, cs in merged:
            if len(cs) == 1:
                groups.append((g, cs[0].a, cs[0].w,
                               self._w_host(cs[0], stats)))
            else:
                groups.append((g, torch.cat([c.a for c in cs], dim=1),
                               torch.cat([c.w for c in cs], dim=1),
                               np.concatenate([self._w_host(c, stats)
                                               for c in cs], axis=1)))

        n_ids = sum(g.size for g, _, _, _ in groups)
        disjoint = np.unique(
            np.concatenate([g.ravel() for g, _, _, _ in groups])).size \
            == n_ids
        shift = self._requant_shift(tile.alu_chain) if disjoint else None

        wgroups: List[Tuple[torch.Tensor, np.ndarray,
                            List[Tuple[np.ndarray, torch.Tensor]]]] = []
        windex: Dict[tuple, int] = {}
        for g, A, W, W_host in groups:
            key = (W_host.shape, W_host.tobytes())
            if key in windex:
                wgroups[windex[key]][2].append((g, A))
            else:
                windex[key] = len(wgroups)
                wgroups.append((W, W_host, [(g, A)]))
        plan = (wgroups, shift)
        tile.plan_memo = (len(tile.chunks), len(tile.alu_chain), plan)
        return plan

    @staticmethod
    def _pre_key(tile: _PendingTile) -> tuple:
        """O(#chunks) structural fingerprint (no data copies) used to
        pre-filter batch-peer candidates before the full plan is built."""
        base = int(tile.indices[0])
        return (tile.grid.shape, (tile.grid - base).tobytes(),
                tuple((c.grid.shape, tuple(c.a.shape), tuple(c.w.shape))
                      for c in tile.chunks),
                tuple((k, op, x) if k == "imm" else (k, op, tuple(x.shape))
                      for k, op, x in tile.alu_chain))

    @staticmethod
    def _plan_key(tile: _PendingTile, plan) -> tuple:
        """Structural signature of a tile's resolution plan.  Tiles with
        equal keys (peer virtual-thread contexts of one op) run the same
        kernel shapes over the same relative index structure and can be
        resolved by ONE launch per GEMM stage (the kernel's tile axis)."""
        wgroups, shift = plan
        base = int(tile.indices[0])
        alu_sig = tuple(
            (k, op, x) if k == "imm" else (k, op, tuple(x.shape))
            for k, op, x in tile.alu_chain)
        return (shift, tile.grid.shape, (tile.grid - base).tobytes(),
                alu_sig,
                tuple((W_host.shape,
                       tuple((g.shape, (g - base).tobytes(), tuple(A.shape))
                             for g, A in parts))
                      for _, W_host, parts in wgroups))

    def _resolve_tiles(self, tiles: Sequence[_PendingTile],
                       plans: Sequence[tuple], statss: Sequence[RunStats],
                       spec: HardwareSpec, key: Optional[tuple] = None
                       ) -> List[torch.Tensor]:
        """Execute structurally-identical tile plans (``key``: their plan
        key, computed when not given): per GEMM stage the
        tiles' operands stack along the kernel's leading tile axis and
        run as ONE ``vta_gemm`` launch — cutting per-tile launch overhead;
        requant fuses into the kernel epilogue exactly as in the per-tile
        path.  Sub-byte weights on
        decode-shaped groups go through ``lut_gemm`` instead (the same
        operands and epilogue, a bit-identical result; the reference's
        ``jax.vmap(lut_gemm_pallas)`` is the kernel's tile axis here).
        The GEMM outputs then go, in place, through ONE
        ``tensor_alu_scatter`` launch for the batch, which sums each
        tile's parts into the tile's layout and applies the ALU chain
        (its first run: at most ALU_MAX_OPS steps and one tensor operand;
        the rest, which no lowering emits, through ``tensor_alu``); a
        tile whose one GEMM output is already in its layout, with no
        chain, takes no launch.
        Returns one assembled (R, C) int32 accumulator matrix per tile.

        ``statss`` is parallel to ``tiles`` (gang members contribute
        tiles with their own RunStats); each distinct stats object counts
        every launch it participated in exactly once."""
        T = len(tiles)
        wgroups0, shift = plans[0]
        kw = dict(epilogue="requant", shift=shift) if shift is not None \
            else {}
        # per tile, its GEMM output of each weight group
        srcs: List[List[torch.Tensor]] = [[] for _ in range(T)]
        for wi in range(len(wgroups0)):
            bm = 128   # the reference's row block: its launch-cost unit
            A_alls: List[torch.Tensor] = []
            Ws: List[torch.Tensor] = []
            W_hosts: List[np.ndarray] = []
            for wgroups, _shift in plans:
                W, W_host, parts = wgroups[wi]
                A_alls.append(parts[0][1] if len(parts) == 1 else
                              torch.cat([A for _, A in parts], dim=0))
                Ws.append(W)
                W_hosts.append(W_host)
            Rg = A_alls[0].shape[0]
            Rp = -(-Rg // bm) * bm
            # per-shape kernel choice: sub-byte weights on decode-shaped
            # tiles go through the T-MAC LUT kernel (same operands, same
            # epilogue contract, bit-identical output)
            use_lut = self._lut_select(spec, Rg)
            if use_lut:
                gemm_call = functools.partial(lut_gemm, bits=spec.wgt_bits,
                                              **kw)
            else:
                gemm_call = functools.partial(vta_gemm, **kw)
            # tiles whose weight DATA is identical (gang members serving
            # the same constant weights) can row-concat into one taller
            # GEMM instead of spending a tile-axis slot each.  The choice
            # is the reference's: by padded-row cost, ~64 rows standing
            # for the fixed cost of an extra launch.
            subgroups: Dict[bytes, List[int]] = {}
            for t, W_host in enumerate(W_hosts):
                subgroups.setdefault(W_host.tobytes(), []).append(t)
            cost_vmap = T * Rp
            cost_concat = sum(-(-(len(g) * Rg) // bm) * bm
                              for g in subgroups.values()) \
                + 64 * (len(subgroups) - 1)
            if len(subgroups) < T and cost_concat < cost_vmap:
                for g in subgroups.values():
                    A = torch.cat([A_alls[t] for t in g], dim=0)
                    out = gemm_call(A, Ws[g[0]].T)
                    for s_ in {id(statss[t]): statss[t] for t in g}.values():
                        s_.tile_batches += 1
                        s_.lut_launches += int(use_lut)
                    for j, t in enumerate(g):
                        srcs[t].append(out[j * Rg:(j + 1) * Rg])
            else:
                if T == 1:
                    outs = gemm_call(A_alls[0], Ws[0].T)[None]
                else:
                    outs = gemm_call(torch.stack(A_alls),
                                     torch.stack(Ws).transpose(1, 2))
                for s_ in {id(s_): s_ for s_ in statss}.values():
                    s_.tile_batches += 1
                    s_.lut_launches += int(use_lut)
                for t in range(T):
                    srcs[t].append(outs[t])

        tile0 = tiles[0]
        chain = tile0.alu_chain if shift is None else []
        parts0 = wgroups0[0][2]
        g0 = parts0[0][0]
        if len(wgroups0) == 1 and len(parts0) == 1 and not chain \
                and g0.shape == tile0.grid.shape and (g0 == tile0.grid).all():
            return [srcs[t][0].to(torch.int32) for t in range(T)]
        bmap = self._block_map(self._plan_key(tile0, plans[0])
                               if key is None else key, tile0, wgroups0,
                               spec)
        # the first run of the chain: at most ALU_MAX_OPS steps reading
        # one tensor operand (the same object in every tile)
        n, ti = 0, None
        for i, (kind, _, _) in enumerate(chain[:ALU_MAX_OPS]):
            if kind == "tensor":
                if ti is not None and any(
                        t.alu_chain[i][2] is not t.alu_chain[ti][2]
                        for t in tiles):
                    break
                ti = i if ti is None else ti
            n = i + 1
        first = tuple((op, None if kind == "tensor" else y)
                      for kind, op, y in chain[:n])
        bias = None if ti is None else [t.alu_chain[ti][2] for t in tiles]
        accs = list(tensor_alu_scatter(srcs, bmap, bias, chain=first))
        if len(chain) > n:
            accs = self._alu_chain_batch(accs,
                                         [t.alu_chain[n:] for t in tiles])
        return accs

    @staticmethod
    def _block_map(key: tuple, tile: _PendingTile, wgroups,
                   spec: HardwareSpec) -> BlockMap:
        """The scatter's block map of this tile structure, built on the
        first tile batch of the structure and kept (with its device copy)
        in the process-wide LRU cache.  Grids are taken relative to the
        tile's first entry, as the plan key takes them."""
        global _BLOCK_MAP_BUILDS
        with _BLOCK_MAP_LOCK:
            hit = _BLOCK_MAPS.pop(key, None)
            if hit is not None:
                _BLOCK_MAPS[key] = hit
                return hit
        base = int(tile.indices[0])
        groups = []
        for _, _, parts in wgroups:
            rows, lst = 0, []
            for g, A in parts:
                lst.append((g - base, rows))
                rows += A.shape[0]
            groups.append(lst)
        bmap = BlockMap(tile.grid - base, groups, spec.batch, spec.block_out)
        with _BLOCK_MAP_LOCK:
            while len(_BLOCK_MAPS) >= _BLOCK_MAP_CAP:
                _BLOCK_MAPS.pop(next(iter(_BLOCK_MAPS)))
            _BLOCK_MAPS[key] = bmap
            _BLOCK_MAP_BUILDS += 1
        return bmap

    def _alu_chain_batch(self, accs: List[torch.Tensor],
                         chains: Sequence[Sequence[tuple]]
                         ) -> List[torch.Tensor]:
        """Apply structurally-identical per-tile ALU chains to the whole
        tile batch in one pass: accumulators row-stack into a single
        matrix, tensor operands (bias rows) stack the same way, and each
        chain step becomes ONE tensor_alu launch for all tiles."""
        T = len(accs)
        if T == 1:
            return [self._alu_chain(accs[0], chains[0])]
        R = accs[0].shape[0]
        x = torch.cat(accs, dim=0)
        chain: List[tuple] = []
        for i, entry in enumerate(chains[0]):
            if entry[0] == "imm":
                chain.append(entry)
            else:
                chain.append(("tensor", entry[1],
                              torch.cat([c[i][2] for c in chains], dim=0)))
        out = self._alu_chain(x, chain)
        return [out[t * R:(t + 1) * R] for t in range(T)]

    @staticmethod
    def _alu_chain(acc: torch.Tensor, chain: Sequence[tuple]) -> torch.Tensor:
        """Apply the recorded epilogue: each run of steps that reads at
        most one distinct tensor operand is one tensor_alu pass, so every
        epilogue the lowerings emit (bias add, shift, clip) is one pass."""
        x, ops, src = acc, [], None
        for kind, op, y in chain:
            if kind == "tensor":
                if src is not None and y is not src:
                    x, ops = tensor_alu(x, src, chain=tuple(ops)), []
                src, y = y, None
            ops.append((op, y))
        return tensor_alu(x, src, chain=tuple(ops)) if ops else x


def assert_fast_path(stats: Union[RunStats, Sequence[RunStats]],
                     allow_eager_alu: bool = False) -> None:
    """Assert that a CudaBackend run took zero eager-loop iterations.

    The eager per-uop numpy loop is the correctness net, not the product:
    schedules that are supposed to be on the kernel fast path (matmul,
    direct conv, im2col conv, 1x1-via-GEMM, dense vector ALU) must never
    hit it.  Accepts one RunStats or a sequence (e.g.
    ``CompiledProgram.last_stats``)."""
    all_stats = [stats] if isinstance(stats, RunStats) else list(stats)
    for s in all_stats:
        if s.backend != "cuda":
            continue
        if s.eager_gemm_insns:
            raise AssertionError(
                f"{s.eager_gemm_insns} GEMM instruction(s) fell back to "
                f"the eager loop ({s.coalesced_gemm_insns} coalesced)")
        if s.eager_alu_insns and not allow_eager_alu:
            raise AssertionError(
                f"{s.eager_alu_insns} ALU instruction(s) fell back to "
                f"the eager loop ({s.coalesced_alu_insns} coalesced)")


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------
_REGISTRY = {"simulator": SimulatorBackend, "cuda": CudaBackend}

BackendLike = Union[None, str, ExecutionBackend]


def resolve_backend(backend: BackendLike = None) -> ExecutionBackend:
    """None -> CudaBackend (the normal entry points run on the kernels);
    a name -> registry lookup ("simulator" is the oracle); an instance
    passes through unchanged."""
    if backend is None:
        return CudaBackend()
    if isinstance(backend, str):
        try:
            return _REGISTRY[backend]()
        except KeyError:
            raise ValueError(f"unknown execution backend {backend!r}; "
                             f"known: {sorted(_REGISTRY)}") from None
    return backend


# ----------------------------------------------------------------------
# differential testing across engines
# ----------------------------------------------------------------------
@dataclass
class BackendRun:
    backend: str
    stats: RunStats
    device: Device


@dataclass
class CrossBackendReport:
    runs: List[BackendRun]
    matches: bool
    mismatched_bytes: int

    def run_for(self, name: str) -> BackendRun:
        for r in self.runs:
            if r.backend == name:
                return r
        raise KeyError(name)

    def device_for(self, name: str) -> Device:
        return self.run_for(name).device

    def stats_for(self, name: str) -> RunStats:
        return self.run_for(name).stats

    def speedup(self, slow: str = "simulator", fast: str = "cuda") -> float:
        return (self.stats_for(slow).wall_time_s
                / max(self.stats_for(fast).wall_time_s, 1e-12))


class CrossBackendChecker:
    """Run one encoded task-ISA stream on several backends against cloned
    devices and diff the resulting DRAM images byte-for-byte — the
    simulator-vs-hardware differential flow of the paper, with the
    simulator as the oracle for the CUDA fast path."""

    def __init__(self, backends: Sequence[BackendLike] = ("simulator",
                                                          "cuda")):
        self.backends = [resolve_backend(b) for b in backends]
        if len(self.backends) < 2:
            raise ValueError("need at least two backends to cross-check")

    def run(self, spec: HardwareSpec, device: Device, stream: np.ndarray,
            timing: Optional[TimingModel] = None) -> CrossBackendReport:
        runs = []
        for b in self.backends:
            dev = device.clone()
            runs.append(BackendRun(b.name, b.execute(spec, dev, stream,
                                                     timing=timing), dev))
        ref = runs[0].device.dram.mem
        mismatched = 0
        for r in runs[1:]:
            mismatched += int(torch.count_nonzero(ref != r.device.dram.mem))
        return CrossBackendReport(runs=runs, matches=mismatched == 0,
                                  mismatched_bytes=mismatched)

    def check_runtime(self, rt, timing: Optional[TimingModel] = None,
                      adopt: str = "simulator") -> CrossBackendReport:
        """Finalize `rt`'s pending stream, run it on every backend, then
        adopt the named backend's memory image into rt.device so scheduled
        results remain readable through the usual read_* helpers."""
        stream = rt.finalize_stream()
        report = self.run(rt.spec, rt.device, stream, timing=timing)
        rt.device.copy_from(report.device_for(adopt))
        rt.stats_history.extend(r.stats for r in report.runs)
        rt.reset_stream()
        return report
