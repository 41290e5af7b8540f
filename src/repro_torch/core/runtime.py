"""VTA JIT runtime (§3): instruction-stream + micro-kernel generation.

Python port of the paper's C++ runtime API.  Responsibilities (§3.2):
  * dynamic memory allocation / buffer management (physically contiguous);
  * 2D DMA instruction generation (`load_buffer_2d` / `store_buffer_2d`,
    i.e. VTALoadBuffer2D / VTAStoreBuffer2D);
  * micro-op kernel generation + DRAM caching + LRU residency management of
    the on-chip uop cache (VTAUopLoopBegin/Push/LoopEnd);
  * explicit dependence management (VTADepPush / VTADepPop, Fig. 12);
  * CPU↔accelerator synchronization (VTASynchronize → runs the simulator).

The runtime *adapts to the HardwareSpec*: all encodings, element sizes and
SRAM budgets are derived from the spec instance, mirroring the paper's
co-design fluidity.

The device's DRAM image lives on a torch device: ``torch_device`` (default
``"cuda"``) is passed to the ``Device`` the runtime makes when it is not
given one.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .driver import Device, TorchDeviceLike
from .hwspec import HardwareSpec
from .isa import (AluInsn, AluOp, DepFlags, DEP_IN_EDGES, DEP_OUT_EDGES,
                  FinishInsn, GemmInsn, Insn, IsaLayout, LoadStoreInsn,
                  MemId, Opcode, route_queue, LOAD_Q, COMPUTE_Q, STORE_Q)
from .microop import UOp, UopLayout
from .simulator import RunStats, TimingModel, _MODULE_NAMES


# ----------------------------------------------------------------------
# micro-kernel construction (VTAUopLoopBegin / VTAUopPush / VTAUopLoopEnd)
# ----------------------------------------------------------------------
@dataclass
class LoopLevel:
    extent: int
    dst_factor: int
    src_factor: int
    wgt_factor: int


@dataclass
class UopKernel:
    """A micro-coded kernel: a uop sequence + up to two affine loop levels."""
    uops: List[UOp]
    loops: List[LoopLevel]
    key: str = ""
    dram_addr: int = -1          # where the encoded uops live in DRAM
    sram_base: int = -1          # uop-cache residency (managed by runtime)

    @property
    def iter_out(self) -> int:
        return self.loops[0].extent if len(self.loops) >= 1 else 1

    @property
    def iter_in(self) -> int:
        return self.loops[1].extent if len(self.loops) >= 2 else 1

    def factors(self) -> Tuple[int, int, int, int, int, int]:
        l0 = self.loops[0] if len(self.loops) >= 1 else LoopLevel(1, 0, 0, 0)
        l1 = self.loops[1] if len(self.loops) >= 2 else LoopLevel(1, 0, 0, 0)
        return (l0.dst_factor, l1.dst_factor, l0.src_factor,
                l1.src_factor, l0.wgt_factor, l1.wgt_factor)


class UopBuilder:
    def __init__(self):
        self._loops: List[LoopLevel] = []
        self._uops: List[UOp] = []

    def loop_begin(self, extent: int, dst_factor: int, src_factor: int,
                   wgt_factor: int = 0) -> None:
        if len(self._loops) >= 2:
            raise ValueError("VTA supports at most 2 uop loop levels")
        self._loops.append(LoopLevel(extent, dst_factor, src_factor, wgt_factor))

    def loop_end(self) -> None:
        if not self._loops:
            raise ValueError("loop_end without loop_begin")
        # loops stay recorded; end just closes nesting for API symmetry

    def push(self, dst: int, src: int, wgt: int = 0) -> None:
        self._uops.append(UOp(dst, src, wgt))

    def build(self) -> UopKernel:
        if not self._uops:
            raise ValueError("empty micro-kernel")
        return UopKernel(uops=self._uops, loops=list(self._loops))


# ----------------------------------------------------------------------
# the runtime
# ----------------------------------------------------------------------
class Runtime:
    def __init__(self, spec: HardwareSpec, device: Optional[Device] = None,
                 torch_device: TorchDeviceLike = None,
                 dram_size: int = 1 << 28):
        self.spec = spec
        self.device = device or Device(dram_size, torch_device=torch_device)
        self.isa = IsaLayout(spec)
        self.uop_layout = UopLayout(spec)

        self._stream: List[Insn] = []
        # DepPop is recorded *before* the target instruction is pushed
        self._pending_pop: Dict[int, Dict[str, bool]] = {
            LOAD_Q: {}, COMPUTE_Q: {}, STORE_Q: {}}
        # index of last instruction per queue (for DepPush)
        self._last_in_queue: Dict[int, Optional[int]] = {
            LOAD_Q: None, COMPUTE_Q: None, STORE_Q: None}

        # uop cache management
        self._kernel_cache: Dict[str, UopKernel] = {}
        self._resident: Dict[str, UopKernel] = {}   # key -> kernel, LRU order
        self._uop_cursor = 0                        # bump allocator in uop SRAM

        # profiling
        self.stats_history: List[RunStats] = []

    # ------------------------------------------------------------------
    # buffer management (VTABufferAlloc / VTABufferCopy)
    # ------------------------------------------------------------------
    def buffer_alloc(self, nbytes: int, align: int = 64) -> int:
        return self.device.dram.alloc(nbytes, align=align)

    def copy_to_device(self, arr: np.ndarray, align: int = 256) -> int:
        addr = self.device.dram.alloc(arr.nbytes, align=align)
        self.device.dram.write(addr, arr)
        self.device.flush_cache(addr, arr.nbytes)
        return addr

    def copy_from_device(self, addr: int, nbytes: int, dtype, shape,
                         device: Optional[Device] = None) -> np.ndarray:
        """`device` overrides the runtime's own device so results can be
        read from a cross-backend checker clone."""
        dev = device if device is not None else self.device
        dev.invalidate_cache(addr, nbytes)
        return dev.dram.read(addr, nbytes, dtype=dtype, shape=shape)

    def elem_bytes(self, mem: MemId) -> int:
        s = self.spec
        return {MemId.UOP: s.uop_elem_bytes, MemId.WGT: s.wgt_elem_bytes,
                MemId.INP: s.inp_elem_bytes, MemId.ACC: s.acc_elem_bytes,
                MemId.OUT: s.out_elem_bytes}[mem]

    def to_elem_addr(self, byte_addr: int, mem: MemId) -> int:
        eb = self.elem_bytes(mem)
        if byte_addr % eb:
            raise ValueError(f"address {byte_addr} not aligned to {mem.name} "
                             f"element size {eb}")
        return byte_addr // eb

    # ------------------------------------------------------------------
    # dependence management (VTADepPush / VTADepPop)
    # ------------------------------------------------------------------
    @staticmethod
    def _edge(from_q: int, to_q: int) -> Tuple[str, str]:
        """Returns (push_flag_on_from, pop_flag_on_to)."""
        if (from_q, to_q) == (LOAD_Q, COMPUTE_Q):
            return "push_next", "pop_prev"
        if (from_q, to_q) == (COMPUTE_Q, LOAD_Q):
            return "push_prev", "pop_next"
        if (from_q, to_q) == (COMPUTE_Q, STORE_Q):
            return "push_next", "pop_prev"
        if (from_q, to_q) == (STORE_Q, COMPUTE_Q):
            return "push_prev", "pop_next"
        raise ValueError(f"no dependence edge between queues {from_q}->{to_q}")

    def dep_push(self, from_q: int, to_q: int) -> None:
        """Token will be *produced* by the most recent instruction of from_q."""
        push_flag, _ = self._edge(from_q, to_q)
        idx = self._last_in_queue[from_q]
        if idx is None:
            raise ValueError("dep_push before any instruction in source queue")
        setattr(self._stream[idx].dep, push_flag, True)

    def dep_pop(self, from_q: int, to_q: int) -> None:
        """Token will be *consumed* by the next instruction pushed to to_q."""
        _, pop_flag = self._edge(from_q, to_q)
        self._pending_pop[to_q][pop_flag] = True

    def _push_insn(self, insn: Insn) -> int:
        q = route_queue(insn)
        for flag, v in self._pending_pop[q].items():
            if v:
                setattr(insn.dep, flag, True)
        self._pending_pop[q] = {}
        self._stream.append(insn)
        idx = len(self._stream) - 1
        self._last_in_queue[q] = idx
        return idx

    def noop(self, queue: int) -> int:
        """Zero-extent instruction: no memory effect, but it occupies a slot
        in its module's FIFO and can carry dependence flags — the program
        compiler's barrier primitive for cross-op WAR/RAW joins in a
        composed stream."""
        if queue == LOAD_Q:
            return self._push_insn(LoadStoreInsn(
                opcode=Opcode.LOAD, dep=DepFlags(), memory_type=MemId.INP,
                sram_base=0, dram_base=0, y_size=0, x_size=0, x_stride=0))
        if queue == STORE_Q:
            return self._push_insn(LoadStoreInsn(
                opcode=Opcode.STORE, dep=DepFlags(), memory_type=MemId.OUT,
                sram_base=0, dram_base=0, y_size=0, x_size=0, x_stride=0))
        if queue == COMPUTE_Q:
            return self._push_insn(GemmInsn(
                dep=DepFlags(), reset=False, uop_bgn=0, uop_end=0,
                iter_out=0, iter_in=0, dst_factor_out=0, dst_factor_in=0,
                src_factor_out=0, src_factor_in=0, wgt_factor_out=0,
                wgt_factor_in=0))
        raise ValueError(f"unknown queue {queue}")

    def token_balance(self, start: int = 0) -> Dict[str, int]:
        """Net token count per dependence FIFO over the stream suffix —
        the tokens that would remain unconsumed if the suffix ran alone."""
        bal = {"l2c": 0, "c2l": 0, "c2s": 0, "s2c": 0}
        for insn in self._stream[start:]:
            q = route_queue(insn)
            for fifo, flag in DEP_IN_EDGES[q]:
                if getattr(insn.dep, flag):
                    bal[fifo] -= 1
            for fifo, flag in DEP_OUT_EDGES[q]:
                if getattr(insn.dep, flag):
                    bal[fifo] += 1
        return bal

    # dependence FIFO -> (producer queue, consumer queue); the consumer
    # queue is where a drain noop must live to pop the token
    _FIFO_EDGE = {"c2l": (COMPUTE_Q, LOAD_Q), "c2s": (COMPUTE_Q, STORE_Q),
                  "l2c": (LOAD_Q, COMPUTE_Q), "s2c": (STORE_Q, COMPUTE_Q)}

    def _drain_fifo(self, fifo: str, count: int) -> None:
        """Consume `count` tokens from one dependence FIFO on noops of
        its consumer queue — the stale-token-pairing primitive shared by
        drain_dep_tokens, join_barrier, and buffer_fence."""
        from_q, to_q = self._FIFO_EDGE[fifo]
        for _ in range(count):
            self.dep_pop(from_q, to_q)
            self.noop(to_q)

    def drain_dep_tokens(self) -> None:
        """Consume every unmatched dependence token in the four FIFOs.

        Required between schedules composed into one stream: tokens are
        information-less, so a schedule's k-th pop pairs with the k-th
        push in FIFO order.  Stale tokens from a predecessor shift that
        pairing one generation early and silently break the successor's
        own WAR protocol — drain first, then compose."""
        if any(self._pending_pop[q] for q in self._pending_pop):
            raise RuntimeError(
                "drain_dep_tokens called with an un-attached dep_pop pending")
        bal = self.token_balance()
        for fifo in ("c2l", "c2s", "l2c", "s2c"):
            self._drain_fifo(fifo, bal[fifo])

    def clear_pending_pop(self, queue: int) -> None:
        """Cancel dep_pops registered for `queue` but not yet attached to
        an instruction (the compiler's fence fallback path)."""
        self._pending_pop[queue] = {}

    def buffer_fence(self, consumer_loads: bool = True) -> None:
        """Buffer-granular producer->consumer fence: the cheap alternative
        to ``join_barrier`` for dependent ops in one composed stream.

        Serializes one edge only — instructions that pop the fence token
        wait until every STORE emitted so far has completed (the
        producer's DRAM image is final); nothing else rendezvouses.
        Construction::

            store-noop ──s2c──> compute-noop [──c2l──> first fenced LOAD]

        The store noop sits behind every producer store in the store
        FIFO, so its s2c push publishes "all stores done"; the compute
        noop(s) pop it — stale s2c tokens are consumed first so the FIFO
        pairing stays aligned (tokens are information-less, see
        ``drain_dep_tokens``).  With ``consumer_loads`` the last compute
        noop also pushes c2l and the *caller* chooses which load pops it
        (``dep_pop(COMPUTE_Q, LOAD_Q)`` immediately before emitting the
        consumer's first load of the produced buffer).  Loads emitted
        before that pop — e.g. the consumer's first weight tile — run
        while the producer's epilogue and store tail are still draining,
        which is what lets dependent layers double-buffer across the op
        boundary.  Unlike ``join_barrier``, the consumer's stores are
        never gated and no load/compute rendezvous is inserted.
        """
        if not self._stream:
            return
        if any(self._pending_pop[q] for q in self._pending_pop):
            raise RuntimeError(
                "buffer_fence called with an un-attached dep_pop pending")
        bal = self.token_balance()
        # stale WAR tokens would shift the consumer's own push/pop pairing
        # one generation early; consume them on noops that retire as soon
        # as their producing instruction completes
        for fifo in ("c2l", "l2c", "c2s"):
            self._drain_fifo(fifo, bal[fifo])
        # the fence proper: one store noop behind every producer store...
        self.noop(STORE_Q)
        self.dep_push(STORE_Q, COMPUTE_Q)
        # ...whose token the LAST of these compute noops pops (the first
        # bal["s2c"] pops consume the producers' own trailing WAR pushes)
        self._drain_fifo("s2c", bal["s2c"] + 1)
        if consumer_loads:
            self.dep_push(COMPUTE_Q, LOAD_Q)

    def join_barrier(self) -> None:
        """Full cross-module rendezvous: every instruction emitted after
        the barrier starts only after every instruction before it has
        completed, on all three modules.

        Construction (compute is the hub — the only module with edges to
        and from both others): drain stale tokens so the FIFOs are empty,
        then  load-noop ─l2c→ ┐
              store-noop─s2c→ ┼→ compute-join ─c2l→ load-noop
                              └────────────────c2s→ store-noop
        FIFO order serializes each module's later instructions behind its
        resume noop, hence behind the join, hence behind everything."""
        if not self._stream:
            return
        self.drain_dep_tokens()
        self.noop(LOAD_Q)
        self.dep_push(LOAD_Q, COMPUTE_Q)
        self.noop(STORE_Q)
        self.dep_push(STORE_Q, COMPUTE_Q)
        self.dep_pop(LOAD_Q, COMPUTE_Q)
        self.dep_pop(STORE_Q, COMPUTE_Q)
        self.noop(COMPUTE_Q)
        self.dep_push(COMPUTE_Q, LOAD_Q)
        self.dep_push(COMPUTE_Q, STORE_Q)
        self.dep_pop(COMPUTE_Q, LOAD_Q)
        self.noop(LOAD_Q)
        self.dep_pop(COMPUTE_Q, STORE_Q)
        self.noop(STORE_Q)

    # ------------------------------------------------------------------
    # DMA instruction generation
    # ------------------------------------------------------------------
    def load_buffer_2d(self, mem: MemId, sram_base: int, dram_elem_base: int,
                       y_size: int, x_size: int, x_stride: int,
                       y_pad_0: int = 0, y_pad_1: int = 0,
                       x_pad_0: int = 0, x_pad_1: int = 0) -> int:
        return self._push_insn(LoadStoreInsn(
            opcode=Opcode.LOAD, dep=DepFlags(), memory_type=mem,
            sram_base=sram_base, dram_base=dram_elem_base,
            y_size=y_size, x_size=x_size, x_stride=x_stride,
            y_pad_0=y_pad_0, y_pad_1=y_pad_1, x_pad_0=x_pad_0, x_pad_1=x_pad_1))

    def store_buffer_2d(self, sram_base: int, dram_elem_base: int,
                        y_size: int, x_size: int, x_stride: int) -> int:
        return self._push_insn(LoadStoreInsn(
            opcode=Opcode.STORE, dep=DepFlags(), memory_type=MemId.OUT,
            sram_base=sram_base, dram_base=dram_elem_base,
            y_size=y_size, x_size=x_size, x_stride=x_stride))

    # ------------------------------------------------------------------
    # micro-kernel generation + uop-cache residency (LRU, §3.2)
    # ------------------------------------------------------------------
    def uop_kernel(self, builder_fn: Callable[[UopBuilder], None],
                   key: Optional[str] = None) -> UopKernel:
        """JIT a micro-kernel; cached in DRAM for the program lifetime."""
        b = UopBuilder()
        builder_fn(b)
        kernel = b.build()
        if key is None:
            sig = repr([(l.extent, l.dst_factor, l.src_factor, l.wgt_factor)
                        for l in kernel.loops] + kernel.uops)
            key = hashlib.sha1(sig.encode()).hexdigest()[:16]
        if key in self._kernel_cache:
            return self._kernel_cache[key]
        kernel.key = key
        words = self.uop_layout.encode_kernel(kernel.uops)
        kernel.dram_addr = self.copy_to_device(
            words, align=self.spec.uop_elem_bytes)
        self._kernel_cache[key] = kernel
        return kernel

    def _ensure_resident(self, kernel: UopKernel) -> None:
        """Make the kernel resident in uop SRAM, LRU-evicting as needed.
        Safe because uop LOADs and compute ops share the compute queue
        (FIFO order ⇒ no hazard)."""
        n = len(kernel.uops)
        if kernel.key in self._resident:
            self._resident.pop(kernel.key)          # refresh LRU position
            self._resident[kernel.key] = kernel
            return
        if n > self.spec.uop_depth:
            raise ValueError(f"micro-kernel of {n} uops exceeds uop cache "
                             f"depth {self.spec.uop_depth}")
        if self._uop_cursor + n > self.spec.uop_depth:
            # wrap-around: invalidate everything (simple two-space LRU à la VTA)
            self._resident.clear()
            self._uop_cursor = 0
        kernel.sram_base = self._uop_cursor
        self._uop_cursor += n
        self._resident[kernel.key] = kernel
        self.load_buffer_2d(
            MemId.UOP, sram_base=kernel.sram_base,
            dram_elem_base=self.to_elem_addr(kernel.dram_addr, MemId.UOP),
            y_size=1, x_size=n, x_stride=n)

    # ------------------------------------------------------------------
    # compute instruction generation
    # ------------------------------------------------------------------
    def push_gemm(self, kernel: UopKernel, reset: bool = False) -> int:
        self._ensure_resident(kernel)
        dfo, dfi, sfo, sfi, wfo, wfi = kernel.factors()
        return self._push_insn(GemmInsn(
            dep=DepFlags(), reset=reset,
            uop_bgn=kernel.sram_base, uop_end=kernel.sram_base + len(kernel.uops),
            iter_out=kernel.iter_out, iter_in=kernel.iter_in,
            dst_factor_out=dfo, dst_factor_in=dfi,
            src_factor_out=sfo, src_factor_in=sfi,
            wgt_factor_out=wfo, wgt_factor_in=wfi))

    def push_alu(self, kernel: UopKernel, op: AluOp, imm: int = 0,
                 use_imm: bool = True, reset: bool = False) -> int:
        self._ensure_resident(kernel)
        dfo, dfi, sfo, sfi, _, _ = kernel.factors()
        return self._push_insn(AluInsn(
            dep=DepFlags(), reset=reset,
            uop_bgn=kernel.sram_base, uop_end=kernel.sram_base + len(kernel.uops),
            iter_out=kernel.iter_out, iter_in=kernel.iter_in,
            dst_factor_out=dfo, dst_factor_in=dfi,
            src_factor_out=sfo, src_factor_in=sfi,
            alu_opcode=op, use_imm=use_imm, imm=imm))

    # ------------------------------------------------------------------
    # stream validation + synchronize
    # ------------------------------------------------------------------
    def validate_stream(self, require_net_zero: bool = False,
                        start: int = 0) -> None:
        """Exact static deadlock check: replay the stream the way the three
        modules execute it — each consumes its command queue in FIFO order,
        predicated on the four dependence-token FIFOs.  Greedy replay is
        exact here because the modules consume from disjoint FIFO sets
        (firing an enabled instruction can never disable another), so a
        stuck replay == guaranteed deadlock.  Unlike the old net-balance
        check this also rejects streams where a pop precedes its matching
        push in module order.  With require_net_zero, additionally reject
        streams that leave unconsumed tokens behind — schedules that close
        over their own WAR/RAW protocol (e.g. the vector-binop path) must
        end with every FIFO drained.  `start` restricts the check to the
        stream suffix emitted from that index on, so a self-contained
        schedule can be validated even when composed after others."""
        queues: Dict[int, List[Insn]] = {LOAD_Q: [], COMPUTE_Q: [],
                                         STORE_Q: []}
        for insn in self._stream[start:]:
            queues[route_queue(insn)].append(insn)
        tokens = {"l2c": 0, "c2l": 0, "c2s": 0, "s2c": 0}
        pc = {LOAD_Q: 0, COMPUTE_Q: 0, STORE_Q: 0}
        remaining = sum(len(v) for v in queues.values())
        while remaining:
            progressed = False
            for q in (LOAD_Q, COMPUTE_Q, STORE_Q):
                while pc[q] < len(queues[q]):
                    insn = queues[q][pc[q]]
                    needs = [fifo for fifo, flag in DEP_IN_EDGES[q]
                             if getattr(insn.dep, flag)]
                    if any(tokens[f] == 0 for f in needs):
                        break
                    for f in needs:
                        tokens[f] -= 1
                    for fifo, flag in DEP_OUT_EDGES[q]:
                        if getattr(insn.dep, flag):
                            tokens[fifo] += 1
                    pc[q] += 1
                    remaining -= 1
                    progressed = True
            if not progressed:
                state = {_MODULE_NAMES[q]: f"{pc[q]}/{len(queues[q])}"
                         for q in pc}
                raise ValueError(
                    f"dependence deadlock: no module can issue; pcs={state} "
                    f"tokens={tokens} — a pop precedes its matching push")
        if require_net_zero:
            for k, v in tokens.items():
                if v != 0:
                    raise ValueError(
                        f"dependence FIFO {k} balance {v} != 0: "
                        "stream leaves unconsumed tokens")

    def finalize_stream(self) -> np.ndarray:
        """Append FINISH, validate token balance, and encode the stream to
        its binary task-ISA form — the single artifact every execution
        backend consumes."""
        if any(self._pending_pop[q] for q in self._pending_pop):
            raise ValueError(
                "finalize_stream with un-attached dep_pop(s): a fence token "
                "pop was registered but never claimed by an instruction")
        self._push_insn(FinishInsn(dep=DepFlags()))
        self.validate_stream()
        return self.isa.encode_stream(self._stream)

    def synchronize(self, timing: Optional[TimingModel] = None,
                    keep_stream: bool = False,
                    backend: "object | str | None" = None) -> RunStats:
        """VTASynchronize: finalize the stream, hand off to an execution
        backend, block until FINISH.

        backend: None (default) or "cuda" runs the stream through the
        CUDA kernels' engine (``CudaBackend``); "simulator" runs the same
        encoded stream on the cycle-capable behavioural oracle; any
        ExecutionBackend instance is used as-is.
        """
        from .backend import resolve_backend
        stream = self.finalize_stream()
        stats = resolve_backend(backend).execute(
            self.spec, self.device, stream, timing=timing)
        self.stats_history.append(stats)
        if not keep_stream:
            self.reset_stream()
        return stats

    def reset_stream(self) -> None:
        self._stream = []
        self._pending_pop = {LOAD_Q: {}, COMPUTE_Q: {}, STORE_Q: {}}
        self._last_in_queue = {LOAD_Q: None, COMPUTE_Q: None, STORE_Q: None}
        # kernels stay JIT-cached in DRAM for the program lifetime (§3.2),
        # but the simulator starts each run with cold SRAM, so uop-cache
        # residency must be rebuilt on the next stream.
        self._resident.clear()
        self._uop_cursor = 0

    @property
    def stream(self) -> List[Insn]:
        return list(self._stream)

    @property
    def stream_len(self) -> int:
        """O(1) pending-instruction count (the `stream` property copies)."""
        return len(self._stream)
