"""Behavioral + cycle-level simulator of the VTA pipeline.

Executes an *encoded* VTA instruction stream the way the hardware does
(§2.3–§2.6): the fetch module routes instructions into three command
queues (load / compute / store); each module executes its queue in FIFO
order, predicated on RAW/WAR dependence tokens exchanged through four
dependence FIFOs; SRAM scratchpads are single-reader/single-writer.

One engine serves two roles:
  * functional simulation (unit latencies) — the oracle-checked backend;
  * cycle-level timing (TimingModel) — reproduces the latency-hiding /
    roofline study of Fig. 15.

Correctness therefore *depends on the dependence flags the runtime
emitted*, exactly as on hardware: strip the WAR tokens and double-buffered
schedules produce wrong results (tested), which is the Fig. 5 argument.

The SRAMs are torch tensors on the DRAM image's device.  The uop SRAM is
the exception: it holds micro-op words that are decoded on the host, so it
stays a numpy array.  Each LOAD and each STORE moves its whole 2D DMA
footprint with one strided copy.  GEMM and ALU instructions compute over
all their uops at once with the reference's integer semantics (int32
accumulation that wraps; ALU ops in int64, wrapped back to int32); an ALU
instruction whose uops read a value an earlier uop of the same instruction
wrote runs uop by uop, in the reference's order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.tensor_alu.ref import alu_apply
from . import layout
from .driver import Device
from .hwspec import HardwareSpec
from .isa import (AluInsn, AluOp, DepFlags, FinishInsn, GemmInsn, Insn,
                  IsaLayout, LoadStoreInsn, MemId, Opcode, route_queue,
                  LOAD_Q, COMPUTE_Q, STORE_Q)
from .microop import UopLayout


class DeadlockError(RuntimeError):
    pass


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------
class TimingModel:
    """Latency of each CISC instruction in cycles (§2.5, §2.6)."""

    def __init__(self, spec: HardwareSpec):
        self.spec = spec

    def _dma_cycles(self, nbytes: int, write: bool) -> int:
        bpc = (self.spec.dram_wr_bytes_per_cycle if write
               else self.spec.dram_rd_bytes_per_cycle)
        return self.spec.dram_latency_cycles + int(math.ceil(nbytes / bpc))

    def latency(self, insn: Insn, spec: HardwareSpec) -> int:
        if isinstance(insn, LoadStoreInsn):
            elem = {
                MemId.UOP: spec.uop_elem_bytes, MemId.WGT: spec.wgt_elem_bytes,
                MemId.INP: spec.inp_elem_bytes, MemId.ACC: spec.acc_elem_bytes,
                MemId.OUT: spec.out_elem_bytes,
            }[insn.memory_type]
            nbytes = insn.y_size * insn.x_size * elem
            if nbytes == 0:
                return 1  # barrier noop: no DMA setup cost
            return self._dma_cycles(nbytes, write=insn.opcode == Opcode.STORE)
        if isinstance(insn, GemmInsn):
            # one tensor-tensor matrix multiply per cycle (Fig. 7)
            return max(1, insn.iter_out * insn.iter_in * (insn.uop_end - insn.uop_bgn))
        if isinstance(insn, AluInsn):
            # initiation interval >= 2: single register-file read port (§2.5)
            n = insn.iter_out * insn.iter_in * (insn.uop_end - insn.uop_bgn)
            return max(1, n * self.spec.alu_init_interval)
        return 1  # FINISH


class UnitTiming(TimingModel):
    """Functional mode: every instruction takes one cycle."""

    def latency(self, insn: Insn, spec: HardwareSpec) -> int:  # noqa: D102
        return 1


# ----------------------------------------------------------------------
# stats
# ----------------------------------------------------------------------
@dataclass
class ModuleStats:
    busy_cycles: int = 0
    insn_count: int = 0
    stall_on_token: int = 0   # cycles spent waiting for dependence tokens


@dataclass
class RunStats:
    total_cycles: int = 0
    modules: Dict[str, ModuleStats] = field(default_factory=dict)
    gemm_macs: int = 0
    alu_ops: int = 0
    dram_rd_bytes: int = 0
    dram_wr_bytes: int = 0
    tokens_pushed: int = 0
    backend: str = "simulator"   # which execution engine produced this run
    wall_time_s: float = 0.0     # host wall-clock of the engine (not cycles)
    # CudaBackend fast-path accounting (always 0 on the simulator, which
    # has no coalescer): compute instructions absorbed into lazy tiles and
    # resolved through the CUDA kernels vs. ones that fell back to the
    # eager per-uop numpy loop.
    coalesced_gemm_insns: int = 0
    coalesced_alu_insns: int = 0
    eager_gemm_insns: int = 0
    eager_alu_insns: int = 0
    # program-compiler pipelining + serving-path accounting, filled in by
    # CompiledProgram.__call__ per accelerator step: how the stream's
    # dependent-op boundaries were synchronized and how many bytes the
    # call staged into DRAM (inputs; + the stream itself when not
    # pre-staged)
    n_join_barriers: int = 0
    n_buffer_fences: int = 0
    staging_bytes_per_call: int = 0
    # cross-call persistent state (KV caches, recurrent state) resident
    # at stable DRAM addresses during this run — bytes that are neither
    # staged per call nor recycled through the arena
    persistent_bytes: int = 0
    # CudaBackend batched tile dispatch: lazily-coalesced accumulator
    # tiles resolved, and the number of kernel launches that resolved
    # them (tiles_resolved / tile_batches = batching factor)
    tiles_resolved: int = 0
    tile_batches: int = 0
    # kernel launches that went through the LUT-GEMM path (sub-byte
    # weights, memory-bound decode shapes) instead of the dense MXU GEMM
    lut_launches: int = 0
    # gang width of the run that produced this stats object: 1 for a
    # plain execute; N when the stream ran on N pooled devices in
    # lockstep (CudaBackend.execute_gang) — wall_time_s is then the
    # shared gang window, not a per-device slice
    gang_size: int = 1
    # entries evicted from the bounded decoded-stream LRU cache while
    # decoding this run's stream (backend.set_decode_cache_cap); nonzero
    # means a long-lived multi-program server is cycling more distinct
    # streams than the cache holds
    decode_evictions: int = 0
    # tuning-cache consultation of the compile that produced this
    # program (mirrored from CompiledProgram.tune_hits/tune_misses per
    # call): accel op nodes resolved from a TuningCache record vs ones
    # that fell back to the default / cycle-compare path
    tune_cache_hits: int = 0
    tune_cache_misses: int = 0
    # CudaBackend's exact weight-content keys: host copies of coalesced
    # GEMM weight operands (device-to-host on the card), their bytes, and
    # the host seconds they took (waits for queued work included)
    content_key_copies: int = 0
    content_key_bytes: int = 0
    content_key_s: float = 0.0

    @property
    def eager_compute_insns(self) -> int:
        """Compute instructions the CudaBackend executed on the eager
        per-uop fallback instead of the kernel fast path."""
        return self.eager_gemm_insns + self.eager_alu_insns

    @classmethod
    def merged(cls, runs: "List[RunStats]") -> "RunStats":
        """Sum the counter fields of several runs (e.g. one pooled slot's
        serving history) into one aggregate RunStats.  Cycle/wall fields
        add too — meaningful as totals, not as a single-run profile;
        ``gang_size`` reports the maximum seen."""
        out = cls(modules={})
        for r in runs:
            for f in ("total_cycles", "gemm_macs", "alu_ops",
                      "dram_rd_bytes", "dram_wr_bytes", "tokens_pushed",
                      "wall_time_s", "coalesced_gemm_insns",
                      "coalesced_alu_insns", "eager_gemm_insns",
                      "eager_alu_insns", "n_join_barriers",
                      "n_buffer_fences", "staging_bytes_per_call",
                      "tiles_resolved", "tile_batches", "lut_launches",
                      "decode_evictions", "tune_cache_hits",
                      "tune_cache_misses", "content_key_copies",
                      "content_key_bytes", "content_key_s"):
                setattr(out, f, getattr(out, f) + getattr(r, f))
            out.gang_size = max(out.gang_size, r.gang_size)
            for nm, ms in r.modules.items():
                agg = out.modules.setdefault(nm, ModuleStats())
                agg.busy_cycles += ms.busy_cycles
                agg.insn_count += ms.insn_count
                agg.stall_on_token += ms.stall_on_token
        if runs:
            out.backend = runs[-1].backend
        return out

    @property
    def compute_utilization(self) -> float:
        """GEMM-core busy fraction — the Fig. 15 utilization metric."""
        c = self.modules.get("compute")
        if not c or self.total_cycles == 0:
            return 0.0
        return c.busy_cycles / self.total_cycles

    def gops(self, freq_mhz: float) -> float:
        if self.total_cycles == 0:
            return 0.0
        secs = self.total_cycles / (freq_mhz * 1e6)
        return 2.0 * self.gemm_macs / secs / 1e9

    @property
    def arithmetic_intensity(self) -> float:
        moved = self.dram_rd_bytes + self.dram_wr_bytes
        return 2.0 * self.gemm_macs / max(1, moved)


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
_MODULE_NAMES = {LOAD_Q: "load", COMPUTE_Q: "compute", STORE_Q: "store"}


def _pipeline_schedule(spec: HardwareSpec, insns: List["Insn"],
                       timing: TimingModel,
                       commit=None) -> RunStats:
    """The three-module decoupled-pipeline scheduler (§2.3): each module
    consumes its command queue in FIFO order, predicated on the four
    dependence-token FIFOs; latencies come from `timing`.  `commit` (when
    given) applies each instruction's memory semantics — the behavioral
    simulator; with commit=None this is a pure cycle-accounting replay,
    which is how the CUDA engine prices the exact same stream with the
    same TimingModel (see ``replay_timing``)."""
    queues: Dict[int, List[Insn]] = {LOAD_Q: [], COMPUTE_Q: [], STORE_Q: []}
    for insn in insns:
        queues[route_queue(insn)].append(insn)

    # dependence token FIFOs (timestamps of pushes)
    l2c: List[int] = []   # RAW  load -> compute
    c2l: List[int] = []   # WAR  compute -> load
    c2s: List[int] = []   # RAW  compute -> store
    s2c: List[int] = []   # WAR  store -> compute

    def in_queues(q: int) -> List[Tuple[List[int], str]]:
        if q == LOAD_Q:
            return [(c2l, "pop_next")]
        if q == COMPUTE_Q:
            return [(l2c, "pop_prev"), (s2c, "pop_next")]
        return [(c2s, "pop_prev")]

    def out_queues(q: int) -> Dict[str, List[int]]:
        if q == LOAD_Q:
            return {"push_next": l2c}
        if q == COMPUTE_Q:
            return {"push_prev": c2l, "push_next": c2s}
        return {"push_prev": s2c}

    pc = {LOAD_Q: 0, COMPUTE_Q: 0, STORE_Q: 0}
    free_at = {LOAD_Q: 0, COMPUTE_Q: 0, STORE_Q: 0}
    stats = RunStats(modules={n: ModuleStats() for n in _MODULE_NAMES.values()})

    while True:
        # find, among modules with pending work, the one that can start
        # earliest (tokens available), and commit its instruction.
        best_q, best_start, best_insn = None, None, None
        all_done = True
        for q in (LOAD_Q, COMPUTE_Q, STORE_Q):
            if pc[q] >= len(queues[q]):
                continue
            all_done = False
            insn = queues[q][pc[q]]
            start = free_at[q]
            ok = True
            for fifo, flag in in_queues(q):
                if getattr(insn.dep, flag):
                    if not fifo:
                        ok = False
                        break
                    start = max(start, fifo[0])
            if not ok:
                continue
            if best_start is None or start < best_start:
                best_q, best_start, best_insn = q, start, insn
        if all_done:
            break
        if best_q is None:
            state = {(_MODULE_NAMES[q]): f"{pc[q]}/{len(queues[q])}"
                     for q in pc}
            raise DeadlockError(
                f"dependence deadlock: no module can issue; pcs={state} "
                f"tokens l2c={len(l2c)} c2l={len(c2l)} c2s={len(c2s)} s2c={len(s2c)}")

        q, insn = best_q, best_insn
        # consume tokens
        for fifo, flag in in_queues(q):
            if getattr(insn.dep, flag):
                fifo.pop(0)
        lat = timing.latency(insn, spec)
        finish = best_start + lat
        mstats = stats.modules[_MODULE_NAMES[q]]
        mstats.stall_on_token += best_start - free_at[q]
        mstats.busy_cycles += lat
        mstats.insn_count += 1
        free_at[q] = finish
        pc[q] += 1

        if commit is not None:
            commit(insn, stats)

        # publish outgoing tokens at completion time
        for flag, fifo in out_queues(q).items():
            if getattr(insn.dep, flag):
                fifo.append(finish)
                stats.tokens_pushed += 1

    stats.total_cycles = max(free_at.values())
    return stats


def replay_timing(spec: HardwareSpec, insns: List["Insn"],
                  timing: Optional[TimingModel] = None) -> RunStats:
    """Cycle-account an instruction list on the pipeline model without
    executing memory semantics — gives any engine (e.g. CudaBackend)
    TimingModel cycles for the exact stream it ran."""
    return _pipeline_schedule(spec, insns, timing or TimingModel(spec),
                              commit=None)


class Simulator:
    def __init__(self, spec: HardwareSpec, device: Device,
                 timing: Optional[TimingModel] = None, strict: bool = True):
        self.spec = spec
        self.device = device
        self.isa = IsaLayout(spec)
        self.uop_layout = UopLayout(spec)
        self.timing = timing or UnitTiming(spec)
        self.strict = strict  # bounds-check SRAM indices

        s = spec
        dev = self.torch_device = device.torch_device
        # uop words are decoded on the host: the uop SRAM stays numpy
        self.uop_sram = np.zeros(s.uop_depth, dtype=np.uint32)
        self.inp_sram = torch.zeros((s.inp_depth, s.batch, s.block_in),
                                    dtype=torch.int8, device=dev)
        self.wgt_sram = torch.zeros((s.wgt_depth, s.block_out, s.block_in),
                                    dtype=torch.int8, device=dev)
        self.acc_sram = torch.zeros((s.acc_depth, s.batch, s.block_out),
                                    dtype=torch.int32, device=dev)
        # out buffer mirrors acc, narrowed (write-through on compute, §2.5)
        self.out_sram = torch.zeros((s.acc_depth, s.batch, s.block_out),
                                    dtype=torch.int8, device=dev)

    def index(self, idx) -> torch.Tensor:
        """Host index array -> int64 index tensor on the SRAMs' device."""
        return torch.as_tensor(np.asarray(idx, dtype=np.int64),
                               device=self.torch_device)

    # ------------------------------------------------------------------
    def run(self) -> RunStats:
        """Execute the stream at device.regs.insns (fetch → route → run)."""
        regs = self.device.regs
        if not (regs.control & 1):
            raise RuntimeError("device not started (control register bit0 clear)")
        raw = self.device.dram.read(
            regs.insns, regs.insn_count * self.isa.insn_bytes,
            dtype=np.uint64, shape=(regs.insn_count, self.isa.insn_words))
        insns = self.isa.decode_stream(raw)
        stats = self._execute(insns)
        regs.set_done()
        return stats

    # ------------------------------------------------------------------
    def _execute(self, insns: List[Insn]) -> RunStats:
        return _pipeline_schedule(self.spec, insns, self.timing,
                                  commit=self._commit)

    # ------------------------------------------------------------------
    # instruction semantics
    # ------------------------------------------------------------------
    def _commit(self, insn: Insn, stats: RunStats) -> None:
        if isinstance(insn, LoadStoreInsn):
            if insn.opcode == Opcode.LOAD:
                self._do_load(insn, stats)
            else:
                self._do_store(insn, stats)
        elif isinstance(insn, GemmInsn):
            self._do_gemm(insn, stats)
        elif isinstance(insn, AluInsn):
            self._do_alu(insn, stats)
        # FINISH: no memory effect

    def _buf(self, mem: MemId):
        s = self.spec
        if mem == MemId.UOP:
            return self.uop_sram, s.uop_elem_bytes
        if mem == MemId.INP:
            return self.inp_sram, s.inp_elem_bytes
        if mem == MemId.WGT:
            return self.wgt_sram, s.wgt_elem_bytes
        if mem == MemId.ACC:
            return self.acc_sram, s.acc_elem_bytes
        if mem == MemId.OUT:
            return self.out_sram, s.out_elem_bytes
        raise ValueError(mem)

    def _do_load(self, insn: LoadStoreInsn, stats: RunStats) -> None:
        buf, elem_bytes = self._buf(insn.memory_type)
        width = insn.x_pad_0 + insn.x_size + insn.x_pad_1
        rows = insn.y_pad_0 + insn.y_size + insn.y_pad_1
        lo = insn.sram_base
        hi = lo + rows * width
        dram = self.device.dram
        nbytes = insn.x_size * elem_bytes
        addr = insn.dram_base * elem_bytes
        stride = insn.x_stride * elem_bytes
        if insn.memory_type == MemId.UOP:
            self._load_uops(insn, elem_bytes, width)
        elif hi > lo:
            if hi > buf.shape[0]:
                raise IndexError(f"{insn.memory_type.name} load [{lo}, {hi})"
                                 f" past SRAM depth {buf.shape[0]}")
            region = buf[lo:hi].view((rows, width) + tuple(buf.shape[1:]))
            if rows * width != insn.y_size * insn.x_size:
                region.zero_()
            if insn.y_size and insn.x_size:
                src = dram.rows(addr, insn.y_size, nbytes, stride)
                dst = region[insn.y_pad_0:insn.y_pad_0 + insn.y_size,
                             insn.x_pad_0:insn.x_pad_0 + insn.x_size]
                if insn.memory_type == MemId.WGT and self.spec.wgt_packed:
                    # sub-byte weights: DRAM holds b-bit packed element
                    # rows; the WGT SRAM always holds sign-extended int8
                    # (the one decode point both engines share)
                    raw = src.cpu().numpy().reshape(-1, elem_bytes)
                    data = layout.unpack_wgt_elems(
                        raw, self.spec.wgt_bits, self.spec.block_out,
                        self.spec.block_in)
                    dst.copy_(torch.from_numpy(data).view(dst.shape))
                else:
                    # one strided copy of the whole 2D footprint
                    dst.view(torch.uint8).view(
                        insn.y_size, insn.x_size, elem_bytes).copy_(
                        src.view(insn.y_size, insn.x_size, elem_bytes))
        stats.dram_rd_bytes += insn.y_size * nbytes
        if insn.memory_type == MemId.ACC:
            # keep the out-buffer mirror coherent with direct ACC loads
            self._writethrough(lo, hi)

    def _load_uops(self, insn: LoadStoreInsn, elem_bytes: int,
                   width: int) -> None:
        """Uop words go to the host-side uop SRAM (reference row loop)."""
        buf, dram, sram = self.uop_sram, self.device.dram, insn.sram_base
        buf[sram:sram + insn.y_pad_0 * width] = 0
        sram += insn.y_pad_0 * width
        for y in range(insn.y_size):
            buf[sram:sram + insn.x_pad_0] = 0
            sram += insn.x_pad_0
            byte_addr = (insn.dram_base + y * insn.x_stride) * elem_bytes
            buf[sram:sram + insn.x_size] = dram.read(
                byte_addr, insn.x_size * elem_bytes, dtype=np.uint32)
            sram += insn.x_size
            buf[sram:sram + insn.x_pad_1] = 0
            sram += insn.x_pad_1
        buf[sram:sram + insn.y_pad_1 * width] = 0

    def _do_store(self, insn: LoadStoreInsn, stats: RunStats) -> None:
        # STORE reads the narrowed out-buffer (§2.5 write-through mirror)
        elem_bytes = self.spec.out_elem_bytes
        n = insn.y_size * insn.x_size
        if n == 0:
            return
        lo = insn.sram_base
        if lo + n > self.out_sram.shape[0]:
            raise IndexError(f"store [{lo}, {lo + n}) past OUT SRAM depth "
                             f"{self.out_sram.shape[0]}")
        nbytes = insn.x_size * elem_bytes
        src = self.out_sram[lo:lo + n].view(torch.uint8).view(
            insn.y_size, nbytes)
        addr = insn.dram_base * elem_bytes
        stride = insn.x_stride * elem_bytes
        dram = self.device.dram
        if insn.y_size == 1 or insn.x_stride >= insn.x_size:
            # rows do not overlap in DRAM: one strided copy
            dram.rows(addr, insn.y_size, nbytes, stride).copy_(src)
        else:
            # overlapping rows: the later row wins, as in row order
            for y in range(insn.y_size):
                dram.rows(addr + y * stride, 1, nbytes, nbytes).copy_(
                    src[y:y + 1])
        stats.dram_wr_bytes += insn.y_size * nbytes

    def _writethrough(self, lo: int, hi: int) -> None:
        self.out_sram[lo:hi] = self.acc_sram[lo:hi].to(torch.int8)  # truncating cast

    def _affine_indices(self, insn, uops) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized 2-level affine loop (Fig. 7 pseudo-code)."""
        i0 = np.arange(insn.iter_out).reshape(-1, 1, 1)
        i1 = np.arange(insn.iter_in).reshape(1, -1, 1)
        dst = np.array([u.dst for u in uops]).reshape(1, 1, -1)
        src = np.array([u.src for u in uops]).reshape(1, 1, -1)
        wgt = np.array([u.wgt for u in uops]).reshape(1, 1, -1)
        dsts = (dst + i0 * insn.dst_factor_out + i1 * insn.dst_factor_in).ravel()
        srcs = (src + i0 * insn.src_factor_out + i1 * insn.src_factor_in).ravel()
        wfo = getattr(insn, "wgt_factor_out", 0)
        wfi = getattr(insn, "wgt_factor_in", 0)
        wgts = (wgt + i0 * wfo + i1 * wfi).ravel()
        return dsts, srcs, wgts

    def _do_gemm(self, insn: GemmInsn, stats: RunStats) -> None:
        uops = self.uop_layout.decode_kernel(
            self.uop_sram[insn.uop_bgn:insn.uop_end])
        if not uops or insn.iter_out == 0 or insn.iter_in == 0:
            return
        dsts, srcs, wgts = self._affine_indices(insn, uops)
        if self.strict:
            for name, idx, depth in (("dst", dsts, self.spec.acc_depth),
                                     ("src", srcs, self.spec.inp_depth),
                                     ("wgt", wgts, self.spec.wgt_depth)):
                if idx.max(initial=0) >= depth:
                    raise IndexError(f"GEMM {name} index {idx.max()} >= depth {depth}")
        touched, inv = np.unique(dsts, return_inverse=True)
        t_idx = self.index(touched)
        if insn.reset:
            self.acc_sram[t_idx] = 0
        else:
            # acc[dst] += inp[src] @ wgt[wgt].T, int8 x int8 -> int32.  The
            # reference adds uop by uop in int32 with wraparound; a sum mod
            # 2^32 does not depend on its order, so summing every uop's
            # product in int64 and wrapping once gives the same bits.
            acc = self.acc_sram[t_idx].to(torch.int64)
            inv_t = self.index(inv.reshape(-1))
            for c0 in range(0, len(dsts), _GEMM_CHUNK):
                c1 = c0 + _GEMM_CHUNK
                a = self.inp_sram[self.index(srcs[c0:c1])].to(torch.int32)
                b = self.wgt_sram[self.index(wgts[c0:c1])].to(torch.int32)
                prod = (a[:, :, None, :] * b[:, None, :, :]).sum(
                    -1, dtype=torch.int64)
                acc.index_add_(0, inv_t[c0:c1], prod)
            self.acc_sram[t_idx] = acc.to(torch.int32)
            stats.gemm_macs += (len(dsts) * self.spec.batch *
                                self.spec.block_in * self.spec.block_out)
        self.out_sram[t_idx] = self.acc_sram[t_idx].to(torch.int8)

    def _do_alu(self, insn: AluInsn, stats: RunStats) -> None:
        uops = self.uop_layout.decode_kernel(
            self.uop_sram[insn.uop_bgn:insn.uop_end])
        if not uops or insn.iter_out == 0 or insn.iter_in == 0:
            return
        dsts, srcs, _ = self._affine_indices(insn, uops)
        if self.strict:
            for idx in (dsts, srcs):
                if idx.max(initial=0) >= self.spec.acc_depth:
                    raise IndexError(f"ALU index {idx.max()} >= acc depth")
        # alu_apply computes in int64 and wraps to int32, as in RTL
        op = ALU_NAMES[insn.alu_opcode]
        imm = torch.tensor(int(insn.imm), dtype=torch.int32,
                           device=self.torch_device)
        if _alu_vectorizable(dsts, None if insn.use_imm else srcs):
            d = self.index(dsts)
            srcv = imm if insn.use_imm else self.acc_sram[self.index(srcs)]
            self.acc_sram[d] = alu_apply(op, self.acc_sram[d], srcv)
        else:
            # a uop reads what an earlier uop of this instruction wrote:
            # keep the reference's uop order
            for d, s_ in zip(dsts.tolist(), srcs.tolist()):
                srcv = imm if insn.use_imm else self.acc_sram[s_]
                self.acc_sram[d] = alu_apply(op, self.acc_sram[d], srcv)
        stats.alu_ops += len(dsts) * self.spec.batch * self.spec.block_out
        t_idx = self.index(np.unique(dsts))
        self.out_sram[t_idx] = self.acc_sram[t_idx].to(torch.int8)


#: ALU opcode -> the op name the tensor-ALU kernel and its plain version use
ALU_NAMES = {AluOp.MIN: "min", AluOp.MAX: "max", AluOp.ADD: "add",
             AluOp.SHR: "shr", AluOp.MUL: "mul"}

# uops per vectorized slice of an eager GEMM (bounds the int32 product
# temporary at _GEMM_CHUNK * batch * block_out * block_in elements)
_GEMM_CHUNK = 4096


def _alu_vectorizable(dsts: np.ndarray, srcs: Optional[np.ndarray]) -> bool:
    """True when computing every uop at once gives the uop-by-uop result:
    each dst is written once, and no uop reads (as src) a dst that an
    EARLIER uop of the same instruction wrote."""
    if np.unique(dsts).size != dsts.size:
        return False
    if srcs is None:
        return True
    order = np.argsort(dsts, kind="stable")
    k = np.clip(np.searchsorted(dsts, srcs, sorter=order), 0, dsts.size - 1)
    writer = order[k]
    hit = dsts[writer] == srcs
    return not np.any(hit & (writer < np.arange(srcs.size)))


def run_program(spec: HardwareSpec, device: Device, stream: np.ndarray,
                timing: Optional[TimingModel] = None,
                staged_addr: Optional[int] = None) -> RunStats:
    """Write `stream` to DRAM (or kick a pre-staged copy at
    `staged_addr` — zero allocation), set the control regs, run to
    FINISH."""
    if staged_addr is None:
        device.stage_stream(stream)
    else:
        device.kick_stream(staged_addr, stream.shape[0])
    sim = Simulator(spec, device, timing=timing)
    return sim.run()
