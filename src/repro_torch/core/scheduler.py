"""VTA scheduler: tensorization, memory scopes, virtual threading (§4).

This is the TVM-analogue layer: it lowers hardware-agnostic tensor
programs (blocked matmul, 2D convolution, elementwise epilogues) onto the
VTA runtime API — tiling loops to the GEMM intrinsic (*tensorization*,
§4.2), assigning tiles to data-specialized SRAM *memory scopes* with
explicit capacity budgeting (§4.1), and lowering `virtual_threads`
contexts into a single instruction stream with explicit RAW/WAR token
insertion (*virtual threading*, §4.3 / Fig. 14).

Dependence-token protocol (per virtual thread, Fig. 12):
  load group  : pop c2l WAR token if this thread's context was read by a
                previous compute group; push l2c RAW token on last load.
  compute grp : pop l2c; on first acc write of a tile, pop s2c WAR token
                if this context was stored before; push c2l after the last
                instruction reading inp/wgt; push c2s before store.
  store       : pop c2s; push s2c.
Round-robin interleaving at tile granularity is safe because each module
executes its queue in FIFO order (the paper's information-less tokens
argument, §2.3).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import layout
from .hwspec import HardwareSpec
from .isa import AluOp, MemId, COMPUTE_Q, LOAD_Q, STORE_Q
from .runtime import Runtime, UopBuilder, UopKernel


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ----------------------------------------------------------------------
# per-virtual-thread dependence bookkeeping
# ----------------------------------------------------------------------
@dataclass
class _ThreadDeps:
    """Tracks which WAR tokens this thread has outstanding."""
    c2l_pending: bool = False   # compute has signalled loader (buffers free)
    s2c_pending: bool = False   # store has signalled compute (acc free)

    def begin_load_group(self, rt: Runtime) -> None:
        if self.c2l_pending:
            rt.dep_pop(COMPUTE_Q, LOAD_Q)
            self.c2l_pending = False

    def end_load_group(self, rt: Runtime) -> None:
        rt.dep_push(LOAD_Q, COMPUTE_Q)

    def begin_compute_group(self, rt: Runtime, pops_acc: bool) -> None:
        rt.dep_pop(LOAD_Q, COMPUTE_Q)
        if pops_acc and self.s2c_pending:
            rt.dep_pop(STORE_Q, COMPUTE_Q)
            self.s2c_pending = False

    def end_compute_group_frees_loads(self, rt: Runtime) -> None:
        rt.dep_push(COMPUTE_Q, LOAD_Q)
        self.c2l_pending = True

    def compute_to_store(self, rt: Runtime, own_insn: bool = True) -> None:
        """Signal the store module that this tile's accumulator is ready.
        The token must ride on an instruction of *this thread's* epilogue:
        dep_push attaches to the last compute-queue instruction, so a tile
        whose epilogue emitted nothing (n_alu_passes == 0, the wraparound
        store) must emit a compute noop first — otherwise the push lands
        on the interleaved peer thread's GEMM and, since a flag bit can
        only be set once, the second thread's push is silently lost and
        the stream deadlocks at its store (fuzzer-found)."""
        if not own_insn:
            rt.noop(COMPUTE_Q)
        rt.dep_push(COMPUTE_Q, STORE_Q)

    def begin_store(self, rt: Runtime) -> None:
        rt.dep_pop(COMPUTE_Q, STORE_Q)   # lands on the first store insn

    def end_store(self, rt: Runtime) -> None:
        rt.dep_push(STORE_Q, COMPUTE_Q)  # flags the last store insn
        self.s2c_pending = True


def emit_fenced_load_group(rt: Runtime, fence_pending: List[bool],
                           load_data, load_weights) -> None:
    """Emit one tile load group under the buffer-fence protocol (shared
    by every lowering pass so the token-claim invariant lives in ONE
    place): while the fence is unclaimed, the weight tile loads first —
    free-running, it overlaps the producer's epilogue/store tail in its
    disjoint wgt region — and the fence token is claimed by (gates) the
    first load of the produced data operand; afterwards the normal
    data-then-weights order resumes."""
    if fence_pending[0]:
        load_weights()
        rt.dep_pop(COMPUTE_Q, LOAD_Q)
        fence_pending[0] = False
        load_data()
    else:
        load_data()
        load_weights()


# ----------------------------------------------------------------------
# virtual-threading lowering (§4.3, Fig. 14)
# ----------------------------------------------------------------------
def interleave_virtual_threads(work_items, vt, make_program) -> None:
    """Lower a `vt`-thread data-parallel tile program into one instruction
    stream, interleaving threads at *phase* granularity.

    `make_program(item, thread)` returns a generator that emits one
    (load | compute | store) phase per `next()`.  Within each group of `vt`
    consecutive tiles, phase p of thread 0 precedes phase p of thread 1,
    etc.  This ordering is what makes VTA's information-less dependence
    tokens safe: every module executes its queue in FIFO order, so the
    k-th pop on a FIFO is always satisfied by the semantically matching
    k-th push (§2.3).  Coarser interleaving (whole tiles) breaks the
    pairing and corrupts results — covered by a regression test.
    """
    for g in range(0, len(work_items), vt):
        group = work_items[g:g + vt]
        progs = [make_program(item, t) for t, item in enumerate(group)]
        alive = list(progs)
        while alive:
            for p in list(alive):
                try:
                    next(p)
                except StopIteration:
                    alive.remove(p)


# ----------------------------------------------------------------------
# epilogue description (tensor-ALU ops applied to the acc tile)
# ----------------------------------------------------------------------
@dataclass
class Epilogue:
    """Requantization / activation epilogue executed on the tensor ALU:
      acc = acc + bias            (optional, per-output-channel)
      acc = acc >> shift          (requantize, §SHR)
      acc = min(max(acc, lo), hi) (clip; ReLU when lo=0)
    """
    bias_blocked: Optional[np.ndarray] = None  # (Nb, BATCH, BLOCK_OUT) int32
    shift: int = 0
    clip_lo: Optional[int] = -128
    clip_hi: Optional[int] = 127
    relu: bool = False

    @property
    def n_alu_passes(self) -> int:
        """Tensor-ALU passes the scheduler emits for this epilogue.  relu
        combined with a clip folds into the clip's lower bound (MAX pass),
        so it only costs its own pass when there is no clip to fold into."""
        n = 0
        if self.bias_blocked is not None:
            n += 1
        if self.shift:
            n += 1
        if self.relu and self.clip_lo is None:
            n += 1
        if self.clip_lo is not None:
            n += 2
        return n

    @property
    def folded_clip_lo(self) -> Optional[int]:
        """Effective clip lower bound with relu folded in (relu == clip at
        zero, so MAX imm=0 followed by MAX imm=lo<=0 is one MAX imm=0)."""
        if self.relu and self.clip_lo is not None:
            return max(0, self.clip_lo)
        return self.clip_lo


# ----------------------------------------------------------------------
# SRAM partitions (program-level memory scopes)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class SramPartition:
    """A contiguous region of each data scratchpad assigned to one lowered
    op.  Lowering passes confine all their SRAM addressing to the
    partition, so the program compiler can keep ops with disjoint
    partitions in flight simultaneously in one stream.  The uop cache is
    exempt: uop loads share the compute queue with their consumers, so
    FIFO order already serializes them (§3.2)."""
    inp_base: int
    inp_depth: int
    wgt_base: int
    wgt_depth: int
    acc_base: int
    acc_depth: int

    @classmethod
    def full(cls, spec: HardwareSpec) -> "SramPartition":
        return cls(0, spec.inp_depth, 0, spec.wgt_depth, 0, spec.acc_depth)

    def overlaps(self, other: "SramPartition") -> bool:
        def hit(a0, an, b0, bn):
            return a0 < b0 + bn and b0 < a0 + an
        return (hit(self.inp_base, self.inp_depth,
                    other.inp_base, other.inp_depth)
                or hit(self.wgt_base, self.wgt_depth,
                       other.wgt_base, other.wgt_depth)
                or hit(self.acc_base, self.acc_depth,
                       other.acc_base, other.acc_depth))


# ----------------------------------------------------------------------
# tile-size selection (memory-scope capacity budgeting, §4.1)
# ----------------------------------------------------------------------
def choose_matmul_tiles(Mb: int, Nb: int, Kb: int, spec: HardwareSpec,
                        virtual_threads: int,
                        bias: bool = False,
                        sram: Optional[SramPartition] = None
                        ) -> Tuple[int, int, int]:
    """Pick (mt, nt, kt) block-tile sizes so each virtual-thread context
    fits its SRAM partition.  Greedy: grow kt (reduction reuse), then nt,
    then mt."""
    sram = sram or SramPartition.full(spec)
    inp_cap = sram.inp_depth // virtual_threads
    wgt_cap = sram.wgt_depth // virtual_threads
    acc_cap = sram.acc_depth // virtual_threads
    if bias:
        acc_cap //= 2  # bias tile staged in the second half of the context

    def fits(mt, nt, kt):
        return (mt * kt <= inp_cap and nt * kt <= wgt_cap
                and mt * nt <= acc_cap)

    mt, nt, kt = 1, 1, 1
    changed = True
    while changed:
        changed = False
        for grow in ("kt", "nt", "mt"):
            m2, n2, k2 = mt, nt, kt
            if grow == "kt" and kt < Kb:
                k2 = min(Kb, kt * 2)
            elif grow == "nt" and nt < Nb:
                n2 = min(Nb, nt * 2)
            elif grow == "mt" and mt < Mb:
                m2 = min(Mb, mt * 2)
            if (m2, n2, k2) != (mt, nt, kt) and fits(m2, n2, k2):
                mt, nt, kt = m2, n2, k2
                changed = True
    if not fits(mt, nt, kt):
        raise ValueError("even a 1x1x1 block tile does not fit SRAM")
    return mt, nt, kt


# ----------------------------------------------------------------------
# blocked matmul:  C[M,N] = clip((A[M,K] @ W[N,K]^T + bias) >> shift)
# ----------------------------------------------------------------------
@dataclass
class MatmulPlan:
    M: int
    N: int
    K: int
    Mb: int
    Nb: int
    Kb: int
    tiles: Tuple[int, int, int]
    a_addr: int
    w_addr: int
    c_addr: int
    bias_addr: int = -1


def lower_matmul(rt: Runtime, *, a_base: int, w_base: int, c_base: int,
                 Mb: int, Nb: int, Kb: int,
                 epilogue: Optional[Epilogue] = None, bias_base: int = -1,
                 virtual_threads: int = 2,
                 sram: Optional[SramPartition] = None,
                 transposed: bool = False,
                 a_stride: Optional[int] = None,
                 c_stride: Optional[int] = None,
                 fenced: bool = False) -> Tuple[int, int, int]:
    """Emit the blocked-matmul schedule into rt's open stream.

    This is the lowering pass behind ``schedule_matmul``: it takes
    *element* addresses of already-staged DRAM buffers, so the emitted
    stream is data-independent — rebinding the buffers with new bytes and
    re-running the same encoded stream recomputes the result (the program
    JIT-cache contract).  All SRAM addressing stays inside ``sram``.

    Normal mode addresses A row-major — elem (mb, kb) at
    ``a_base + mb*a_stride + kb`` (a_stride defaults to Kb) — and writes C
    row-major at ``c_base + mb*c_stride + nb``.  ``transposed=True``
    consumes A stored K-major — elem (kb, m) at ``a_base + kb*a_stride +
    m`` — and writes C N-major at ``c_base + nb*c_stride + m`` (strides
    default to Mb).  That is exactly the 1x1-conv fast path: a blocked
    NCHW activation plane *is* a K-major matrix over (channel-block,
    pixel), and the N-major output *is* the blocked NCHW result.  The
    schedule only moves (BATCH x block) tensor-register elements, so it is
    batch-agnostic: for batch-blocked specs the register rows carry one
    image block per element (the caller owns that interpretation — a
    batch-blocked *matrix* packed by ``pack_inp`` is row-blocked and would
    need ``transposed=False``).

    ``fenced=True`` means the program compiler emitted a
    ``Runtime.buffer_fence`` immediately before this op because operand A
    is produced by an in-flight predecessor: the first load group stages
    its *weight* tile first (free-running — it overlaps the producer's
    epilogue and store tail, SRAM partitions are disjoint), then claims
    the fence token on the first A load, which is the only instruction
    that must wait for the producer's final store.

    Returns the chosen (mt, nt, kt) tile sizes.
    """
    spec = rt.spec
    ep = epilogue or Epilogue()
    has_bias = ep.bias_blocked is not None
    if has_bias != (bias_base >= 0):
        raise ValueError("epilogue.bias_blocked and bias_base must agree")
    sram = sram or SramPartition.full(spec)
    if a_stride is None:
        a_stride = Mb if transposed else Kb
    if c_stride is None:
        c_stride = Mb if transposed else Nb
    b_base = bias_base

    mt, nt, kt = choose_matmul_tiles(Mb, Nb, Kb, spec, virtual_threads,
                                     bias=has_bias, sram=sram)
    vt = virtual_threads
    inp_ctx = sram.inp_depth // vt
    wgt_ctx = sram.wgt_depth // vt
    acc_ctx = sram.acc_depth // vt
    deps = [_ThreadDeps() for _ in range(vt)]

    n_m, n_n, n_k = _ceil_div(Mb, mt), _ceil_div(Nb, nt), _ceil_div(Kb, kt)
    tp = "T" if transposed else ""
    fence_pending = [fenced]   # claimed by the first A load emitted

    # JIT one GEMM micro-kernel per (tile-shape, context); LRU-cached.
    def gemm_kernel(mtt, ntt, ktt, acc_base, inp_base, wgt_base) -> UopKernel:
        def build(b: UopBuilder):
            if transposed:
                # SRAM holds the A tile K-major (k*mtt + m); acc is N-major
                b.loop_begin(mtt, dst_factor=1, src_factor=1, wgt_factor=0)
                b.loop_begin(ntt, dst_factor=mtt, src_factor=0,
                             wgt_factor=ktt)
                for k in range(ktt):
                    b.push(dst=acc_base, src=inp_base + k * mtt,
                           wgt=wgt_base + k)
            else:
                b.loop_begin(mtt, dst_factor=ntt, src_factor=ktt,
                             wgt_factor=0)
                b.loop_begin(ntt, dst_factor=1, src_factor=0, wgt_factor=ktt)
                for k in range(ktt):
                    b.push(dst=acc_base, src=inp_base + k, wgt=wgt_base + k)
            b.loop_end(); b.loop_end()
        return rt.uop_kernel(build,
                             key=f"mm{tp}.{mtt}.{ntt}.{ktt}.{acc_base}.{inp_base}.{wgt_base}")

    def reset_kernel(mtt, ntt, acc_base) -> UopKernel:
        dfo, dfi = (1, mtt) if transposed else (ntt, 1)

        def build(b: UopBuilder):
            b.loop_begin(mtt, dst_factor=dfo, src_factor=0)
            b.loop_begin(ntt, dst_factor=dfi, src_factor=0)
            b.push(dst=acc_base, src=0)
            b.loop_end(); b.loop_end()
        return rt.uop_kernel(build, key=f"rst{tp}.{mtt}.{ntt}.{acc_base}")

    def alu_tile_kernel(mtt, ntt, acc_base, src_base, src_fo, src_fi, tag) -> UopKernel:
        dfo, dfi = (1, mtt) if transposed else (ntt, 1)

        def build(b: UopBuilder):
            b.loop_begin(mtt, dst_factor=dfo, src_factor=src_fo)
            b.loop_begin(ntt, dst_factor=dfi, src_factor=src_fi)
            b.push(dst=acc_base, src=src_base)
            b.loop_end(); b.loop_end()
        return rt.uop_kernel(build,
                             key=f"alu{tp}.{tag}.{mtt}.{ntt}.{acc_base}.{src_base}.{src_fo}.{src_fi}")

    def tile_program(i: int, j: int, t: int):
        """Phase generator for one macro tile executed on virtual thread t.
        Yields once per (load group | compute group | store) phase so the
        driver can interleave threads at *phase granularity* — required for
        the information-less token pairing to be safe (Fig. 14)."""
        d = deps[t]
        mtt = min(mt, Mb - i * mt)
        ntt = min(nt, Nb - j * nt)
        acc_base = sram.acc_base + t * acc_ctx
        # bias tile staged in the second half of the acc context
        bias_sram = sram.acc_base + t * acc_ctx + mt * nt
        inp_base0 = sram.inp_base + t * inp_ctx
        wgt_base0 = sram.wgt_base + t * wgt_ctx
        # self-epilogue source factors must track the dst grid layout
        self_fo, self_fi = (1, mtt) if transposed else (ntt, 1)

        first_compute_of_tile = True
        for kk in range(n_k):
            ktt = min(kt, Kb - kk * kt)
            # ---- load group ----
            d.begin_load_group(rt)

            def load_a(kk=kk, ktt=ktt):
                if transposed:
                    rt.load_buffer_2d(MemId.INP, inp_base0,
                                      a_base + (kk * kt) * a_stride + i * mt,
                                      y_size=ktt, x_size=mtt,
                                      x_stride=a_stride)
                else:
                    rt.load_buffer_2d(MemId.INP, inp_base0,
                                      a_base + (i * mt) * a_stride + kk * kt,
                                      y_size=mtt, x_size=ktt,
                                      x_stride=a_stride)

            def load_w(kk=kk, ktt=ktt):
                rt.load_buffer_2d(MemId.WGT, wgt_base0,
                                  w_base + (j * nt) * Kb + kk * kt,
                                  y_size=ntt, x_size=ktt, x_stride=Kb)

            emit_fenced_load_group(rt, fence_pending, load_a, load_w)
            d.end_load_group(rt)
            yield
            # ---- compute group ----
            d.begin_compute_group(rt, pops_acc=first_compute_of_tile)
            if first_compute_of_tile:
                rt.push_gemm(reset_kernel(mtt, ntt, acc_base), reset=True)
                if has_bias:
                    rt.load_buffer_2d(MemId.ACC, bias_sram,
                                      b_base + j * nt,
                                      y_size=1, x_size=ntt, x_stride=Nb)
                first_compute_of_tile = False
            rt.push_gemm(gemm_kernel(mtt, ntt, ktt, acc_base,
                                     inp_base0, wgt_base0))
            d.end_compute_group_frees_loads(rt)
            yield

        # ---- epilogue on the tensor ALU ----
        if has_bias:
            rt.push_alu(alu_tile_kernel(mtt, ntt, acc_base, bias_sram,
                                        0, 1, "bias"),
                        op=AluOp.ADD, use_imm=False)
        if ep.shift:
            rt.push_alu(alu_tile_kernel(mtt, ntt, acc_base, acc_base,
                                        self_fo, self_fi, "self"),
                        op=AluOp.SHR, imm=ep.shift)
        clip_lo = ep.folded_clip_lo
        if ep.relu and clip_lo is None:
            rt.push_alu(alu_tile_kernel(mtt, ntt, acc_base, acc_base,
                                        self_fo, self_fi, "self"),
                        op=AluOp.MAX, imm=0)
        if clip_lo is not None:
            rt.push_alu(alu_tile_kernel(mtt, ntt, acc_base, acc_base,
                                        self_fo, self_fi, "self"),
                        op=AluOp.MAX, imm=clip_lo)
            rt.push_alu(alu_tile_kernel(mtt, ntt, acc_base, acc_base,
                                        self_fo, self_fi, "self"),
                        op=AluOp.MIN, imm=ep.clip_hi)
        # ---- store (own phase: the peer thread's epilogue precedes this
        # store in program order, so the backend's batched tile dispatch
        # sees every peer tile fully recorded at the group's first store;
        # per-queue FIFO order — hence execution and timing — unchanged)
        d.compute_to_store(rt, own_insn=ep.n_alu_passes > 0)
        yield
        d.begin_store(rt)
        if transposed:
            rt.store_buffer_2d(acc_base,
                               c_base + (j * nt) * c_stride + i * mt,
                               y_size=ntt, x_size=mtt, x_stride=c_stride)
        else:
            rt.store_buffer_2d(acc_base,
                               c_base + (i * mt) * c_stride + j * nt,
                               y_size=mtt, x_size=ntt, x_stride=c_stride)
        d.end_store(rt)
        yield

    tiles = [(i, j) for i in range(n_m) for j in range(n_n)]
    interleave_virtual_threads(
        tiles, vt, lambda coord, t: tile_program(coord[0], coord[1], t))
    return mt, nt, kt


def schedule_matmul(rt: Runtime, a: np.ndarray, w: np.ndarray,
                    epilogue: Optional[Epilogue] = None,
                    virtual_threads: int = 2,
                    sram: Optional[SramPartition] = None) -> MatmulPlan:
    """Lower C = A @ W^T (+epilogue) onto VTA.  Returns the plan whose
    c_addr holds the blocked int8 result after rt.synchronize().

    Thin wrapper over ``lower_matmul``: stages the operands in DRAM and
    delegates the stream emission to the lowering pass."""
    spec = rt.spec
    ep = epilogue or Epilogue()
    M, K = a.shape
    N, K2 = w.shape
    assert K == K2, (K, K2)

    ab = layout.pack_inp(a, spec)
    wb = layout.pack_wgt(w, spec)
    Mb, Kb = ab.shape[0], ab.shape[1]
    Nb = wb.shape[0]
    a_addr = rt.copy_to_device(ab, align=spec.inp_elem_bytes)
    w_addr = rt.copy_to_device(wb, align=spec.wgt_elem_bytes)
    out_bytes = Mb * Nb * spec.out_elem_bytes
    c_addr = rt.buffer_alloc(out_bytes, align=spec.out_elem_bytes)
    bias_addr = -1
    if ep.bias_blocked is not None:
        bias_addr = rt.copy_to_device(
            np.ascontiguousarray(ep.bias_blocked, dtype=np.int32),
            align=spec.acc_elem_bytes)

    tiles = lower_matmul(
        rt,
        a_base=rt.to_elem_addr(a_addr, MemId.INP),
        w_base=rt.to_elem_addr(w_addr, MemId.WGT),
        c_base=rt.to_elem_addr(c_addr, MemId.OUT),
        Mb=Mb, Nb=Nb, Kb=Kb, epilogue=ep,
        bias_base=(rt.to_elem_addr(bias_addr, MemId.ACC)
                   if bias_addr >= 0 else -1),
        virtual_threads=virtual_threads, sram=sram)

    return MatmulPlan(M=M, N=N, K=K, Mb=Mb, Nb=Nb, Kb=Kb, tiles=tiles,
                      a_addr=a_addr, w_addr=w_addr, c_addr=c_addr,
                      bias_addr=bias_addr)


def read_matmul_result(rt: Runtime, plan: MatmulPlan,
                       device=None) -> np.ndarray:
    """Read back the blocked int8 result.  `device` overrides rt.device so
    results can be read from a cloned device (cross-backend checking)."""
    spec = rt.spec
    blocked = rt.copy_from_device(
        plan.c_addr, plan.Mb * plan.Nb * spec.out_elem_bytes, np.int8,
        (plan.Mb, plan.Nb, spec.batch, spec.block_out), device=device)
    return layout.unpack_out(blocked, plan.M, plan.N, spec)


def matmul_reference(a: np.ndarray, w: np.ndarray,
                     epilogue: Optional[Epilogue] = None,
                     spec: Optional[HardwareSpec] = None) -> np.ndarray:
    """Pure-numpy oracle with identical integer semantics."""
    ep = epilogue or Epilogue()
    acc = a.astype(np.int64) @ w.astype(np.int64).T
    if ep.bias_blocked is not None and spec is not None:
        bias = ep.bias_blocked  # (Nb, BATCH, BLOCK_OUT): batch rows identical
        flat = bias[:, 0, :].reshape(-1)[:w.shape[0]]
        acc = acc + flat.astype(np.int64)[None, :]
    if ep.shift:
        acc = acc >> ep.shift
    clip_lo = ep.folded_clip_lo  # relu folds into the clip lower bound
    if ep.relu and clip_lo is None:
        acc = np.maximum(acc, 0)
    if clip_lo is not None:
        acc = np.clip(acc, clip_lo, ep.clip_hi)
    return acc.astype(np.int32).astype(np.int8)  # truncating out-store


# ----------------------------------------------------------------------
# elementwise vector ops (the Listing-1 vector-add path)
# ----------------------------------------------------------------------
def lower_vector_binop(rt: Runtime, *, a_base: int, b_base: int, c_base: int,
                       ne: int, op: AluOp = AluOp.ADD,
                       sram: Optional[SramPartition] = None) -> None:
    """Emit the chunked vector-ALU schedule (element addresses, like
    ``lower_matmul``).  Emits a self-synchronized protocol for *its own*
    SRAM traffic only; the program compiler inserts the cross-op tokens
    when composing it with other lowered ops in one stream."""
    spec = rt.spec
    sram = sram or SramPartition.full(spec)
    cap = sram.acc_depth // 2
    if cap < 1:
        raise ValueError(f"acc partition depth {sram.acc_depth} cannot "
                         "double-buffer even one vector element")
    acc0 = sram.acc_base
    stream_start = rt.stream_len   # validate only this schedule's suffix
    done = 0
    while done < ne:
        cur = min(cap, ne - done)
        # both operands staged via the compute module's ACC-load path
        rt.load_buffer_2d(MemId.ACC, acc0, a_base + done,
                          y_size=1, x_size=cur, x_stride=cur)
        rt.load_buffer_2d(MemId.ACC, acc0 + cap, b_base + done,
                          y_size=1, x_size=cur, x_stride=cur)

        def build(bu: UopBuilder, cur=cur):
            bu.loop_begin(cur, dst_factor=1, src_factor=1)
            bu.push(dst=acc0, src=acc0 + cap)
            bu.loop_end()
        rt.push_alu(rt.uop_kernel(build, key=f"vec.{op}.{cur}.{acc0}.{cap}"),
                    op=op, use_imm=False)
        rt.dep_push(COMPUTE_Q, STORE_Q)
        rt.dep_pop(COMPUTE_Q, STORE_Q)
        rt.store_buffer_2d(acc0, c_base + done,
                           y_size=1, x_size=cur, x_stride=cur)
        done += cur
        if done < ne:
            # WAR: the next chunk's ACC loads overwrite rows this store is
            # still draining.  Only emitted when another chunk follows, so
            # the stream ends with every dependence FIFO at net zero.
            rt.dep_push(STORE_Q, COMPUTE_Q)
            rt.dep_pop(STORE_Q, COMPUTE_Q)
    rt.validate_stream(require_net_zero=True, start=stream_start)


def schedule_vector_binop(rt: Runtime, a: np.ndarray, b: np.ndarray,
                          op: AluOp = AluOp.ADD,
                          sram: Optional[SramPartition] = None
                          ) -> Tuple[int, Tuple[int, ...]]:
    """C = a (op) b over int32 vectors via the tensor ALU (Listing 1).
    Thin wrapper over ``lower_vector_binop``."""
    spec = rt.spec
    lane = spec.batch * spec.block_out
    a = np.asarray(a, np.int32).ravel()
    b = np.asarray(b, np.int32).ravel()
    n = a.size
    ne = _ceil_div(n, lane)
    ab = np.zeros((ne, spec.batch, spec.block_out), np.int32)
    bb = np.zeros_like(ab)
    ab.reshape(-1)[:n] = a
    bb.reshape(-1)[:n] = b
    a_addr = rt.copy_to_device(ab, align=spec.acc_elem_bytes)
    b_addr = rt.copy_to_device(bb, align=spec.acc_elem_bytes)
    c_addr = rt.buffer_alloc(ne * spec.out_elem_bytes, align=spec.out_elem_bytes)
    lower_vector_binop(rt,
                       a_base=rt.to_elem_addr(a_addr, MemId.ACC),
                       b_base=rt.to_elem_addr(b_addr, MemId.ACC),
                       c_base=rt.to_elem_addr(c_addr, MemId.OUT),
                       ne=ne, op=op, sram=sram)
    return c_addr, (ne, spec.batch, spec.block_out)


def read_vector_result(rt: Runtime, c_addr: int, shape: Tuple[int, ...],
                       n: int, device=None) -> np.ndarray:
    ne = shape[0]
    spec = rt.spec
    blocked = rt.copy_from_device(c_addr, ne * spec.out_elem_bytes, np.int8,
                                  (ne, spec.batch, spec.block_out),
                                  device=device)
    return blocked.reshape(-1)[:n]
