"""VTA two-level ISA: 128-bit CISC instructions, bit-packed.

Four CISC instructions (§2.2): LOAD, GEMM, ALU, STORE (+ FINISH sentinel).
Every instruction carries 4 dependence-flag bits (pop_prev, pop_next,
push_prev, push_next) that drive the RAW/WAR token FIFOs between the
load / compute / store modules (§2.3, Fig. 3).

Field widths are *derived from the HardwareSpec* (SRAM depths, intrinsic
shape), reproducing the paper's co-design fluidity: change the template
parameters and the binary encoding changes with them; the runtime and
simulator re-derive the layout so generated code always matches the
generated hardware instance.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from enum import IntEnum
from typing import List, Tuple

import numpy as np

from .hwspec import HardwareSpec

INSN_BITS = 128


class Opcode(IntEnum):
    LOAD = 0
    STORE = 1
    GEMM = 2
    FINISH = 3
    ALU = 4


class MemId(IntEnum):
    """Target scratchpad of a LOAD/STORE (data-specialized SRAMs, §2.6)."""
    UOP = 0
    WGT = 1
    INP = 2
    ACC = 3
    OUT = 4


class AluOp(IntEnum):
    MIN = 0
    MAX = 1
    ADD = 2
    SHR = 3   # arithmetic shift right; negative shift = shift left
    MUL = 4


# module ids for dependence-token routing
LOAD_Q, COMPUTE_Q, STORE_Q = 1, 2, 3

# Dependence-edge tables shared by every stream consumer (runtime validator,
# backends): which token FIFO a queue's instruction consumes / produces, and
# the dep flag that requests it.  Each module consumes from a disjoint FIFO
# set — the property that makes greedy FIFO-order replay an *exact*
# deadlock check (firing an enabled instruction can never disable another).
DEP_IN_EDGES = {LOAD_Q: (("c2l", "pop_next"),),
                COMPUTE_Q: (("l2c", "pop_prev"), ("s2c", "pop_next")),
                STORE_Q: (("c2s", "pop_prev"),)}
DEP_OUT_EDGES = {LOAD_Q: (("l2c", "push_next"),),
                 COMPUTE_Q: (("c2l", "push_prev"), ("c2s", "push_next")),
                 STORE_Q: (("s2c", "push_prev"),)}


@dataclass
class DepFlags:
    pop_prev: bool = False
    pop_next: bool = False
    push_prev: bool = False
    push_next: bool = False


@dataclass
class LoadStoreInsn:
    """2D strided DMA between DRAM and an SRAM (Fig. 3, Fig. 9).

    Addresses are in *elements* of the target buffer (one element = one
    tensor register row, e.g. a BATCH x BLOCK_IN int8 block for INP).
    Padding fields insert zero rows/columns on the fly (conv2d tiling
    without host-side re-layout)."""
    opcode: Opcode            # LOAD or STORE
    dep: DepFlags
    memory_type: MemId
    sram_base: int
    dram_base: int
    y_size: int               # number of rows
    x_size: int               # elements per row
    x_stride: int             # DRAM row stride, elements
    y_pad_0: int = 0
    y_pad_1: int = 0
    x_pad_0: int = 0
    x_pad_1: int = 0


@dataclass
class GemmInsn:
    """Micro-coded GEMM (Fig. 7): runs uops[uop_bgn:uop_end] inside a
    2-level nested loop; tensor-register indices are affine in the loop
    variables.  `reset` zeroes the accumulator instead of multiplying."""
    dep: DepFlags
    reset: bool
    uop_bgn: int
    uop_end: int
    iter_out: int
    iter_in: int
    dst_factor_out: int
    dst_factor_in: int
    src_factor_out: int
    src_factor_in: int
    wgt_factor_out: int
    wgt_factor_in: int
    opcode: Opcode = Opcode.GEMM


@dataclass
class AluInsn:
    """Micro-coded tensor-ALU op (Fig. 8), same 2-level loop structure.
    src operand is a register-file tensor or an immediate."""
    dep: DepFlags
    reset: bool
    uop_bgn: int
    uop_end: int
    iter_out: int
    iter_in: int
    dst_factor_out: int
    dst_factor_in: int
    src_factor_out: int
    src_factor_in: int
    alu_opcode: AluOp
    use_imm: bool
    imm: int
    opcode: Opcode = Opcode.ALU


@dataclass
class FinishInsn:
    dep: DepFlags
    opcode: Opcode = Opcode.FINISH


Insn = LoadStoreInsn | GemmInsn | AluInsn | FinishInsn


# ----------------------------------------------------------------------
# bit packing
# ----------------------------------------------------------------------
class _Packer:
    def __init__(self, max_bits: int = INSN_BITS):
        self.value = 0
        self.pos = 0
        self.max_bits = max_bits

    def put(self, v: int, bits: int, name: str = "?"):
        v = int(v)
        if v < 0 or v >= (1 << bits):
            raise ValueError(f"field {name}={v} does not fit in {bits} bits")
        self.value |= v << self.pos
        self.pos += bits
        if self.pos > self.max_bits:
            raise ValueError(f"instruction exceeds {self.max_bits} bits")


class _Unpacker:
    def __init__(self, value: int):
        self.value = value
        self.pos = 0

    def get(self, bits: int) -> int:
        v = (self.value >> self.pos) & ((1 << bits) - 1)
        self.pos += bits
        return v


class IsaLayout:
    """Field-width table derived from a HardwareSpec."""

    OPCODE_BITS = 3
    MEMID_BITS = 3
    ALUOP_BITS = 3
    DRAM_ADDR_BITS = 32
    SIZE_BITS = 16
    STRIDE_BITS = 16
    PAD_BITS = 4
    LOOP_BITS = 14
    IMM_BITS = 16

    def __init__(self, spec: HardwareSpec):
        self.spec = spec
        # SRAM address width = max over scratchpads (shared field)
        self.sram_addr_bits = max(
            spec.inp_addr_bits, spec.wgt_addr_bits,
            spec.acc_addr_bits, spec.uop_addr_bits, 12,
        )
        self.uop_addr_bits = max(spec.uop_addr_bits, 12) + 1  # uop_end is exclusive
        # affine factor widths: must address the largest scratchpad
        self.factor_bits = max(spec.acc_addr_bits, spec.inp_addr_bits,
                               spec.wgt_addr_bits, 11)
        # co-design fluidity (§2.2): large template instances widen the
        # instruction word from 128 to 256 bits so all fields still fit.
        gemm_bits = (self.OPCODE_BITS + 4 + 1 + 2 * self.uop_addr_bits
                     + 2 * self.LOOP_BITS + 6 * self.factor_bits)
        mem_bits = (self.OPCODE_BITS + 4 + self.MEMID_BITS
                    + self.sram_addr_bits + self.DRAM_ADDR_BITS
                    + 2 * self.SIZE_BITS + self.STRIDE_BITS + 4 * self.PAD_BITS)
        need = max(gemm_bits, mem_bits)
        self.insn_bits = 128 if need <= 128 else 256
        self.insn_words = self.insn_bits // 64

    @property
    def insn_bytes(self) -> int:
        return self.insn_bits // 8

    # ---- encode ----
    def encode(self, insn: Insn) -> Tuple[int, ...]:
        p = _Packer(self.insn_bits)
        p.put(insn.opcode, self.OPCODE_BITS, "opcode")
        d = insn.dep
        p.put(d.pop_prev, 1); p.put(d.pop_next, 1)
        p.put(d.push_prev, 1); p.put(d.push_next, 1)
        if isinstance(insn, LoadStoreInsn):
            p.put(insn.memory_type, self.MEMID_BITS, "memory_type")
            p.put(insn.sram_base, self.sram_addr_bits, "sram_base")
            p.put(insn.dram_base, self.DRAM_ADDR_BITS, "dram_base")
            p.put(insn.y_size, self.SIZE_BITS, "y_size")
            p.put(insn.x_size, self.SIZE_BITS, "x_size")
            p.put(insn.x_stride, self.STRIDE_BITS, "x_stride")
            p.put(insn.y_pad_0, self.PAD_BITS, "y_pad_0")
            p.put(insn.y_pad_1, self.PAD_BITS, "y_pad_1")
            p.put(insn.x_pad_0, self.PAD_BITS, "x_pad_0")
            p.put(insn.x_pad_1, self.PAD_BITS, "x_pad_1")
        elif isinstance(insn, GemmInsn):
            p.put(insn.reset, 1, "reset")
            p.put(insn.uop_bgn, self.uop_addr_bits, "uop_bgn")
            p.put(insn.uop_end, self.uop_addr_bits, "uop_end")
            p.put(insn.iter_out, self.LOOP_BITS, "iter_out")
            p.put(insn.iter_in, self.LOOP_BITS, "iter_in")
            p.put(insn.dst_factor_out, self.factor_bits, "dst_factor_out")
            p.put(insn.dst_factor_in, self.factor_bits, "dst_factor_in")
            p.put(insn.src_factor_out, self.factor_bits, "src_factor_out")
            p.put(insn.src_factor_in, self.factor_bits, "src_factor_in")
            p.put(insn.wgt_factor_out, self.factor_bits, "wgt_factor_out")
            p.put(insn.wgt_factor_in, self.factor_bits, "wgt_factor_in")
        elif isinstance(insn, AluInsn):
            p.put(insn.reset, 1, "reset")
            p.put(insn.uop_bgn, self.uop_addr_bits, "uop_bgn")
            p.put(insn.uop_end, self.uop_addr_bits, "uop_end")
            p.put(insn.iter_out, self.LOOP_BITS, "iter_out")
            p.put(insn.iter_in, self.LOOP_BITS, "iter_in")
            p.put(insn.dst_factor_out, self.factor_bits, "dst_factor_out")
            p.put(insn.dst_factor_in, self.factor_bits, "dst_factor_in")
            p.put(insn.src_factor_out, self.factor_bits, "src_factor_out")
            p.put(insn.src_factor_in, self.factor_bits, "src_factor_in")
            p.put(insn.alu_opcode, self.ALUOP_BITS, "alu_opcode")
            p.put(insn.use_imm, 1, "use_imm")
            p.put(np.uint16(np.int16(insn.imm)), self.IMM_BITS, "imm")
        elif isinstance(insn, FinishInsn):
            pass
        else:
            raise TypeError(type(insn))
        mask = (1 << 64) - 1
        return tuple((p.value >> (64 * i)) & mask
                     for i in range(self.insn_words))

    # ---- decode ----
    def decode(self, *words: int) -> Insn:
        value = 0
        for i, w in enumerate(words):
            value |= int(w) << (64 * i)
        u = _Unpacker(value)
        opcode = Opcode(u.get(self.OPCODE_BITS))
        dep = DepFlags(bool(u.get(1)), bool(u.get(1)), bool(u.get(1)), bool(u.get(1)))
        if opcode in (Opcode.LOAD, Opcode.STORE):
            return LoadStoreInsn(
                opcode=opcode, dep=dep,
                memory_type=MemId(u.get(self.MEMID_BITS)),
                sram_base=u.get(self.sram_addr_bits),
                dram_base=u.get(self.DRAM_ADDR_BITS),
                y_size=u.get(self.SIZE_BITS),
                x_size=u.get(self.SIZE_BITS),
                x_stride=u.get(self.STRIDE_BITS),
                y_pad_0=u.get(self.PAD_BITS), y_pad_1=u.get(self.PAD_BITS),
                x_pad_0=u.get(self.PAD_BITS), x_pad_1=u.get(self.PAD_BITS),
            )
        if opcode == Opcode.GEMM:
            return GemmInsn(
                dep=dep, reset=bool(u.get(1)),
                uop_bgn=u.get(self.uop_addr_bits), uop_end=u.get(self.uop_addr_bits),
                iter_out=u.get(self.LOOP_BITS), iter_in=u.get(self.LOOP_BITS),
                dst_factor_out=u.get(self.factor_bits), dst_factor_in=u.get(self.factor_bits),
                src_factor_out=u.get(self.factor_bits), src_factor_in=u.get(self.factor_bits),
                wgt_factor_out=u.get(self.factor_bits), wgt_factor_in=u.get(self.factor_bits),
            )
        if opcode == Opcode.ALU:
            return AluInsn(
                dep=dep, reset=bool(u.get(1)),
                uop_bgn=u.get(self.uop_addr_bits), uop_end=u.get(self.uop_addr_bits),
                iter_out=u.get(self.LOOP_BITS), iter_in=u.get(self.LOOP_BITS),
                dst_factor_out=u.get(self.factor_bits), dst_factor_in=u.get(self.factor_bits),
                src_factor_out=u.get(self.factor_bits), src_factor_in=u.get(self.factor_bits),
                alu_opcode=AluOp(u.get(self.ALUOP_BITS)),
                use_imm=bool(u.get(1)),
                imm=int(np.int16(np.uint16(u.get(self.IMM_BITS)))),
            )
        if opcode == Opcode.FINISH:
            return FinishInsn(dep=dep)
        raise ValueError(opcode)

    # ---- stream helpers ----
    def encode_stream(self, insns: List[Insn]) -> np.ndarray:
        out = np.zeros((len(insns), self.insn_words), dtype=np.uint64)
        for i, insn in enumerate(insns):
            for j, w in enumerate(self.encode(insn)):
                out[i, j] = np.uint64(w)
        return out

    def decode_stream(self, buf: np.ndarray) -> List[Insn]:
        return [self.decode(*(int(buf[i, j]) for j in range(buf.shape[1])))
                for i in range(buf.shape[0])]


def route_queue(insn: Insn) -> int:
    """fetch-module routing rule (§2.4): which command queue an instruction
    is pushed to.  LOADs of UOP/ACC data go to the *compute* queue; LOADs of
    INP/WGT go to the *load* queue; STOREs go to the store queue."""
    if isinstance(insn, LoadStoreInsn):
        if insn.opcode == Opcode.STORE:
            return STORE_Q
        if insn.memory_type in (MemId.INP, MemId.WGT):
            return LOAD_Q
        return COMPUTE_Q  # UOP / ACC loads execute on the compute module
    return COMPUTE_Q      # GEMM / ALU / FINISH
