"""VTA RISC micro-ops (the lower level of the two-level ISA).

A micro-op is a 32-bit word holding three scratchpad indices
(dst = accumulator / register-file, src = input (GEMM) or accumulator
(ALU), wgt = weight).  The compute core executes a micro-op *sequence*
inside a 2-level nested loop; the effective index of each operand is an
affine function of the loop variables (§2.5):

    dst_idx = uop.dst + i0 * dst_factor_out + i1 * dst_factor_in
    src_idx = uop.src + i0 * src_factor_out + i1 * src_factor_in
    wgt_idx = uop.wgt + i0 * wgt_factor_out + i1 * wgt_factor_in

This loop compression keeps micro-kernels tiny (no control flow) while
covering matmul and 2D convolution access patterns.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from .hwspec import HardwareSpec


@dataclass(frozen=True)
class UOp:
    dst: int          # accumulator (register file) index
    src: int          # input-buffer index (GEMM) or accumulator index (ALU)
    wgt: int = 0      # weight-buffer index (GEMM only)


class UopLayout:
    def __init__(self, spec: HardwareSpec):
        self.dst_bits = spec.acc_addr_bits
        self.src_bits = max(spec.inp_addr_bits, spec.acc_addr_bits)
        self.wgt_bits = spec.wgt_addr_bits
        total = self.dst_bits + self.src_bits + self.wgt_bits
        if total > spec.uop_bits:
            raise ValueError(
                f"uop fields ({total} bits) exceed uop width {spec.uop_bits}; "
                "shrink SRAM depths or widen uops")

    def encode(self, u: UOp) -> int:
        for v, b, n in ((u.dst, self.dst_bits, "dst"),
                        (u.src, self.src_bits, "src"),
                        (u.wgt, self.wgt_bits, "wgt")):
            if v < 0 or v >= (1 << b):
                raise ValueError(f"uop field {n}={v} does not fit {b} bits")
        return u.dst | (u.src << self.dst_bits) | (
            u.wgt << (self.dst_bits + self.src_bits))

    def decode(self, word: int) -> UOp:
        word = int(word)
        dst = word & ((1 << self.dst_bits) - 1)
        src = (word >> self.dst_bits) & ((1 << self.src_bits) - 1)
        wgt = (word >> (self.dst_bits + self.src_bits)) & ((1 << self.wgt_bits) - 1)
        return UOp(dst, src, wgt)

    def encode_kernel(self, uops: List[UOp]) -> np.ndarray:
        return np.array([self.encode(u) for u in uops], dtype=np.uint32)

    def decode_kernel(self, words: np.ndarray) -> List[UOp]:
        return [self.decode(w) for w in np.asarray(words).ravel()]
