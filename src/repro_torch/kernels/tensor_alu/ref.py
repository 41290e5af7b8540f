"""Plain PyTorch version of the tensor-ALU kernel.  The CPU tests run it;
on the card it is what the kernel is held against."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

ALU_OPS = ("min", "max", "add", "shr", "mul")


def alu_apply(op: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One VTA ALU op on int32 tensors (y broadcasts), computed in int64
    and wrapped back to int32, as the reference simulator does.  SHR by a
    negative amount shifts left; the amount is capped at 32, past which a
    right shift of an int32 value is all sign bits and a left shift keeps
    no low 32 bits (so -INT_MIN gives 0)."""
    x = x.to(torch.int64)
    y = y.to(torch.int64)
    if op == "min":
        r = torch.minimum(x, y)
    elif op == "max":
        r = torch.maximum(x, y)
    elif op == "add":
        r = x + y
    elif op == "mul":
        r = x * y
    elif op == "shr":
        amt = y.abs().clamp(max=32)
        r = torch.where(y >= 0, x >> amt, x << amt)
    else:
        raise ValueError(op)
    return r.to(torch.int32)


def tensor_alu_ref(dst: torch.Tensor, src: Optional[torch.Tensor] = None,
                   *, chain: Tuple[Tuple[str, Optional[int]], ...]
                   ) -> torch.Tensor:
    x = dst.to(torch.int32)
    for op, imm in chain:
        y = src if imm is None else torch.tensor(int(imm), dtype=torch.int32,
                                                 device=x.device)
        x = alu_apply(op, x, y)
    return x
