"""Public op: a chain of VTA tensor-ALU steps over an int32 tensor.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the CUDA kernel; any other device raises.  There is no fallback between
the two.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import MAX_OPS, OP_CODES, tensor_alu_cuda
from .ref import tensor_alu_ref


def tensor_alu(dst: torch.Tensor, src: Optional[torch.Tensor] = None,
               *, chain: Tuple[Tuple[str, Optional[int]], ...]
               ) -> torch.Tensor:
    """Apply `chain` — (op, imm) steps, imm=None meaning tensor-tensor with
    `src` — element-wise to int32 `dst`; returns a new int32 tensor."""
    chain = tuple(chain)
    for op, imm in chain:
        if op not in OP_CODES:
            raise ValueError(f"unknown ALU op {op!r}")
        if imm is None and src is None:
            raise ValueError(f"tensor-tensor step {op!r} needs src")
    if dst.dtype != torch.int32 or (src is not None
                                    and (src.dtype != torch.int32
                                         or src.shape != dst.shape)):
        raise TypeError("tensor_alu takes int32 dst and a same-shape int32 "
                        "src")
    dev = dst.device
    if src is not None and src.device != dev:
        raise ValueError("tensor_alu operands on different devices")
    if dev.type == "cpu":
        return tensor_alu_ref(dst, src, chain=chain)
    if dev.type != "cuda":
        raise ValueError(f"tensor_alu has no kernel for device {dev}")
    x = dst.contiguous()
    if not chain or x.numel() == 0:
        return x.clone()
    uses_src = any(imm is None for _, imm in chain)
    s = src.contiguous() if uses_src else None
    for i in range(0, len(chain), MAX_OPS):
        x = tensor_alu_cuda(x, s, chain[i:i + MAX_OPS])
        tensor_alu.launches += 1
        key = (tuple(x.shape), chain[i:i + MAX_OPS])
        tensor_alu.shapes[key] = tensor_alu.shapes.get(key, 0) + 1
    return x


#: kernel launches made by this op (plain-version calls do not count)
tensor_alu.launches = 0
#: (shape, chain) -> launches with that shape and chain
tensor_alu.shapes = {}


def requantize(acc: torch.Tensor, shift: int, lo: int = -128,
               hi: int = 127) -> torch.Tensor:
    """The canonical VTA epilogue: SHR then clip (MIN/MAX pair)."""
    return tensor_alu(acc, chain=(("shr", shift), ("max", lo), ("min", hi)))
