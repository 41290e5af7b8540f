"""Public ops: a chain of VTA tensor-ALU steps over an int32 tensor
(:func:`tensor_alu`), and the task-ISA engine's tile epilogue, the
scatter of a tile batch's GEMM blocks into the tiles' layout with the
chain, in one launch (:func:`tensor_alu_scatter`).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the CUDA kernel; any other device raises.  There is no fallback between
the two.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .._grad import refuse_grad
from .block_map import BlockMap
from .kernel import (MAX_OPS, MAX_SRC, MAX_T, OP_CODES, tensor_alu_cuda,
                     tensor_alu_scatter_cuda)
from .ref import tensor_alu_ref, tensor_alu_scatter_ref


def _check_chain(chain, has_src: bool) -> None:
    for op, imm in chain:
        if op not in OP_CODES:
            raise ValueError(f"unknown ALU op {op!r}")
        if imm is None and not has_src:
            raise ValueError(f"tensor-tensor step {op!r} needs src")


def tensor_alu(dst: torch.Tensor, src: Optional[torch.Tensor] = None,
               *, chain: Tuple[Tuple[str, Optional[int]], ...]
               ) -> torch.Tensor:
    """Apply `chain` — (op, imm) steps, imm=None meaning tensor-tensor with
    `src` — element-wise to int32 `dst`; returns a new int32 tensor."""
    refuse_grad("tensor_alu", (dst, src))
    chain = tuple(chain)
    _check_chain(chain, src is not None)
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


def tensor_alu_scatter(mats: Sequence[Sequence[torch.Tensor]],
                       bmap: BlockMap,
                       bias: Optional[Sequence[torch.Tensor]] = None, *,
                       chain: Tuple[Tuple[str, Optional[int]], ...] = ()
                       ) -> torch.Tensor:
    """The tile epilogue of T tiles of one structure: ``mats[t][g]`` is
    tile t's GEMM output of weight group g (``bmap.rows[g]`` x
    ``bmap.widths[g]``, int32, or int8 after a fused requant, contiguous
    rows), ``bias[t]`` its (R, C) int32 tensor operand, read by the steps
    whose imm is None (at most MAX_OPS steps).  Returns (T, R, C) int32:
    each tile's blocks summed as ``bmap`` says, in int32 wraparound, then
    the chain.  Tiles beyond MAX_T (or MAX_SRC outputs) take more
    launches."""
    refuse_grad("tensor_alu_scatter",
                [t for row in mats for t in row] + list(bias or ()))
    chain = tuple(chain)
    _check_chain(chain, bias is not None)
    T, G = len(mats), len(bmap.groups)
    if T == 0 or len(chain) > MAX_OPS or G > MAX_SRC:
        raise ValueError(f"tensor_alu_scatter: {T} tiles, {G} weight "
                         f"groups, {len(chain)} chain steps")
    dtype = mats[0][0].dtype
    dev = mats[0][0].device
    for tile in mats:
        if len(tile) != G:
            raise ValueError("tensor_alu_scatter: a tile's GEMM outputs do "
                             "not match the block map's weight groups")
        for m, rows, width in zip(tile, bmap.rows, bmap.widths):
            if m.dtype != dtype or dtype not in (torch.int32, torch.int8) \
                    or m.dim() != 2 or m.shape[0] < rows \
                    or m.shape[1] != width or m.stride() != (width, 1) \
                    or m.device != dev:
                raise ValueError(f"tensor_alu_scatter: a GEMM output "
                                 f"{tuple(m.shape)} {m.dtype} does not "
                                 f"match ({rows}, {width}) int32 or int8 "
                                 f"with contiguous rows on {dev}")
    R, C = bmap.shape
    if bias is not None:
        if len(bias) != T or any(
                b.dtype != torch.int32 or tuple(b.shape) != (R, C)
                or b.device != dev for b in bias):
            raise ValueError(f"tensor_alu_scatter takes one ({R}, {C}) "
                             f"int32 tensor operand per tile")
    if dev.type == "cpu":
        return tensor_alu_scatter_ref(mats, bmap, bias, chain=chain)
    if dev.type != "cuda":
        raise ValueError(f"tensor_alu_scatter has no kernel for device "
                         f"{dev}")
    if bias is not None:
        bias = [b.contiguous() for b in bias]
    out = torch.empty((T, R, C), dtype=torch.int32, device=dev)
    step = min(MAX_T, MAX_SRC // G)
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        tensor_alu_scatter_cuda(mats[t0:t1], bmap,
                                None if bias is None else bias[t0:t1],
                                chain, out[t0:t1])
        tensor_alu_scatter.launches += 1
        key = (t1 - t0, R, C, G, bmap.nnz, str(dtype).split(".")[-1],
               bias is not None, chain)
        tensor_alu_scatter.shapes[key] = \
            tensor_alu_scatter.shapes.get(key, 0) + 1
        tensor_alu_scatter.maps[key] = bmap
    return out


#: kernel launches made by this op (plain-version calls do not count)
tensor_alu_scatter.launches = 0
#: (T, R, C, weight groups, map entries, GEMM dtype, tensor operand,
#: chain) -> launches at that shape
tensor_alu_scatter.shapes = {}
#: the same keys -> the block map of the last launch at that shape
tensor_alu_scatter.maps = {}


def requantize(acc: torch.Tensor, shift: int, lo: int = -128,
               hi: int = 127) -> torch.Tensor:
    """The canonical VTA epilogue: SHR then clip (MIN/MAX pair)."""
    return tensor_alu(acc, chain=(("shr", shift), ("max", lo), ("min", hi)))
