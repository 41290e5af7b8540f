"""Plain PyTorch version of the tensor-ALU kernel.  The CPU tests run it;
on the card it is what the kernel is held against."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .block_map import BlockMap

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


def tensor_alu_scatter_ref(mats: Sequence[Sequence[torch.Tensor]],
                           bmap: BlockMap,
                           bias: Optional[Sequence[torch.Tensor]] = None,
                           *, chain: Tuple[Tuple[str, Optional[int]], ...]
                           ) -> torch.Tensor:
    """The scatter instance's plain version: for each tile t, its parts'
    blocks of the GEMM outputs ``mats[t][g]`` summed into the tile's
    layout (the engine's scatter arithmetic: positions by argsort and
    searchsorted of the tile's grid, index_add_ in int64, wrapped to int32
    once at the end), then ``chain`` over it with ``bias[t]`` as the
    tensor operand.  Returns (T, R, C) int32.  It reads the grids, not the
    map's CSR arrays, so the kernel is held against an independent
    derivation of the same sums."""
    io, ii = bmap.grid.shape
    nb, bo = bmap.batch, bmap.block_out
    flat = bmap.grid.ravel()
    order = np.argsort(flat)
    outs = []
    for t, tile_mats in enumerate(mats):
        dev = tile_mats[0].device
        acc = torch.zeros((flat.size, nb, bo), dtype=torch.int64, device=dev)
        for parts, mat in zip(bmap.groups, tile_mats):
            for g, row0 in parts:
                pio, pii = g.shape
                part = mat[row0:row0 + pio * nb]
                blocked = part.reshape(pio, nb, pii, bo).permute(0, 2, 1, 3) \
                    .reshape(-1, nb, bo)
                pos = order[np.searchsorted(flat, g.ravel(), sorter=order)]
                acc.index_add_(0, torch.as_tensor(pos, device=dev),
                               blocked.to(torch.int64))
        x = acc.to(torch.int32).reshape(io, ii, nb, bo).permute(0, 2, 1, 3) \
            .reshape(io * nb, ii * bo)
        outs.append(tensor_alu_ref(x, None if bias is None else bias[t],
                                   chain=chain))
    return torch.stack(outs)
