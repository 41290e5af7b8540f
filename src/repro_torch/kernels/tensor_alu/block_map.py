"""The block map of the scatter instance: which blocks of a tile batch's
GEMM outputs sum into each block of the tile.

A tile is an (io x ii) grid of accumulator-SRAM entries (blocks of batch
x block_out int32); the engine computes it from weight groups, each one
GEMM whose output rows stack the group's parts, and a part covers a
sub-grid of the tile (or all of it).  The map lists, for every block of
the tile, its source blocks (weight group, element offset of the block's
first row in that group's output) in CSR form.  It depends only on the
tile's structure (grids relative to the tile's first entry), so the
engine builds one per structure and keeps it, with its device copy.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


class BlockMap:
    """The scatter of one tile structure.

    ``grid``: the tile's (io, ii) accumulator ids; ``groups``: per weight
    group, the list of its parts as (part grid, first row of the part in
    the group's GEMM output); ``batch`` and ``block_out`` the block's
    shape.  Ids need only be consistent between the tile and its parts.
    The host arrays ``row_ptr`` (io * ii + 1) and ``ent`` (nnz, 2: group,
    offset) are built here; :meth:`tensors` copies them to a device once
    per device."""

    def __init__(self, grid: np.ndarray,
                 groups: Sequence[Sequence[Tuple[np.ndarray, int]]],
                 batch: int, block_out: int):
        self.grid = np.asarray(grid)
        self.groups = [[(np.asarray(g), int(off)) for g, off in parts]
                       for parts in groups]
        self.batch, self.block_out = int(batch), int(block_out)
        io, ii = self.grid.shape
        self.shape = (io * self.batch, ii * self.block_out)
        # each group's GEMM output: (rows, width) int32 or int8, every part
        # of a group as wide as the group
        self.widths: List[int] = []
        self.rows: List[int] = []
        flat = self.grid.ravel()
        order = np.argsort(flat, kind="stable")
        dst, grp, off = [], [], []
        for gi, parts in enumerate(self.groups):
            width = parts[0][0].shape[1] * self.block_out
            rows = 0
            for g, row0 in parts:
                if g.shape[1] * self.block_out != width:
                    raise ValueError("the parts of a weight group differ in "
                                     "width")
                idx = np.searchsorted(flat, g.ravel(), sorter=order)
                pos = order[np.minimum(idx, flat.size - 1)]
                if not np.array_equal(flat[pos], g.ravel()):
                    raise ValueError("a part covers blocks outside the tile")
                pi, pj = np.divmod(np.arange(g.size), g.shape[1])
                dst.append(pos)
                grp.append(np.full(g.size, gi))
                off.append((row0 + pi * self.batch) * width
                           + pj * self.block_out)
                rows = max(rows, row0 + g.shape[0] * self.batch)
            self.widths.append(width)
            self.rows.append(rows)
        dst_a = np.concatenate(dst) if dst else np.zeros(0, np.int64)
        srt = np.argsort(dst_a, kind="stable")
        self.row_ptr = np.zeros(flat.size + 1, np.int64)
        np.cumsum(np.bincount(dst_a, minlength=flat.size),
                  out=self.row_ptr[1:])
        ent = np.stack([np.concatenate(grp)[srt], np.concatenate(off)[srt]],
                       axis=1) if dst else np.zeros((0, 2), np.int64)
        if ent.size and ent[:, 1].max() >= 2 ** 31:
            raise ValueError("a GEMM output too large for the block map's "
                             "int32 offsets")
        self.ent = ent.astype(np.int32)
        self.row_ptr = self.row_ptr.astype(np.int32)
        self._dev: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def nnz(self) -> int:
        return int(self.ent.shape[0])

    def tensors(self, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(row_ptr, ent) on `device`, copied there on first use."""
        dev = torch.device(device)
        hit = self._dev.get(dev)
        if hit is None:
            # the ent array is never empty on the device: a (1, 2) pad
            # keeps the pointer valid for a map with no sources
            ent = self.ent if self.nnz else np.zeros((1, 2), np.int32)
            hit = self._dev[dev] = (
                torch.from_numpy(self.row_ptr).to(dev),
                torch.from_numpy(np.ascontiguousarray(ent)).to(dev))
            BlockMap.uploads += 1
        return hit


#: device copies made by BlockMap.tensors (every map, every device)
BlockMap.uploads = 0
