"""Simulated device driver: DRAM address space + control handshake.

Models the pieces of the FPGA platform the runtime needs (§3.2): a
physically-contiguous DRAM allocator (VTABufferAlloc), typed load/store
views for DMA, and the fetch-module control registers (§2.4: `control`,
`insn_count`, `insns`).  On real hardware these are AXI/MMIO; here they
drive the behavioural simulator.  Cache flush/invalidate (non-coherent
SoCs) are modelled as no-op hooks with counters so the runtime code path
stays faithful and testable.

The DRAM image is a ``torch.uint8`` tensor on an explicit torch device,
chosen where the ``Device`` is made.  The default is ``"cuda"``; a caller
that wants the CPU says so (``torch_device="cpu"``), and asking for the
card where there is none raises instead of quietly running on the CPU.
Host code reads and writes it through :meth:`Dram.read` (a host numpy
copy) and :meth:`Dram.write` (numpy or torch in); the engines address it
in place through :meth:`Dram.rows`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import numpy as np
import torch

TorchDeviceLike = Union[None, str, torch.device]


def resolve_torch_device(torch_device: TorchDeviceLike = None
                         ) -> torch.device:
    """None -> the card.  A CUDA device that is not there raises
    RuntimeError: nothing in this package runs on the CPU unless the
    caller asked for it."""
    dev = torch.device("cuda" if torch_device is None else torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass torch_device='cpu' to run "
            "on the CPU")
    return dev


def _zeros(size: int, dev: torch.device) -> torch.Tensor:
    if dev.type == "cpu":
        # numpy's zeros maps untouched pages lazily, like the reference's
        # image: a large address space costs nothing until it is written
        return torch.from_numpy(np.zeros(size, dtype=np.uint8))
    return torch.zeros(size, dtype=torch.uint8, device=dev)



class Dram:
    """Flat byte-addressed DRAM with a bump allocator (physically contiguous
    buffers, as required by VTA's DMA engines)."""

    def __init__(self, size: int = 1 << 28, align: int = 64,
                 torch_device: TorchDeviceLike = None):
        self.size = size
        self.align = align
        self.torch_device = resolve_torch_device(torch_device)
        self.mem = _zeros(size, self.torch_device)
        self._next = align  # keep address 0 as a null sentinel
        self._allocs: Dict[int, int] = {}

    def alloc(self, nbytes: int, align: int | None = None) -> int:
        a = max(self.align, align or 1)
        addr = (self._next + a - 1) // a * a
        if addr + nbytes > self.size:
            raise MemoryError(f"DRAM exhausted: {addr + nbytes} > {self.size}")
        self._next = addr + nbytes
        self._allocs[addr] = nbytes
        return addr

    def free(self, addr: int) -> None:
        self._allocs.pop(addr, None)  # bump allocator: bookkeeping only

    def clone(self, trim: bool = False) -> "Dram":
        """Independent copy of the DRAM state.  With ``trim`` the copy
        keeps only the ALLOCATED image (every byte below the bump
        pointer, rounded up to alignment): reads and writes of existing
        buffers behave identically, but any further ``alloc`` raises
        MemoryError — exactly the contract of a pooled serving device,
        whose pre-staged CompiledProgram must never allocate per call.
        A pool of trimmed clones costs O(used bytes) each instead of the
        full address-space image."""
        c = Dram.__new__(Dram)
        c.align = self.align
        c.torch_device = self.torch_device
        if trim:
            used = (self._next + self.align - 1) // self.align * self.align
            c.size = used
            c.mem = self.mem[:used].clone()
        else:
            c.size = self.size
            c.mem = self.mem.clone()
        c._next = self._next
        c._allocs = dict(self._allocs)
        return c

    def copy_from(self, other: "Dram") -> None:
        """Adopt another DRAM's full state (same-size images only)."""
        if other.size != self.size:
            raise ValueError(f"DRAM size mismatch: {other.size} != {self.size}")
        self.mem.copy_(other.mem)
        self._next = other._next
        self._allocs = dict(other._allocs)

    # -- typed access ---------------------------------------------------
    def write(self, addr: int, arr: Union[np.ndarray, torch.Tensor]) -> None:
        """Write host (numpy) or torch data at a byte address."""
        if isinstance(arr, torch.Tensor):
            b = arr.contiguous().reshape(-1).view(torch.uint8)
        else:
            b = torch.from_numpy(
                np.ascontiguousarray(arr).view(np.uint8).ravel())
        self.mem[addr:addr + b.numel()].copy_(b)

    def read(self, addr: int, nbytes: int, dtype=np.uint8, shape=None) -> np.ndarray:
        """Host copy of a byte range, viewed as `dtype` (one device-to-host
        copy on the card)."""
        raw = self.mem[addr:addr + nbytes].to("cpu", copy=True).numpy()
        out = raw.view(dtype)
        return out.reshape(shape) if shape is not None else out

    def rows(self, addr: int, n_rows: int, row_bytes: int,
             stride_bytes: int) -> torch.Tensor:
        """In-place (n_rows, row_bytes) uint8 view of the image: row y starts
        at ``addr + y * stride_bytes`` — one 2D DMA's footprint, so the
        engines move it with one strided copy."""
        end = addr + (n_rows - 1) * stride_bytes + row_bytes
        if addr < 0 or end > self.size:
            raise IndexError(f"DMA [{addr}, {end}) outside DRAM of "
                             f"{self.size} bytes")
        return self.mem.as_strided((n_rows, row_bytes), (stride_bytes, 1),
                                   self.mem.storage_offset() + addr)


@dataclass
class ControlRegisters:
    """fetch-module MMIO registers (§2.4)."""
    control: int = 0       # bit0 = start, bit1 = done
    insn_count: int = 0
    insns: int = 0         # DRAM physical address of the instruction stream

    def start(self) -> None:
        self.control |= 1
        self.control &= ~2

    def set_done(self) -> None:
        self.control &= ~1
        self.control |= 2

    @property
    def done(self) -> bool:
        return bool(self.control & 2)


class Device:
    """One simulated VTA device: DRAM + control registers + cache model."""

    def __init__(self, dram_size: int = 1 << 28,
                 torch_device: TorchDeviceLike = None):
        self.dram = Dram(dram_size, torch_device=torch_device)
        self.regs = ControlRegisters()
        self.cache_flushes = 0
        self.cache_invalidates = 0

    def clone(self, trim: bool = False) -> "Device":
        """Independent copy of the full device state — the cross-backend
        checker runs each engine against its own clone and diffs the
        resulting DRAM images.  ``trim`` clones only the allocated DRAM
        image and forbids further allocation (see :meth:`Dram.clone`) —
        the device-pool slot configuration."""
        c = Device.__new__(Device)
        c.dram = self.dram.clone(trim=trim)
        c.regs = ControlRegisters(self.regs.control, self.regs.insn_count,
                                  self.regs.insns)
        c.cache_flushes = self.cache_flushes
        c.cache_invalidates = self.cache_invalidates
        return c

    @property
    def torch_device(self) -> torch.device:
        return self.dram.torch_device

    def copy_from(self, other: "Device") -> None:
        """Adopt another device's state (used to fold a checker clone's
        results back into the runtime's live device)."""
        self.dram.copy_from(other.dram)
        self.regs.control = other.regs.control
        self.regs.insn_count = other.regs.insn_count
        self.regs.insns = other.regs.insns
        self.cache_flushes = other.cache_flushes
        self.cache_invalidates = other.cache_invalidates

    def stage_stream(self, stream: np.ndarray) -> int:
        """DMA an encoded instruction stream to DRAM and kick the fetch
        registers (§2.4) — the shared handshake every execution engine
        performs before running to FINISH.  Returns the stream address."""
        addr = self.dram.alloc(stream.nbytes)
        self.dram.write(addr, stream)
        self.kick_stream(addr, stream.shape[0])
        return addr

    def kick_stream(self, addr: int, insn_count: int) -> None:
        """Point the fetch registers at an ALREADY-staged instruction
        stream and start the engine — the repeat-call handshake of a
        pre-staged CompiledProgram (zero per-call DRAM allocation)."""
        self.regs.insns = addr
        self.regs.insn_count = insn_count
        self.regs.start()

    # non-coherent-SoC cache maintenance hooks (§3.2)
    def flush_cache(self, addr: int, nbytes: int) -> None:
        self.cache_flushes += 1

    def invalidate_cache(self, addr: int, nbytes: int) -> None:
        self.cache_invalidates += 1
