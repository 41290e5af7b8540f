"""VTA hardware template parameters.

The paper's central artifact is a *parameterizable* accelerator template:
the GEMM-core intrinsic shape, data-type widths and SRAM depths are template
parameters, and the ISA encoding is *derived* from them ("the VTA ISA
changes as VTA's architectural parameters are modified").  This module is
the single source of truth for those parameters; `isa.py` derives its field
widths from a `HardwareSpec`, and the runtime/simulator adapt automatically
— reproducing the co-design fluidity the paper describes in §2.2.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


def _log2(x: int) -> int:
    l = int(math.log2(x))
    if 1 << l != x:
        raise ValueError(f"{x} is not a power of two")
    return l


@dataclass(frozen=True)
class HardwareSpec:
    """Template parameters of one VTA instance (defaults: paper's Pynq build)."""

    # --- GEMM core intrinsic shape (single-cycle matrix multiply) ---
    batch: int = 1            # rows of the input/acc tensor register
    block_in: int = 16        # inner (reduction) dimension
    block_out: int = 16       # columns of the acc tensor register

    # --- data type widths, bits ---
    inp_bits: int = 8
    wgt_bits: int = 8
    acc_bits: int = 32
    out_bits: int = 8
    uop_bits: int = 32

    # --- on-chip SRAM sizes, bytes (paper §5: 32kB inp, 256kB wgt,
    #     128kB acc/register-file, 16kB uop cache) ---
    inp_buff_bytes: int = 32 * 1024
    wgt_buff_bytes: int = 256 * 1024
    acc_buff_bytes: int = 128 * 1024
    out_buff_bytes: int = 32 * 1024
    uop_buff_bytes: int = 16 * 1024

    # --- clocking / memory system (used by the cycle-level pipeline model) ---
    freq_mhz: float = 100.0
    dram_rd_bytes_per_cycle: float = 8.0   # effective DMA read bandwidth
    dram_wr_bytes_per_cycle: float = 8.0   # effective DMA write bandwidth
    dram_latency_cycles: int = 200         # fixed DMA setup latency
    alu_init_interval: int = 2             # §2.5: tensor ALU II >= 2
    queue_depth: int = 512                 # command-queue depth (wide window)

    def __post_init__(self):
        # sub-byte storage is weight-only (activations stay int8): the
        # packed WGT element must still be a whole number of bytes
        if self.wgt_bits not in (1, 2, 4, 8):
            raise ValueError(f"wgt_bits must be 1, 2, 4 or 8, "
                             f"got {self.wgt_bits}")
        if self.block_out * self.block_in * self.wgt_bits % 8:
            raise ValueError("wgt element is not byte-aligned: "
                             f"{self.block_out}x{self.block_in}"
                             f"x{self.wgt_bits}b")

    # ------------------------------------------------------------------
    # element ("tensor register") geometry
    # ------------------------------------------------------------------
    @property
    def wgt_packed(self) -> bool:
        """Sub-byte weight storage: DRAM/SRAM-load bytes are b-bit packed;
        the GEMM core still computes on sign-extended int8 values."""
        return self.wgt_bits < 8

    @property
    def inp_elem_bytes(self) -> int:
        return self.batch * self.block_in * self.inp_bits // 8

    @property
    def wgt_elem_bytes(self) -> int:
        return self.block_out * self.block_in * self.wgt_bits // 8

    @property
    def acc_elem_bytes(self) -> int:
        return self.batch * self.block_out * self.acc_bits // 8

    @property
    def out_elem_bytes(self) -> int:
        return self.batch * self.block_out * self.out_bits // 8

    @property
    def uop_elem_bytes(self) -> int:
        return self.uop_bits // 8

    # SRAM depths, in elements
    @property
    def inp_depth(self) -> int:
        return self.inp_buff_bytes // self.inp_elem_bytes

    @property
    def wgt_depth(self) -> int:
        return self.wgt_buff_bytes // self.wgt_elem_bytes

    @property
    def acc_depth(self) -> int:
        return self.acc_buff_bytes // self.acc_elem_bytes

    @property
    def out_depth(self) -> int:
        return self.out_buff_bytes // self.out_elem_bytes

    @property
    def uop_depth(self) -> int:
        return self.uop_buff_bytes // self.uop_elem_bytes

    # ------------------------------------------------------------------
    # derived ISA field widths (address bits per SRAM)
    # ------------------------------------------------------------------
    @property
    def inp_addr_bits(self) -> int:
        return max(1, _log2(self.inp_depth))

    @property
    def wgt_addr_bits(self) -> int:
        return max(1, _log2(self.wgt_depth))

    @property
    def acc_addr_bits(self) -> int:
        return max(1, _log2(self.acc_depth))

    @property
    def uop_addr_bits(self) -> int:
        return max(1, _log2(self.uop_depth))

    # ------------------------------------------------------------------
    # performance identities (used by §2.6 bandwidth benchmark + rooflines)
    # ------------------------------------------------------------------
    @property
    def macs_per_cycle(self) -> int:
        return self.batch * self.block_in * self.block_out

    @property
    def peak_gops(self) -> float:
        """Peak throughput in GOPS (1 MAC = 2 ops). Pynq default: 51.2 GOPS
        for batch=1 … wait: paper quotes ~51 GOPS for the 16x16 unit @100MHz,
        i.e. 16*16*2*100e6 = 51.2e9."""
        return self.macs_per_cycle * 2 * self.freq_mhz / 1e3

    @property
    def gemm_sram_bandwidth_gbps(self) -> dict[str, float]:
        """§2.6: per-buffer bandwidth (Gbit/s) needed to keep the GEMM core
        busy at one matrix multiply per cycle."""
        f = self.freq_mhz * 1e6
        return {
            "inp": self.batch * self.block_in * self.inp_bits * f / 1e9,
            "wgt": self.block_out * self.block_in * self.wgt_bits * f / 1e9,
            # register file is read + written every cycle (accumulate)
            "acc": 2 * self.batch * self.block_out * self.acc_bits * f / 1e9,
        }

    def replace(self, **kw) -> "HardwareSpec":
        return dataclasses.replace(self, **kw)


def pynq() -> HardwareSpec:
    """The paper's evaluation build (§5)."""
    return HardwareSpec()


def lowbit(bits: int = 4, base: HardwareSpec | None = None) -> HardwareSpec:
    """A template instance with packed sub-byte weights (the
    representation-flexibility claim: only the weight width changes; the
    ISA encoding, scheduler and both engines adapt).  The WGT SRAM keeps
    the same element DEPTH (bytes scale down with the element width):
    letting the depth grow 8/bits-fold instead would widen the uop
    address fields past the 32-bit uop budget — the derived-ISA
    constraint surfacing exactly as §2.2 describes."""
    base = base or pynq()
    return base.replace(wgt_bits=bits,
                        wgt_buff_bytes=base.wgt_buff_bytes * bits // 8)


def pynq_batch2() -> HardwareSpec:
    """The §2.6 bandwidth-example config: BATCH=2, 200 MHz."""
    return HardwareSpec(batch=2, freq_mhz=200.0)


# DMA/compute constants fitted by the JAX reference package against its
# Pallas kernels run through the JAX CPU interpreter (not against any
# accelerator, and not against this package's CUDA kernels).  They are
# kept here, unchanged, only so that this package's TimingModel cycle
# counts equal the reference's for the same stream; they say nothing
# about how fast the CUDA engine runs.
HOST_FIT = dict(freq_mhz=11.0,
                dram_rd_bytes_per_cycle=650.0,
                dram_wr_bytes_per_cycle=650.0,
                dram_latency_cycles=37)


def calibrated(base: HardwareSpec | None = None,
               fit: dict | None = None) -> HardwareSpec:
    """Template instance with fitted TimingModel constants.  Both engines
    price a stream with them (the simulator directly, ``CudaBackend`` by
    replaying the same TimingModel when given one).  Defaults to
    ``HOST_FIT``, the reference package's fit to the JAX CPU interpreter,
    kept for cycle-count equality with the reference; pass another fit
    dict to price a different engine."""
    return (base or pynq()).replace(**(fit or HOST_FIT))


def spec_feasible(spec: HardwareSpec) -> str | None:
    """Validate one candidate template instance against every derived-ISA
    constraint: power-of-two SRAM depths, address fields that fit the
    encodings, and the 32-bit uop budget (`uop_bits` must hold the acc
    dst + max(inp, acc) src + wgt address fields).  Returns None when the
    instance is buildable, else the constraint violation message — the
    autotuner's cheap front-gate before it ever compiles a candidate."""
    from .isa import IsaLayout
    from .microop import UopLayout
    try:
        # constructing the derived layouts runs every width/budget check
        UopLayout(spec)
        IsaLayout(spec)
        # depth accessors raise on non-power-of-two SRAM geometry
        spec.inp_addr_bits, spec.wgt_addr_bits, spec.acc_addr_bits
        spec.uop_addr_bits, spec.out_depth
    except (ValueError, ZeroDivisionError) as e:
        return str(e)
    return None


def tpu_like() -> HardwareSpec:
    """A large instance of the template: a 128x128 intrinsic with
    megabyte-scale buffers.  The behavioural simulator runs it exactly
    like any other template instance; its DRAM constants are template
    parameters for the cycle model, not a measurement of any device."""
    return HardwareSpec(
        batch=8,
        block_in=128,
        block_out=128,
        inp_buff_bytes=4 * 1024 * 1024,
        wgt_buff_bytes=8 * 1024 * 1024,
        acc_buff_bytes=4 * 1024 * 1024,
        out_buff_bytes=2 * 1024 * 1024,
        uop_buff_bytes=64 * 1024,
        freq_mhz=940.0,
        dram_rd_bytes_per_cycle=871.0,
        dram_wr_bytes_per_cycle=871.0,
        dram_latency_cycles=500,
    )
