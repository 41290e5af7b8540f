"""Roofline + latency-hiding analysis over the cycle-level simulator.

The port of the reference's ``core/pipeline_model.py``.  Reproduces the
Fig. 15 methodology: for each workload, measure achieved GOPS from the
timed simulation of the *actual instruction stream* the runtime emitted
(with and without virtual threading), and place it against the hardware
roofline min(peak_gops, bandwidth * intensity).  The stream runs on the
numpy simulator (the reference's engine here), against a DRAM
image on ``torch_device`` (default the card); its cycles come from the
TimingModel replay, so every number equals the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .conv import ConvShape, schedule_conv2d
from .driver import TorchDeviceLike
from .hwspec import HardwareSpec
from .runtime import Runtime
from .scheduler import Epilogue, schedule_matmul
from .simulator import RunStats, TimingModel


@dataclass
class RooflinePoint:
    name: str
    arithmetic_intensity: float     # ops / DRAM byte (from the timed run)
    gops: float                     # achieved throughput
    utilization: float              # GEMM-core busy fraction
    total_cycles: int
    virtual_threads: int
    roofline_gops: float            # min(peak, bw * intensity)

    @property
    def roofline_fraction(self) -> float:
        return self.gops / self.roofline_gops if self.roofline_gops else 0.0


def hardware_roofline(spec: HardwareSpec, intensity: float) -> float:
    bw_gbps = spec.dram_rd_bytes_per_cycle * spec.freq_mhz * 1e6 / 1e9
    return min(spec.peak_gops, bw_gbps * intensity)


def conv_roofline_point(spec: HardwareSpec, shape: ConvShape, name: str,
                        virtual_threads: int, seed: int = 0,
                        epilogue: Optional[Epilogue] = None,
                        torch_device: TorchDeviceLike = None
                        ) -> RooflinePoint:
    """Schedule + simulate one conv layer; return its roofline placement.
    The DRAM image lives on `torch_device` (default the card)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 8, size=(shape.n, shape.ic, shape.h, shape.w),
                     dtype=np.int8)
    w = rng.integers(-4, 4, size=(shape.oc, shape.ic, shape.kh, shape.kw),
                     dtype=np.int8)
    rt = Runtime(spec, torch_device=torch_device)
    schedule_conv2d(rt, x, w, shape, epilogue=epilogue,
                    virtual_threads=virtual_threads)
    stats = rt.synchronize(timing=TimingModel(spec), backend="simulator")
    ai = stats.arithmetic_intensity
    return RooflinePoint(
        name=name, arithmetic_intensity=ai, gops=stats.gops(spec.freq_mhz),
        utilization=stats.compute_utilization, total_cycles=stats.total_cycles,
        virtual_threads=virtual_threads,
        roofline_gops=hardware_roofline(spec, ai))


def matmul_roofline_point(spec: HardwareSpec, M: int, N: int, K: int,
                          name: str, virtual_threads: int,
                          seed: int = 0,
                          torch_device: TorchDeviceLike = None
                          ) -> RooflinePoint:
    """Schedule + simulate one (M, K) x (N, K) matmul; return its roofline
    placement (arguments as for :func:`conv_roofline_point`)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-8, 8, size=(M, K), dtype=np.int8)
    w = rng.integers(-4, 4, size=(N, K), dtype=np.int8)
    rt = Runtime(spec, torch_device=torch_device)
    schedule_matmul(rt, a, w, virtual_threads=virtual_threads)
    stats = rt.synchronize(timing=TimingModel(spec), backend="simulator")
    ai = stats.arithmetic_intensity
    return RooflinePoint(
        name=name, arithmetic_intensity=ai, gops=stats.gops(spec.freq_mhz),
        utilization=stats.compute_utilization, total_cycles=stats.total_cycles,
        virtual_threads=virtual_threads,
        roofline_gops=hardware_roofline(spec, ai))


def peak_compute_utilization(points: List[RooflinePoint]) -> float:
    """The paper's headline metric: max compute utilization across layers."""
    return max((p.utilization for p in points), default=0.0)
