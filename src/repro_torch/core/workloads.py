"""Paper workloads: the ResNet-18 conv2d table (Table 1) and the e2e graph.

All twelve conv operators, with "SAME" padding as stated.  C1 is evaluated
on the CPU in the paper (3 input channels — shallow depth); we keep it in
the table and mark it `cpu_only` for the Fig. 16 offload study.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from .conv import ConvShape


@dataclass(frozen=True)
class ResnetLayer:
    name: str
    shape: ConvShape
    cpu_only: bool = False
    repeat: int = 1      # how many times the op appears in ResNet-18


def _c(h, ic, oc, k, s) -> ConvShape:
    # "SAME" padding: pad = k // 2
    return ConvShape(n=1, h=h, w=h, ic=ic, oc=oc, kh=k, kw=k, stride=s,
                     pad=k // 2)


def resnet18_table1() -> List[ResnetLayer]:
    return [
        ResnetLayer("C1", _c(224, 3, 64, 7, 2), cpu_only=True, repeat=1),
        ResnetLayer("C2", _c(56, 64, 64, 3, 1), repeat=4),
        ResnetLayer("C3", _c(56, 64, 64, 1, 1), repeat=1),
        ResnetLayer("C4", _c(56, 64, 128, 3, 2), repeat=1),
        ResnetLayer("C5", _c(56, 64, 128, 1, 2), repeat=1),
        ResnetLayer("C6", _c(28, 128, 128, 3, 1), repeat=3),
        ResnetLayer("C7", _c(28, 128, 256, 3, 2), repeat=1),
        ResnetLayer("C8", _c(28, 128, 256, 1, 2), repeat=1),
        ResnetLayer("C9", _c(14, 256, 256, 3, 1), repeat=3),
        ResnetLayer("C10", _c(14, 256, 512, 3, 2), repeat=1),
        ResnetLayer("C11", _c(14, 256, 512, 1, 2), repeat=1),
        ResnetLayer("C12", _c(7, 512, 512, 3, 1), repeat=3),
    ]


def layer_by_name(name: str) -> ResnetLayer:
    for l in resnet18_table1():
        if l.name == name:
            return l
    raise KeyError(name)


# rough ARM Cortex-A9 (dual, 667 MHz, NEON) effective conv throughput used
# for the Fig. 16 CPU-side model; the paper measures >3 s full-CPU ResNet-18
# inference (~3.6 GOP of conv work => ~1.2 GOPS effective).
CPU_EFFECTIVE_GOPS = 1.2
# non-conv CPU residue (pooling, fc, residual adds, data layout): Fig. 16
# shows ~0.4 s of the offloaded pipeline remaining on the CPU.
CPU_RESIDUE_SECONDS = 0.40
