"""The kernel ops' route on ``meta`` tensors: the dry run
(``launch/dryrun.py``).

A kernel is one opaque call that aten cannot see into, so each op's
meta route runs its card wrapper, which allocates on ``meta`` what it
allocates on the card (outputs, saved rows, padded operands, scratch)
from the same plans and launches nothing, and reports the call's work
here: the FLOPs of the reference's oracle for the same call and the
operand and result bytes (``launch/op_analysis.py:record_kernel``, a
no-op when no analysis is active).  Nothing is computed, nothing is
counted as a launch, and no plain version runs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.launch import op_analysis


def record(name: str, flops: float, *tensors: Optional[torch.Tensor]
           ) -> None:
    """Report one call of kernel op `name`: `flops`, and the bytes of
    `tensors` (its operands and results; None entries skipped)."""
    op_analysis.record_kernel(name, float(flops), float(sum(
        t.numel() * t.element_size() for t in tensors if t is not None)))
