"""The rule for ops whose CUDA kernel has no backward.

A kernel writes its output through ctypes into a fresh tensor, which
autograd does not see: on the card such an op would return a result that
silently drops the gradient of its operands.  So on a CUDA tensor each of
them raises instead, when grad mode is on and an operand requires grad.
On the CPU the plain versions run and carry gradients as PyTorch does.
Two ops have a backward kernel and are differentiable on the card as
well, and do not call this: ``flash_attention`` and ``gla_chunk``.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch


def refuse_grad(op: str, tensors: Iterable[Optional[torch.Tensor]],
                why: str = "") -> None:
    """Raise ValueError if grad mode is on and one of `tensors` lies on a
    CUDA device and requires grad."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.requires_grad \
                and t.device.type == "cuda":
            raise ValueError(
                f"{op} has no backward kernel: on the card it takes no "
                f"operand that requires grad while grad mode is on (its "
                f"result would drop the gradient){why}; call it under "
                f"torch.no_grad() or on detached tensors")
