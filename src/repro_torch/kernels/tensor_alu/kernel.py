"""ctypes binding of the CUDA tensor_alu kernel (``csrc/tensor_alu.cu``;
the design note is at the top of that file).  Built at first call by
:mod:`repro_torch.kernels._build`, never at import."""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import _build

#: op name -> the kernel's op code
OP_CODES = {"min": 0, "max": 1, "add": 2, "shr": 3, "mul": 4}
#: chain steps one launch takes (MAX_OPS in the source)
MAX_OPS = 8


def _launcher():
    fn = _build.load("tensor_alu").tensor_alu_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tensor_alu_cuda(dst: torch.Tensor, src: Optional[torch.Tensor],
                    chain: Sequence[Tuple[str, Optional[int]]]
                    ) -> torch.Tensor:
    """One launch: a chain of at most MAX_OPS steps over contiguous int32
    `dst` (and `src`, same shape, when a step has no immediate)."""
    n_ops = len(chain)
    ints = ctypes.c_int * n_ops
    ops = ints(*(OP_CODES[op] for op, _ in chain))
    imms = ints(*(0 if imm is None else int(imm) for _, imm in chain))
    use_src = ints(*(int(imm is None) for _, imm in chain))
    out = torch.empty_like(dst)
    stream = torch.cuda.current_stream(dst.device).cuda_stream
    err = _launcher()(dst.data_ptr(),
                      src.data_ptr() if src is not None else None,
                      out.data_ptr(), dst.numel(), n_ops, ops, imms, use_src,
                      stream)
    _build.check(err, "tensor_alu")
    return out
