"""ctypes bindings of the CUDA tensor_alu kernel's two instances
(``csrc/tensor_alu.cu``; the design note is at the top of that file): the
standalone chain and the scatter of a tile batch's GEMM blocks with the
chain.  Built at first call by :mod:`repro_torch.kernels._build`, never
at import."""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from .block_map import BlockMap

#: op name -> the kernel's op code
OP_CODES = {"min": 0, "max": 1, "add": 2, "shr": 3, "mul": 4}
#: chain steps one launch takes (MAX_OPS in the source)
MAX_OPS = 8
#: tiles one scatter launch writes, and GEMM outputs (tiles x weight
#: groups) it reads (MAX_T, MAX_SRC in the source)
MAX_T = 16
MAX_SRC = 64


def _launcher():
    fn = _build.load("tensor_alu").tensor_alu_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _chain_arrays(chain):
    n_ops = len(chain)
    ints = ctypes.c_int * max(n_ops, 1)
    return (n_ops, ints(*(OP_CODES[op] for op, _ in chain)),
            ints(*(0 if imm is None else int(imm) for _, imm in chain)),
            ints(*(int(imm is None) for _, imm in chain)))


def tensor_alu_cuda(dst: torch.Tensor, src: Optional[torch.Tensor],
                    chain: Sequence[Tuple[str, Optional[int]]]
                    ) -> torch.Tensor:
    """One launch: a chain of at most MAX_OPS steps over contiguous int32
    `dst` (and `src`, same shape, when a step has no immediate)."""
    n_ops, ops, imms, use_src = _chain_arrays(chain)
    out = torch.empty_like(dst)
    stream = torch.cuda.current_stream(dst.device).cuda_stream
    err = _launcher()(dst.data_ptr(),
                      src.data_ptr() if src is not None else None,
                      out.data_ptr(), dst.numel(), n_ops, ops, imms, use_src,
                      stream)
    _build.check(err, "tensor_alu")
    return out


def _scatter_launcher():
    fn = _build.load("tensor_alu").tensor_alu_scatter_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p] \
        + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tensor_alu_scatter_cuda(mats: Sequence[Sequence[torch.Tensor]],
                            bmap: BlockMap,
                            bias: Optional[Sequence[torch.Tensor]],
                            chain: Sequence[Tuple[str, Optional[int]]],
                            out: torch.Tensor) -> None:
    """One launch of the scatter instance: T <= MAX_T tiles, T * G <=
    MAX_SRC GEMM outputs (contiguous rows, int32 or int8, one dtype),
    bias None or T contiguous (R, C) int32 tensors, at most MAX_OPS
    chain steps, into `out` (T, R, C) int32, contiguous."""
    T, G = len(mats), len(bmap.groups)
    row_ptr, ent = bmap.tensors(out.device)
    flat = [m for tile in mats for m in tile]
    src_int8 = flat[0].dtype == torch.int8
    esz = flat[0].element_size()
    vec = bmap.block_out % 4 == 0 and out.data_ptr() % 16 == 0 \
        and all(w % 4 == 0 for w in bmap.widths) \
        and all(m.data_ptr() % (4 * esz) == 0 for m in flat) \
        and (bias is None or all(b.data_ptr() % 16 == 0 for b in bias))
    srcs = (ctypes.c_void_p * (T * G))(*(m.data_ptr() for m in flat))
    widths = (ctypes.c_int * G)(*bmap.widths)
    c_bias = None if bias is None else \
        (ctypes.c_void_p * T)(*(b.data_ptr() for b in bias))
    n_ops, ops, imms, use_src = _chain_arrays(chain)
    io, ii = bmap.grid.shape
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = _scatter_launcher()(
        row_ptr.data_ptr(), ent.data_ptr(),
        ctypes.cast(srcs, ctypes.c_void_p), int(src_int8), T, G, widths,
        None if c_bias is None else ctypes.cast(c_bias, ctypes.c_void_p),
        out.data_ptr(), io * ii, ii, bmap.batch, bmap.block_out, int(vec),
        n_ops, ops, imms, use_src, stream)
    _build.check(err, "tensor_alu (scatter)")
