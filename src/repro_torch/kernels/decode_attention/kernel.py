"""ctypes binding of the CUDA decode_attention kernel
(``csrc/decode_attention.cu``; the design note is at the top of that
file).  :func:`decode_plan` picks the split of the positions; it is plain
Python, so the CPU tests reach it.  Built at first call by
:mod:`repro_torch.kernels._build`, never at import."""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple, Union

import torch

from .. import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: query heads a block takes at most (G > 8 is cut into nearly equal blocks)
MAXG = 8
#: blocks per SM the split aims the grid at
BLOCKS_PER_SM = 2
#: the fewest positions a split is given (a block steps 4-128 rows at once)
MIN_SPLIT = 32
#: SMs of an H100 (the plan's card on ``meta`` tensors, the dry run)
SMS = 132


def head_blocks(G: int) -> int:
    """Blocks a kv head row's G query heads are cut into."""
    return -(-G // MAXG)


def decode_plan(B: int, KH: int, G: int, S: int,
                kv_len: Optional[int] = None,
                sms: int = 132) -> Tuple[int, int]:
    """(splits, split_len): split s reads positions [s * split_len,
    min((s + 1) * split_len, kv_len)).  split_len follows from S and the
    card: the B * KH * head_blocks(G) blocks of a full cache come to about
    BLOCKS_PER_SM a SM, each split at least MIN_SPLIT positions.  The
    splits launched follow from the rows read: kv_len where the host knows
    it, else (a device kv_len) S, and the blocks wholly past kv_len do no
    work.  So a host and a device kv_len split the same positions alike,
    and give the same bits."""
    base = B * KH * head_blocks(G)
    want = -(-BLOCKS_PER_SM * sms // base)
    split_len = max(MIN_SPLIT, -(-S // want))
    rows = S if kv_len is None else max(0, min(int(kv_len), S))
    return max(1, -(-rows // split_len)), split_len


def split_ranges(splits: int, split_len: int, kv_len: int
                 ) -> List[Tuple[int, int]]:
    """The positions [s0, s1) each split reads (empty past kv_len)."""
    return [(s * split_len, max(s * split_len,
                                min((s + 1) * split_len, kv_len)))
            for s in range(splits)]


_TICKETS: Dict[int, torch.Tensor] = {}


def _tickets(dev: torch.device, n: int) -> torch.Tensor:
    """The kernel's ticket counters on `dev`: zeroed once, and left zeroed
    by every launch (the last block of a head row resets its counter).
    Grown, never shrunk.  Calls on one device's streams must not
    overlap."""
    if dev.type == "meta":         # the dry run: a fresh buffer each call
        return torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    buf = _TICKETS.get(idx)
    if buf is None or buf.numel() < n:
        buf = _TICKETS[idx] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                          device=dev)
    return buf


def _launcher():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 \
        + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _lanes_per_row(D: int, vec: int) -> int:
    n = D // vec
    lpr = 1
    while lpr < n:
        lpr *= 2
    return lpr


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """q (B*KH, G, D) contiguous; k, v (B, S, KH, D) views with the same
    strides and a contiguous last dim; kv_len an int or a one-element
    int32 tensor on the same CUDA device (read there: no host sync).  q
    may be of another dtype than k and v (it is upcast exactly in the
    kernel).  Returns (B*KH, G, D) in q's dtype."""
    BH, G, D = q.shape
    B, S, KH, _ = k.shape
    if q.dtype not in DTYPES or k.dtype not in DTYPES \
            or v.dtype != k.dtype:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q, and "
                        f"k and v of one such dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    vec = 16 // k.element_size()
    if D % vec or D > 32 * vec:
        raise ValueError(f"the decode_attention kernel takes D a multiple "
                         f"of {vec} up to {32 * vec} for {k.dtype}, got {D}")
    if k.stride() != v.stride() or k.stride(-1) != 1 \
            or any(s % vec for s in k.stride()[:3]):
        raise ValueError(f"k and v need equal strides, a contiguous last "
                         f"dim and 16-byte rows, got {k.stride()}, "
                         f"{v.stride()}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention operands must be 16-byte aligned")
    dev = q.device
    len_dev, len_host = None, 0
    if isinstance(kv_len, torch.Tensor):
        if kv_len.device != dev or kv_len.dtype != torch.int32 \
                or kv_len.numel() != 1:
            raise ValueError("a tensor kv_len must be one int32 on q's "
                             "device")
        len_dev = kv_len.contiguous().data_ptr()
    else:
        len_host = int(kv_len)
    sms = SMS if dev.type == "meta" else \
        torch.cuda.get_device_properties(dev).multi_processor_count
    splits, split_len = decode_plan(B, KH, G, S, None if len_dev is not None
                                    else len_host, sms)
    ws = tickets = None
    if splits > 1:
        ws = torch.empty(BH * splits * G * (D + 2), dtype=torch.float32,
                         device=dev)
        tickets = _tickets(dev, BH * head_blocks(G))
    out = torch.empty((BH, G, D), dtype=q.dtype, device=dev)
    if dev.type == "meta":         # the dry run: allocations alone
        return out
    sb, ss, sh, _ = k.stride()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), len_dev,
                      len_host, ws.data_ptr() if ws is not None else None,
                      tickets.data_ptr() if tickets is not None else None,
                      out.data_ptr(), DTYPES[k.dtype], DTYPES[q.dtype], BH,
                      KH, G, D, S, split_len, splits,
                      _lanes_per_row(D, vec), sb, ss, sh,
                      float(1.0 / (D ** 0.5)), stream)
    _build.check(err, "decode_attention")
    return out
