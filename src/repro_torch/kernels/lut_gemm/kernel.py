"""ctypes binding of the CUDA lut_gemm kernel (``csrc/lut_gemm.cu``; the
design note is at the top of that file).  :func:`lut_plan` picks the row
instance and the split of K; it is plain Python, so the CPU tests reach it
and the table model in ``ref.py`` follows the same split.  Built at first
call by :mod:`repro_torch.kernels._build`, never at import."""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import _build

EPILOGUES = {"none": 0, "requant": 1}
OUT_DTYPES = {"none": torch.int32, "requant": torch.int8}
#: group sizes the kernel is instantiated for
GROUPS = (2, 4, 8)
#: K lanes per chunk: one 16-byte weight vector per lane of a warp
KC = 512
#: row instances; a 2^8-pattern table of 8 or 16 rows would not fit in
#: shared memory, so group 8 runs passes of at most 4 rows
ROW_INSTANCES = {2: (1, 2, 4, 8, 16), 4: (1, 2, 4, 8, 16), 8: (1, 2, 4)}
#: blocks per SM the split of K aims the grid at
BLOCKS_PER_SM = 2


def table_layout(group: int, mt: int) -> Dict[str, int]:
    """The shared-memory table of one K chunk (``Cfg`` in the source):
    rows per 32-bit word (two, packed as lo + 65536 hi, from two rows
    up), words per pattern, words per shared load, loads per pattern,
    lanes per wavefront, groups per 16-byte vector, and its size."""
    rp = 2 if mt >= 2 else 1
    wpp = mt // rp
    uw = min(4, wpp)
    return dict(P=1 << group, RP=rp, WPP=wpp, UW=uw, NU=wpp // uw,
                LW=32 // uw, GPV=16 // group,
                WORDS=(KC // group) * (1 << group) * wpp)


def table_word(group: int, mt: int, v, gsub, wi, p):
    """The table word that holds row word `wi` of (vector v of the chunk,
    group gsub of the vector, pattern p): ``unit_word`` in the source plus
    the word within the load.  Works on ints and on integer tensors."""
    L = table_layout(group, mt)
    nu, w = wi // L["UW"], wi % L["UW"]
    return (((((v // L["LW"]) * L["GPV"] + gsub) * L["NU"] + nu) * L["P"]
             + p) * L["LW"] + v % L["LW"]) * L["UW"] + w


def columns_per_block(mt: int) -> int:
    """BN of the instance: eight warps of 8 columns, or of 4 from 4 rows
    up (each lane keeps C x mt row sums and two chunks' weight vectors in
    registers)."""
    return 8 * (4 if mt >= 4 else 8)


def lut_plan(T: int, M: int, N: int, K: int, group: int,
             sms: int = 132) -> Tuple[int, int, int, int]:
    """(mt, vw, splits, chunks_per_split): the least row instance mt >= M
    (or the largest, in passes); vw, the 16-byte vectors a chunk reads of
    each column (32, or for K <= 256 the least power of two covering K,
    so that a warp's lanes spread over its columns instead of idling);
    and the split of the K chunks across blocks that brings ceil(N / BN)
    * T column blocks up to about BLOCKS_PER_SM blocks per SM.  K is
    split only when one row pass covers M."""
    inst = ROW_INSTANCES[group]
    mt = next((m for m in inst if m >= M), inst[-1])
    bn = columns_per_block(mt)
    vw = 32
    while vw > 8 * 32 // bn and 16 * (vw // 2) >= K:
        vw //= 2
    nchunks = -(-K // (16 * vw))
    blocks = -(-N // bn) * T
    want = -(-BLOCKS_PER_SM * sms // blocks)
    if M > mt or nchunks <= 1 or want <= 1:
        return mt, vw, 1, max(nchunks, 1)
    cps = -(-nchunks // min(want, nchunks))
    return mt, vw, -(-nchunks // cps), cps


_TICKETS: Dict[int, torch.Tensor] = {}


def _tickets(dev: torch.device, n: int) -> torch.Tensor:
    """The split kernel's ticket counters on `dev`: zeroed once, and left
    zeroed by every launch (the last block of a column block resets its
    counter).  Grown, never shrunk.  Calls on one device's streams must
    not overlap."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    buf = _TICKETS.get(idx)
    if buf is None or buf.numel() < n:
        buf = _TICKETS[idx] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                          device=dev)
    return buf


def _launcher():
    fn = _build.load("lut_gemm").lut_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lut_gemm_cuda(a: torch.Tensor, w_nk: torch.Tensor, *, bits: int,
                  group: int, epilogue: str, shift: int) -> torch.Tensor:
    """One launch over T tiles: a (T, M, K) int8, w_nk (T, N, K) int8 (W
    transposed, K contiguous), both contiguous on one CUDA device.
    Returns (T, M, N)."""
    T, M, K = a.shape
    N = w_nk.shape[1]
    dev = a.device
    out = torch.empty((T, M, N), dtype=OUT_DTYPES[epilogue], device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mt, vw, splits, cps = lut_plan(T, M, N, K, group, sms)
    part = tickets = None
    if splits > 1:
        part = torch.empty((splits, T, M, N), dtype=torch.int32, device=dev)
        tickets = _tickets(dev, T * -(-N // columns_per_block(mt)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(a.data_ptr(), w_nk.data_ptr(), out.data_ptr(),
                      part.data_ptr() if part is not None else None,
                      tickets.data_ptr() if tickets is not None else None,
                      T, M, N, K, bits, group, EPILOGUES[epilogue],
                      int(shift), mt, vw, splits, cps, stream)
    _build.check(err, "lut_gemm")
    return out
