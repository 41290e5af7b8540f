"""ctypes bindings of the CUDA flash_attention kernels (the design notes
are at the top of each source): ``csrc/flash_wgmma.cu`` for bfloat16
operands (wgmma and TMA) and ``csrc/flash_tf32x3.cu`` for float32 ones
(mma.sync in 3xTF32), and the backward of both, ``csrc/flash_bwd.cu``
(:func:`flash_attention_bwd_cuda`), all for D up to 128; and
``csrc/flash_wide.cu`` (forward and backward, every product on the tensor
cores: bfloat16 on wgmma fed by TMA, float32 on mma.sync in 3xTF32, the
head dim streamed in 128-byte chunks) for every D above 128
(:func:`flash_wide_cuda`, :func:`flash_wide_bwd_cuda`;
:func:`wide_fwd_launches` says how many launches its forward takes).
:func:`head_dim_plan` says which takes a head dim and to what D the op
zero-pads it, :func:`route` picks one by dtype, :func:`wgmma_plan` turns
the operands' shapes and strides into the tensor maps of the bfloat16
kernel, :func:`flash_f32_plan` sizes the float32 kernel's tiles and
:func:`flash_bwd_plan` checks and pads the backward's D; all are plain
Python, so the CPU tests reach them.  Built at first call by
:mod:`repro_torch.kernels._build`, never at import.  On ``meta`` tensors
(the dry run, ``launch/dryrun.py``) each wrapper allocates what it
allocates on the card, from the same plans, and launches nothing."""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from .. import _build

#: the largest head dim the tensor-core kernels are instantiated for
MAX_D = 128
#: the output columns one block of flash_wide.cu's bfloat16 forward writes
#: (its online softmax covers the whole output up to this D; above it the
#: forward takes two launches, L and then slices of WIDE_SLICE)
WIDE_SLICE = 256
#: log2(e): the bf16 kernel's exponentials are exp2 of log2e-scaled scores
LOG2E = 1.4426950408889634


#: SMs of an H100: the float32 plan takes 128-row blocks where they fill
#: the card with one block each
SMS = 132
#: the most shared memory a block may use (bytes)
SMEM_MAX = 232448


class HeadDimPlan(NamedTuple):
    """Which kernels take head dim D ("tensor": wgmma / tf32x3 and
    flash_bwd.cu; "wide": flash_wide.cu) and the D the op zero-pads q, k
    and v to for them (the output and gradients are sliced back; zero
    columns add nothing to q k^T, and the scale stays 1/sqrt(D))."""
    kernels: str
    dp: int


def head_dim_plan(D: int, dtype: torch.dtype) -> HeadDimPlan:
    """The plan for head dim D: up to MAX_D the tensor-core kernels of
    D <= 128, above it flash_wide.cu; either way D padded to a multiple of
    16 (bfloat16: wgmma's k-step, and TMA's 16-byte rows) or 4 (float32:
    16-byte cp.async pieces).  Raises ValueError for D below 1.  The dtype
    is checked by the kernels' wrappers (the forward's TypeError, the
    backward's ValueError), not here."""
    step = 16 if dtype == torch.bfloat16 else 4
    if D < 1:
        raise ValueError(f"flash_attention takes head dims from 1, got {D}")
    return HeadDimPlan("tensor" if D <= MAX_D else "wide",
                       -(-D // step) * step)


def wide_fwd_launches(D: int, dtype: torch.dtype) -> int:
    """The launches of flash_wide.cu's forward at padded head dim D (above
    MAX_D, a multiple of 16 in bfloat16 and of 4 in float32; ValueError
    else): 1 (bfloat16 up to WIDE_SLICE: an online softmax), else 2 (each
    row's L, then the output's slices from it; L is then needed as scratch
    where the caller asks for none)."""
    step = 16 if dtype == torch.bfloat16 else 4
    if D <= MAX_D or D % step:
        raise ValueError(f"flash_wide takes D above {MAX_D}, a multiple of "
                         f"{step} in {dtype}, got {D}")
    return 1 if dtype == torch.bfloat16 and D <= WIDE_SLICE else 2


def route(dtype: torch.dtype) -> str:
    """The kernel a CUDA call of this dtype launches: "wgmma" (bfloat16)
    or "tf32x3" (float32).  Nothing falls back from one to the other."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "tf32x3"
    raise TypeError(f"flash_attention takes float32 or bfloat16, got {dtype}")


def wgmma_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> Tuple[List[int], List[int]]:
    """The bf16 kernel's TMA tensor maps: for q, k and v in turn, the dims
    (D, S, H, B), innermost first, and the byte strides of dims S, H and
    B.  The maps read each operand in place, so every stride the kernel
    uses and the base must be multiples of 16 bytes; a dim of extent 1 is
    never stepped, so its stride is replaced by one that is.  Raises
    ValueError for a layout TMA cannot read."""
    dims, strides = [], []
    D = q.shape[-1]
    if D % 16 or D > MAX_D:
        raise ValueError(f"the bf16 flash_attention kernel takes D a "
                         f"multiple of 16 up to {MAX_D}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        esz = t.element_size()
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention {name} needs a contiguous "
                             f"last dim, got strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention {name}'s base is not "
                             f"16-byte aligned")
        B, S, H, _ = t.shape
        extent = D * esz
        row = []
        for size, st in ((S, t.stride(1)), (H, t.stride(2)),
                         (B, t.stride(0))):
            nbytes = st * esz if size > 1 else -(-extent // 16) * 16
            if nbytes % 16:
                raise ValueError(f"flash_attention {name}'s strides "
                                 f"{t.stride()} are not multiples of 16 "
                                 f"bytes: TMA cannot read it in place")
            row.append(nbytes)
            extent = max(extent, nbytes * size)
        dims += [D, S, H, B]
        strides += row
    return dims, strides


class FlashF32Plan(NamedTuple):
    """The float32 kernel's tiles: query rows a block takes (16 a warp),
    keys a K/V tile holds, D padded to a multiple of 8, cp.async ring
    stages, and the shared-memory bytes (the C ``make_layout``'s)."""
    bq: int
    bk: int
    dp: int
    stages: int
    smem: int


def flash_f32_smem(bq: int, bk: int, dp: int, stages: int) -> int:
    """Shared-memory bytes of the float32 kernel's layout (the C
    ``make_layout``): the Q tile and `stages` K/V stages, each row stride
    padded for conflict-free fragment loads."""
    qs = dp + (8 if dp % 16 == 0 else 0)
    return 4 * (bq * qs + stages * bk * (qs + dp + 4))


@functools.lru_cache(maxsize=256)
def flash_f32_plan(B: int, S: int, Sk: int, HQ: int, KH: int, D: int,
                   causal: bool) -> FlashF32Plan:
    """Tiles of the 3xTF32 kernel at one shape.  128-row blocks (8 warps,
    one block an SM, a 3-stage ring) where their grid gives every SM a
    block, since each block streams all the K/V it sees through shared
    memory; else 64-row blocks (4 warps, a 2-stage ring, two blocks an
    SM).  The key tile is 64 keys at DP <= 64 and 32 above, which keeps
    the score and output accumulators in registers.  Raises ValueError
    for a D the kernel does not take."""
    if D % 4 or not 4 <= D <= MAX_D:
        raise ValueError(f"the float32 flash_attention kernel takes D a "
                         f"multiple of 4 up to {MAX_D}, got {D}")
    dp = -(-D // 8) * 8
    bk = 64 if dp <= 64 else 32
    bq = 128 if S > 64 and -(-S // 128) * B * HQ >= SMS else 64
    stages = 3 if bq == 128 else 2
    smem = flash_f32_smem(bq, bk, dp, stages)
    if smem > SMEM_MAX:
        raise ValueError(f"flash_f32_plan: {smem} bytes of shared memory")
    return FlashF32Plan(bq, bk, dp, stages, smem)


def _launcher(name, argtypes):
    fn = getattr(_build.load(name), f"{name}_launch")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _tf32x3(q, k, v, out, lse, causal, scale):
    B, S, HQ, D = q.shape
    _, Sk, KH, _ = k.shape
    plan = flash_f32_plan(B, S, Sk, HQ, KH, D, bool(causal))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3]):
            raise ValueError(f"flash_attention {name} needs a contiguous "
                             f"last dim and strides that are multiples of "
                             f"4, got {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention {name} is not aligned to 4 "
                             f"elements")
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    fn = _launcher("flash_tf32x3", [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              _ptr(lse), B, HQ, KH, S, Sk, D,
              ctypes.cast(strides, ctypes.c_void_p), int(causal),
              float(1.0 / math.sqrt(D) if scale is None else scale),
              plan.bq, plan.bk, plan.stages, plan.smem, stream)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _wgmma(q, k, v, out, lse, causal, scale):
    B, S, HQ, D = q.shape
    _, Sk, KH, _ = k.shape
    dims, strides = wgmma_plan(q, k, v)
    c_dims = (ctypes.c_ulonglong * 12)(*dims)
    c_strides = (ctypes.c_ulonglong * 9)(*strides)
    fn = _launcher("flash_wgmma", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              _ptr(lse), B, HQ, KH, S, Sk, D,
              ctypes.cast(c_dims, ctypes.c_void_p),
              ctypes.cast(c_strides, ctypes.c_void_p), int(causal),
              float(LOG2E / math.sqrt(D) if scale is None
                    else LOG2E * scale), stream)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, with_lse: bool = False,
                         scale: Optional[float] = None):
    """q (B, S, HQ, D), k and v (B, Sk, KH, D) on one CUDA device, of one
    dtype.  bfloat16 launches the wgmma kernel (D a multiple of 16,
    strides and base multiples of 16 bytes), float32 the 3xTF32 kernel (D
    a multiple of 4, strides multiples of 4 elements); both read strided
    operands in place and raise ValueError for what they cannot read.
    Returns out (B, S, HQ, D) in q's dtype, contiguous; with `with_lse`,
    (out, L): the kernel also writes each query row's log-sum-exp of its
    scaled scores, L (B, HQ, S) float32, +inf for a row that sees no key
    (the output is bitwise the same either way).  `scale` multiplies the
    scores (default 1/sqrt(D); the op passes the unpadded D's)."""
    B, S, HQ, D = q.shape
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q, k and v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    which = route(q.dtype)
    if D > MAX_D:
        raise ValueError(f"flash_attention kernels take D up to {MAX_D}, "
                         f"got {D}")
    out = torch.empty((B, S, HQ, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, HQ, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() and not q.is_meta:
        err = (_wgmma if which == "wgmma" else _tf32x3)(
            q, k, v, out, lse, causal, scale)
        _build.check(err, f"flash_attention ({which})")
    return (out, lse) if with_lse else out


#: the backward's rows of (L, Delta) are padded to a multiple of this
#: (``csrc/flash_bwd.cu``: ROW_PAD), so that its kernels copy a tile whole
ROW_PAD = 128


class FlashBwdPlan(NamedTuple):
    """The backward's instance: "wgmma" (bfloat16: dk dv and dq on wgmma,
    D padded in shared memory to dp 64 or 128) or "tf32x3" (float32:
    mma.sync in 3xTF32, D padded to dp 32, 64, 96 or 128)."""
    route: str
    dp: int


def flash_bwd_plan(D: int, dtype: torch.dtype) -> FlashBwdPlan:
    """The backward kernel's instance for head dim D: it takes every D the
    forward takes (bfloat16 a multiple of 16 up to 128, float32 a multiple
    of 4 up to 128) and raises ValueError for any other."""
    which = route(dtype)
    if which == "wgmma":
        if D % 16 or not 16 <= D <= MAX_D:
            raise ValueError(f"the bf16 flash_attention backward takes D a "
                             f"multiple of 16 up to {MAX_D}, got {D}")
        return FlashBwdPlan(which, 64 if D <= 64 else 128)
    if D % 4 or not 4 <= D <= MAX_D:
        raise ValueError(f"the float32 flash_attention backward takes D a "
                         f"multiple of 4 up to {MAX_D}, got {D}")
    return FlashBwdPlan(which, -(-D // 32) * 32)


def _bwd_operand(t: torch.Tensor) -> torch.Tensor:
    """t contiguous with a 16-byte aligned base (a copy where it is not)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor,
                             causal: bool, scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradient of flash_attention on the card: q, o (the forward's
    output) and do (its gradient) (B, S, HQ, D), k and v (B, Sk, KH, D),
    one dtype, float32 or bfloat16, D as :func:`flash_bwd_plan` takes it
    (ValueError else, before any launch); lse the forward's L (B, HQ, S)
    float32.  Launches ``csrc/flash_bwd.cu``'s three kernels (Delta, dk
    and dv, dq) and returns (dq, dk, dv), contiguous, in the operands'
    dtype.  Scratch: each row's (L, Delta), 2 B HQ S float32 (S rounded up
    to a multiple of ROW_PAD).  `scale` as in flash_attention_cuda."""
    if len({t.dtype for t in (q, k, v, o, do)}) != 1 \
            or q.dtype not in (torch.float32, torch.bfloat16):
        # the mixed route (a bfloat16 query over float32 K/V) included
        raise ValueError(f"the flash_attention backward kernel takes q, k, "
                         f"v, out and grad of one dtype, float32 or "
                         f"bfloat16, got "
                         f"{[str(t.dtype) for t in (q, k, v, o, do)]}")
    plan = flash_bwd_plan(q.shape[-1], q.dtype)
    q, k, v, o, do, lse = (_bwd_operand(t) for t in (q, k, v, o, do, lse))
    B, S, HQ, D = q.shape
    _, Sk, KH, _ = k.shape
    if min(B, S, Sk, HQ) == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    # every element is written by the kernels
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # each row's (L, Delta), the rows padded to a multiple of ROW_PAD
    ld = torch.empty((B * HQ, -(-S // ROW_PAD) * ROW_PAD, 2),
                     dtype=torch.float32, device=q.device)
    if q.is_meta:
        return dq, dk, dv
    fn = _launcher("flash_bwd", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             lse.data_ptr(), ld.data_ptr(), B, S, Sk, HQ, KH, D,
             int(causal), int(plan.route == "tf32x3"), plan.dp,
             float(1.0 / math.sqrt(D) if scale is None else scale), stream)
    _build.check(err, f"flash_attention backward ({plan.route})")
    return dq, dk, dv


def _wide_operands(*ts: torch.Tensor):
    dt = ts[0].dtype
    if any(t.dtype != dt for t in ts) or dt not in (torch.float32,
                                                    torch.bfloat16):
        raise ValueError(f"flash_wide takes operands of one dtype, float32 "
                         f"or bfloat16, got {[str(t.dtype) for t in ts]}")
    launches = wide_fwd_launches(ts[0].shape[-1], dt)
    return launches, [_bwd_operand(t) for t in ts]


def flash_wide_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, with_lse: bool = False,
                    scale: Optional[float] = None):
    """``csrc/flash_wide.cu``'s forward: as :func:`flash_attention_cuda`
    for a padded D above MAX_D (:func:`wide_fwd_launches`; ValueError
    else): one launch for bfloat16 up to WIDE_SLICE, else two (each row's
    L, then the output slice by slice; L is written to scratch where
    `with_lse` is off); the operands are read contiguous with 16-byte
    aligned bases (copied where they are not)."""
    launches, (q, k, v) = _wide_operands(q, k, v)
    B, S, HQ, D = q.shape
    _, Sk, KH, _ = k.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, HQ, S), dtype=torch.float32, device=q.device) \
        if with_lse or launches == 2 else None
    if out.numel() and not q.is_meta:
        fn = _launcher("flash_wide", [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _ptr(lse), B, HQ, KH, S, Sk, D, int(causal),
                 int(q.dtype == torch.bfloat16),
                 float(1.0 / math.sqrt(D) if scale is None else scale),
                 stream)
        _build.check(err, "flash_attention (wide)")
    return (out, lse) if with_lse else out


def flash_wide_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        causal: bool, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``csrc/flash_wide.cu``'s backward from the forward's L, at a padded
    D above MAX_D (:func:`wide_fwd_launches` checks it; ValueError else):
    (dq, dk, dv) in the operands' dtype, three launches (Delta, dk dv, dq);
    scratch: Delta, (B, HQ, S) float32."""
    _, (q, k, v, o, do) = _wide_operands(q, k, v, o, do)
    lse = _bwd_operand(lse)
    B, S, HQ, D = q.shape
    _, Sk, KH, _ = k.shape
    if min(B, S, Sk, HQ) == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, HQ, S), dtype=torch.float32, device=q.device)
    if q.is_meta:
        return dq, dk, dv
    fn = getattr(_build.load("flash_wide"), "flash_wide_bwd_launch")
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), B, HQ, KH, S, Sk, D,
             int(causal), int(q.dtype == torch.bfloat16),
             float(1.0 / math.sqrt(D) if scale is None else scale), stream)
    _build.check(err, "flash_attention backward (wide)")
    return dq, dk, dv
