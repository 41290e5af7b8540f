"""ctypes bindings of the CUDA gla_chunk kernel (``csrc/gla_chunk.cu``)
and its launch plan, and of its backward (``csrc/gla_bwd.cu``,
:func:`gla_chunk_bwd_cuda`); the design notes are at the top of those
files.  Built at first call by :mod:`repro_torch.kernels._build`, never at
import."""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest state width N the kernel takes
MAX_N = 256
#: the most rows of a tile: a longer chunk is walked in tiles
MAX_TILE = 64
#: shared memory one block may use on an H100 (227 KB)
SMEM_MAX = 232_448
#: streaming multiprocessors of an H100 SXM: one block of the plan on each
SMS = 132
#: rows of a tile, and columns of a block's slice of P, the kernel takes
TILES = (64, 32, 16)
P_BLOCKS = (64, 32, 16)
#: 16 x 8 tiles of a block's slice of the state (PB / 16 * NP / 8): at most
#: 8 for each of the kernel's 8 warps to hold in registers
MAX_H_TILES = 64


@dataclass(frozen=True)
class GlaPlan:
    """How the kernel walks one call: tiles of `tile` rows, N padded to
    `n_pad`, P cut into `p_slices` slices of `p_block` columns (the last
    one ragged), a ring of `stages` (1-3) cp.async stages, `smem_bytes` of
    dynamic shared memory, and the launch grid (B * H, p_slices)."""
    tile: int
    n_pad: int
    p_block: int
    p_slices: int
    stages: int
    smem_bytes: int
    grid: Tuple[int, int]


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(T: int, N: int, pb: int, stages: int, esz: int) -> int:
    """Dynamic shared memory of one block: `stages` copies of the q, k, v
    and la tiles, the weighted score tile, hᵀ and the scan of la.  The row
    strides are those of ``csrc/gla_chunk.cu:make_layout``, whose launcher
    refuses a count that differs from this one."""
    n_pad = -(-N // 8) * 8
    qs = n_pad + (8 if n_pad % 16 == 0 else 0)
    stage = 2 * _align16(T * qs * esz) + T * (pb + 8) * 4 + _align16(T * 4)
    return (stages * stage + T * (T + 4) * 4 + pb * qs * 4
            + (3 * T + 4) * 4)


def _row_ops(T: int, n_pad: int, pb: int, exact_qk: bool) -> float:
    """Tensor-core operations one block spends per row of the scan: the
    causal part of the score tile and of its product with v, q h and the
    state update, each counted 3 times (3xTF32), or fewer where a
    bfloat16 q or k is exact in TF32."""
    mt = T // 16
    causal = sum(2 * m + 2 for m in range(mt)) / (mt * 2 * mt)
    score = 2 * T * n_pad * causal * (1 if exact_qk else 3)
    wv = 2 * T * pb * causal * 3
    qh = 2 * n_pad * pb * (2 if exact_qk else 3)
    return score + wv + qh + 2 * n_pad * pb * 3


@functools.lru_cache(maxsize=256)
def gla_plan(B: int, H: int, N: int, P: int, Q: int,
             qk_dtype: torch.dtype) -> GlaPlan:
    """The launch plan for q and k (B, S, H, N) of `qk_dtype`, v (B, S, H,
    P) and tiles of at most Q rows.  The tile is the largest of 64, 32 and
    16 rows that covers Q (a shorter chunk needs no longer tile) and fits
    beside the slice of P in shared memory with a ring of at least two
    stages (three where they fit), else with one.  The slice width (64, 32 or 16 columns) minimizes the
    waves of blocks over the card's SMs times a block's operations per row:
    narrower slices give more blocks, each of which recomputes the score
    tile."""
    if not 1 <= N <= MAX_N:
        raise ValueError(f"the gla_chunk kernel takes N from 1 to {MAX_N}, "
                         f"got {N}")
    if Q < 1:
        raise ValueError(f"gla_plan takes Q >= 1, got {Q}")
    esz = 2 if qk_dtype == torch.bfloat16 else 4
    n_pad = -(-N // 8) * 8
    cap = next(T for T in reversed(TILES) if T >= min(Q, MAX_TILE))
    best = None
    for pb in P_BLOCKS:
        if pb // 16 * n_pad // 8 > MAX_H_TILES:
            continue
        fits = [(T, st) for st in (3, 2, 1) for T in TILES
                if T <= cap and smem_bytes(T, N, pb, st, esz) <= SMEM_MAX]
        T, stages = next((T, st) for T, st in sorted(
            fits, key=lambda f: (f[1] == 1, -f[0], -f[1])))
        slices = -(-P // pb)
        waves = -(-(B * H * slices) // SMS)
        cost = waves * _row_ops(T, n_pad, pb, esz == 2)
        if best is None or cost < best[0]:
            best = (cost, GlaPlan(T, n_pad, pb, slices, stages,
                                  smem_bytes(T, N, pb, stages, esz),
                                  (B * H, slices)))
    return best[1]


def _launcher():
    fn = _build.load("gla_chunk").gla_chunk_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rows16(t: torch.Tensor) -> bool:
    """Whether t's rows (its last dim, contiguous) start on 16 bytes: the
    kernel copies them 16 bytes at a time."""
    n = 16 // t.element_size()
    return t.stride(-1) == 1 and not any(t.stride(d) % n for d in (0, 1, 2)) \
        and t.data_ptr() % 16 == 0


def _rows(name: str, t: torch.Tensor) -> torch.Tensor:
    """q or k as the kernel reads them: rows that start on 16 bytes (4
    float32 or 8 bfloat16 elements).  A contiguous tensor whose rows do not
    (N not a multiple of that) is copied into one padded with zero
    columns, which the kernel never reads; a view that does not fit
    raises."""
    n = 16 // t.element_size()
    if t.is_contiguous() and t.shape[-1] % n:
        return F.pad(t, (0, -t.shape[-1] % n))
    if not _rows16(t):
        raise ValueError(f"gla_chunk {name} needs a contiguous last dim, "
                         f"strides that are multiples of {n} and a start "
                         f"aligned to 16 bytes, got strides {t.stride()}")
    return t


def gla_chunk_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   la: torch.Tensor, h0: Optional[torch.Tensor], tile: int,
                   y_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k (B, S, H, N) float32 or bfloat16 of one dtype, N from 1 to
    256, v (B, S, H, P) and la (B, S, H) float32, h0 (B, H, N, P) float32
    or None (zeros), all on one CUDA device; q and k may be stride-0 views
    over heads.  The scan runs in tiles of at most `tile` rows (1..64; the
    plan is :func:`gla_plan`).  Returns y (B, S, H, P) in `y_dtype`
    (float32 or bfloat16) and h (B, H, N, P) float32, both contiguous."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    if q.dtype not in DTYPES or k.dtype != q.dtype:
        raise TypeError(f"gla_chunk takes float32 or bfloat16 q and k of one "
                        f"dtype, got {q.dtype}, {k.dtype}")
    if v.dtype != torch.float32 or la.dtype != torch.float32 \
            or (h0 is not None and h0.dtype != torch.float32):
        raise TypeError(f"gla_chunk takes float32 v, la and h0, got "
                        f"{v.dtype}, {la.dtype}, "
                        f"{None if h0 is None else h0.dtype}")
    if y_dtype not in DTYPES:
        raise TypeError(f"gla_chunk writes y in float32 or bfloat16, not "
                        f"{y_dtype}")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"the gla_chunk kernel takes tiles of 1 to "
                         f"{MAX_TILE} rows, got {tile}")
    plan = gla_plan(B, H, N, P, tile, q.dtype)      # raises for N > 256
    q, k = _rows("q", q), _rows("k", k)
    y = torch.empty((B, S, H, P), dtype=y_dtype, device=q.device)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=q.device)
    if B * H * P == 0:             # y and h are empty: nothing to compute
        return y, h
    if S == 0:
        raise ValueError("the gla_chunk kernel takes S > 0")
    if q.is_meta:                  # the dry run: allocations alone
        return y, h
    h0_strides = h0.stride() if h0 is not None else (0, 0, 0, 0)
    strides = (ctypes.c_longlong * 21)(
        *q.stride()[:3], *k.stride()[:3], *v.stride(), *la.stride(),
        *h0_strides, *y.stride())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      la.data_ptr(), 0 if h0 is None else h0.data_ptr(),
                      y.data_ptr(), h.data_ptr(), DTYPES[q.dtype],
                      DTYPES[y_dtype], B, H, S, N, P, plan.tile,
                      plan.p_block, plan.stages, plan.smem_bytes,
                      int(_rows16(v)), ctypes.cast(strides, ctypes.c_void_p),
                      stream)
    _build.check(err, "gla_chunk")
    return y, h


#: rows of a tile of the backward kernel (``csrc/gla_bwd.cu``: T), and
#: columns of P (and of N) of its tile pass's blocks (C)
BWD_TILE = 64
BWD_CHUNK = 64


def _bwd_launcher():
    fn = _build.load("gla_bwd").gla_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gla_chunk_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       la: torch.Tensor, h0: Optional[torch.Tensor],
                       dy: torch.Tensor, dh: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, ...]:
    """The gradient of the scan (``csrc/gla_bwd.cu``) on one CUDA device:
    q, k (B, S, Hq, N) float32 or bfloat16 of one dtype, N from 1 to 256,
    Hq = H or 1 (one row for every head), any strides; v (B, S, H, P), la
    (B, S, H), dy (B, S, H, P), h0 and dh (B, H, N, P) or None, float32.
    Returns (dq, dk, dv, dla, dh0), contiguous float32: dq and dk (B, S,
    Hq, N), summed over the heads where Hq = 1 < H; dv (B, S, H, P); dla
    (B, S, H); dh0 (B, H, N, P).  Anything else raises ValueError before
    any launch.  Scratch: the states entering and the gradients leaving
    each 64-row tile, 2 B H ceil(S / 64) N P float32 (each tile's own
    contribution first, turned into the states in place); and, with C =
    ceil(P / 64) chunks of P above one (the tile pass cuts P across
    blocks), the later chunks' partials of dq and dk, 2 (C - 1) B S H N
    float32, and of dΛ, (C - 1) B H S float64: at xlstm-1.3b's B 2, S
    2048, H 4, N 256, P 1025 (17 chunks) 268 MB each for dq and dk."""
    B, S, Hq, N = q.shape
    H, P = v.shape[2], v.shape[3]
    if q.dtype not in DTYPES or k.dtype != q.dtype:
        raise ValueError(f"the gla_chunk backward takes float32 or bfloat16 "
                         f"q and k of one dtype, got {q.dtype}, {k.dtype}")
    f32 = [t for t in (v, la, h0, dy, dh) if t is not None]
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError(f"the gla_chunk backward takes float32 v, la, h0, "
                         f"dy and dh, got {[t.dtype for t in f32]}")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"the gla_chunk backward takes N from 1 to "
                         f"{MAX_N}, got {N}")
    if k.shape != q.shape or Hq not in (1, H) or v.shape[:2] != (B, S) \
            or la.shape != (B, S, H) or dy.shape != v.shape \
            or any(t is not None and t.shape != (B, H, N, P)
                   for t in (h0, dh)):
        raise ValueError(f"gla_chunk backward shapes q {tuple(q.shape)}, v "
                         f"{tuple(v.shape)}, la {tuple(la.shape)}, dy "
                         f"{tuple(dy.shape)}")
    if any(t.device != q.device for t in [k] + f32):
        raise ValueError("gla_chunk backward operands on different devices")
    if S == 0 or B * H * P == 0:
        raise ValueError(f"the gla_chunk backward takes nonempty operands, "
                         f"got B {B}, S {S}, H {H}, P {P}")
    dev = q.device
    f = dict(dtype=torch.float32, device=dev)
    nt = -(-S // BWD_TILE)
    hs = torch.empty((B * H, nt, N, P), **f)
    gs = torch.empty((B * H, nt, N, P), **f)
    hfin = torch.empty((B * H, N, P), **f)
    dtot = torch.empty((B * H, nt), **f)
    dlam = torch.empty((B * H, S), dtype=torch.float64, device=dev)
    chunks = -(-P // BWD_CHUNK)
    dq_part = dk_part = dl_part = None
    if chunks > 1:
        dq_part = torch.empty((chunks - 1, B, S, H, N), **f)
        dk_part = torch.empty((chunks - 1, B, S, H, N), **f)
        dl_part = torch.empty((chunks - 1, B * H, S), dtype=torch.float64,
                              device=dev)
    dq, dk = torch.empty((B, S, H, N), **f), torch.empty((B, S, H, N), **f)
    dv, dla = torch.empty((B, S, H, P), **f), torch.empty((B, S, H), **f)
    dh0 = torch.empty((B, H, N, P), **f)
    summed = Hq == 1 and H > 1
    dq_sum = torch.empty((B, S, 1, N), **f) if summed else None
    dk_sum = torch.empty((B, S, 1, N), **f) if summed else None
    if q.is_meta:                  # the dry run: allocations alone
        return (dq_sum, dk_sum, dv, dla, dh0) if summed \
            else (dq, dk, dv, dla, dh0)

    def heads(t: torch.Tensor) -> tuple:
        s = t.stride()
        return (s[0], s[1], 0 if t.shape[2] == 1 else s[2], s[3])
    zeros4 = (0, 0, 0, 0)
    strides = (ctypes.c_longlong * 27)(
        *heads(q), *heads(k), *v.stride(), *la.stride(),
        *(h0.stride() if h0 is not None else zeros4), *dy.stride(),
        *(dh.stride() if dh is not None else zeros4))

    def ptr(t: Optional[torch.Tensor]) -> int:
        return 0 if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bwd_launcher()(
        ptr(q), ptr(k), ptr(v), ptr(la), ptr(h0), ptr(dy), ptr(dh), ptr(hs),
        ptr(gs), ptr(hfin), ptr(dtot), ptr(dlam), ptr(dl_part), ptr(dq),
        ptr(dk), ptr(dq_part), ptr(dk_part), ptr(dv), ptr(dla), ptr(dh0),
        ptr(dq_sum), ptr(dk_sum), DTYPES[q.dtype], B, H, S, N, P,
        ctypes.cast(strides, ctypes.c_void_p), stream)
    _build.check(err, "gla_chunk backward")
    if summed:
        dq, dk = dq_sum, dk_sum
    return dq, dk, dv, dla, dh0
