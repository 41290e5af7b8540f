"""ctypes bindings of the CUDA vta_gemm kernels: the skinny instance
(M <= 16) in ``csrc/vta_gemm.cu`` and the wgmma instance (M > 16) in
``csrc/vta_wgmma.cu`` (the design notes are at the top of each).
:func:`gemm_plan` picks the instance, its tile and the split of K; it is
plain Python, so the CPU tests reach it.  Built at first call by
:mod:`repro_torch.kernels._build`, never at import.  On ``meta`` tensors
(the dry run, ``launch/dryrun.py``) each wrapper allocates what it
allocates on the card, from the same plans at an H100's 132 SMs, and
launches nothing."""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build

EPILOGUES = {"none": 0, "requant": 1, "dequant": 2}
OUT_DTYPES = {"none": torch.int32, "requant": torch.int8,
              "dequant": torch.float32}
#: quantized_linear's epilogue code and its activation dtypes' codes
EPI_QLINEAR = 3
X_DTYPES = {torch.float32: 1, torch.bfloat16: 2}
#: vta_gemm.cu's routes: the skinny instance, and for quantized_linear the
#: skinny instance with the grid-wide amax in its own cooperative launch
ROUTES = {"skinny": 1, "skinny_amax": 2}

#: the most rows the skinny instance takes (the cut between the instances)
SKINNY_MAX_M = 16
#: output channels per skinny block: eight warps of 16
SKINNY_BN = 128
#: K bytes a warp step consumes (two m16n8k32)
SKINNY_KC = 64
#: the longest K slice of a block (its int8 X slice sits in shared memory)
SKINNY_KMAX = 2048
#: blocks per SM the split of K aims the grid at (and, launched
#: cooperatively, the most that are resident: 256 threads at <= 128
#: registers and <= 100 KB of shared memory each)
BLOCKS_PER_SM = 2
AMAX_THREADS = 256

#: the wgmma instance: K bytes a ring stage (one 128-byte swizzle row),
#: and the (rows, channels) tiles it is built for; rows are 64 per consumer
#: warpgroup
WGMMA_KSTEP = 128
WGMMA_TILES = ((128, 256), (128, 128), (128, 64), (64, 256), (64, 128),
               (64, 64))
#: the most K slices of a wgmma tile: the slices of one tile run as one
#: thread block cluster (8 blocks, the portable cluster size)
WGMMA_MAX_SPLITS = 8
#: the share of the SMs a grid of output tiles must give a block for the
#: plan to take that tile (else a smaller one), and the K steps a tile
#: must have before its K is split (tools/vta_sweep.py on an H100: a
#: split pays from 9 steps, with 2-5 steps a slice)
WGMMA_FILL = 0.7
WGMMA_SPLIT_STEPS = 8
#: row alignment of the operands the wgmma instance reads by TMA (bytes)
K_ALIGN = 16
#: the quantize launch ahead of the wgmma instance: threads a block, and
#: the most blocks an SM holds (its cooperative grid must be resident)
QUANT_THREADS = 256
QUANT_BLOCKS_PER_SM = 4


@dataclass(frozen=True)
class GemmPlan:
    """route "skinny" (M <= 16: 128 channels a block, K cut into `splits`
    slices of `kslice` bytes, a multiple of SKINNY_KC) or "wgmma" (bm x bn
    output tiles, K cut into `splits` slices of `kslice` bytes, a
    multiple of WGMMA_KSTEP)."""
    route: str
    splits: int
    kslice: int
    bm: int = 0
    bn: int = SKINNY_BN


def padded_k(K: int) -> int:
    """K rounded up to K_ALIGN (at least K_ALIGN): the row length the
    wgmma instance reads."""
    return max(K_ALIGN, -(-K // K_ALIGN) * K_ALIGN)


@functools.lru_cache(maxsize=4096)
def _wgmma_plan(T: int, M: int, N: int, K: int, sms: int) -> GemmPlan:
    steps = -(-padded_k(K) // WGMMA_KSTEP)
    bm, bn = 64, 64
    for tbm, tbn in sorted(WGMMA_TILES, key=lambda t: (-t[0] * t[1], -t[0])):
        if T * -(-M // tbm) * -(-N // tbn) >= WGMMA_FILL * sms:
            bm, bn = tbm, tbn
            break
    tiles = T * -(-M // bm) * -(-N // bn)
    per = steps
    if tiles < WGMMA_FILL * sms and steps >= WGMMA_SPLIT_STEPS:
        per = max(2, -(-steps // WGMMA_MAX_SPLITS),
                  -(-steps // max(1, sms // tiles)))
    return GemmPlan("wgmma", -(-steps // per), per * WGMMA_KSTEP, bm, bn)


def gemm_plan(T: int, M: int, N: int, K: int, sms: int = 132) -> GemmPlan:
    """Above SKINNY_MAX_M rows the wgmma instance: the largest tile (128
    rows before 64 on a tie) whose grid gives at least WGMMA_FILL of the
    SMs a block, else 64 x 64; where even that grid leaves the card mostly
    idle and K has WGMMA_SPLIT_STEPS steps or more, K split into up to
    WGMMA_MAX_SPLITS slices of at least two steps, no more blocks than
    SMs.  (tools/vta_sweep.py times every tile and split on
    the card.)  At most SKINNY_MAX_M rows the skinny instance with K split
    so that ceil(N / 128) * T column blocks come to about BLOCKS_PER_SM
    blocks per SM, no slice longer than SKINNY_KMAX."""
    if M > SKINNY_MAX_M:
        return _wgmma_plan(T, M, N, K, sms)
    chunks = max(1, -(-K // SKINNY_KC))
    cols = -(-N // SKINNY_BN) * T
    least = -(-chunks // (SKINNY_KMAX // SKINNY_KC))
    splits = min(chunks, max(least, BLOCKS_PER_SM * sms // cols, 1))
    cps = -(-chunks // splits)
    return GemmPlan("skinny", -(-chunks // cps), cps * SKINNY_KC)


def k_slices(plan: GemmPlan, K: int) -> List[Tuple[int, int]]:
    """The [k0, k1) range of K each split of a plan covers."""
    return [(s * plan.kslice, min(K, (s + 1) * plan.kslice))
            for s in range(plan.splits)]


def grid_resident(plan: GemmPlan, T: int, N: int, sms: int = 132) -> bool:
    """Whether a skinny grid fits on the card at once (BLOCKS_PER_SM a
    SM), so that quantized_linear can take its amax in the GEMM's own
    launch (a grid-wide wait needs every block resident)."""
    return plan.route == "skinny" and T == 1 and \
        plan.splits * -(-N // SKINNY_BN) <= BLOCKS_PER_SM * sms


def amax_blocks(numel: int, sms: int = 132) -> int:
    """Blocks of the separate amax launch: 8 elements a thread, at most
    BLOCKS_PER_SM a SM."""
    return max(1, min(BLOCKS_PER_SM * sms,
                      -(-numel // (AMAX_THREADS * 8))))


_SCRATCH: Dict[Tuple[int, str], torch.Tensor] = {}


def _scratch(dev: torch.device, what: str, n: int) -> torch.Tensor:
    """A zeroed int32 buffer on `dev` that every launch leaves zeroed (the
    split's partial sums, the tickets and the grid-wide amax words).
    Grown, never shrunk.  Calls on one device's streams must not
    overlap."""
    if dev.type == "meta":         # the dry run: a fresh buffer each call
        return torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    buf = _SCRATCH.get((idx, what))
    if buf is None or buf.numel() < n:
        buf = _SCRATCH[(idx, what)] = torch.zeros(
            max(n, 4096), dtype=torch.int32, device=dev)
    return buf


def quant_blocks(M: int, Kp: int, sms: int = 132) -> int:
    """Blocks of the quantize launch: 16 bytes of x_q a thread, at most
    QUANT_BLOCKS_PER_SM a SM (launched cooperatively, all resident)."""
    return max(1, min(QUANT_BLOCKS_PER_SM * sms,
                      -(-M * Kp // (16 * QUANT_THREADS))))


def k_operand(t: torch.Tensor, K: int) -> torch.Tensor:
    """A contiguous int8 operand (..., K) as the wgmma instance reads it by
    TMA: rows of padded_k(K) bytes, zero past K, at a 16-byte aligned base.
    A copy only where K is not a multiple of 16 or the base is
    misaligned; zero columns add nothing to an integer sum."""
    Kp = padded_k(K)
    if Kp != K:
        return F.pad(t, (0, Kp - K))
    if t.data_ptr() % K_ALIGN:
        return t.clone()
    return t


_FNS: Dict[str, ctypes._CFuncPtr] = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "vta_gemm_launch": [_P] * 10 + [_I] * 11 + [_F, _P],
    "vta_wgmma_launch": [_P] * 5 + [_I] * 10 + [_P],
    "vta_wgmma_qlinear": [_P, _I] + [_P] * 7 + [_I] * 5 + [_F] + [_I] * 4
    + [_P],
}


def _launcher(sym: str):
    """The C entry `sym` of vta_gemm.cu or vta_wgmma.cu."""
    fn = _FNS.get(sym)
    if fn is None:
        lib = "vta_gemm" if sym == "vta_gemm_launch" else "vta_wgmma"
        fn = getattr(_build.load(lib), sym)
        fn.argtypes = _ARGTYPES[sym]
        fn.restype = ctypes.c_int
        _FNS[sym] = fn
    return fn


def _sms(dev: torch.device) -> int:
    if dev.type == "meta":         # the dry run plans for an H100
        return 132
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return t.data_ptr() if t is not None else None


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_skinny(a, w_nk, bias, scale, out, T, M, N, K, a_dtype,
                   epilogue, shift, route, plan, xs_given=None, lo=0.0,
                   n_amax=0):
    dev = a.device
    ws = part = xs_buf = None
    sync = _scratch(dev, "sync", 4 + T * -(-N // SKINNY_BN))
    if plan.splits > 1:
        ws = _scratch(dev, "partials", T * M * N)
    if n_amax:
        part = _scratch(dev, "amax", n_amax + 1)
        xs_buf = torch.empty(1, dtype=torch.float32, device=dev)
    if dev.type == "meta":         # the dry run: allocations alone
        return
    err = _launcher("vta_gemm_launch")(
        a.data_ptr(), w_nk.data_ptr(), _ptr(bias), _ptr(scale),
        out.data_ptr(), _ptr(ws), _ptr(sync), _ptr(xs_given), _ptr(xs_buf),
        _ptr(part), T, M, N, K, a_dtype, epilogue, int(shift), route,
        plan.splits, plan.kslice, n_amax, float(lo), _stream(dev))
    _build.check(err, "vta_gemm")


def vta_gemm_cuda(a: torch.Tensor, w_nk: torch.Tensor,
                  bias: Optional[torch.Tensor],
                  scale: Optional[torch.Tensor],
                  epilogue: str, shift: int) -> torch.Tensor:
    """One launch over T tiles: a (T, M, K) int8, w_nk (T, N, K) int8 (W
    transposed, K contiguous), bias (N,) int32, scale (N,) float32, all
    contiguous on one CUDA device.  Returns (T, M, N)."""
    T, M, K = a.shape
    N = w_nk.shape[1]
    dev = a.device
    out = torch.empty((T, M, N), dtype=OUT_DTYPES[epilogue], device=dev)
    plan = gemm_plan(T, M, N, K, _sms(dev))
    if plan.route == "skinny":
        _launch_skinny(a, w_nk, bias, scale, out, T, M, N, K, 0,
                       EPILOGUES[epilogue], shift, ROUTES["skinny"], plan)
        return out
    a, w_nk = k_operand(a, K), k_operand(w_nk, K)
    if dev.type == "meta":         # the dry run: allocations alone
        return out
    err = _launcher("vta_wgmma_launch")(
        a.data_ptr(), w_nk.data_ptr(), _ptr(bias), _ptr(scale),
        out.data_ptr(), T, M, N, padded_k(K), EPILOGUES[epilogue],
        int(shift), plan.bm // 64, plan.bn, plan.splits,
        plan.kslice // WGMMA_KSTEP, _stream(dev))
    _build.check(err, "vta_gemm")
    return out


_LO: Dict[torch.dtype, float] = {}


def clamp_floor(dtype: torch.dtype) -> float:
    """1e-6 in `dtype` (what ``amax.clamp_min(1e-6)`` compares with)."""
    if dtype not in _LO:
        _LO[dtype] = float(torch.tensor(1e-6, dtype=dtype))
    return _LO[dtype]


def quantized_linear_cuda(x2: torch.Tensor, w_nk: torch.Tensor,
                          w_scale: torch.Tensor,
                          x_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """quantized_linear on the card: x2 (M, K) float32 or bfloat16, w_nk
    (N, K) int8, w_scale (N,) float32, all contiguous on one CUDA device;
    x_scale None or a one-element float32 tensor there.  Up to 16 rows
    the skinny instance quantizes x in shared memory: one launch (the
    grid resident, x_scale not given) or two (the amax in its own
    launch).  Above 16 rows two launches: x quantized once into an int8
    x_q (M, padded_k(K)), then the wgmma instance on x_q.  Returns (M, N)
    in x2's dtype."""
    M, K = x2.shape
    N = w_nk.shape[0]
    dev = x2.device
    sms = _sms(dev)
    plan = gemm_plan(1, M, N, K, sms)
    out = torch.empty((M, N), dtype=x2.dtype, device=dev)
    lo = clamp_floor(x2.dtype)
    if plan.route == "skinny":
        route = ROUTES["skinny_amax"] if x_scale is None and grid_resident(
            plan, 1, N, sms) else ROUTES["skinny"]
        n_amax = 0 if x_scale is not None or route == ROUTES["skinny_amax"] \
            else amax_blocks(M * K, sms)
        _launch_skinny(x2, w_nk, None, w_scale, out, 1, M, N, K,
                       X_DTYPES[x2.dtype], EPI_QLINEAR, 0, route, plan,
                       xs_given=x_scale, lo=lo, n_amax=n_amax)
        return out
    Kp = padded_k(K)
    if M * Kp >= 1 << 31:
        raise ValueError(f"quantized_linear takes M * K below 2^31, got "
                         f"{M} x {K}")
    w_nk = k_operand(w_nk, K)
    xq = torch.empty((M, Kp), dtype=torch.int8, device=dev)
    xs_buf = torch.empty(1, dtype=torch.float32, device=dev) \
        if x_scale is None else None
    if dev.type == "meta":         # the dry run: allocations alone
        _scratch(dev, "sync", 4)
        return out
    err = _launcher("vta_wgmma_qlinear")(
        x2.data_ptr(), X_DTYPES[x2.dtype], w_nk.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), xq.data_ptr(), _ptr(x_scale), _ptr(xs_buf),
        _scratch(dev, "sync", 4).data_ptr(),
        M, N, K, Kp, quant_blocks(M, Kp, sms), lo, plan.bm // 64, plan.bn,
        plan.splits, plan.kslice // WGMMA_KSTEP, _stream(dev))
    _build.check(err, "vta_gemm")
    return out
