"""ctypes binding of the CUDA vta_gemm kernels (``csrc/vta_gemm.cu``; the
design note is at the top of that file).  :func:`gemm_plan` picks the
instance and the split of K; it is plain Python, so the CPU tests reach it.
Built at first call by :mod:`repro_torch.kernels._build`, never at
import."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from .. import _build

EPILOGUES = {"none": 0, "requant": 1, "dequant": 2}
OUT_DTYPES = {"none": torch.int32, "requant": torch.int8,
              "dequant": torch.float32}
#: quantized_linear's epilogue code and its activation dtypes' codes
EPI_QLINEAR = 3
X_DTYPES = {torch.float32: 1, torch.bfloat16: 2}
ROUTES = {"tile": 0, "skinny": 1, "skinny_amax": 2}

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


@dataclass(frozen=True)
class GemmPlan:
    """route "tile" (64x64 blocks, the K loop in the block) or "skinny"
    (M <= 16: 128 channels a block, K cut into `splits` slices of
    `kslice` bytes, a multiple of SKINNY_KC)."""
    route: str
    splits: int
    kslice: int


def gemm_plan(T: int, M: int, N: int, K: int, sms: int = 132) -> GemmPlan:
    """The tile instance above SKINNY_MAX_M rows; else the skinny one with
    K split so that ceil(N / 128) * T column blocks come to about
    BLOCKS_PER_SM blocks per SM, no slice longer than SKINNY_KMAX."""
    if M > SKINNY_MAX_M:
        return GemmPlan("tile", 1, K)
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
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    buf = _SCRATCH.get((idx, what))
    if buf is None or buf.numel() < n:
        buf = _SCRATCH[(idx, what)] = torch.zeros(
            max(n, 4096), dtype=torch.int32, device=dev)
    return buf


def _launcher():
    fn = _build.load("vta_gemm").vta_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(a, w_nk, bias, scale, out, T, M, N, K, a_dtype, epilogue,
            shift, route, plan, xs_given=None, lo=0.0, n_amax=0):
    dev = a.device
    ws = sync = part = xs_buf = None
    if plan.route == "skinny":
        sync = _scratch(dev, "sync", 4 + T * -(-N // SKINNY_BN))
        if plan.splits > 1:
            ws = _scratch(dev, "partials", T * M * N)
    if n_amax:
        part = _scratch(dev, "amax", n_amax + 1)
        xs_buf = torch.empty(1, dtype=torch.float32, device=dev)
    ptr = (lambda t: t.data_ptr() if t is not None else None)  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(a.data_ptr(), w_nk.data_ptr(), ptr(bias), ptr(scale),
                      out.data_ptr(), ptr(ws), ptr(sync), ptr(xs_given),
                      ptr(xs_buf), ptr(part), T, M, N, K, a_dtype, epilogue,
                      int(shift), route, plan.splits, plan.kslice, n_amax,
                      float(lo), stream)
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
    out = torch.empty((T, M, N), dtype=OUT_DTYPES[epilogue], device=a.device)
    plan = gemm_plan(T, M, N, K, _sms(a.device))
    _launch(a, w_nk, bias, scale, out, T, M, N, K, 0, EPILOGUES[epilogue],
            shift, ROUTES[plan.route], plan)
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
    """quantized_linear in one launch (at most 16 rows, the grid resident,
    x_scale not given) or two (the amax in its own launch): x2 (M, K)
    float32 or bfloat16, w_nk (N, K) int8, w_scale (N,) float32, all
    contiguous on one CUDA device; x_scale None or a one-element float32
    tensor there.  Returns (M, N) in x2's dtype."""
    M, K = x2.shape
    N = w_nk.shape[0]
    dev = x2.device
    sms = _sms(dev)
    plan = gemm_plan(1, M, N, K, sms)
    if plan.route == "tile":
        route = ROUTES["tile"]
    elif x_scale is None and grid_resident(plan, 1, N, sms):
        route = ROUTES["skinny_amax"]
    else:
        route = ROUTES["skinny"]
    n_amax = 0 if x_scale is not None or route == ROUTES["skinny_amax"] \
        else amax_blocks(M * K, sms)
    out = torch.empty((M, N), dtype=x2.dtype, device=dev)
    _launch(x2, w_nk, None, w_scale, out, 1, M, N, K, X_DTYPES[x2.dtype],
            EPI_QLINEAR, 0, route, plan, xs_given=x_scale,
            lo=clamp_floor(x2.dtype), n_amax=n_amax)
    return out
