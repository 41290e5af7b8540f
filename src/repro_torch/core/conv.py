"""2D convolution lowered onto VTA (§2.6, Fig. 9, §4.2).

Three lowering modes, selected per shape by :func:`select_conv_lowering`
and surfaced as an inspectable scheduling decision on
``CompiledProgram.describe()``:

``direct`` (default, any shape) — tensorizes NCHW conv2d onto the GEMM
intrinsic *without* im2col anywhere: the load module's 2D strided DMA
inserts spatial zero-padding on the fly, and the micro-op kernel's
2-level affine loop walks (kh, kw, icb) — the access-pattern compression
the paper describes in §2.5.  Emits one GEMM instruction per output row,
which the CudaBackend coalescer row-stacks into one batched ``vta_gemm``
call per tile (the direct-conv fast path).

``via_matmul`` (kh=kw=1, stride=1, pad=0) — pointwise convs consume the
blocked NCHW plane *in place* as a K-major matrix through ``lower_matmul``
transposed mode; works for batch-blocked template instances too (each
image block is one transposed matmul; ``tpu_like()``-style specs included).

``im2col`` (stride=1) — builds the im2col matrix *in SRAM* with
one 2D padded DMA per (icb, kh, kw) gather row, then runs the pure
transposed-GEMM schedule over it: a single coalescable GEMM instruction
per tile instead of one per output row.  Trades kh*kw-fold inp-SRAM
duplication (the §2.5 argument for the direct schedule) for the smallest
possible instruction stream — profitable when a shape is uop-cache- or
insn-issue-bound.

Selection rules (``select_conv_lowering``): auto picks ``via_matmul`` for
eligible pointwise shapes (structural 1:1 mapping); for every other
stride-1 shape the choice between ``direct`` and ``im2col`` comes from
REPLAYED CYCLES — each candidate is lowered into a scratch stream and
priced on the calibrated TimingModel (:func:`predict_conv_cycles`), the
cheaper one wins.  Strided shapes take ``direct`` (im2col's gather rows
must be DMA-contiguous).  Explicit requests are validated and constraint
violations raise at graph-build time with the legal alternatives in the
message.

Direct-schedule SRAM layouts per virtual-thread context:
  inp  tile: (cbt, iht, IWp)    idx = (cb*iht + ih)*IWp + iw
  wgt  tile: (ocbt, cbt*KH*KW)  idx = ocb*cbt*KH*KW + (cb*KH+kh)*KW + kw
  acc  tile: (ocbt, oht, OW)    idx = (ocb*oht + oh)*OW + ow     (+ bias slot)

One GEMM instruction per output row `oh_l`:
  i0 = ow   (extent OW,   dst*1,        src*S,  wgt*0)
  i1 = ocb  (extent ocbt, dst*oht*OW,   src*0,  wgt*cbt*KH*KW)
  uops enumerate (cb, kh, kw).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from . import layout
from .hwspec import HardwareSpec
from .isa import AluOp, IsaLayout, MemId
from .runtime import Runtime, UopBuilder, UopKernel
from .scheduler import (Epilogue, SramPartition, _ceil_div, _ThreadDeps,
                        emit_fenced_load_group, interleave_virtual_threads,
                        lower_matmul)


@dataclass(frozen=True)
class ConvShape:
    """One conv2d workload (Table 1 row)."""
    n: int
    h: int
    w: int
    ic: int
    oc: int
    kh: int
    kw: int
    stride: int
    pad: int

    @property
    def oh(self) -> int:
        return (self.h + 2 * self.pad - self.kh) // self.stride + 1

    @property
    def ow(self) -> int:
        return (self.w + 2 * self.pad - self.kw) // self.stride + 1

    @property
    def macs(self) -> int:
        return self.n * self.oc * self.oh * self.ow * self.ic * self.kh * self.kw

    @property
    def gops(self) -> float:
        return 2.0 * self.macs / 1e9

    def dram_bytes(self, spec: HardwareSpec) -> int:
        """Minimum DRAM traffic (one pass over each tensor, int8/int32)."""
        inp = self.n * self.ic * self.h * self.w
        wgt = self.oc * self.ic * self.kh * self.kw
        out = self.n * self.oc * self.oh * self.ow
        return inp + wgt + out

    @property
    def arithmetic_intensity(self) -> float:
        return 2.0 * self.macs / self.dram_bytes(HardwareSpec())


@dataclass
class ConvPlan:
    shape: ConvShape
    tiles: Tuple[int, int, int]      # (oht, ocbt, cbt)
    x_addr: int
    w_addr: int
    y_addr: int
    Nb: int
    Cb: int
    OCb: int
    mode: str = "direct"             # which lowering produced the stream


def choose_conv_tiles(shape: ConvShape, spec: HardwareSpec,
                      virtual_threads: int, bias: bool,
                      sram: Optional[SramPartition] = None
                      ) -> Tuple[int, int, int]:
    sram = sram or SramPartition.full(spec)
    Cb = _ceil_div(shape.ic, spec.block_in)
    OCb = _ceil_div(shape.oc, spec.block_out)
    IWp = shape.w + 2 * shape.pad
    inp_cap = sram.inp_depth // virtual_threads
    wgt_cap = sram.wgt_depth // virtual_threads
    acc_cap = sram.acc_depth // virtual_threads

    def fits(oht, ocbt, cbt):
        iht = (oht - 1) * shape.stride + shape.kh
        a = oht * shape.ow * ocbt + (ocbt if bias else 0)
        return (cbt * iht * IWp <= inp_cap
                and ocbt * cbt * shape.kh * shape.kw <= wgt_cap
                and a <= acc_cap)

    oht, ocbt, cbt = 1, 1, 1
    if not fits(1, 1, 1):
        raise ValueError(
            f"conv tile (1,1,1) does not fit SRAM for {shape} "
            f"(inp needs {shape.kh * IWp} of {inp_cap}) — offload to CPU")
    changed = True
    while changed:
        changed = False
        for grow in ("cbt", "ocbt", "oht"):
            o2, c2, b2 = oht, ocbt, cbt
            if grow == "cbt" and cbt < Cb:
                b2 = min(Cb, cbt * 2)
            elif grow == "ocbt" and ocbt < OCb:
                c2 = min(OCb, ocbt * 2)
            elif grow == "oht" and oht < shape.oh:
                o2 = min(shape.oh, oht * 2)
            if (o2, c2, b2) != (oht, ocbt, cbt) and fits(o2, c2, b2):
                oht, ocbt, cbt = o2, c2, b2
                changed = True
    return oht, ocbt, cbt


def lower_conv2d(rt: Runtime, *, x_base: int, w_base: int, y_base: int,
                 shape: ConvShape, epilogue: Optional[Epilogue] = None,
                 bias_base: int = -1, virtual_threads: int = 2,
                 sram: Optional[SramPartition] = None,
                 fenced: bool = False) -> Tuple[int, int, int]:
    """Emit the direct-conv schedule into rt's open stream (element
    addresses of already-staged blocked buffers, like ``lower_matmul``).
    ``fenced`` claims a preceding ``buffer_fence`` token on the first x
    load, after free-running the first weight tile (see ``lower_matmul``).
    Returns the chosen (oht, ocbt, cbt) tiles."""
    spec = rt.spec
    ep = epilogue or Epilogue()
    if (ep.bias_blocked is not None) != (bias_base >= 0):
        raise ValueError("epilogue.bias_blocked and bias_base must agree")
    sram = sram or SramPartition.full(spec)
    S, KH, KW, pad = shape.stride, shape.kh, shape.kw, shape.pad
    OH, OW = shape.oh, shape.ow
    IWp = shape.w + 2 * pad
    H, W = shape.h, shape.w
    Nb = _ceil_div(shape.n, spec.batch)
    Cb = _ceil_div(shape.ic, spec.block_in)
    OCb = _ceil_div(shape.oc, spec.block_out)
    b_base = bias_base

    vt = virtual_threads
    oht, ocbt, cbt = choose_conv_tiles(shape, spec, vt,
                                       ep.bias_blocked is not None, sram=sram)
    iht = (oht - 1) * S + KH
    inp_ctx = sram.inp_depth // vt
    wgt_ctx = sram.wgt_depth // vt
    acc_ctx = sram.acc_depth // vt
    deps = [_ThreadDeps() for _ in range(vt)]

    def gemm_kernel(oh_l, cbt_c, ocbt_c, acc_base, inp_base, wgt_base) -> UopKernel:
        def build(b: UopBuilder):
            b.loop_begin(OW, dst_factor=1, src_factor=S, wgt_factor=0)
            b.loop_begin(ocbt_c, dst_factor=oht * OW, src_factor=0,
                         wgt_factor=cbt_c * KH * KW)
            for cb in range(cbt_c):
                for kh in range(KH):
                    for kw in range(KW):
                        b.push(dst=acc_base + oh_l * OW,
                               src=inp_base + (cb * iht + oh_l * S + kh) * IWp + kw,
                               wgt=wgt_base + (cb * KH + kh) * KW + kw)
            b.loop_end(); b.loop_end()
        return rt.uop_kernel(
            build, key=f"cv.{shape}.{oh_l}.{cbt_c}.{ocbt_c}.{acc_base}.{inp_base}.{wgt_base}")

    def reset_kernel(ocbt_c, oht_c, acc_base) -> UopKernel:
        # note: the ocb stride in the acc tile is the *full* oht (layout),
        # even when an edge tile only computes oht_c < oht rows.
        def build(b: UopBuilder):
            b.loop_begin(ocbt_c, dst_factor=oht * OW, src_factor=0)
            b.loop_begin(oht_c * OW, dst_factor=1, src_factor=0)
            b.push(dst=acc_base, src=0)
            b.loop_end(); b.loop_end()
        return rt.uop_kernel(build, key=f"cvrst.{shape}.{ocbt_c}.{oht_c}.{acc_base}")

    def alu_kernel(ocbt_c, oht_c, acc_base, src_base, s_fo, s_fi, tag) -> UopKernel:
        def build(b: UopBuilder):
            b.loop_begin(ocbt_c, dst_factor=oht * OW, src_factor=s_fo)
            b.loop_begin(oht_c * OW, dst_factor=1, src_factor=s_fi)
            b.push(dst=acc_base, src=src_base)
            b.loop_end(); b.loop_end()
        return rt.uop_kernel(
            build, key=f"cvalu.{shape}.{tag}.{ocbt_c}.{oht_c}.{acc_base}.{src_base}.{s_fo}.{s_fi}")

    n_oh, n_oc, n_cb = _ceil_div(OH, oht), _ceil_div(OCb, ocbt), _ceil_div(Cb, cbt)
    fence_pending = [fenced]   # claimed by the first x load emitted

    def tile_program(coord, t):
        """Phase generator for one (nb, oh-tile, oc-tile); see
        scheduler.interleave_virtual_threads for the pairing argument."""
        nb, ot, jt = coord
        d = deps[t]
        oh0 = ot * oht
        oht_c = min(oht, OH - oh0)
        iht_c = (oht_c - 1) * S + KH
        ocb0 = jt * ocbt
        ocbt_c = min(ocbt, OCb - ocb0)
        acc_base = sram.acc_base + t * acc_ctx
        bias_sram = sram.acc_base + t * acc_ctx + oht * OW * ocbt
        inp_base0 = sram.inp_base + t * inp_ctx
        wgt_base0 = sram.wgt_base + t * wgt_ctx

        first = True
        for kt in range(n_cb):
            cb0 = kt * cbt
            cbt_c = min(cbt, Cb - cb0)
            # ---- load group ----
            d.begin_load_group(rt)
            h_start = oh0 * S - pad
            y_pad_0 = max(0, -h_start)
            y_pad_1 = max(0, h_start + iht_c - H)
            y_size = iht_c - y_pad_0 - y_pad_1

            def load_x(cb0=cb0, cbt_c=cbt_c, y_size=y_size,
                       y_pad_0=y_pad_0, y_pad_1=y_pad_1, h_start=h_start):
                for cb in range(cbt_c):
                    plane = x_base + ((nb * Cb + cb0 + cb) * H
                                      + (h_start + y_pad_0)) * W
                    rt.load_buffer_2d(
                        MemId.INP, inp_base0 + cb * iht * IWp,
                        plane, y_size=y_size, x_size=W, x_stride=W,
                        y_pad_0=y_pad_0, y_pad_1=y_pad_1,
                        x_pad_0=pad, x_pad_1=pad)

            def load_w(cb0=cb0, cbt_c=cbt_c):
                rt.load_buffer_2d(
                    MemId.WGT, wgt_base0,
                    w_base + ((ocb0 * Cb + cb0) * KH) * KW,
                    y_size=ocbt_c, x_size=cbt_c * KH * KW,
                    x_stride=Cb * KH * KW)

            emit_fenced_load_group(rt, fence_pending, load_x, load_w)
            d.end_load_group(rt)
            yield
            # ---- compute group ----
            d.begin_compute_group(rt, pops_acc=first)
            if first:
                rt.push_gemm(reset_kernel(ocbt_c, oht_c, acc_base),
                             reset=True)
                if b_base >= 0:
                    rt.load_buffer_2d(MemId.ACC, bias_sram,
                                      b_base + ocb0, y_size=1,
                                      x_size=ocbt_c, x_stride=OCb)
                first = False
            for oh_l in range(oht_c):
                rt.push_gemm(gemm_kernel(oh_l, cbt_c, ocbt_c,
                                         acc_base, inp_base0, wgt_base0))
            d.end_compute_group_frees_loads(rt)
            yield

        # ---- epilogue ----
        if b_base >= 0:
            rt.push_alu(alu_kernel(ocbt_c, oht_c, acc_base, bias_sram,
                                   1, 0, "bias"),
                        op=AluOp.ADD, use_imm=False)
        if ep.shift:
            rt.push_alu(alu_kernel(ocbt_c, oht_c, acc_base, acc_base,
                                   oht * OW, 1, "self"),
                        op=AluOp.SHR, imm=ep.shift)
        if ep.relu:
            rt.push_alu(alu_kernel(ocbt_c, oht_c, acc_base, acc_base,
                                   oht * OW, 1, "self"),
                        op=AluOp.MAX, imm=0)
        if ep.clip_lo is not None:
            rt.push_alu(alu_kernel(ocbt_c, oht_c, acc_base, acc_base,
                                   oht * OW, 1, "self"),
                        op=AluOp.MAX, imm=ep.clip_lo)
            rt.push_alu(alu_kernel(ocbt_c, oht_c, acc_base, acc_base,
                                   oht * OW, 1, "self"),
                        op=AluOp.MIN, imm=ep.clip_hi)
        # ---- store: one 2D store per output-channel block (own phase so
        # peer tiles are fully recorded at the group's first store) ----
        d.compute_to_store(rt, own_insn=ep.n_alu_passes > 0)
        yield
        d.begin_store(rt)
        for ocb in range(ocbt_c):
            rt.store_buffer_2d(
                acc_base + ocb * oht * OW,
                ((nb * OCb + ocb0 + ocb) * OH + oh0) * OW + y_base,
                y_size=oht_c, x_size=OW, x_stride=OW)
        d.end_store(rt)
        yield

    tiles = [(nb, ot, jt) for nb in range(Nb)
             for ot in range(n_oh) for jt in range(n_oc)]
    interleave_virtual_threads(tiles, vt, tile_program)
    return oht, ocbt, cbt


CONV_LOWERINGS = ("direct", "im2col", "via_matmul")


def conv1x1_eligible(shape: ConvShape, spec: HardwareSpec) -> bool:
    """Pointwise convs with unit stride map 1:1 onto the transposed-matmul
    lowering: a blocked NCHW plane is a K-major (channel-block, pixel)
    matrix whose elements carry the image block in the tensor-register
    rows, so batch-blocked template instances (``tpu_like()``) work the
    same way — one transposed matmul per image *block*."""
    return (shape.kh == 1 and shape.kw == 1 and shape.stride == 1
            and shape.pad == 0)


def conv_im2col_eligible(shape: ConvShape) -> bool:
    """The im2col gather loads one (icb, kh, kw) row of the K-major SRAM
    tile per 2D DMA; elements within a DMA row are contiguous, so the
    output-pixel axis must walk the image with unit stride."""
    return shape.stride == 1


def _ep_cost_sig(ep) -> Tuple:
    """What an epilogue costs in the timing replay: its ALU-pass set and
    whether a bias DMA happens — never the bias VALUES."""
    if ep is None:
        return ()
    return (ep.shift, ep.clip_lo, ep.clip_hi, ep.relu,
            ep.bias_blocked is not None)


_PREDICT_MEMO: dict = {}


def predict_conv_cycles(shape: ConvShape, spec: HardwareSpec, mode: str,
                        *, epilogue=None, virtual_threads: int = 2,
                        timing=None) -> int:
    """Replayed TimingModel cycles of ONE conv2d node lowered in `mode`.

    Emits the real lowering into a scratch runtime (synthetic base
    addresses — the replay prices DMA sizes and uop iteration counts,
    never the addresses) and replays it on the calibrated model.  This
    is the cycle oracle behind auto lowering selection and the
    autotuner; memoized per (mode, shape, spec, vt, epilogue-cost,
    timing), so a compile touches each distinct decision once.  Raises
    ValueError when `mode` cannot lower `shape` (e.g. SRAM too small)."""
    from .driver import Device
    from .simulator import TimingModel, replay_timing
    tm = timing or TimingModel(spec)
    key = (mode, shape, spec, virtual_threads, _ep_cost_sig(epilogue),
           type(tm).__name__, tm.spec)
    got = _PREDICT_MEMO.get(key)
    if got is not None:
        return got
    lower = {"direct": lower_conv2d, "im2col": lower_conv_im2col,
             "via_matmul": lower_conv1x1}[mode]
    # a scratch image on the host: only the stream is read back
    rt = Runtime(spec, device=Device(dram_size=1 << 22, torch_device="cpu"))
    bias = 0 if (epilogue is not None
                 and epilogue.bias_blocked is not None) else -1
    lower(rt, x_base=0, w_base=0, y_base=0, shape=shape,
          epilogue=epilogue, bias_base=bias,
          virtual_threads=virtual_threads)
    cycles = replay_timing(spec, rt.stream, tm).total_cycles
    _PREDICT_MEMO[key] = cycles
    return cycles


def cheapest_conv_lowering(shape: ConvShape, spec: HardwareSpec, *,
                           candidates: Tuple[str, ...] = ("direct",
                                                          "im2col"),
                           epilogue=None, virtual_threads: int = 2,
                           timing=None) -> Tuple[str, dict]:
    """Cycle-compare candidate lowerings on the TimingModel: returns
    ``(winner, {mode: predicted_cycles})``.  Shape-ineligible or
    SRAM-infeasible modes are dropped (priced at None in the map); ties
    break toward the earlier candidate.  Raises if NO candidate can
    lower the shape."""
    cycles: dict = {}
    for mode in candidates:
        if mode == "im2col" and not conv_im2col_eligible(shape):
            cycles[mode] = None
            continue
        if mode == "via_matmul" and not conv1x1_eligible(shape, spec):
            cycles[mode] = None
            continue
        try:
            cycles[mode] = predict_conv_cycles(
                shape, spec, mode, epilogue=epilogue,
                virtual_threads=virtual_threads, timing=timing)
        except ValueError:
            cycles[mode] = None
    feasible = [(c, m) for m, c in cycles.items() if c is not None]
    if not feasible:
        raise ValueError(f"no candidate lowering in {candidates} can "
                         f"lower {shape} on this spec")
    return min(feasible)[1], cycles


def select_conv_lowering(shape: ConvShape, spec: HardwareSpec,
                         requested: Optional[str] = None, *,
                         epilogue=None, virtual_threads: int = 2,
                         timing=None) -> str:
    """Resolve (and validate) the lowering mode for one conv2d node.

    requested=None/"auto": pointwise unit-stride shapes take
    ``via_matmul`` (a structural 1:1 mapping, not a cost call); every
    other eligible shape is decided by REPLAYED CYCLES — ``direct`` vs
    ``im2col`` lowered into a scratch stream and priced on the
    TimingModel (:func:`cheapest_conv_lowering`), never by a hardcoded
    profitability rule.  An explicitly requested mode is validated
    against its shape constraints and raises a ValueError naming the
    legal alternatives — this is what makes bad graph configurations
    fail at build time instead of deep inside a lowering pass."""
    if requested in (None, "auto"):
        if conv1x1_eligible(shape, spec):
            return "via_matmul"
        if not conv_im2col_eligible(shape):
            return "direct"
        return cheapest_conv_lowering(
            shape, spec, epilogue=epilogue,
            virtual_threads=virtual_threads, timing=timing)[0]
    if requested == "via_matmul":
        if not conv1x1_eligible(shape, spec):
            raise ValueError(
                f"lowering='via_matmul' requires a pointwise unit-stride "
                f"conv (kh=kw=1, stride=1, pad=0); got kh={shape.kh} "
                f"kw={shape.kw} stride={shape.stride} pad={shape.pad}. "
                f"Use lowering='direct' (any shape) or 'im2col' (stride=1).")
        return requested
    if requested == "im2col":
        if not conv_im2col_eligible(shape):
            raise ValueError(
                f"lowering='im2col' requires stride=1 (the im2col gather "
                f"rows must be DMA-contiguous); got stride={shape.stride}. "
                f"Use lowering='direct'.")
        return requested
    if requested == "direct":
        return requested
    raise ValueError(f"unknown conv lowering {requested!r}; choose from "
                     f"{CONV_LOWERINGS} or None for auto")


def lower_conv1x1(rt: Runtime, *, x_base: int, w_base: int, y_base: int,
                  shape: ConvShape, epilogue: Optional[Epilogue] = None,
                  bias_base: int = -1, virtual_threads: int = 2,
                  sram: Optional[SramPartition] = None,
                  fenced: bool = False) -> None:
    """1x1-conv fast path: lower through the transposed GEMM schedule so
    these nodes hit the vta_gemm fast path (ResNet C3/C8/C11-style
    pointwise layers).  The blocked conv activation/weight/output buffers
    are consumed *in place* — no host-side im2col, no relayout.  For
    batch-blocked specs each image block is one transposed matmul whose
    tensor-register rows carry the images."""
    spec = rt.spec
    if not conv1x1_eligible(shape, spec):
        raise ValueError(f"{shape} is not 1x1-fast-path eligible")
    Cb = _ceil_div(shape.ic, spec.block_in)
    OCb = _ceil_div(shape.oc, spec.block_out)
    HW = shape.h * shape.w
    Nb = _ceil_div(shape.n, spec.batch)
    for nb in range(Nb):
        if nb:
            # image blocks reuse the same SRAM partition: rendezvous first
            rt.join_barrier()
        lower_matmul(rt,
                     a_base=x_base + nb * Cb * HW,
                     w_base=w_base,
                     c_base=y_base + nb * OCb * HW,
                     Mb=HW, Nb=OCb, Kb=Cb,
                     epilogue=epilogue, bias_base=bias_base,
                     virtual_threads=virtual_threads, sram=sram,
                     transposed=True,
                     fenced=fenced and nb == 0)


def choose_im2col_tiles(shape: ConvShape, spec: HardwareSpec,
                        virtual_threads: int, bias: bool,
                        sram: Optional[SramPartition] = None
                        ) -> Tuple[int, int, int]:
    """(oht, ocbt, cbt) for the im2col schedule: the K-major SRAM tile is
    (cbt*KH*KW) x (oht*OW), so the inp footprint carries the kh*kw
    duplication the direct schedule avoids."""
    sram = sram or SramPartition.full(spec)
    Cb = _ceil_div(shape.ic, spec.block_in)
    OCb = _ceil_div(shape.oc, spec.block_out)
    OW = shape.ow
    inp_cap = sram.inp_depth // virtual_threads
    wgt_cap = sram.wgt_depth // virtual_threads
    acc_cap = sram.acc_depth // virtual_threads
    # affine dst factors must encode mtt = oht*OW (transposed-mode layout)
    max_factor = (1 << IsaLayout(spec).factor_bits) - 1

    def fits(oht, ocbt, cbt):
        mtt = oht * OW
        ktt = cbt * shape.kh * shape.kw
        a = mtt * ocbt + (ocbt if bias else 0)
        return (ktt * mtt <= inp_cap and ocbt * ktt <= wgt_cap
                and a <= acc_cap and mtt <= max_factor)

    if not fits(1, 1, 1):
        raise ValueError(
            f"im2col tile (1,1,1) does not fit SRAM for {shape} "
            f"(inp needs {shape.kh * shape.kw * OW} of {inp_cap}) — "
            f"use lowering='direct' or offload to CPU")
    oht, ocbt, cbt = 1, 1, 1
    changed = True
    while changed:
        changed = False
        for grow in ("cbt", "ocbt", "oht"):
            o2, c2, b2 = oht, ocbt, cbt
            if grow == "cbt" and cbt < Cb:
                b2 = min(Cb, cbt * 2)
            elif grow == "ocbt" and ocbt < OCb:
                c2 = min(OCb, ocbt * 2)
            elif grow == "oht" and oht < shape.oh:
                o2 = min(shape.oh, oht * 2)
            if (o2, c2, b2) != (oht, ocbt, cbt) and fits(o2, c2, b2):
                oht, ocbt, cbt = o2, c2, b2
                changed = True
    return oht, ocbt, cbt


def lower_conv_im2col(rt: Runtime, *, x_base: int, w_base: int, y_base: int,
                      shape: ConvShape, epilogue: Optional[Epilogue] = None,
                      bias_base: int = -1, virtual_threads: int = 2,
                      sram: Optional[SramPartition] = None,
                      fenced: bool = False) -> Tuple[int, int, int]:
    """im2col-in-SRAM lowering: gather the K-major im2col tile with one 2D
    padded DMA per (icb, kh, kw) row, then run ``lower_matmul``'s
    transposed-mode GEMM/epilogue/store structure over it — a single
    coalescable GEMM instruction per (k-chunk, tile) instead of the direct
    schedule's one-per-output-row.  Requires stride == 1 (gather rows must
    be DMA-contiguous); any kh/kw/pad.  Returns (oht, ocbt, cbt)."""
    spec = rt.spec
    ep = epilogue or Epilogue()
    if (ep.bias_blocked is not None) != (bias_base >= 0):
        raise ValueError("epilogue.bias_blocked and bias_base must agree")
    if not conv_im2col_eligible(shape):
        raise ValueError(f"{shape} is not im2col-eligible (stride != 1)")
    sram = sram or SramPartition.full(spec)
    KH, KW, pad = shape.kh, shape.kw, shape.pad
    OH, OW = shape.oh, shape.ow
    H, W = shape.h, shape.w
    Nb = _ceil_div(shape.n, spec.batch)
    Cb = _ceil_div(shape.ic, spec.block_in)
    OCb = _ceil_div(shape.oc, spec.block_out)
    Kfull = Cb * KH * KW
    b_base = bias_base

    vt = virtual_threads
    oht, ocbt, cbt = choose_im2col_tiles(shape, spec, vt,
                                         ep.bias_blocked is not None,
                                         sram=sram)
    inp_ctx = sram.inp_depth // vt
    wgt_ctx = sram.wgt_depth // vt
    acc_ctx = sram.acc_depth // vt
    deps = [_ThreadDeps() for _ in range(vt)]

    # transposed-mode micro-kernels (lower_matmul's K-major structure):
    # acc tile is N-major over pixels, dst = acc_base + m + n*mtt
    def gemm_kernel(mtt, ntt, ktt, acc_base, inp_base, wgt_base) -> UopKernel:
        def build(b: UopBuilder):
            b.loop_begin(mtt, dst_factor=1, src_factor=1, wgt_factor=0)
            b.loop_begin(ntt, dst_factor=mtt, src_factor=0, wgt_factor=ktt)
            for k in range(ktt):
                b.push(dst=acc_base, src=inp_base + k * mtt, wgt=wgt_base + k)
            b.loop_end(); b.loop_end()
        return rt.uop_kernel(
            build,
            key=f"i2c.{shape}.{mtt}.{ntt}.{ktt}.{acc_base}.{inp_base}.{wgt_base}")

    def reset_kernel(mtt, ntt, acc_base) -> UopKernel:
        def build(b: UopBuilder):
            b.loop_begin(mtt, dst_factor=1, src_factor=0)
            b.loop_begin(ntt, dst_factor=mtt, src_factor=0)
            b.push(dst=acc_base, src=0)
            b.loop_end(); b.loop_end()
        return rt.uop_kernel(build, key=f"i2crst.{shape}.{mtt}.{ntt}.{acc_base}")

    def alu_kernel(mtt, ntt, acc_base, src_base, s_fo, s_fi, tag) -> UopKernel:
        def build(b: UopBuilder):
            b.loop_begin(mtt, dst_factor=1, src_factor=s_fo)
            b.loop_begin(ntt, dst_factor=mtt, src_factor=s_fi)
            b.push(dst=acc_base, src=src_base)
            b.loop_end(); b.loop_end()
        return rt.uop_kernel(
            build,
            key=f"i2calu.{shape}.{tag}.{mtt}.{ntt}.{acc_base}.{src_base}.{s_fo}.{s_fi}")

    n_oh, n_oc, n_cb = _ceil_div(OH, oht), _ceil_div(OCb, ocbt), \
        _ceil_div(Cb, cbt)
    fence_pending = [fenced]   # claimed by the first gather load emitted

    def tile_program(coord, t):
        nb, ot, jt = coord
        d = deps[t]
        oh0 = ot * oht
        oht_c = min(oht, OH - oh0)
        mtt = oht_c * OW
        ocb0 = jt * ocbt
        ocbt_c = min(ocbt, OCb - ocb0)
        acc_base = sram.acc_base + t * acc_ctx
        bias_sram = sram.acc_base + t * acc_ctx + oht * OW * ocbt
        inp_base0 = sram.inp_base + t * inp_ctx
        wgt_base0 = sram.wgt_base + t * wgt_ctx

        first = True
        for kt in range(n_cb):
            cb0 = kt * cbt
            cbt_c = min(cbt, Cb - cb0)
            ktt = cbt_c * KH * KW
            # ---- load group: the im2col gather (one DMA per k-row) ----
            d.begin_load_group(rt)

            def load_x(cb0=cb0, cbt_c=cbt_c, oht_c=oht_c, mtt=mtt, oh0=oh0):
                for cb in range(cbt_c):
                    plane = x_base + (nb * Cb + cb0 + cb) * H * W
                    for kh in range(KH):
                        row0 = oh0 + kh - pad       # stride==1: oh walks h
                        y_pad_0 = min(oht_c, max(0, -row0))
                        y_pad_1 = min(oht_c - y_pad_0,
                                      max(0, row0 + oht_c - H))
                        y_size = oht_c - y_pad_0 - y_pad_1
                        for kw in range(KW):
                            col0 = kw - pad
                            x_pad_0 = min(OW, max(0, -col0))
                            x_pad_1 = min(OW - x_pad_0,
                                          max(0, col0 + OW - W))
                            k_local = (cb * KH + kh) * KW + kw
                            rt.load_buffer_2d(
                                MemId.INP, inp_base0 + k_local * mtt,
                                plane + (row0 + y_pad_0) * W
                                + (col0 + x_pad_0),
                                y_size=y_size,
                                x_size=OW - x_pad_0 - x_pad_1, x_stride=W,
                                y_pad_0=y_pad_0, y_pad_1=y_pad_1,
                                x_pad_0=x_pad_0, x_pad_1=x_pad_1)

            def load_w(cb0=cb0, ktt=ktt):
                rt.load_buffer_2d(
                    MemId.WGT, wgt_base0,
                    w_base + ocb0 * Kfull + cb0 * KH * KW,
                    y_size=ocbt_c, x_size=ktt, x_stride=Kfull)

            emit_fenced_load_group(rt, fence_pending, load_x, load_w)
            d.end_load_group(rt)
            yield
            # ---- compute group ----
            d.begin_compute_group(rt, pops_acc=first)
            if first:
                rt.push_gemm(reset_kernel(mtt, ocbt_c, acc_base), reset=True)
                if b_base >= 0:
                    rt.load_buffer_2d(MemId.ACC, bias_sram, b_base + ocb0,
                                      y_size=1, x_size=ocbt_c, x_stride=OCb)
                first = False
            rt.push_gemm(gemm_kernel(mtt, ocbt_c, ktt, acc_base,
                                     inp_base0, wgt_base0))
            d.end_compute_group_frees_loads(rt)
            yield

        # ---- epilogue (transposed-mode source factors) ----
        if b_base >= 0:
            rt.push_alu(alu_kernel(mtt, ocbt_c, acc_base, bias_sram,
                                   0, 1, "bias"),
                        op=AluOp.ADD, use_imm=False)
        if ep.shift:
            rt.push_alu(alu_kernel(mtt, ocbt_c, acc_base, acc_base,
                                   1, mtt, "self"),
                        op=AluOp.SHR, imm=ep.shift)
        clip_lo = ep.folded_clip_lo
        if ep.relu and clip_lo is None:
            rt.push_alu(alu_kernel(mtt, ocbt_c, acc_base, acc_base,
                                   1, mtt, "self"),
                        op=AluOp.MAX, imm=0)
        if clip_lo is not None:
            rt.push_alu(alu_kernel(mtt, ocbt_c, acc_base, acc_base,
                                   1, mtt, "self"),
                        op=AluOp.MAX, imm=clip_lo)
            rt.push_alu(alu_kernel(mtt, ocbt_c, acc_base, acc_base,
                                   1, mtt, "self"),
                        op=AluOp.MIN, imm=ep.clip_hi)
        # ---- store: one 2D store, rows = output-channel blocks (own
        # phase so peer tiles are fully recorded at the group's store) ----
        d.compute_to_store(rt, own_insn=ep.n_alu_passes > 0)
        yield
        d.begin_store(rt)
        rt.store_buffer_2d(
            acc_base,
            (nb * OCb + ocb0) * OH * OW + oh0 * OW + y_base,
            y_size=ocbt_c, x_size=mtt, x_stride=OH * OW)
        d.end_store(rt)
        yield

    tiles = [(nb, ot, jt) for nb in range(Nb)
             for ot in range(n_oh) for jt in range(n_oc)]
    interleave_virtual_threads(tiles, vt, tile_program)
    return oht, ocbt, cbt


def schedule_conv2d(rt: Runtime, x: np.ndarray, w: np.ndarray,
                    shape: ConvShape, epilogue: Optional[Epilogue] = None,
                    virtual_threads: int = 2,
                    sram: Optional[SramPartition] = None,
                    via_matmul: bool = False,
                    lowering: Optional[str] = None) -> ConvPlan:
    """Lower y = conv2d(x, w) (+epilogue) onto VTA: stages the blocked
    operands in DRAM and delegates stream emission to the lowering pass
    picked by ``lowering`` ("direct" | "im2col" | "via_matmul"; validated
    by ``select_conv_lowering``).  ``via_matmul=True`` is the back-compat
    spelling of lowering="via_matmul" that silently degrades to "direct"
    for ineligible shapes."""
    spec = rt.spec
    ep = epilogue or Epilogue()
    assert x.shape == (shape.n, shape.ic, shape.h, shape.w)
    assert w.shape == (shape.oc, shape.ic, shape.kh, shape.kw)
    if lowering is not None:
        mode = select_conv_lowering(shape, spec, lowering)
    elif via_matmul and conv1x1_eligible(shape, spec):
        mode = "via_matmul"
    else:
        mode = "direct"

    xb = layout.pack_conv_inp(x, spec)
    wb = layout.pack_conv_wgt(w, spec)
    Nb, Cb = xb.shape[0], xb.shape[1]
    OCb = wb.shape[0]
    x_addr = rt.copy_to_device(xb, align=spec.inp_elem_bytes)
    w_addr = rt.copy_to_device(wb, align=spec.wgt_elem_bytes)
    y_addr = rt.buffer_alloc(Nb * OCb * shape.oh * shape.ow
                             * spec.out_elem_bytes,
                             align=spec.out_elem_bytes)
    b_base = -1
    if ep.bias_blocked is not None:
        b_addr = rt.copy_to_device(
            np.ascontiguousarray(ep.bias_blocked, np.int32),
            align=spec.acc_elem_bytes)
        b_base = rt.to_elem_addr(b_addr, MemId.ACC)

    kw = dict(x_base=rt.to_elem_addr(x_addr, MemId.INP),
              w_base=rt.to_elem_addr(w_addr, MemId.WGT),
              y_base=rt.to_elem_addr(y_addr, MemId.OUT),
              shape=shape, epilogue=ep, bias_base=b_base,
              virtual_threads=virtual_threads, sram=sram)
    if mode == "via_matmul":
        lower_conv1x1(rt, **kw)
        tiles = (0, 0, 0)   # GEMM-path tiling; not a conv (oht, ocbt, cbt)
    elif mode == "im2col":
        tiles = lower_conv_im2col(rt, **kw)
    else:
        tiles = lower_conv2d(rt, **kw)
    return ConvPlan(shape=shape, tiles=tiles, x_addr=x_addr,
                    w_addr=w_addr, y_addr=y_addr, Nb=Nb, Cb=Cb, OCb=OCb,
                    mode=mode)


def read_conv_result(rt: Runtime, plan: ConvPlan) -> np.ndarray:
    spec = rt.spec
    s = plan.shape
    blocked = rt.copy_from_device(
        plan.y_addr,
        plan.Nb * plan.OCb * s.oh * s.ow * spec.out_elem_bytes, np.int8,
        (plan.Nb, plan.OCb, s.oh, s.ow, spec.batch, spec.block_out))
    return layout.unpack_conv_out(blocked, s.n, s.oc, s.oh, s.ow, spec)


def conv2d_reference(x: np.ndarray, w: np.ndarray, shape: ConvShape,
                     epilogue: Optional[Epilogue] = None,
                     spec: Optional[HardwareSpec] = None) -> np.ndarray:
    """Pure-numpy integer oracle."""
    ep = epilogue or Epilogue()
    S, KH, KW, pad = shape.stride, shape.kh, shape.kw, shape.pad
    xp = np.pad(x.astype(np.int64),
                ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    OH, OW = shape.oh, shape.ow
    acc = np.zeros((shape.n, shape.oc, OH, OW), np.int64)
    for kh in range(KH):
        for kw in range(KW):
            xs = xp[:, :, kh:kh + OH * S:S, kw:kw + OW * S:S]
            acc += np.einsum("nchw,oc->nohw", xs, w[:, :, kh, kw].astype(np.int64))
    if ep.bias_blocked is not None:
        flat = ep.bias_blocked[:, 0, :].reshape(-1)[:shape.oc]
        acc += flat.astype(np.int64)[None, :, None, None]
    if ep.shift:
        acc = acc >> ep.shift
    if ep.relu:
        acc = np.maximum(acc, 0)
    if ep.clip_lo is not None:
        acc = np.clip(acc, ep.clip_lo, ep.clip_hi)
    return acc.astype(np.int32).astype(np.int8)
