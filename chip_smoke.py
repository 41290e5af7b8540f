#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py [--record PATH]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It imports nothing of JAX and nothing of the JAX package.  Every phase
raises on failure and the script then exits non-zero; with no card, or
without the repository beside it, it exits non-zero before printing any
result.

Phases:
  0. the card's name and power limit (nvidia-smi) and the kernel build;
  2. the main path, with every kernel's launch count set to 0 just before
     and read just after: each accelerator layer C2-C12 of ResNet-18's
     Table 1 at its published shape as a one-layer Program (three
     requests each), the layer2.0 residual block (C4 -> C6, C5 shortcut,
     host residual add with relu), the C2 heterogeneous chain (cpu_only
     112x112x3 -> 64 stem, C2 body, 64-channel 1x1), and one 2^16-element
     vector ALU op.  Every output is held byte-equal to the port's numpy
     conv2d_reference, with zero eager GEMMs.  After it, the cost of the
     exact weight-content keys and a torch.profiler view of one request;
  1. each kernel against its plain PyTorch version, on the card, at every
     shape the main path launched plus ragged shapes and every epilogue,
     with CUDA-event times beside the least time the card could take;
  3. the simulator and cuda engines on one stream, DRAM images compared;
  4. the kernels line, the card line, and the result line.

With --record PATH, a detailed record (per-layer request times,
per-shape kernel times, the request profile, the nvcc reports) is
written to PATH as JSON.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
# no int32 figure in the table: the non-tensor-core float32 rate stands in
# for the int32 ALU rate (tensor_alu is bound by bytes either way)
INT32_ALU_OPS_PER_S = 67e12
# where the main path runs; main() refuses to run without a card
DEVICE = "cuda"


def log(msg=""):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_time_ms(fn, reps=20, warmup=3):
    """Median per-call time of fn() between two CUDA events: the device
    time of one call, plus any gap while the host prepares the launch."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def kernel_ms(fn, kernel_name, reps=20):
    """Mean device time of the CUDA kernels named `kernel_name` per call
    of fn(), from torch.profiler.  Fails when the profiler saw none: a
    launched kernel it cannot see is a fault, not a time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
    if total_us <= 0:
        fail(f"torch.profiler saw no device time for {kernel_name}")
    return total_us / reps / 1e3


# ----------------------------------------------------------------------
# phase 2: the main path
# ----------------------------------------------------------------------
def layer_epilogue(shape, spec, rng):
    """3x3 layers: bias, shift, relu.  1x1 shortcut layers: shift only
    (the fused requant path)."""
    import numpy as np
    from repro_torch.core.scheduler import Epilogue
    if shape.kh == 1:
        return Epilogue(shift=6)
    bias = rng.integers(-512, 512, size=shape.oc, dtype=np.int32)
    bb = np.repeat(bias.reshape(-1, 1, spec.block_out), spec.batch, axis=1)
    return Epilogue(bias_blocked=bb, shift=8, relu=True)


def serve(compiled, make_inputs, reference, n_requests=3):
    """Serve n requests; hold each output byte-equal to its reference.
    Returns (wall ms per request, launches per request per kernel)."""
    import numpy as np
    from repro_torch.core.backend import assert_fast_path
    from repro_torch.kernels.tensor_alu import tensor_alu
    from repro_torch.kernels.vta_gemm import vta_gemm
    walls, g_l, a_l = [], [], []
    for r in range(n_requests):
        inputs = make_inputs(r)
        g0, a0 = vta_gemm.launches, tensor_alu.launches
        t0 = time.perf_counter()
        out = compiled(**inputs)      # returns host numpy: device done
        walls.append((time.perf_counter() - t0) * 1e3)
        g_l.append(vta_gemm.launches - g0)
        a_l.append(tensor_alu.launches - a0)
        want = reference(inputs)
        if out.dtype != want.dtype or out.shape != want.shape \
                or not np.array_equal(out, want):
            fail(f"request {r}: output differs from conv2d_reference "
                 f"({int(np.count_nonzero(out != want))} elements)")
        assert_fast_path(compiled.last_stats)
        if any(s.backend != "cuda" for s in compiled.last_stats):
            fail("a segment did not run on the cuda engine")
    return walls, g_l, a_l


def phase_layers(rec):
    import numpy as np
    from repro_torch.core import hwspec
    from repro_torch.core.conv import conv2d_reference
    from repro_torch.core.program import Program
    from repro_torch.core.workloads import resnet18_table1
    spec = hwspec.pynq()
    for layer in resnet18_table1():
        if layer.cpu_only:
            continue
        s = layer.shape
        rng = np.random.default_rng(1000 + s.h + s.ic + s.oc + s.kh)
        w = rng.integers(-8, 8, size=(s.oc, s.ic, s.kh, s.kw), dtype=np.int8)
        ep = layer_epilogue(s, spec, rng)
        p = Program(spec)
        p.conv2d(p.input("x", (s.n, s.ic, s.h, s.w)), p.constant("w", w), s,
                 epilogue=ep, name=layer.name)
        t0 = time.perf_counter()
        c = p.compile(use_cache=False, torch_device=DEVICE)
        compile_ms = (time.perf_counter() - t0) * 1e3

        def make(r, s=s):
            g = np.random.default_rng(r + 17 * s.h + s.ic)
            return {"x": g.integers(-64, 64, size=(s.n, s.ic, s.h, s.w),
                                    dtype=np.int8)}
        walls, g_l, a_l = serve(
            c, make, lambda inp, w=w, s=s, ep=ep: conv2d_reference(
                inp["x"], w, s, epilogue=ep))
        st = c.last_stats[0]
        row = dict(layer=layer.name, shape=str(s), lowering=c.nodes[2].lowering,
                   insns=c.insn_count, compile_ms=compile_ms,
                   request_ms=walls, vta_gemm_launches=g_l,
                   tensor_alu_launches=a_l, tile_batches=st.tile_batches,
                   tiles_resolved=st.tiles_resolved,
                   coalesced_gemm_insns=st.coalesced_gemm_insns)
        rec["layers"].append(row)
        log(f"  {layer.name:4s} {c.nodes[2].lowering:10s} {c.insn_count:5d} "
            f"insns  compile {compile_ms:7.1f} ms  requests "
            + " ".join(f"{x:7.2f}" for x in walls)
            + f" ms  launches/request vta_gemm {g_l[-1]} tensor_alu "
            f"{a_l[-1]}")


def residual_relu(a, b):
    """int8 residual add with the tensor ALU's saturation, then relu."""
    import numpy as np
    s = np.clip(a.astype(np.int32) + b.astype(np.int32), -128, 127)
    return np.maximum(s, 0).astype(np.int8)


def phase_block(rec):
    """ResNet-18 layer2.0: C4 -> C6 main branch, C5 shortcut, host
    residual add with relu; one Program with fan-out."""
    import numpy as np
    from repro_torch.core import hwspec
    from repro_torch.core.conv import conv2d_reference
    from repro_torch.core.program import Program
    from repro_torch.core.scheduler import Epilogue
    from repro_torch.core.workloads import layer_by_name
    spec = hwspec.pynq()
    c4, c5, c6 = (layer_by_name(n).shape for n in ("C4", "C5", "C6"))
    rng = np.random.default_rng(44)
    w4 = rng.integers(-8, 8, size=(c4.oc, c4.ic, 3, 3), dtype=np.int8)
    w6 = rng.integers(-8, 8, size=(c6.oc, c6.ic, 3, 3), dtype=np.int8)
    w5 = rng.integers(-8, 8, size=(c5.oc, c5.ic, 1, 1), dtype=np.int8)
    ep4 = layer_epilogue(c4, spec, rng)
    b6 = np.repeat(rng.integers(-512, 512, size=c6.oc, dtype=np.int32)
                   .reshape(-1, 1, spec.block_out), spec.batch, axis=1)
    ep6 = Epilogue(bias_blocked=b6, shift=8)       # relu after the join
    ep5 = Epilogue(shift=6)
    p = Program(spec)
    x = p.input("x", (1, c4.ic, c4.h, c4.w))
    h = p.conv2d(x, p.constant("w4", w4), c4, epilogue=ep4, name="C4")
    h = p.conv2d(h, p.constant("w6", w6), c6, epilogue=ep6, name="C6")
    sc = p.conv2d(x, p.constant("w5", w5), c5, epilogue=ep5, name="C5")
    p.output(p.host(residual_relu, h, sc, shape=(1, c6.oc, c6.oh, c6.ow),
                    name="join", key="residual_relu"))
    t0 = time.perf_counter()
    c = p.compile(use_cache=False, torch_device=DEVICE)
    compile_ms = (time.perf_counter() - t0) * 1e3

    def ref(inp):
        a = conv2d_reference(conv2d_reference(inp["x"], w4, c4, epilogue=ep4),
                             w6, c6, epilogue=ep6)
        return residual_relu(a, conv2d_reference(inp["x"], w5, c5,
                                                 epilogue=ep5))
    walls, g_l, a_l = serve(c, lambda r: {"x": np.random.default_rng(
        500 + r).integers(-64, 64, size=(1, 64, 56, 56), dtype=np.int8)},
        ref)
    rec["block"] = dict(describe=c.describe(), compile_ms=compile_ms,
                        request_ms=walls, vta_gemm_launches=g_l,
                        tensor_alu_launches=a_l, insns=c.insn_count,
                        fences=c.n_fences)
    log(f"  layer2.0 block: {c.describe()}")
    log(f"    compile {compile_ms:.1f} ms; requests "
        + " ".join(f"{x:.2f}" for x in walls)
        + f" ms; launches/request vta_gemm {g_l[-1]} tensor_alu {a_l[-1]}")


def phase_chain(rec):
    """examples/resnet18_offload.py's heterogeneous chain at C2: a
    cpu_only 7x7/2 stem 112x112x3 -> 64, the C2 body, a 64-channel 1x1."""
    import numpy as np
    from repro_torch.core import hwspec
    from repro_torch.core.conv import ConvShape, conv2d_reference
    from repro_torch.core.program import Program
    from repro_torch.core.scheduler import Epilogue
    from repro_torch.core.workloads import layer_by_name
    spec = hwspec.pynq()
    body = layer_by_name("C2").shape
    stem = ConvShape(n=1, h=112, w=112, ic=3, oc=64, kh=7, kw=7, stride=2,
                     pad=3)
    point = ConvShape(n=1, h=56, w=56, ic=64, oc=64, kh=1, kw=1, stride=1,
                      pad=0)
    ep = Epilogue(shift=5, relu=True)
    rng = np.random.default_rng(1)
    k1 = rng.integers(-8, 8, size=(64, 3, 7, 7), dtype=np.int8)
    k2 = rng.integers(-8, 8, size=(64, 64, 3, 3), dtype=np.int8)
    k3 = rng.integers(-8, 8, size=(64, 64, 1, 1), dtype=np.int8)
    p = Program(spec)
    t = p.conv2d(p.input("x", (1, 3, 112, 112)), p.constant("k1", k1), stem,
                 epilogue=ep, cpu_only=True, name="stem")
    t = p.conv2d(t, p.constant("k2", k2), body, epilogue=ep, name="C2")
    p.conv2d(t, p.constant("k3", k3), point, epilogue=ep, name="point")
    t0 = time.perf_counter()
    c = p.compile(use_cache=False, torch_device=DEVICE)
    compile_ms = (time.perf_counter() - t0) * 1e3

    def ref(inp):
        r = conv2d_reference(inp["x"], k1, stem, epilogue=ep)
        r = conv2d_reference(r, k2, body, epilogue=ep)
        return conv2d_reference(r, k3, point, epilogue=ep)
    walls, g_l, a_l = serve(c, lambda r: {"x": np.random.default_rng(
        900 + r).integers(-64, 64, size=(1, 3, 112, 112), dtype=np.int8)},
        ref)
    rec["chain"] = dict(describe=c.describe(), compile_ms=compile_ms,
                        request_ms=walls, vta_gemm_launches=g_l,
                        tensor_alu_launches=a_l)
    log(f"  C2 chain: {c.describe()}")
    log(f"    compile {compile_ms:.1f} ms; requests "
        + " ".join(f"{x:.2f}" for x in walls)
        + f" ms; launches/request vta_gemm {g_l[-1]} tensor_alu {a_l[-1]}")


def phase_vector(rec):
    """One Program.vector_binop of 2^16 int32 elements (the dense vector
    ALU path: _alu_eager_region)."""
    import numpy as np
    from repro_torch.core import hwspec
    from repro_torch.core.backend import assert_fast_path
    from repro_torch.core.program import Program
    from repro_torch.kernels.tensor_alu import tensor_alu
    n = 1 << 16
    p = Program(hwspec.pynq())
    p.vector_binop(p.input("a", (n,), dtype="int32"),
                   p.input("b", (n,), dtype="int32"))
    c = p.compile(use_cache=False, torch_device=DEVICE)
    rng = np.random.default_rng(65536)
    a = rng.integers(-(1 << 30), 1 << 30, size=n, dtype=np.int32)
    b = rng.integers(-(1 << 30), 1 << 30, size=n, dtype=np.int32)
    a0 = tensor_alu.launches
    t0 = time.perf_counter()
    got = c(a=a, b=b)
    wall = (time.perf_counter() - t0) * 1e3
    want = (a.astype(np.int64) + b).astype(np.int32).astype(np.int8)
    if not np.array_equal(got, want):
        fail("vector_binop differs from the int8-narrowed sum")
    assert_fast_path(c.last_stats)
    rec["vector"] = dict(n=n, request_ms=wall, insns=c.insn_count,
                         tensor_alu_launches=tensor_alu.launches - a0)
    log(f"  vector_binop 2^16: {c.insn_count} insns, {wall:.2f} ms, "
        f"tensor_alu launches {tensor_alu.launches - a0}")


def content_key_cost(rec):
    """What the exact weight-content keys cost on the card over one warm C2
    and one warm C12 request, from the engine's RunStats.content_key_*
    counters: device-to-host copies, bytes, and host ms.  Each copy also
    waits for the work queued before it, so the time is an upper bound."""
    import numpy as np
    from repro_torch.core import hwspec
    from repro_torch.core.program import Program
    from repro_torch.core.workloads import layer_by_name
    out = {}
    spec = hwspec.pynq()
    for name in ("C2", "C12"):
        s = layer_by_name(name).shape
        rng = np.random.default_rng(3)
        p = Program(spec)
        p.conv2d(p.input("x", (1, s.ic, s.h, s.w)), p.constant(
            "w", rng.integers(-8, 8, (s.oc, s.ic, s.kh, s.kw),
                              dtype=np.int8)), s,
            epilogue=layer_epilogue(s, spec, rng))
        c = p.compile(use_cache=False, torch_device=DEVICE)
        x = rng.integers(-64, 64, (1, s.ic, s.h, s.w), dtype=np.int8)
        c(x=x)
        t0 = time.perf_counter()
        c(x=x)
        total = (time.perf_counter() - t0) * 1e3
        n = sum(st.content_key_copies for st in c.last_stats)
        nbytes = sum(st.content_key_bytes for st in c.last_stats)
        ms = sum(st.content_key_s for st in c.last_stats) * 1e3
        if n <= 0:
            fail(f"{name}: the engine counted no weight-content key copies")
        out[name] = dict(copies=n, bytes=nbytes, ms=ms, request_ms=total)
        log(f"  weight-content keys, {name}: {n} device-to-host copies, "
            f"{nbytes} bytes, {ms:.2f} ms of a {total:.2f} ms request")
    rec["content_keys"] = out


def request_profile(rec, name="C9"):
    """Where one full-width request's time goes: torch.profiler over one
    request of layer `name` (after a warm one).  Device busy time is the
    sum of the CUDA kernels' and copies' device time; the rest of the
    profiled wall time the card sat idle.  The profiler's own cost
    inflates the wall time; the unprofiled request time is recorded too."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import hwspec
    from repro_torch.core.program import Program
    from repro_torch.core.workloads import layer_by_name
    spec = hwspec.pynq()
    s = layer_by_name(name).shape
    rng = np.random.default_rng(9)
    p = Program(spec)
    p.conv2d(p.input("x", (1, s.ic, s.h, s.w)), p.constant(
        "w", rng.integers(-8, 8, (s.oc, s.ic, s.kh, s.kw), dtype=np.int8)),
        s, epilogue=layer_epilogue(s, spec, rng))
    c = p.compile(use_cache=False, torch_device=DEVICE)
    x = rng.integers(-64, 64, (1, s.ic, s.h, s.w), dtype=np.int8)
    c(x=x)
    t0 = time.perf_counter()
    c(x=x)
    plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        c(x=x)
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    top = [dict(op=e.key, calls=e.count,
                self_cpu_ms=e.self_cpu_time_total / 1e3) for e in ops[:12]]
    rec["profile"] = dict(layer=name, request_ms=plain_ms,
                          profiled_ms=wall_ms, device_busy_ms=dev_ms,
                          idle_share=1 - dev_ms / wall_ms, top_cpu_ops=top)
    log(f"  profile {name}: request {plain_ms:.2f} ms ({wall_ms:.2f} ms "
        f"profiled); device busy {dev_ms:.3f} ms -> idle share "
        f"{1 - dev_ms / wall_ms:.4f}")
    for t in top[:6]:
        log(f"    {t['op']}: {t['calls']} calls, {t['self_cpu_ms']:.2f} ms "
            f"self CPU")


# ----------------------------------------------------------------------
# phase 1: kernels against plain versions
# ----------------------------------------------------------------------
def gemm_bound_ms(T, M, N, K, epilogue, has_bias):
    out_b = {"none": 4, "requant": 1, "dequant": 4}[epilogue]
    nbytes = T * (M * K + N * K + M * N * out_b) + 4 * N * has_bias \
        + 4 * N * (epilogue == "dequant")
    ops = 2 * T * M * N * K
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT8_TENSOR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def alu_bound_ms(numel, n_ops, has_src):
    nbytes = numel * 4 * (2 + has_src)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = numel * n_ops / INT32_ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_gemm_kernel(rec, main_shapes):
    import numpy as np
    import torch
    from repro_torch.kernels.vta_gemm import vta_gemm, vta_gemm_ref
    dev = torch.device("cuda")
    cases = [(k, n) for k, n in main_shapes.items()]
    extra = [((1, 37, 50, 70, e, s, b), 0)
             for e, s in (("none", 0), ("requant", 0), ("requant", 5),
                          ("requant", 31), ("requant", 40), ("dequant", 0))
             for b in (False, True)]
    extra += [((3, 130, 72, 200, "requant", 9, False), 0),
              ((1, 1, 3, 5, "none", 0, True), 0)]
    rows, max_err = [], 0
    for (T, M, N, K, epi, shift, has_bias), launches in cases + extra:
        rng = np.random.default_rng(T * 131 + M * 7 + N * 3 + K)
        a = torch.from_numpy(rng.integers(-128, 128, (T, M, K),
                                          dtype=np.int8)).to(dev)
        w_nk = torch.from_numpy(rng.integers(-128, 128, (T, N, K),
                                             dtype=np.int8)).to(dev)
        w = w_nk.transpose(1, 2)
        bias = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, N,
                                             dtype=np.int32)).to(dev) \
            if has_bias else None
        scale = torch.from_numpy(rng.random(N, dtype=np.float32)
                                 * 1e-3).to(dev)
        kw = dict(epilogue=epi, shift=shift)
        got = vta_gemm(a, w, bias, scale, **kw)
        want = vta_gemm_ref(a, w, bias, scale, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"vta_gemm {(T, M, N, K, epi, shift, has_bias)} differs "
                 f"from its plain version")
        max_err = max(max_err, int((got.to(torch.float64)
                                    - want.to(torch.float64)).abs().max()))
        if launches == 0:
            continue
        call_ms = cuda_time_ms(lambda: vta_gemm(a, w, bias, scale, **kw))
        ms = kernel_ms(lambda: vta_gemm(a, w, bias, scale, **kw),
                       "vta_gemm_kernel")
        plain = cuda_time_ms(lambda: vta_gemm_ref(a, w, bias, scale, **kw),
                             reps=5, warmup=1)
        lib = None
        if epi == "none" and not has_bias and T == 1 and M > 16 \
                and K % 8 == 0 and N % 8 == 0:
            # one PyTorch call computing the same function (never used by
            # the port): int8 x int8 -> int32 on the tensor cores
            a2, b2 = a[0].contiguous(), w_nk[0].t()
            try:
                lib_out = torch._int_mm(a2, b2)
            except RuntimeError as e:      # shape or layout it refuses
                log(f"  torch._int_mm refused {(M, N, K)}: {e}")
            else:
                if not torch.equal(lib_out, want[0]):
                    fail("torch._int_mm disagrees with the plain version")
                lib = cuda_time_ms(lambda: torch._int_mm(a2, b2))
        bound, by = gemm_bound_ms(T, M, N, K, epi, has_bias)
        rows.append(dict(T=T, M=M, N=N, K=K, epilogue=epi, shift=shift,
                         bias=has_bias, launches=launches, ms=ms,
                         call_ms=call_ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bound, bound_by=by))
        log(f"  vta_gemm T={T} M={M} N={N} K={K} {epi}/{shift}"
            f"{' +bias' if has_bias else ''}: kernel {ms:.4f} ms, call "
            f"{call_ms:.4f} ms (bound {bound:.5f} "
            f"ms by {by}; plain {plain:.4f} ms; library "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}) x{launches}")
    rec["vta_gemm_shapes"] = rows
    return rows, max_err


def alu_library_call(chain, d, s):
    """A closure making the one PyTorch call that computes the same
    function as a one-step `chain` on (d, s); None for longer chains,
    which no single call computes.  The port never calls these."""
    import torch
    if len(chain) != 1:
        return None
    (op, imm), = chain
    if imm is None:
        fn = {"add": torch.add, "mul": torch.mul, "min": torch.minimum,
              "max": torch.maximum}.get(op)
        return None if fn is None else (lambda: fn(d, s))
    if op == "shr":
        return (lambda: torch.bitwise_right_shift(d, imm)) \
            if 0 <= imm < 32 else None
    return {"add": lambda: torch.add(d, imm), "mul": lambda: torch.mul(d, imm),
            "min": lambda: torch.clamp(d, max=imm),
            "max": lambda: torch.clamp(d, min=imm)}[op]


def phase_alu_kernel(rec, main_shapes):
    import numpy as np
    import torch
    from repro_torch.kernels.tensor_alu import tensor_alu, tensor_alu_ref
    dev = torch.device("cuda")
    i32 = np.iinfo(np.int32)
    edge = (-3, 0, 31, 33, int(i32.min), 40)
    extra = [((37, 50), (("shr", None),)),
             ((37, 50), (("mul", 3), ("add", int(i32.max)))),
             ((37, 50), (("add", None), ("mul", None), ("min", 1000))),
             ((37, 50), tuple(("shr", s) for s in edge)),
             ((5, 3), (("max", 0), ("min", 127)))]
    rows, max_err = [], 0
    for (shape, chain), launches in list(main_shapes.items()) \
            + [(e, 0) for e in extra]:
        rng = np.random.default_rng(sum(shape) + len(chain))
        d = torch.from_numpy(rng.integers(i32.min, i32.max, shape,
                                          dtype=np.int64)
                             .astype(np.int32)).to(dev)
        src = rng.integers(-40, 40, shape, dtype=np.int32)
        src.reshape(-1)[:len(edge)] = edge
        s = torch.from_numpy(src).to(dev)
        uses_src = any(imm is None for _, imm in chain)
        s_arg = s if uses_src else None
        got = tensor_alu(d, s_arg, chain=chain)
        want = tensor_alu_ref(d, s_arg, chain=chain)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"tensor_alu {shape} {chain} differs from its plain version")
        max_err = max(max_err, int((got.to(torch.int64)
                                    - want.to(torch.int64)).abs().max()))
        if launches == 0:
            continue
        call_ms = cuda_time_ms(lambda: tensor_alu(d, s_arg, chain=chain))
        ms = kernel_ms(lambda: tensor_alu(d, s_arg, chain=chain),
                       "tensor_alu_kernel")
        plain = cuda_time_ms(lambda: tensor_alu_ref(d, s_arg, chain=chain),
                             reps=5, warmup=1)
        lib = None
        lib_fn = alu_library_call(chain, d, s_arg)
        if lib_fn is not None:
            if not torch.equal(lib_fn(), want):
                fail(f"the library call for {chain} disagrees with the "
                     f"plain version")
            lib = cuda_time_ms(lib_fn)
        numel = int(np.prod(shape))
        bound, by = alu_bound_ms(numel, len(chain), uses_src)
        rows.append(dict(shape=list(shape), chain=[list(c) for c in chain],
                         launches=launches, ms=ms, call_ms=call_ms,
                         plain_ms=plain, library_ms=lib, bound_ms=bound,
                         bound_by=by))
        log(f"  tensor_alu {shape} {chain}: kernel {ms:.4f} ms, call "
            f"{call_ms:.4f} ms (bound {bound:.6f} "
            f"ms by {by}; plain {plain:.4f} ms; library "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}) x{launches}")
    rec["tensor_alu_shapes"] = rows
    return rows, max_err


# ----------------------------------------------------------------------
def phase_engines(rec):
    import numpy as np
    from repro_torch.core import hwspec
    from repro_torch.core.backend import CrossBackendChecker
    from repro_torch.core.runtime import Runtime
    from repro_torch.core.scheduler import (Epilogue, matmul_reference,
                                            read_matmul_result,
                                            schedule_matmul)
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, size=(64, 64), dtype=np.int8)
    w = rng.integers(-128, 128, size=(64, 64), dtype=np.int8)
    rt = Runtime(hwspec.pynq(), torch_device=DEVICE)
    plan = schedule_matmul(rt, a, w, epilogue=Epilogue(shift=5),
                           virtual_threads=2)
    report = CrossBackendChecker(("simulator", "cuda")).check_runtime(rt)
    if not report.matches:
        fail(f"simulator and cuda engines differ in "
             f"{report.mismatched_bytes} DRAM bytes")
    got = read_matmul_result(rt, plan)
    if not np.array_equal(got, matmul_reference(a, w, Epilogue(shift=5))):
        fail("GOLDEN matmul result differs from matmul_reference")
    rec["engines"] = dict(matches=True, mismatched_bytes=0,
                          devices=[str(r.device.torch_device)
                                   for r in report.runs])
    log("  GOLDEN matmul stream: simulator and cuda DRAM images byte-equal "
        f"on {report.runs[1].device.torch_device}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", type=Path, default=None,
                    help="write the detailed record to this JSON file")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs only on the "
              "card", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside the script: "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    from repro_torch.kernels.tensor_alu import tensor_alu
    from repro_torch.kernels.vta_gemm import vta_gemm

    rec = {"layers": []}
    # ---- phase 0: card and build --------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: no output"
    name = torch.cuda.get_device_name(0)
    log(f"phase 0: card {name}; nvidia-smi: {card_line}")
    rec["card"] = dict(name=name, nvidia_smi=card_line,
                       torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"  built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(per kernel: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                      sorted(secs.items())) + ")")
    for k, v in sorted(_build.BUILD_LOGS.items()):
        regs = [ln.strip() for ln in v.splitlines() if "Used" in ln]
        log(f"  {k}: " + "; ".join(regs))
    rec["build"] = dict(seconds=secs, logs=_build.BUILD_LOGS)

    # ---- phase 2: the main path (counts from 0) ------------------------
    log("phase 2: the slice at full width (pynq spec, torch_device=cuda, "
        "backend=cuda)")
    vta_gemm.launches, tensor_alu.launches = 0, 0
    vta_gemm.shapes.clear()
    tensor_alu.shapes.clear()
    t_main = time.perf_counter()
    phase_layers(rec)
    phase_block(rec)
    phase_chain(rec)
    phase_vector(rec)
    main_launches = {"vta_gemm": vta_gemm.launches,
                     "tensor_alu": tensor_alu.launches}
    gemm_shapes = dict(vta_gemm.shapes)
    alu_shapes = dict(tensor_alu.shapes)
    rec["main_path"] = dict(seconds=time.perf_counter() - t_main,
                            launches=main_launches)
    log(f"  main path launches: {main_launches}")
    for k, n in main_launches.items():
        if n <= 0:
            fail(f"{k} was never launched on the main path")
    content_key_cost(rec)
    request_profile(rec)

    # ---- phase 1: kernels against plain versions ------------------------
    log("phase 1: kernels against their plain versions, on the card")
    g_rows, g_err = phase_gemm_kernel(rec, gemm_shapes)
    a_rows, a_err = phase_alu_kernel(rec, alu_shapes)

    # ---- phase 3: engines against each other ----------------------------
    log("phase 3: the engines against each other")
    phase_engines(rec)

    # ---- phase 4: the kernels line --------------------------------------
    # the line reports each kernel at its heaviest main-path shape (for
    # vta_gemm one that a single library call also computes, if any);
    # every shape is in the record
    g = max(g_rows, key=lambda r: (r["library_ms"] is not None,
                                   r["M"] * r["N"] * r["K"] * r["T"]))
    a = max(a_rows, key=lambda r: r["launches"] * r["shape"][0]
            * r["shape"][1])
    kernels = [
        dict(name="vta_gemm", route="cuda",
             source="src/repro_torch/kernels/vta_gemm/csrc/vta_gemm.cu",
             replaces="src/repro/kernels/vta_gemm/kernel.py:72",
             launches=main_launches["vta_gemm"], max_abs_err=g_err,
             ms=g["ms"], call_ms=g["call_ms"], plain_ms=g["plain_ms"],
             bound_ms=g["bound_ms"],
             bound_by=g["bound_by"], library_ms=g["library_ms"],
             checked=True,
             shape=dict(T=g["T"], M=g["M"], N=g["N"], K=g["K"],
                        epilogue=g["epilogue"])),
        dict(name="tensor_alu", route="cuda",
             source="src/repro_torch/kernels/tensor_alu/csrc/tensor_alu.cu",
             replaces="src/repro/kernels/tensor_alu/kernel.py:50",
             launches=main_launches["tensor_alu"], max_abs_err=a_err,
             ms=a["ms"], call_ms=a["call_ms"], plain_ms=a["plain_ms"],
             bound_ms=a["bound_ms"],
             bound_by=a["bound_by"], library_ms=a["library_ms"],
             checked=True,
             shape=dict(shape=a["shape"], chain=a["chain"])),
    ]
    if args.record is not None:
        rec["kernels"] = kernels
        args.record.parent.mkdir(parents=True, exist_ok=True)
        args.record.write_text(json.dumps(rec, indent=1, default=str))
        log(f"record written to {args.record}")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
