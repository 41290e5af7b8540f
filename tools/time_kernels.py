#!/usr/bin/env python3
"""Time the port's kernels of one checkout.

    python3 tools/time_kernels.py [--src DIR] [--label NAME] [--big]
        [--ops lut_gemm,flash_attention,flash_bwd,flash_wide,gla_bwd,
               vta_gemm,quantized_linear,int_mm,decode_attention,
               gla_chunk,lm_step,c9_request]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``),
builds its CUDA kernels, and times each op at the shapes ``chip_smoke.py``
phases 1 and 7 time (the int4 decoder's lut_gemm launches, Llama-3.2-3B's
lut_gemm at M 1 and 16 for bits 1, 2 and 4, flash_attention at the Llama
and zamba2 prefill shapes and whisper's float32 cross-attention; vta_gemm at the task-ISA engine's T1 M112 N128
K1152 and its deep-K T2 tiles, at the LM decode linears, at zamba2-1.2b's
512-token prefill linears and Llama-3.2-3B's at 512 and 4096 tokens;
quantized_linear, the whole call from float activations, at the LM
decode linears and the same prefill linears; int_mm,
torch._int_mm (the library yardstick of a skinny quantized linear: x
int8 with its M rows padded to 32, the weights (K, N) a transposed view
of a contiguous (N, K) int8 matrix) at the served skinny shapes of
INT_MM_SHAPES;
decode_attention at the decoder's and the LM steps' shapes, at kv_len S
and at the served 32; gla_chunk at zamba2-1.2b's served 16- and
512-token prefills and at S 4096 and 32768 (q and k broadcast over 64
heads) and at xlstm-1.3b's N 256, P 1025, chunk 512 (bf16 q and k per
head), a shape where a version that raises is recorded as "raises", and
at both models' training shapes (B2, bf16 q and k);
flash_bwd, the flash_attention backward kernel at chip_smoke's
FLASH_BWD_CASES (Llama-3.2-3B's train_4k B2 S4096 causal bf16, whisper's
encoder in bf16 and float32, phi-3-vision's D 96, a long-key float32
case) beside its operation bound, the plain backward and
scaled_dot_product_attention's backward alone, and at the first of them
the forward kernel with and without writing the log-sum-exp L that the
backward takes; flash_wide, the wide kernels (``flash_wide.cu``),
forward and backward, at WIDE_SHAPES (D 160 and 256 at B1 S2048 H8, D
320 and 512 at B1 S1024 H8, causal, bfloat16 and float32) beside the
plain versions, scaled_dot_product_attention and its backward alone
(each op's and SDPA's time both as a call's CUDA-event time and as the
device time of every kernel the call runs, ``device_ms``, so that a
kernel is compared with the library call like with like);
gla_bwd, the gla_chunk
backward kernel at chip_smoke's GLA_BWD_CASES (zamba2-1.2b's and
xlstm-1.3b's train_4k scans, h0 and dh given, a ragged last tile, a long
slow-decay scan) beside its operation and byte bound and the plain
backward (no single PyTorch call computes this function: no library
time);
lm_step, whole int8 decode steps of llama3.2-3b
and zamba2-1.2b at 4 slots: the host-clock step ms of each of 8 steps,
and of one more under torch.profiler the device busy ms, the idle share
and the number of device operations; c9_request, ``chip_smoke.request_profile``
of a ResNet-18 C9 request on the task-ISA engine, twice: the launch and
copy API calls, device operations, tensor_alu launches by instance and
the idle share), with ``chip_smoke.kernel_ms``
(torch.profiler
device time per call of every kernel whose name holds "lut_gemm",
"flash", "vta_gemm", "decode_" or "gla_kernel") beside the call's
CUDA-event time.  The first line is the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``).
With --big, flash_attention also at S 32768; --ops picks the ops (the
default: the first two).  One JSON line per shape on stdout.  Run it
once per checkout, each in its own process, to hold two versions of
the port against each other on one card, in turns (parent, change,
change, parent): unpack the other version with `git archive` into a
directory .gitignore lists (build/) and pass its src.  Needs a CUDA
card; it imports no JAX.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (N, K) of zamba2-1.2b's quantized linears (in_proj, out_proj, the
#: shared block's attention, gate/up, down) and Llama-3.2-3B's (q/o, k/v,
#: gate/up, down)
ZAMBA2_PREFILL = [(8384, 2048), (2048, 4096), (2048, 2048), (8192, 2048),
                  (2048, 8192)]
LLAMA_PREFILL = [(3072, 3072), (1024, 3072), (8192, 3072), (3072, 8192)]
#: (T, M, N, K, bits, epilogue, shift): the decoder's launches, then Llama
LUT_SHAPES = [(1, 2, 192, 64, 4, "requant", 7),
              (1, 2, 64, 64, 4, "requant", 7),
              (1, 2, 128, 64, 4, "none", 0),
              (1, 2, 64, 128, 4, "requant", 7),
              (1, 2, 32, 64, 4, "requant", 7),
              (1, 1, 192, 64, 4, "requant", 7),
              (1, 1, 64, 128, 4, "requant", 7)] + [
    (1, m, 8192, 3072, b, "none", 0) for m in (1, 16) for b in (1, 2, 4)]
#: (B, S, Sk, HQ, KH, D, dtype, causal): Llama's 16-token prefill,
#: zamba2's 16- and 512-token prefills, Llama at S 4096 (both dtypes),
#: all causal; whisper's cross-attention (non-causal, Sk 1500) in float32
FLASH_SHAPES = [(1, 16, 16, 24, 8, 128, "bfloat16", True),
                (1, 16, 16, 32, 32, 64, "bfloat16", True),
                (1, 512, 512, 32, 32, 64, "bfloat16", True),
                (1, 16, 16, 32, 32, 64, "float32", True),
                (1, 4096, 4096, 24, 8, 128, "bfloat16", True),
                (1, 4096, 4096, 24, 8, 128, "float32", True),
                (2, 1000, 1500, 20, 20, 64, "float32", False)]
#: (T, M, N, K, epilogue): the task-ISA engine's rows (T1 M112 N128 K1152,
#: its deep-K T2 tiles and three one-step tiles), then the LM linears (Llama-3.2-3B decode at M
#: 4 and prefill at M 16, zamba2-1.2b decode), zamba2-1.2b's five 512-token
#: prefill linears, and Llama-3.2-3B's prefill linears at 512 and 4096
#: tokens
VTA_SHAPES = [(1, 112, 128, 1152, "none"), (2, 49, 64, 4608, "none"),
              (2, 56, 64, 2304, "none"), (1, 64, 64, 64, "none"),
              (2, 256, 64, 64, "none"), (1, 112, 256, 128, "none")] + [
    (1, m, n, k, "dequant") for m, n, k in (
        (4, 3072, 3072), (4, 1024, 3072), (4, 8192, 3072), (4, 3072, 8192),
        (16, 3072, 8192), (4, 8384, 2048), (4, 2048, 4096))] + [
    (1, 512, n, k, "dequant") for n, k in ZAMBA2_PREFILL] + [
    (1, m, n, k, "dequant") for m in (512, 4096) for n, k in LLAMA_PREFILL]
#: (M, N, K, x dtype): the LM decode steps' quantized linears, then the
#: same prefill linears as VTA_SHAPES in bf16
QLINEAR_SHAPES = [(4, 3072, 8192, "bfloat16"), (4, 8192, 3072, "bfloat16"),
                  (4, 1024, 3072, "bfloat16"), (4, 8384, 2048, "bfloat16"),
                  (4, 3072, 8192, "float32")] + [
    (512, n, k, "bfloat16") for n, k in ZAMBA2_PREFILL] + [
    (m, n, k, "bfloat16") for m in (512, 4096) for n, k in LLAMA_PREFILL]
#: (B, S, H, N, P, chunk, q/k dtype, heads broadcast): zamba2-1.2b's
#: served prefills (16 and 512 tokens), its long prefills, xlstm-1.3b's;
#: then the training forwards of chip_smoke's phase 14 (zamba2-1.2b B2
#: S4096, xlstm-1.3b B2 S2048)
GLA_SHAPES = [(1, 16, 64, 64, 64, 16, "float32", True),
              (1, 512, 64, 64, 64, 64, "float32", True),
              (1, 4096, 64, 64, 64, 64, "float32", True),
              (1, 32768, 64, 64, 64, 64, "float32", True),
              (1, 4096, 4, 256, 1025, 512, "bfloat16", False),
              (2, 4096, 64, 64, 64, 64, "bfloat16", True),
              (2, 2048, 4, 256, 1025, 512, "bfloat16", False)]
#: (M, N, K) of the served skinny quantized linears (whisper's steps at
#: M 4, phi-3-vision's at M 2, Llama-3.2-3B's down projection, xlstm's
#: w_if, phi3.5-moe's and kimi-k2's at M 4) that torch._int_mm is timed
#: at, M padded to 32 rows
INT_MM_SHAPES = [(4, 1280, 1280), (4, 1280, 5120), (4, 5120, 1280),
                 (2, 3072, 3072), (2, 8192, 3072), (2, 3072, 8192),
                 (4, 3072, 8192), (4, 8, 4096), (4, 4096, 4096),
                 (4, 1024, 4096), (4, 8192, 7168), (4, 7168, 8192)]
#: (B, S, HQ, KH, D, q dtype, cache dtype, kv_len)
DECODE_SHAPES = [(1, 96, 2, 2, 32, "float32", "float32", 96),
                 (4, 256, 24, 8, 128, "bfloat16", "float32", 256),
                 (4, 256, 24, 8, 128, "bfloat16", "float32", 32),
                 (4, 1024, 32, 32, 64, "bfloat16", "float32", 1024),
                 (4, 1024, 32, 32, 64, "bfloat16", "float32", 32)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--ops", default="lut_gemm,flash_attention",
                    help="comma-separated ops to time")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lut_gemm import lut_gemm
    _build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps(dict(label=args.label, card=card, op="card",
                          nvidia_smi=smi.stdout.strip())), flush=True)
    ops = args.ops.split(",")
    for T, M, N, K, bits, epi, shift in LUT_SHAPES * ("lut_gemm" in ops):
        lo = -(1 << (bits - 1))
        a = torch.randint(-128, 128, (T, M, K), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(lo, -lo, (T, N, K), generator=g, device=dev,
                          dtype=torch.int8).transpose(1, 2)
        call = lambda: lut_gemm(a, w, bits=bits, epilogue=epi,  # noqa
                                shift=shift)
        call_ms = cs.cuda_time_ms(call)
        ms = cs.kernel_ms(call, "lut_gemm", call_ms)
        print(json.dumps(dict(label=args.label, card=card, op="lut_gemm",
                              T=T, M=M, N=N, K=K, bits=bits, epilogue=epi,
                              ms=ms, call_ms=call_ms)), flush=True)
    shapes = FLASH_SHAPES + ([(1, 32768, 32768, 24, 8, 128, "bfloat16",
                               True)] if args.big else [])
    shapes *= "flash_attention" in ops
    for B, S, Sk, HQ, KH, D, dt, causal in shapes:
        dtype = getattr(torch, dt)
        q = torch.randn((B, S, HQ, D), generator=g, device=dev).to(dtype)
        k = torch.randn((B, Sk, KH, D), generator=g, device=dev).to(dtype)
        v = torch.randn((B, Sk, KH, D), generator=g, device=dev).to(dtype)
        reps = 3 if S > 8192 else 20
        call = lambda: flash_attention(q, k, v, causal=causal)  # noqa
        call_ms = cs.cuda_time_ms(call, reps=reps, warmup=1)
        ms = cs.kernel_ms(call, "flash", call_ms, reps=reps)
        print(json.dumps(dict(label=args.label, card=card,
                              op="flash_attention", B=B, S=S, Sk=Sk, HQ=HQ,
                              KH=KH, D=D, dtype=dt, causal=causal, ms=ms,
                              call_ms=call_ms)), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    for shape in cs.FLASH_BWD_CASES * ("flash_bwd" in ops):
        flash_bwd_row(cs, args.label, card, shape)
    if "flash_wide" in ops:
        flash_wide_rows(cs, args.label, card)
    for shape in cs.GLA_BWD_CASES * ("gla_bwd" in ops):
        gla_bwd_row(cs, args.label, card, shape)
    if "vta_gemm" in ops or "quantized_linear" in ops:
        from repro_torch.kernels.vta_gemm import quantized_linear, vta_gemm
    for T, M, N, K, epi in VTA_SHAPES * ("vta_gemm" in ops):
        a = torch.randint(-128, 128, (T, M, K), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (T, N, K), generator=g, device=dev,
                          dtype=torch.int8).transpose(1, 2)
        sc = torch.rand(N, generator=g, device=dev) * 1e-3
        call = lambda: vta_gemm(a, w, scale=sc, epilogue=epi)  # noqa
        call_ms = cs.cuda_time_ms(call)
        ms = cs.kernel_ms(call, "vta_gemm", call_ms)
        print(json.dumps(dict(label=args.label, card=card, op="vta_gemm",
                              T=T, M=M, N=N, K=K, epilogue=epi, ms=ms,
                              call_ms=call_ms)), flush=True)
    for M, N, K, dt in QLINEAR_SHAPES * ("quantized_linear" in ops):
        x = torch.randn((M, K), generator=g, device=dev) \
            .to(getattr(torch, dt))
        w = torch.randint(-128, 128, (N, K), generator=g, device=dev,
                          dtype=torch.int8).t()
        sc = torch.rand(N, generator=g, device=dev) * 1e-3
        call = lambda: quantized_linear(x, w, sc)  # noqa
        call_ms = cs.cuda_time_ms(call)
        ms = cs.kernel_ms(call, "vta_gemm", call_ms)
        print(json.dumps(dict(label=args.label, card=card,
                              op="quantized_linear", M=M, N=N, K=K,
                              dtype=dt, gemm_ms=ms, call_ms=call_ms)),
              flush=True)
    for M, N, K in INT_MM_SHAPES * ("int_mm" in ops):
        a = torch.zeros((32, K), dtype=torch.int8, device=dev)
        a[:M] = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                              dtype=torch.int8)
        w = torch.randint(-128, 128, (N, K), generator=g, device=dev,
                          dtype=torch.int8).t()
        want = a[:M].double() @ w.double()
        if not torch.equal(torch._int_mm(a, w)[:M].double(), want):
            raise SystemExit(f"torch._int_mm disagrees at {(M, N, K)}")
        ms = cs.cuda_time_ms(lambda: torch._int_mm(a, w))  # noqa
        print(json.dumps(dict(label=args.label, card=card, op="int_mm",
                              M=M, M_padded=32, N=N, K=K, library_ms=ms)),
              flush=True)
    if "decode_attention" in ops:
        from repro_torch.kernels.decode_attention import decode_attention
    for B, S, HQ, KH, D, qdt, kvdt, kv_len in DECODE_SHAPES * (
            "decode_attention" in ops):
        q = torch.randn((B, 1, HQ, D), generator=g, device=dev) \
            .to(getattr(torch, qdt))
        k = torch.randn((B, S, KH, D), generator=g, device=dev) \
            .to(getattr(torch, kvdt))
        v = torch.randn((B, S, KH, D), generator=g, device=dev) \
            .to(getattr(torch, kvdt))
        call = lambda: decode_attention(q, k, v, kv_len)  # noqa
        call_ms = cs.cuda_time_ms(call)
        ms = cs.kernel_ms(call, "decode_", call_ms)
        print(json.dumps(dict(label=args.label, card=card,
                              op="decode_attention", B=B, S=S, HQ=HQ, KH=KH,
                              D=D, dtype=qdt, cache_dtype=kvdt,
                              kv_len=kv_len, ms=ms, call_ms=call_ms)),
              flush=True)
    if "gla_chunk" in ops:
        from repro_torch.kernels.gla_chunk import gla_chunk
    for B, S, H, N, P, Q, dt, bc in GLA_SHAPES * ("gla_chunk" in ops):
        q, k, v, la, h0 = cs.gla_inputs(B, S, H, N, P, S + N, dt, bc, h0=False)
        row = dict(label=args.label, card=card, op="gla_chunk", B=B, S=S,
                   H=H, N=N, P=P, chunk=Q, qk_dtype=dt, heads_broadcast=bc)
        call = lambda: gla_chunk(q, k, v, la, chunk=Q,  # noqa
                                 y_dtype=torch.float32)
        try:
            call()
        except ValueError as e:      # a version without this instance
            print(json.dumps(dict(row, ms="raises", call_ms="raises",
                                  error=str(e))), flush=True)
            continue
        reps = 5 if S > 8192 else 20
        call_ms = cs.cuda_time_ms(call, reps=reps, warmup=1)
        ms = cs.kernel_ms(call, "gla_kernel", call_ms, reps=reps)
        print(json.dumps(dict(row, ms=ms, call_ms=call_ms)), flush=True)
        del q, k, v, la
        torch.cuda.empty_cache()
    if "c9_request" in ops:
        rec = {}
        for _ in range(C9_PROFILES):
            print(json.dumps(dict(label=args.label, card=card,
                                  op="c9_request",
                                  **cs.request_profile(rec))), flush=True)
    for arch, slots, max_len in LM_STEP_RUNS * ("lm_step" in ops):
        print(json.dumps(dict(label=args.label, card=card, op="lm_step",
                              arch=arch, slots=slots,
                              **lm_steps(cs, arch, slots, max_len))),
              flush=True)
    return 0


#: profiled C9 requests per c9_request run
C9_PROFILES = 2
#: (arch, slots, max_len) of the timed decode steps (chip_smoke's engines)
LM_STEP_RUNS = [("llama3.2-3b", 4, 256), ("zamba2-1.2b", 4, 1024)]


def flash_bwd_row(cs, label, card, shape):
    """One JSON line of the flash backward at `shape` (chip_smoke's
    FLASH_BWD_CASES): the kernel's device ms (torch.profiler, its three
    kernels), the call's CUDA-event ms, the operation bound (5 S Sk D HQ
    multiply-adds a batch row, 2 flops each, halved when causal, at bf16
    989 TFLOP/s), the plain backward's ms, and SDPA's backward alone (its
    forward's graph kept and its time taken apart).  A checkout without
    the backward is recorded "raises"."""
    import torch
    B, S, Sk, HQ, KH, D, causal, dt = shape
    row = dict(label=label, card=card, op="flash_bwd", B=B, S=S, Sk=Sk,
               HQ=HQ, KH=KH, D=D, dtype=dt, causal=causal)
    try:
        from repro_torch.kernels.flash_attention import (
            attention_bwd_ref, flash_attention_bwd)
    except ImportError as e:
        print(json.dumps(dict(row, ms="raises", error=str(e))), flush=True)
        return
    q, k, v, o, do, lse = cs.flash_bwd_inputs(*shape)
    big = S * Sk >= 4096 * 4096
    reps = 5 if big else 20
    kw = dict(causal=causal) if lse is None else dict(causal=causal, lse=lse)
    call = lambda: flash_attention_bwd(q, k, v, o, do, **kw)  # noqa
    call_ms = cs.cuda_time_ms(call, reps=reps, warmup=1)
    ms = cs.kernel_ms(call, cs.FLASH_WIDE_BWD_NAME if D > cs.FLASH_MAX_D
                      else "flash_bwd", call_ms, reps=reps)
    plain = cs.cuda_time_ms(lambda: attention_bwd_ref(
        q, k, v, o, do, group=HQ // KH, causal=causal), reps=2, warmup=1)
    lib_call = cs.sdpa_bwd_call(q, k, v, do, causal) \
        if not causal or S == Sk else None
    lib = cs.cuda_time_ms(lib_call, reps=reps, warmup=1) \
        if lib_call is not None else None
    lib_dev = device_ms(lib_call, reps) if lib_call is not None else None
    bound, by = cs.flash_bwd_bound_ms(B, S, Sk, HQ, KH, D, causal,
                                      q.element_size())
    print(json.dumps(dict(row, ms=ms, call_ms=call_ms,
                          device_ms=device_ms(call, reps), plain_ms=plain,
                          library_ms=lib, library_device_ms=lib_dev,
                          bound_ms=bound, bound_by=by)), flush=True)
    if shape == cs.FLASH_BWD_CASES[0]:
        flash_lse_rows(cs, row, q, k, v, causal)
    del q, k, v, o, do, lse, lib_call
    torch.cuda.empty_cache()


def device_ms(fn, reps=10):
    """Device time per call of fn(): every kernel, copy and fill it runs
    on the card, from torch.profiler's device events (the time the card
    is busy for one call, with no host time in it).  None where the
    profiler recorded no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


#: (B, S, H, D, dtype) the wide kernels (D above 128) are timed at, all
#: causal with HQ = KH = H: D 160 and 256 at S 2048, D 320 and 512 at S
#: 1024, both dtypes
WIDE_SHAPES = [(1, 2048, 8, D, dt) for D in (160, 256)
               for dt in ("bfloat16", "float32")] + [
    (1, 1024, 8, D, dt) for D in (320, 512) for dt in ("bfloat16", "float32")]


def flash_wide_rows(cs, label, card):
    """JSON lines of the wide kernels at WIDE_SHAPES: the forward (each
    held to the plain version) beside scaled_dot_product_attention and
    its bound, then the backward (flash_bwd_row: from the forward's L,
    beside SDPA's backward alone and its bound)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    for B, S, H, D, dt in WIDE_SHAPES:
        q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev)
                   .to(getattr(torch, dt)) for _ in range(3))
        got = flash_attention(q, k, v, causal=True)
        want = flash_attention_plain(q, k, v, causal=True)
        err = float((got.float() - want.float()).abs().max())
        tol = cs.attn_tolerance(dt, want)
        if err > tol:
            raise SystemExit(f"flash_wide D {D} {dt}: error {err} > {tol}")
        call = lambda: flash_attention(q, k, v, causal=True)  # noqa
        call_ms = cs.cuda_time_ms(call, reps=10, warmup=1)
        ms = cs.kernel_ms(call, cs.FLASH_WIDE_NAME, call_ms, reps=10)
        plain = cs.cuda_time_ms(lambda: flash_attention_plain(
            q, k, v, causal=True), reps=5, warmup=1)
        lib_call = cs.sdpa_call(q, k, v, True)
        lib = cs.cuda_time_ms(lib_call, reps=10, warmup=1) \
            if lib_call is not None else None
        lib_dev = device_ms(lib_call) if lib_call is not None else None
        bound, by = cs.flash_bound_ms(B, S, S, H, H, D, True,
                                      q.element_size())
        print(json.dumps(dict(label=label, card=card, op="flash_wide", B=B,
                              S=S, HQ=H, KH=H, D=D, dtype=dt, causal=True,
                              ms=ms, call_ms=call_ms,
                              device_ms=device_ms(call), plain_ms=plain,
                              library_ms=lib, library_device_ms=lib_dev,
                              bound_ms=bound, bound_by=by,
                              max_abs_err=err, limit=tol)), flush=True)
        del q, k, v, got, want, lib_call
        torch.cuda.empty_cache()
        flash_bwd_row(cs, label, card, (B, S, S, H, H, D, True, dt))


def flash_lse_rows(cs, row, q, k, v, causal):
    """Two JSON lines of the forward kernel at the backward's first shape
    (Llama-3.2-3B's train_4k): without L, as a served call runs it, and
    writing L, as the training forward runs it (a checkout whose forward
    writes no L gives only the first)."""
    from repro_torch.kernels import flash_attention as fa
    calls = [("flash_fwd", lambda: fa.flash_attention(q, k, v,
                                                       causal=causal))]
    if hasattr(fa, "flash_attention_fwd"):
        calls.append(("flash_fwd_lse", lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal)))
    for op, call in calls:
        call_ms = cs.cuda_time_ms(call, reps=20, warmup=2)
        ms = cs.kernel_ms(call, "flash_wgmma", call_ms, reps=20)
        print(json.dumps(dict(row, op=op, ms=ms, call_ms=call_ms)),
              flush=True)


def gla_bwd_row(cs, label, card, shape):
    """One JSON line of the gla_chunk backward at `shape` (chip_smoke's
    GLA_BWD_CASES): its device ms (torch.profiler, its five kernels), the
    call's CUDA-event ms, the plain backward's ms and the bound
    (chip_smoke.gla_bwd_bound_ms); no library call computes it.  A
    checkout without the backward is recorded "raises"."""
    import torch
    B, S, H, N, P, Q, dt, heads, state = shape
    row = dict(label=label, card=card, op="gla_bwd", B=B, S=S, H=H, N=N,
               P=P, chunk=Q, qk_dtype=dt, qk_heads=heads, state=state)
    try:
        from repro_torch.kernels.gla_chunk import (gla_chunk_bwd,
                                                   gla_chunk_bwd_plain)
    except ImportError as e:
        print(json.dumps(dict(row, ms="raises", error=str(e))), flush=True)
        return
    args = cs.gla_bwd_inputs(*shape)
    reps = 5 if S * H * P >= 4096 * 64 * 64 else 20
    call = lambda: gla_chunk_bwd(*args, chunk=Q)  # noqa: E731
    call_ms = cs.cuda_time_ms(call, reps=reps, warmup=1)
    ms = cs.kernel_ms(call, "gla_bwd", call_ms, reps=reps)
    plain = cs.cuda_time_ms(lambda: gla_chunk_bwd_plain(*args, chunk=Q),
                            reps=2, warmup=1)
    bound, by = cs.gla_bwd_bound_ms(B, S, H, N, P, Q,
                                    args[0].element_size(),
                                    args[0].shape[2], state)
    print(json.dumps(dict(row, ms=ms, call_ms=call_ms, plain_ms=plain,
                          library_ms=None, bound_ms=bound, bound_by=by)),
          flush=True)
    del args
    torch.cuda.empty_cache()


def lm_steps(cs, arch, slots, max_len, n_steps=8):
    """Int8 decode steps of `arch` at full width (chip_smoke.lm_weights'
    seeded weights), every slot active: host-clock ms of n_steps steps
    (each ends in the host's read of the chosen tokens), then one step
    under torch.profiler: its wall ms, the device's busy ms and idle
    share, and its device operations (kernels and copies)."""
    import statistics
    import time
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import make_requests

    class NoCounts:
        ops = {}
    cfg, params, qparams, _ = cs.lm_weights(arch)
    del params
    eng = cs.lm_engine(cfg, qparams, NoCounts(), slots=slots,
                       max_len=max_len)
    for r in make_requests(cfg, slots, n_steps + 3, seed=7):
        eng.add_request(r)
    eng.step()
    torch.cuda.synchronize()
    times = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        eng.step()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    del eng, qparams
    torch.cuda.empty_cache()
    return dict(step_ms=times, step_ms_median=statistics.median(times),
                profiled_ms=wall, device_busy_ms=busy,
                idle_share=1 - busy / wall, device_ops=len(dev))


if __name__ == "__main__":
    sys.exit(main())
