"""End-to-end driver #1 on the port (paper §5, Fig. 16): ResNet-18 conv
offload onto VTA.

The counterpart of ``examples/resnet18_offload.py`` on ``repro_torch``,
with the same layer argument, seeds and assertions.

Part 1 — per-layer study: quantize one ResNet conv layer end to end,
lower it with the direct-conv scheduler (2D padded DMA, no host im2col),
execute on the simulator, check the result against the integer oracle,
and report cycle-level timing.

Part 2 — heterogeneous execution: a C1-style `cpu_only` stem, the anchor
conv layer, and a 1x1 pointwise conv are compiled by the program-level
JIT into host steps + ONE task-ISA stream, then run end to end on BOTH
execution engines (the simulator oracle and the CUDA engine's fast path)
and checked bit-exact against the chained reference.  The chain is
channel-scaled (<=128) so the simulator side stays quick.

Part 3 — the anchor layer unscaled on the CUDA engine alone, held
byte-equal to ``conv2d_reference`` and timed (median of 3 warmed
requests), beside the card's name and power limit where it runs on the
card.

Run:  PYTHONPATH=src python examples/resnet18_offload_torch.py [layer] \\
          [--device cpu]
Without ``--device`` it runs on the card.
"""
import argparse
import subprocess
import time

import numpy as np

from repro_torch.core import Program, hwspec, quantize as q
from repro_torch.core.backend import assert_fast_path
from repro_torch.core.conv import ConvShape, conv2d_reference, \
    read_conv_result, schedule_conv2d
from repro_torch.core.runtime import Runtime
from repro_torch.core.scheduler import Epilogue
from repro_torch.core.simulator import TimingModel
from repro_torch.core.workloads import layer_by_name


def per_layer_study(name: str, dev: str) -> None:
    layer = layer_by_name(name)
    shape = layer.shape
    spec = hwspec.pynq()
    print(f"{name}: {shape.ic}->{shape.oc} ch, {shape.h}x{shape.w}, "
          f"k={shape.kh} s={shape.stride}  ({shape.gops:.2f} GOP)")

    rng = np.random.default_rng(0)
    x_f = rng.normal(size=(shape.n, shape.ic, shape.h, shape.w)) \
        .astype(np.float32)
    w_f = (rng.normal(size=(shape.oc, shape.ic, shape.kh, shape.kw))
           / np.sqrt(shape.ic * shape.kh * shape.kw)).astype(np.float32)

    qx, qw = q.calibrate(x_f), q.calibrate(w_f)
    xq, wq = q.quantize(x_f, qx), q.quantize(w_f, qw)

    rt = Runtime(spec, torch_device=dev)
    ep = Epilogue(shift=0, relu=False)
    plan = schedule_conv2d(rt, xq, wq, shape, epilogue=ep, virtual_threads=2)
    stats = rt.synchronize(timing=TimingModel(spec))
    got = read_conv_result(rt, plan)
    want = conv2d_reference(xq, wq, shape, epilogue=ep)
    assert np.array_equal(got, want), "simulator diverged!"

    secs = stats.total_cycles / (spec.freq_mhz * 1e6)
    print(f"exact on VTA; {stats.total_cycles:,} cycles = {secs * 1e3:.1f} ms "
          f"@ {spec.freq_mhz:.0f} MHz")
    print(f"achieved {stats.gops(spec.freq_mhz):.1f} / {spec.peak_gops:.1f} "
          f"GOPS  (utilization {stats.compute_utilization:.1%})")
    print(f"DRAM traffic: {stats.dram_rd_bytes / 1e6:.1f} MB read, "
          f"{stats.dram_wr_bytes / 1e6:.1f} MB written "
          f"(intensity {stats.arithmetic_intensity:.1f} ops/B)")


def heterogeneous_chain(name: str, dev: str) -> None:
    """cpu stem -> anchor conv -> 1x1 conv, one Program, two engines."""
    anchor = layer_by_name(name).shape
    spec = hwspec.pynq()
    # channel-scale the chain so the behavioral simulator stays quick
    ic = min(anchor.ic, 128)
    oc = min(anchor.oc, 128)
    h = anchor.h
    stem = ConvShape(n=1, h=2 * h, w=2 * h, ic=3, oc=ic,
                     kh=7, kw=7, stride=2, pad=3)          # C1-style, CPU
    body = ConvShape(n=1, h=h, w=h, ic=ic, oc=oc, kh=anchor.kh,
                     kw=anchor.kw, stride=1, pad=anchor.kh // 2)
    point = ConvShape(n=1, h=body.oh, w=body.ow, ic=oc, oc=oc,
                      kh=1, kw=1, stride=1, pad=0)         # C3-style, GEMM
    ep = Epilogue(shift=5, relu=True)

    rng = np.random.default_rng(1)
    x = rng.integers(-64, 64, size=(1, 3, stem.h, stem.w), dtype=np.int8)
    k1 = rng.integers(-8, 8, size=(stem.oc, 3, 7, 7), dtype=np.int8)
    k2 = rng.integers(-8, 8, size=(body.oc, body.ic, body.kh, body.kw),
                      dtype=np.int8)
    k3 = rng.integers(-8, 8, size=(point.oc, point.ic, 1, 1), dtype=np.int8)

    prog = Program(spec)
    t = prog.conv2d(prog.input("x", x.shape), prog.input("k1", k1.shape),
                    stem, epilogue=ep, cpu_only=True)
    t = prog.conv2d(t, prog.input("k2", k2.shape), body, epilogue=ep)
    prog.conv2d(t, prog.input("k3", k3.shape), point, epilogue=ep)
    t0 = time.perf_counter()
    compiled = prog.compile(torch_device=dev)
    print(f"\nheterogeneous chain ({name}-scaled): {compiled.describe()}")
    print(f"compiled in {(time.perf_counter() - t0) * 1e3:.0f} ms; "
          f"{len(compiled.cpu_steps)} cpu step(s) + "
          f"{len(compiled.accel_steps)} accelerator stream(s), "
          f"{compiled.insn_count} instructions")

    ref = conv2d_reference(x, k1, stem, epilogue=ep)
    ref = conv2d_reference(ref, k2, body, epilogue=ep)
    ref = conv2d_reference(ref, k3, point, epilogue=ep)

    for backend in ("simulator", "cuda"):
        t0 = time.perf_counter()
        got = compiled(backend=backend, x=x, k1=k1, k2=k2, k3=k3)
        dt = time.perf_counter() - t0
        assert np.array_equal(got, ref), f"{backend} diverged!"
        print(f"  {backend}: exact end-to-end in {dt * 1e3:.0f} ms")
        if backend == "cuda":
            # every conv — including the kh*kw>1 body — must stay on the
            # coalesced vta_gemm fast path (describe() shows the modes)
            assert_fast_path(compiled.last_stats)
            coal = sum(s.coalesced_gemm_insns for s in compiled.last_stats)
            eager = sum(s.eager_gemm_insns for s in compiled.last_stats)
            print(f"    fast path: {coal} GEMM insns coalesced, "
                  f"{eager} eager fallbacks")
    # second invocation: rebinds DRAM inputs, no re-scheduling
    x2 = rng.integers(-64, 64, size=x.shape, dtype=np.int8)
    t0 = time.perf_counter()
    compiled(x=x2, k1=k1, k2=k2, k3=k3)
    print(f"  rerun with new data (stream cache hit): "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")


def card_line(dev: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device's name off the card."""
    if not dev.startswith("cuda"):
        return f"on {dev}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return f"on {lines[0] if lines else 'a card nvidia-smi did not name'}"


def anchor_on_engine(name: str, dev: str, reps: int = 3) -> float:
    """The anchor layer at its published width on the CUDA engine alone:
    byte-equal to conv2d_reference, on the fast path; returns the median
    request ms of `reps` warmed requests."""
    shape = layer_by_name(name).shape
    ep = Epilogue(shift=8, relu=True)
    rng = np.random.default_rng(2)
    x = rng.integers(-64, 64, size=(shape.n, shape.ic, shape.h, shape.w),
                     dtype=np.int8)
    k = rng.integers(-8, 8, size=(shape.oc, shape.ic, shape.kh, shape.kw),
                     dtype=np.int8)
    prog = Program(hwspec.pynq())
    prog.conv2d(prog.input("x", x.shape), prog.constant("k", k), shape,
                epilogue=ep, name=name)
    compiled = prog.compile(torch_device=dev)
    want = conv2d_reference(x, k, shape, epilogue=ep)
    got = compiled(backend="cuda", x=x)                  # warm
    assert np.array_equal(got, want), "cuda engine diverged at full width!"
    assert_fast_path(compiled.last_stats)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        got = compiled(backend="cuda", x=x)
        times.append((time.perf_counter() - t0) * 1e3)
        assert np.array_equal(got, want), "cuda engine diverged at full width!"
    ms = float(np.median(times))
    print(f"\n{name} unscaled ({shape.ic}->{shape.oc} ch) on the cuda engine "
          f"alone: exact vs conv2d_reference, {ms:.2f} ms a request "
          f"(median of {reps}) {card_line(dev)}")
    return ms


def main(argv=None) -> float:
    """Returns the unscaled anchor layer's request ms (part 3)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("layer", nargs="?", default="C9")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the DRAM images (default: the "
                         "card)")
    args = ap.parse_args(argv)
    per_layer_study(args.layer, args.device)
    heterogeneous_chain(args.layer, args.device)
    return anchor_on_engine(args.layer, args.device)


if __name__ == "__main__":
    main()
