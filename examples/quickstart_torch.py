"""Quickstart on the port: the full VTA stack in ~100 lines.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``, step
for step, with the same seeds, shapes and assertions.  Where the
reference routes a stream through its Pallas engine, this one routes it
through the port's CUDA engine (``CudaBackend``, ``backend="cuda"``):
the hand-written kernels on the card, their plain PyTorch versions where
the DRAM image lies on the CPU (``--device cpu``).

1. Quantize a float matmul workload to int8 (the paper's PTQ step).
2. Lower it with the scheduler (tensorization + virtual threading).
3. JIT the VTA instruction stream with the runtime.
4. Execute on the behavioral simulator; cross-check against numpy.
5. Time it with the cycle-level pipeline model, with and without
   virtual threading — the paper's latency-hiding result in miniature.
6. Route the *same* encoded stream through the second engine
   (CudaBackend) and differentially check it against the simulator —
   the paper's heterogeneous-execution story (§3).  The CUDA engine's
   first run on the card builds the kernels (nvcc, at first use).
7. Compile a whole multi-op graph (two chained matmuls + requant) into
   ONE task-ISA stream with the program-level JIT, then rerun it on new
   data without re-scheduling.
8. Run a general kh*kw>1 convolution (a ResNet C2-style 3x3) on the
   CUDA engine's fast path: zero eager fallback iterations (the
   fast-path counters), the lowering decision inspectable.
9. Serve the compiled program: compile ONCE, call N times, zero DRAM
   allocation per call (asserted).
10. Pool-serve it asynchronously over a DevicePool of cloned devices;
   results byte-equal to serial calls, per-slot DRAM constant.
11. Decode a 2-block quantized transformer through the pool: KV caches
   in persistent DRAM, four sessions, bit-exact against the eager
   reference, each session's KV bytes in place.
12. Continuous-batch a 2-program mix co-staged into ONE DRAM image
   behind an admission window (core.sched).
13. int4-packed weights: half the staged constant bytes, both engines
   bit-exact, decode-shaped calls through the LUT-GEMM kernel.
14. Kill a serving slot mid-dialogue: it respawns from the pristine
   image, the session restores its KV bytes from its checkpoint, and the
   dialogue continues bit-exact.
15. Autotune the deployment (paper §4), then recompile out of the
   tuning cache: all hits.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
Without ``--device`` it runs on the card.
"""
import argparse
import time

import numpy as np

from repro_torch.core import Program, hwspec, quantize as q
from repro_torch.core.backend import CrossBackendChecker, assert_fast_path
from repro_torch.core.conv import ConvShape, conv2d_reference
from repro_torch.core.runtime import Runtime
from repro_torch.core.scheduler import (Epilogue, matmul_reference,
                                        read_matmul_result, schedule_matmul)
from repro_torch.core.simulator import TimingModel
from repro_torch.kernels import _build


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the DRAM images (default: the "
                         "card)")
    dev = ap.parse_args(argv).device
    spec = hwspec.pynq()
    print(f"VTA template: {spec.batch}x{spec.block_in}x{spec.block_out} "
          f"GEMM core @ {spec.freq_mhz:.0f} MHz "
          f"= {spec.peak_gops:.1f} GOPS peak; DRAM images on {dev}")

    # --- 1. float workload -> int8 (post-training quantization, §5) ---
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 512)).astype(np.float32)
    w = rng.normal(size=(256, 512)).astype(np.float32) / np.sqrt(512)
    qx, qw = q.calibrate(x), q.calibrate(w)
    qy = q.calibrate(x @ w.T)
    shift = q.choose_requant_shift(qx.scale, qw.scale, qy.scale)
    xq, wq = q.quantize(x, qx), q.quantize(w, qw)

    # --- 2-4. schedule, JIT, simulate, verify ---
    rt = Runtime(spec, torch_device=dev)
    plan = schedule_matmul(rt, xq, wq, epilogue=Epilogue(shift=shift),
                           virtual_threads=2)
    stats = rt.synchronize()
    got = read_matmul_result(rt, plan)
    want = matmul_reference(xq, wq, epilogue=Epilogue(shift=shift))
    assert np.array_equal(got, want), "simulator diverged from oracle!"
    print(f"exact int8 result ok; {stats.gemm_macs / 1e6:.1f} M MACs, "
          f"{stats.dram_rd_bytes / 1e3:.0f} kB read")

    # --- 5. latency hiding (Fig. 4 / Fig. 15) ---
    for vt in (1, 2):
        rt = Runtime(spec, torch_device=dev)
        schedule_matmul(rt, xq, wq, virtual_threads=vt)
        s = rt.synchronize(timing=TimingModel(spec))
        print(f"virtual_threads={vt}: {s.total_cycles:,} cycles, "
              f"compute utilization {s.compute_utilization:.1%}, "
              f"{s.gops(spec.freq_mhz):.1f} GOPS")

    # --- 6. heterogeneous execution: one stream, two engines (§3) ---
    rt = Runtime(spec, torch_device=dev)
    plan = schedule_matmul(rt, xq, wq, epilogue=Epilogue(shift=shift),
                           virtual_threads=2)
    built_before = set(_build.BUILD_LOGS)
    report = CrossBackendChecker().check_runtime(rt)
    got = read_matmul_result(rt, plan)
    assert report.matches, "engines diverged!"
    assert np.array_equal(got, want), "adopted image diverged from oracle!"
    built = sorted(set(_build.BUILD_LOGS) - built_before)
    print("cross-backend check ok: "
          + ", ".join(f"{r.backend} {r.stats.wall_time_s * 1e3:.0f} ms"
                      for r in report.runs)
          + (f"  (cuda time includes the kernels' build at first use: "
             f"{len(built)} sources by nvcc)" if built else
             "  (no kernel build in this run: built before, or the "
             "plain versions on CPU tensors)"))

    # --- 7. program-level JIT: a whole graph in ONE stream ---
    w2 = rng.normal(size=(128, 256)).astype(np.float32) / np.sqrt(256)
    w2q = q.quantize(w2, q.calibrate(w2))
    ep1 = Epilogue(shift=shift, relu=True)
    ep2 = Epilogue(shift=6)
    prog = Program(spec)
    h = prog.matmul(prog.input("x", xq.shape), prog.input("w1", wq.shape),
                    epilogue=ep1)
    prog.matmul(h, prog.input("w2", w2q.shape), epilogue=ep2)
    compiled = prog.compile(torch_device=dev)
    print(f"program: {compiled.describe()}")
    want2 = matmul_reference(matmul_reference(xq, wq, ep1), w2q, ep2)
    for backend in ("simulator", "cuda"):
        out = compiled(backend=backend, x=xq, w1=wq, w2=w2q)
        assert np.array_equal(out, want2), f"{backend} diverged!"
    # rerun with fresh activations: rebinds DRAM, no re-scheduling
    from repro_torch.core import program as program_mod
    builds = program_mod.STREAM_BUILDS
    x2 = q.quantize(rng.normal(size=xq.shape).astype(np.float32), qx)
    out = compiled(x=x2, w1=wq, w2=w2q)
    assert program_mod.STREAM_BUILDS == builds
    assert np.array_equal(
        out, matmul_reference(matmul_reference(x2, wq, ep1), w2q, ep2))
    print("program JIT ok: 2-op graph, one stream, both engines exact; "
          "second call hit the stream cache")

    # --- 8. general conv2d on the CUDA engine's fast path (kh*kw > 1) ---
    shape = ConvShape(n=1, h=14, w=14, ic=32, oc=32, kh=3, kw=3,
                      stride=1, pad=1)                  # C2-style 3x3
    xq3 = rng.integers(-64, 64, size=(1, 32, 14, 14), dtype=np.int8)
    k3 = rng.integers(-16, 16, size=(32, 32, 3, 3), dtype=np.int8)
    ep3 = Epilogue(shift=5, relu=True)
    cprog = Program(spec)
    cprog.conv2d(cprog.input("x", xq3.shape), cprog.input("k", k3.shape),
                 shape, epilogue=ep3, name="c2")
    cc = cprog.compile(torch_device=dev)
    print(f"conv program: {cc.describe()}")            # shows c2:direct
    want3 = conv2d_reference(xq3, k3, shape, epilogue=ep3)
    for backend in ("simulator", "cuda"):
        out3 = cc(backend=backend, x=xq3, k=k3)
        assert np.array_equal(out3, want3), f"{backend} conv diverged!"
    assert_fast_path(cc.last_stats)                    # zero eager GEMMs
    eager = sum(s.eager_gemm_insns for s in cc.last_stats)
    coal = sum(s.coalesced_gemm_insns for s in cc.last_stats)
    print(f"3x3 conv ok on the fast path: {coal} GEMM insns coalesced "
          f"into batched vta_gemm launches, {eager} eager fallbacks")

    # --- 9. serve it: compile once, call N times, zero per-call DRAM ---
    sprog = Program(spec)
    t = sprog.conv2d(sprog.input("x", xq3.shape),
                     sprog.constant("k1", k3),      # weight staged ONCE
                     shape, epilogue=ep3, name="s1")
    sprog.conv2d(t, sprog.constant("k2",
                                   rng.integers(-16, 16, size=(32, 32, 1, 1),
                                                dtype=np.int8)),
                 ConvShape(n=1, h=14, w=14, ic=32, oc=32, kh=1, kw=1,
                           stride=1, pad=0),
                 epilogue=ep3, name="s2")
    served = sprog.compile(torch_device=dev)
    print(f"serving program: {served.describe()}")    # fence edge + arena
    served(backend="cuda", x=xq3)                     # warm the engine
    n_calls = 16
    dram_mark = served.device.dram._next
    t0 = time.perf_counter()
    for _ in range(n_calls):
        out9 = served(backend="cuda", x=xq3)
    dt = time.perf_counter() - t0
    assert served.device.dram._next == dram_mark, \
        "serving loop grew the DRAM image!"
    stats9 = served.last_stats[0]
    print(f"served {n_calls} calls at {n_calls / dt:.1f} calls/s: "
          f"{stats9.n_buffer_fences} fence / {stats9.n_join_barriers} "
          f"barriers per stream, {served.last_staging_bytes} B staged per "
          f"call (activations only), DRAM image constant, "
          f"{sum(s.tiles_resolved for s in served.last_stats)} tiles in "
          f"{sum(s.tile_batches for s in served.last_stats)} batched "
          f"launches")

    # --- 10. pool-serve it: async submit/wait over cloned devices ---
    from repro_torch.core.serve import DevicePool
    with DevicePool(served, size=2, backend="cuda",
                    policy="least_loaded") as pool:
        xs = [rng.integers(-64, 64, size=xq3.shape, dtype=np.int8)
              for _ in range(8)]
        futs = [pool.submit(x=xi) for xi in xs]        # async burst
        marks = [s.device.dram._next for s in pool.slots]
        for fut, xi in reversed(list(zip(futs, xs))):  # wait out of order
            got = fut.wait(timeout=600)
            want = served(x=xi)                        # serial oracle
            assert np.array_equal(got, want), "pooled result diverged!"
        assert [s.device.dram._next for s in pool.slots] == marks, \
            "a pool slot grew its DRAM image!"
        gangs = sum(s.ganged_steps for s in pool.slot_stats())
        print(f"pool-served {len(xs)} async requests on "
              f"{len(pool)} slots ({gangs} ganged segments, byte-exact "
              f"vs serial, per-slot DRAM constant):")
        print("\n".join(pool.describe().splitlines()[1:]))  # per-slot

    # --- 11. persistent state: KV-cache decode through the pool ---
    from repro_torch.models.vta_decoder import QuantDecoder
    dec = QuantDecoder(torch_device=dev)       # 2 blocks, d=64, host attn
    cdec = dec.compile()
    print(f"decoder program: {cdec.describe().splitlines()[0]}")
    n_steps = 8
    with DevicePool(cdec, size=2, backend="cuda") as dpool:
        sess = [dpool.session() for _ in range(4)]   # 4 dialogues
        refs = [dec.reference() for _ in range(4)]
        for t in range(n_steps):                     # lockstep decode
            xs = [dec.token(1000 * i + t) for i in range(4)]
            futs = [s.submit(x=xi) for s, xi in zip(sess, xs)]
            for fut, ref, xi in zip(futs, refs, xs):
                assert np.array_equal(fut.wait(300), ref.step(xi)), \
                    "pooled decode diverged from the eager reference!"
        # each session's KV cache really holds ITS dialogue, in place
        for i, s in enumerate(sess):
            assert np.array_equal(s.state("k0"), refs[i].K[0])
            assert int(s.state("pos0")[0]) == n_steps
        print(f"decoded {n_steps} steps x {len(sess)} sessions "
              f"({cdec.persistent_bytes} persistent B/session at stable "
              f"addresses), bit-exact vs the eager reference; per-slot "
              f"state:")
        print("\n".join(dpool.describe().splitlines()[1:]))

    # --- 12. continuous batching: 2-program mix behind an admission
    #         window ---
    from repro_torch.core.program import compile_multi
    from repro_torch.core.sched import SchedConfig, Scheduler

    ws = rng.integers(-64, 64, size=(64, 64), dtype=np.int8)
    pa = Program(spec)
    ta = pa.input("x", (16, 64))
    pa.output(pa.matmul(ta, pa.constant("wa", ws), epilogue=ep2))
    pb = Program(spec)
    tb = pb.input("x", (16, 64))
    tb = pb.matmul(tb, pb.constant("wb", ws), epilogue=ep2)
    pb.output(pb.matmul(tb, pb.constant("wb2", ws.T.copy()),
                        epilogue=ep2))
    ca, cb = compile_multi([pa, pb], torch_device=dev)   # ONE image
    assert not ca.image_range.overlaps(cb.image_range)
    with DevicePool([ca, cb], size=4, backend="cuda") as mpool:
        sched = Scheduler(mpool, SchedConfig(window_us=1500.0))
        feeds = [rng.integers(-64, 64, size=(16, 64), dtype=np.int8)
                 for _ in range(8)]
        futs = [sched.submit(program=i % 2, x=f)
                for i, f in enumerate(feeds)]
        for i, (fut, xf) in enumerate(zip(futs, feeds)):
            want = matmul_reference(xf, ws, ep2)
            if i % 2:
                want = matmul_reference(want, ws.T.copy(), ep2)
            assert np.array_equal(fut.wait(timeout=600), want), \
                "windowed result diverged from serial!"
        sa, sb = sched.stats()
        print(f"continuous-batched {sa.completed}+{sb.completed} "
              f"requests of 2 co-staged programs "
              f"({sa.releases + sb.releases} releases, max gang "
              f"{max(sa.max_gang, sb.max_gang)}, programs never mixed "
              f"in a gang); control plane:")
        print(sched.describe())
        sched.close()

    # --- 13. sub-byte weights: int4 packed storage + LUT-GEMM decode ---
    from repro_torch.core.backend import CudaBackend, SimulatorBackend
    from repro_torch.models.quantized import VtaLinear

    wf = rng.normal(size=(96, 64)).astype(np.float32) * 0.1
    xf = rng.normal(size=(2, 96)).astype(np.float32)   # decode-shaped
    lin8 = VtaLinear(wf, bits=8, torch_device=dev)
    lin4 = VtaLinear(wf, bits=4, torch_device=dev)
    y8, y4 = lin8(xf), lin4(xf)
    # the packed program is bit-exact across both engines...
    assert np.array_equal(lin4(xf, backend=CudaBackend()),
                          lin4(xf, backend=SimulatorBackend()))
    c8 = next(iter(lin8._programs.values()))
    c4 = next(iter(lin4._programs.values()))
    assert c4.const_bytes * 2 == c8.const_bytes       # int4 = half the bytes
    # ...and decode-shaped calls route through the LUT-GEMM kernel
    lin4(xf, backend=CudaBackend())
    luts = sum(s.lut_launches for s in c4.last_stats)
    # int4 output tracks the int8 path within the coarser quant step
    q_step = float(np.abs(y4 - xf @ wf).max())
    print(f"int4 VtaLinear: {c4.describe().splitlines()[0]}")
    print(f"  const {c4.const_bytes}B packed vs {c8.const_bytes}B int8, "
          f"{luts} LUT-GEMM launches, |y4 - x@W|max {q_step:.3f} "
          f"(int8 path {np.abs(y8 - xf @ wf).max():.3f})")

    # --- 14. self-healing: kill a slot mid-dialogue, respawn + restore ---
    with DevicePool(cdec, size=2, backend="cuda", max_respawns=2,
                    checkpoint_every=1) as hpool:
        hsess = hpool.session(slot=0)
        href = dec.reference()
        for t in range(4):
            xi = dec.token(t)
            assert np.array_equal(hsess.submit(x=xi).wait(300),
                                  href.step(xi)), "decode diverged!"
        hpool.kill_slot(0)                   # chaos: the slot dies NOW
        st = hpool.slot_stats()[0]
        assert st.deaths == 1 and st.respawns == 1, \
            "slot did not respawn from the pristine image!"
        assert hsess.stats.restored_from_step == 4, \
            "session did not restore from its checkpoint!"
        for t in range(4, 6):                # the dialogue just continues
            xi = dec.token(t)
            assert np.array_equal(hsess.submit(x=xi).wait(300),
                                  href.step(xi)), \
                "restored decode diverged from the eager reference!"
        print(f"self-healed mid-dialogue: slot 0 died and respawned, "
              f"session restored from step "
              f"{hsess.stats.restored_from_step} (checkpoint_every=1), "
              f"decode continued bit-exact; recovery accounting:")
        print("\n".join(hpool.describe().splitlines()[1:]))

    # --- 15. autotune the deployment, then compile out of the cache ---
    from repro_torch.core import autotune

    wl = autotune.conv_workload(
        ConvShape(n=1, h=14, w=14, ic=32, oc=32, kh=3, kw=3,
                  stride=1, pad=1), seed=0)
    res = autotune.search(wl, seed=0, n_candidates=8, top_n=2, repeats=1,
                          torch_device=dev)
    assert res.winner is not None and res.winner.validated
    # rebuild the workload under the winning spec: every accel op now
    # resolves from the tuning record the search just wrote
    tuned_prog, feeds, refs = wl.build(res.winner.candidate.spec,
                                       res.winner.candidate.virtual_threads,
                                       res.winner.candidate.lowering)
    tuned = tuned_prog.compile(use_cache=False, torch_device=dev)
    assert tuned.tune_hits >= 1 and tuned.tune_misses == 0, \
        "recompile under the tuned spec must be all cache hits!"
    assert np.array_equal(tuned(backend="simulator", **feeds), refs["y"])
    lowering = next(n.lowering for n in tuned.nodes if n.op == "conv2d")
    print(f"autotuned {wl.name}: winner {res.winner.candidate.label()} "
          f"({res.speedup_measured:.2f}x measured over the default), "
          f"conv lowering '{lowering}' picked by replayed cycles")
    print(f"  recompile: {tuned.describe().splitlines()[-1]}")


if __name__ == "__main__":
    main()
