"""The port lowers to the same task-ISA stream bytes as the reference.

The JIT front end (runtime, scheduler, conv lowerings, segment compiler,
program compiler) is host code; the port must emit byte-identical encoded
streams for the same graph.  Cases: the four GOLDEN schedules of the
reference's stream regression test, Program chains and fan-outs in both
fence modes, and six seeded random matmul / conv / vector graphs.
Tolerance: 0 (stream bytes, DRAM addresses and describe() strings are
compared for equality).
"""
import numpy as np
import pytest

import repro.core.conv as r_conv
import repro.core.hwspec as r_hw
import repro.core.program as r_prog
import repro.core.runtime as r_rt
import repro.core.scheduler as r_sched
import repro_torch.core.conv as t_conv
import repro_torch.core.hwspec as t_hw
import repro_torch.core.program as t_prog
import repro_torch.core.runtime as t_rt
import repro_torch.core.scheduler as t_sched
from repro.core.isa import AluOp as r_AluOp
from repro_torch.core.isa import AluOp as t_AluOp

REF = dict(hw=r_hw, conv=r_conv, prog=r_prog, rt=r_rt, sched=r_sched,
           AluOp=r_AluOp, rt_kw={}, compile_kw={})
PORT = dict(hw=t_hw, conv=t_conv, prog=t_prog, rt=t_rt, sched=t_sched,
            AluOp=t_AluOp, rt_kw=dict(torch_device="cpu", dram_size=1 << 24),
            compile_kw=dict(torch_device="cpu", dram_size=1 << 24))

GOLDEN = ["matmul", "conv_direct", "conv_im2col", "conv1x1"]


def _golden_stream(m, name):
    """The reference golden test's schedules (tests/test_golden_streams.py),
    built in package `m`."""
    spec = m["hw"].pynq()
    E, C = m["sched"].Epilogue, m["conv"].ConvShape
    rng = np.random.default_rng(0)
    rt = m["rt"].Runtime(spec, **m["rt_kw"])
    if name == "matmul":
        a = rng.integers(-128, 128, size=(64, 64), dtype=np.int8)
        w = rng.integers(-128, 128, size=(64, 64), dtype=np.int8)
        m["sched"].schedule_matmul(rt, a, w, epilogue=E(shift=5),
                                   virtual_threads=2)
    elif name in ("conv_direct", "conv_im2col"):
        x = rng.integers(-64, 64, size=(1, 32, 14, 14), dtype=np.int8)
        k = rng.integers(-16, 16, size=(32, 32, 3, 3), dtype=np.int8)
        m["conv"].schedule_conv2d(
            rt, x, k, C(n=1, h=14, w=14, ic=32, oc=32, kh=3, kw=3, stride=1,
                        pad=1),
            epilogue=E(shift=5, relu=True), lowering=name.split("_")[1])
    else:
        x = rng.integers(-64, 64, size=(2, 32, 8, 8), dtype=np.int8)
        k = rng.integers(-16, 16, size=(48, 32, 1, 1), dtype=np.int8)
        m["conv"].schedule_conv2d(
            rt, x, k, C(n=2, h=8, w=8, ic=32, oc=48, kh=1, kw=1, stride=1,
                        pad=0),
            epilogue=E(shift=4), lowering="via_matmul")
    return rt.finalize_stream()


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_streams_byte_identical(name):
    r, t = _golden_stream(REF, name), _golden_stream(PORT, name)
    assert r.dtype == t.dtype and r.shape == t.shape
    assert r.tobytes() == t.tobytes()


def _chain_program(m):
    C, E = m["conv"].ConvShape, m["sched"].Epilogue
    p = m["prog"].Program(m["hw"].pynq())
    s = C(n=1, h=14, w=14, ic=32, oc=32, kh=3, kw=3, stride=1, pad=1)
    t = p.conv2d(p.input("x", (1, 32, 14, 14)), p.input("k", (32, 32, 3, 3)),
                 s, epilogue=E(shift=5, relu=True), name="body")
    p.conv2d(t, p.input("k3", (32, 32, 1, 1)),
             C(n=1, h=14, w=14, ic=32, oc=32, kh=1, kw=1, stride=1, pad=0),
             epilogue=E(shift=4), name="point")
    return p


def _fanout_program(m):
    E = m["sched"].Epilogue
    p = m["prog"].Program(m["hw"].pynq())
    x = p.input("x", (32, 64))
    t = p.matmul(x, p.input("w0", (64, 64)),
                 epilogue=E(shift=5, relu=True), name="stem")
    a = p.matmul(t, p.input("w1", (64, 64)),
                 epilogue=E(shift=5, relu=True), name="left")
    b = p.matmul(t, p.input("w2", (48, 64)),
                 epilogue=E(shift=5, relu=True), name="right")
    p.output(a)
    p.output(b)
    return p


def _compiled_pair(builder, **kw):
    rc = builder(REF).compile(use_cache=False, **kw)
    tc = builder(PORT).compile(use_cache=False, **PORT["compile_kw"], **kw)
    return rc, tc


def _assert_same_artifact(rc, tc):
    assert tc.describe() == rc.describe()
    assert len(tc.steps) == len(rc.steps)
    for rs, ts in zip(rc.accel_steps, tc.accel_steps):
        assert ts.stream.tobytes() == rs.stream.tobytes()
        assert (ts.staged_addr, ts.n_fences, ts.n_barriers, ts.fence_edges,
                ts.n_drains) == (rs.staged_addr, rs.n_fences, rs.n_barriers,
                                 rs.fence_edges, rs.n_drains)
    assert tc.addrs == rc.addrs
    assert tc.device.dram._next == rc.device.dram._next
    # the staged image (constants + pre-staged streams) is byte-equal
    hi = rc.device.dram._next
    assert tc.device.dram.read(0, hi).tobytes() == \
        rc.device.dram.read(0, hi).tobytes()


@pytest.mark.parametrize("fence_mode", ["buffer", "barrier"])
@pytest.mark.parametrize("builder", [_chain_program, _fanout_program],
                         ids=["chain", "fanout"])
def test_program_streams_byte_identical(builder, fence_mode):
    rc, tc = _compiled_pair(builder, fence_mode=fence_mode)
    _assert_same_artifact(rc, tc)


def _random_graph(m, seed):
    """A seeded random graph: a matmul chain, a conv pair or a vector op,
    with random widths, epilogues and (for convs) lowerings."""
    rng = np.random.default_rng(seed)
    E, C = m["sched"].Epilogue, m["conv"].ConvShape
    spec = m["hw"].pynq()
    p = m["prog"].Program(spec, virtual_threads=int(rng.integers(1, 3)))
    kind = ["matmul", "conv", "vector"][seed % 3]
    if kind == "matmul":
        M, K = int(rng.integers(1, 5)) * 16, int(rng.integers(1, 5)) * 16
        h = p.input("x", (M, K))
        for i in range(int(rng.integers(1, 4))):
            N = int(rng.integers(1, 5)) * 16
            bias = rng.integers(-300, 300, size=N, dtype=np.int32)
            ep = E(shift=int(rng.integers(0, 8)), relu=bool(seed & 1),
                   bias_blocked=np.repeat(bias.reshape(-1, 1, 16), 1, axis=1)
                   if i == 0 else None)
            w = rng.integers(-128, 128, size=(N, K), dtype=np.int8)
            h = p.matmul(h, p.constant(f"w{i}", w), epilogue=ep)
            K = N
    elif kind == "conv":
        hw = int(rng.integers(6, 12))
        ic, oc = int(rng.choice([16, 32])), int(rng.choice([16, 32]))
        k = int(rng.choice([1, 3]))
        s1 = C(n=1, h=hw, w=hw, ic=ic, oc=oc, kh=k, kw=k,
               stride=int(rng.integers(1, 3)), pad=k // 2)
        x = p.input("x", (1, ic, hw, hw))
        w1 = rng.integers(-16, 16, size=(oc, ic, k, k), dtype=np.int8)
        lowering = [None, "im2col", "direct"][seed % 4 % 3]
        if s1.stride != 1 and lowering == "im2col":
            lowering = "direct"
        t = p.conv2d(x, p.constant("w1", w1), s1,
                     epilogue=E(shift=5, relu=True), lowering=lowering)
        s2 = C(n=1, h=s1.oh, w=s1.ow, ic=oc, oc=16, kh=1, kw=1, stride=1,
               pad=0)
        w2 = rng.integers(-16, 16, size=(16, oc, 1, 1), dtype=np.int8)
        p.conv2d(t, p.constant("w2", w2), s2, epilogue=E(shift=4))
    else:
        n = int(rng.integers(100, 700))
        a = p.input("a", (n,), dtype="int32")
        b = p.input("b", (n,), dtype="int32")
        op = [m["AluOp"].ADD, m["AluOp"].MAX, m["AluOp"].MIN][seed // 3]
        p.vector_binop(a, b, op=op)
    return p


@pytest.mark.parametrize("seed", range(6))
def test_random_graph_streams_byte_identical(seed):
    rc, tc = _compiled_pair(lambda m: _random_graph(m, seed))
    _assert_same_artifact(rc, tc)
