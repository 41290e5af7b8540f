"""The port's two engines against the reference's two engines.

On ``torch_device="cpu"`` the port's ``Simulator`` (through
``SimulatorBackend``) and ``CudaBackend`` (whose kernel ops take their
plain PyTorch versions on CPU tensors) run the same encoded streams as the
reference's ``SimulatorBackend`` and ``PallasBackend`` (Pallas in
interpret mode).  Cases: the ten-case matmul grid of the reference's
cross-backend test and its conv fast-path cases (C2- and C4-like layers,
bias epilogues on both lowerings, batch-blocked specs).

Tolerance: 0.  DRAM images are compared byte for byte over every
allocated byte, and the fast-path counters (coalesced_*, eager_*,
tile_batches, tiles_resolved, MACs, ALU ops, DMA bytes) must be equal, so
the port took the same decisions.
"""
import zlib

import numpy as np
import pytest

import repro.core.backend as r_be
import repro.core.conv as r_conv
import repro.core.hwspec as r_hw
import repro.core.isa as r_isa
import repro.core.runtime as r_rt
import repro.core.scheduler as r_sched
import repro.core.simulator as r_sim
import repro_torch.core.backend as t_be
import repro_torch.core.conv as t_conv
import repro_torch.core.hwspec as t_hw
import repro_torch.core.isa as t_isa
import repro_torch.core.runtime as t_rt
import repro_torch.core.scheduler as t_sched
import repro_torch.core.simulator as t_sim

REF = dict(hw=r_hw, conv=r_conv, rt=r_rt, sched=r_sched, sim=r_sim,
           isa=r_isa, engines=("simulator", "pallas"), rt_kw={})
PORT = dict(hw=t_hw, conv=t_conv, rt=t_rt, sched=t_sched, sim=t_sim,
            isa=t_isa, engines=("simulator", "cuda"),
            rt_kw=dict(torch_device="cpu", dram_size=1 << 23))

COUNTERS = ("coalesced_gemm_insns", "coalesced_alu_insns",
            "eager_gemm_insns", "eager_alu_insns", "tile_batches",
            "tiles_resolved", "gemm_macs", "alu_ops", "dram_rd_bytes",
            "dram_wr_bytes", "tokens_pushed", "total_cycles")


def _image(rt):
    return rt.device.dram.read(0, rt.device.dram._next).tobytes()


def _counters(st):
    return {k: getattr(st, k) for k in COUNTERS} | {
        f"{n}.insns": m.insn_count for n, m in st.modules.items()}


def _run_all(schedule, spec_name="pynq", timing=False):
    """schedule(m, rt) emits one stream into runtime rt of package m.
    Runs it on both engines of both packages; returns
    {(pkg, engine): (image bytes, counters, rt, plan)}."""
    out = {}
    for pkg, m in (("ref", REF), ("port", PORT)):
        spec = (m["hw"].pynq() if spec_name == "pynq"
                else m["hw"].HardwareSpec(batch=2))
        for eng in m["engines"]:
            rt = m["rt"].Runtime(spec, **m["rt_kw"])
            plan = schedule(m, rt)
            tm = m["sim"].TimingModel(spec) if timing else None
            st = rt.synchronize(backend=eng, timing=tm)
            out[(pkg, eng)] = (_image(rt), _counters(st), rt, plan, st)
    return out


def _assert_engines_agree(out):
    ref_img = out[("ref", "simulator")][0]
    for key, (img, _, _, _, _) in out.items():
        assert img == ref_img, f"{key} DRAM image differs"
    assert out[("port", "cuda")][1] == out[("ref", "pallas")][1]
    assert out[("port", "simulator")][1] == out[("ref", "simulator")][1]
    assert out[("port", "cuda")][4].backend == "cuda"


def _bias_epilogue(m, N, spec, rng, **kw):
    bias_n = rng.integers(-1000, 1000, size=N, dtype=np.int32)
    blocked = np.repeat(bias_n.reshape(N // spec.block_out, 1,
                                       spec.block_out), spec.batch, axis=1)
    return m["sched"].Epilogue(bias_blocked=blocked, **kw)


def _make_epilogue(m, name, N, spec, rng):
    E = m["sched"].Epilogue
    return {"default": lambda: None,
            "shift_clip": lambda: E(shift=5),
            "relu": lambda: E(relu=True),
            "relu_noclip": lambda: E(relu=True, clip_lo=None, clip_hi=None),
            "relu_cliplo": lambda: E(relu=True, clip_lo=-4, shift=2),
            "wrap": lambda: E(clip_lo=None, clip_hi=None),
            "bias_shift_relu": lambda: _bias_epilogue(m, N, spec, rng,
                                                      shift=6, relu=True),
            }[name]()


# the reference's cross-backend grid (tests/test_backend.py)
CONFIGS = [
    (16, 16, 16, "default", 1),
    (16, 16, 16, "default", 2),
    (32, 16, 48, "shift_clip", 2),
    (48, 32, 32, "relu", 1),
    (64, 64, 64, "shift_clip", 2),
    (32, 32, 64, "bias_shift_relu", 2),
    (16, 32, 32, "wrap", 1),
    (64, 32, 128, "wrap", 2),
    (48, 16, 80, "relu_cliplo", 2),
    (32, 48, 32, "relu_noclip", 2),
]


@pytest.mark.parametrize("M,N,K,ep_name,vt", CONFIGS)
def test_matmul_grid_images_and_counters_equal(M, N, K, ep_name, vt):
    seed = zlib.crc32(repr((M, N, K, ep_name, vt)).encode())
    data = np.random.default_rng(seed)
    a = data.integers(-128, 128, size=(M, K), dtype=np.int8)
    w = data.integers(-128, 128, size=(N, K), dtype=np.int8)

    def schedule(m, rt):
        ep = _make_epilogue(m, ep_name, N, rt.spec,
                            np.random.default_rng(seed + 1))
        return m["sched"].schedule_matmul(rt, a, w, epilogue=ep,
                                          virtual_threads=vt)
    out = _run_all(schedule)
    _assert_engines_agree(out)
    rt, plan = out[("port", "cuda")][2:4]
    ep = _make_epilogue(REF, ep_name, N, r_hw.pynq(),
                        np.random.default_rng(seed + 1))
    np.testing.assert_array_equal(
        t_sched.read_matmul_result(rt, plan),
        r_sched.matmul_reference(a, w, epilogue=ep, spec=r_hw.pynq()))


# the reference's conv fast-path cases (tests/test_conv_fast_path.py)
CONV_CASES = {
    "C2-like": (dict(n=1, h=56, w=56, ic=32, oc=32, kh=3, kw=3, stride=1,
                     pad=1), "relu", None, "pynq"),
    "C4-like": (dict(n=1, h=56, w=56, ic=32, oc=64, kh=3, kw=3, stride=2,
                     pad=1), "relu", None, "pynq"),
    "bias-direct": (dict(n=1, h=14, w=14, ic=32, oc=32, kh=3, kw=3,
                         stride=1, pad=1), "bias", "direct", "pynq"),
    "bias-im2col": (dict(n=1, h=14, w=14, ic=32, oc=32, kh=3, kw=3,
                         stride=1, pad=1), "bias", "im2col", "pynq"),
    "batch2-1x1": (dict(n=5, h=6, w=6, ic=32, oc=32, kh=1, kw=1, stride=1,
                        pad=0), "relu4", "via_matmul", "batch2"),
    "batch2-direct": (dict(n=4, h=8, w=8, ic=16, oc=32, kh=3, kw=3,
                           stride=1, pad=1), "shift3", None, "batch2"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_fast_path_images_and_counters_equal(case):
    fields, ep_kind, lowering, spec_name = CONV_CASES[case]

    def schedule(m, rt):
        spec = rt.spec
        shape = m["conv"].ConvShape(**fields)
        rng = np.random.default_rng(shape.h * shape.ic + shape.oc)
        x = rng.integers(-64, 64, size=(shape.n, shape.ic, shape.h,
                                        shape.w), dtype=np.int8)
        w = rng.integers(-16, 16, size=(shape.oc, shape.ic, shape.kh,
                                        shape.kw), dtype=np.int8)
        E = m["sched"].Epilogue
        if ep_kind == "bias":
            ep = _bias_epilogue(m, shape.oc, spec, np.random.default_rng(3),
                                shift=5, relu=True)
        else:
            ep = {"relu": E(shift=6, relu=True),
                  "relu4": E(shift=4, relu=True),
                  "shift3": E(shift=3)}[ep_kind]
        return m["conv"].schedule_conv2d(rt, x, w, shape, epilogue=ep,
                                         lowering=lowering)
    out = _run_all(schedule, spec_name=spec_name)
    _assert_engines_agree(out)
    t_be.assert_fast_path(out[("port", "cuda")][4])


def test_vector_binop_and_timing_replay_equal():
    """Dense vector ALU (the _alu_eager_region route), multi-chunk, with
    TimingModel cycles: equal images, counters and replayed cycles."""
    rng = np.random.default_rng(3)
    a = rng.integers(-64, 64, size=600, dtype=np.int32)
    b = rng.integers(-63, 63, size=600, dtype=np.int32)

    def schedule(m, rt):
        return m["sched"].schedule_vector_binop(rt, a, b,
                                                op=m["isa"].AluOp.ADD)
    out = _run_all(schedule, timing=True)
    _assert_engines_agree(out)
    assert out[("port", "cuda")][1]["coalesced_alu_insns"] > 0
    assert out[("port", "cuda")][1]["total_cycles"] > 0


def test_out_load_over_pending_tile_matches_reference():
    """A LOAD into OUT SRAM between a GEMM and its STORE must win over the
    GEMM's write-through mirror on every engine."""
    rng = np.random.default_rng(13)
    a = rng.integers(-128, 128, size=(1, 16), dtype=np.int8)
    w = rng.integers(-128, 128, size=(16, 16), dtype=np.int8)
    injected = rng.integers(-128, 128, size=(1, 1, 16), dtype=np.int8)

    def schedule(m, rt):
        isa, spec = m["isa"], rt.spec
        a_addr = rt.copy_to_device(a, align=spec.inp_elem_bytes)
        w_addr = rt.copy_to_device(w, align=spec.wgt_elem_bytes)
        o_addr = rt.copy_to_device(injected, align=spec.out_elem_bytes)
        c_addr = rt.buffer_alloc(spec.out_elem_bytes,
                                 align=spec.out_elem_bytes)
        rt.load_buffer_2d(isa.MemId.INP, 0,
                          rt.to_elem_addr(a_addr, isa.MemId.INP), 1, 1, 1)
        rt.load_buffer_2d(isa.MemId.WGT, 0,
                          rt.to_elem_addr(w_addr, isa.MemId.WGT), 1, 1, 1)
        rt.dep_push(isa.LOAD_Q, isa.COMPUTE_Q)
        rt.dep_pop(isa.LOAD_Q, isa.COMPUTE_Q)
        rt.push_gemm(rt.uop_kernel(lambda b: b.push(dst=0, src=0),
                                   key="t.rst"), reset=True)
        rt.push_gemm(rt.uop_kernel(lambda b: b.push(dst=0, src=0, wgt=0),
                                   key="t.mm"))
        rt.load_buffer_2d(isa.MemId.OUT, 0,
                          rt.to_elem_addr(o_addr, isa.MemId.OUT), 1, 1, 1)
        rt.dep_push(isa.COMPUTE_Q, isa.STORE_Q)
        rt.dep_pop(isa.COMPUTE_Q, isa.STORE_Q)
        rt.store_buffer_2d(0, rt.to_elem_addr(c_addr, isa.MemId.OUT), 1, 1, 1)
        return c_addr
    out = _run_all(schedule)
    _assert_engines_agree(out)
    rt, c_addr = out[("port", "cuda")][2:4]
    np.testing.assert_array_equal(
        rt.copy_from_device(c_addr, 16, np.int8, (1, 16)), injected[0])


@pytest.mark.parametrize("switch", ["coalesce_subgrids", "batch_tiles"])
def test_ab_switches_match_reference(switch):
    """The engines' A/B switches off: coalesce_subgrids=False sends
    direct-conv GEMMs to the eager per-instruction path, batch_tiles=False
    launches once per tile.  Same image, same counters as the reference
    with the same switch."""
    shape_f = dict(n=1, h=10, w=10, ic=16, oc=32, kh=3, kw=3, stride=1,
                   pad=1)
    rng = np.random.default_rng(21)
    x = rng.integers(-64, 64, size=(1, 16, 10, 10), dtype=np.int8)
    w = rng.integers(-16, 16, size=(32, 16, 3, 3), dtype=np.int8)
    imgs, counts = {}, {}
    off = {switch: False}
    for pkg, m, eng in (("ref", REF, r_be.PallasBackend(**off)),
                        ("port", PORT, t_be.CudaBackend(**off))):
        rt = m["rt"].Runtime(m["hw"].pynq(), **m["rt_kw"])
        m["conv"].schedule_conv2d(rt, x, w, m["conv"].ConvShape(**shape_f),
                                  epilogue=m["sched"].Epilogue(shift=5),
                                  lowering="direct")
        st = rt.synchronize(backend=eng)
        imgs[pkg], counts[pkg] = _image(rt), _counters(st)
    assert imgs["port"] == imgs["ref"]
    assert counts["port"] == counts["ref"]
    if switch == "coalesce_subgrids":
        assert counts["port"]["eager_gemm_insns"] > 0
    else:
        # one launch per resolved tile
        assert counts["port"]["tile_batches"] == \
            counts["port"]["tiles_resolved"] > 0


def test_bias_relu_epilogue_is_one_alu_pass_and_keys_are_counted(
        monkeypatch):
    """A 3x3 conv with bias, shift and relu: each tile batch's epilogue is
    ONE tensor_alu call (bias add and the immediate steps together), and
    the weight-content key copies are counted in RunStats."""
    calls = []

    def spy(dst, src=None, *, chain):
        calls.append(tuple(chain))
        return real(dst, src, chain=chain)
    real = t_be.tensor_alu
    monkeypatch.setattr(t_be, "tensor_alu", spy)
    shape = t_conv.ConvShape(n=1, h=14, w=14, ic=32, oc=32, kh=3, kw=3,
                             stride=1, pad=1)
    rng = np.random.default_rng(5)
    x = rng.integers(-64, 64, size=(1, 32, 14, 14), dtype=np.int8)
    w = rng.integers(-16, 16, size=(32, 32, 3, 3), dtype=np.int8)
    rt = t_rt.Runtime(t_hw.pynq(), **PORT["rt_kw"])
    ep = _bias_epilogue(PORT, 32, rt.spec, rng, shift=5, relu=True)
    t_conv.schedule_conv2d(rt, x, w, shape, epilogue=ep, lowering="direct")
    st = rt.synchronize(backend="cuda")
    assert calls and all(c[0] == ("add", None) and len(c) > 1
                         and all(imm is not None for _, imm in c[1:])
                         for c in calls)
    assert len(calls) <= st.tile_batches
    assert st.content_key_copies >= st.tile_batches > 0
    assert st.content_key_bytes >= st.content_key_copies \
        * rt.spec.block_in * rt.spec.block_out
    assert st.content_key_s >= 0.0


def test_checker_and_registry():
    spec = t_hw.pynq()
    rng = np.random.default_rng(7)
    a = rng.integers(-128, 128, size=(64, 96), dtype=np.int8)
    w = rng.integers(-128, 128, size=(32, 96), dtype=np.int8)
    rt = t_rt.Runtime(spec, torch_device="cpu", dram_size=1 << 22)
    plan = t_sched.schedule_matmul(rt, a, w, epilogue=t_sched.Epilogue(
        shift=3), virtual_threads=2)
    report = t_be.CrossBackendChecker().check_runtime(rt)
    assert report.matches and report.mismatched_bytes == 0
    assert [r.backend for r in report.runs] == ["simulator", "cuda"]
    np.testing.assert_array_equal(
        t_sched.read_matmul_result(rt, plan),
        r_sched.matmul_reference(a, w, epilogue=r_sched.Epilogue(shift=3),
                                 spec=r_hw.pynq()))
    assert isinstance(t_be.resolve_backend(None), t_be.CudaBackend)
    assert isinstance(t_be.resolve_backend("simulator"),
                      t_be.SimulatorBackend)
    with pytest.raises(ValueError):
        t_be.resolve_backend("pallas")
    with pytest.raises(NotImplementedError, match="lut_gemm"):
        lrt = t_rt.Runtime(t_hw.lowbit(4), torch_device="cpu",
                           dram_size=1 << 20)
        t_be.CudaBackend().execute(lrt.spec, lrt.device,
                                   lrt.finalize_stream())


def test_decode_cache_is_a_bounded_lru():
    class _FakeIsa:
        insn_words = 2

        def decode_stream(self, raw):
            return [("decoded", raw.tobytes())]

    spec, eng, isa = t_hw.pynq(), t_be.CudaBackend(), _FakeIsa()

    def raw(i):
        return np.full((1, 2), 9_000_000 + i, dtype=np.uint64)
    old = t_be.decode_cache_info()["cap"]
    try:
        t_be.set_decode_cache_cap(2)
        for i in range(2):
            eng._decode_cached(spec, isa, raw(i))
        eng._decode_cached(spec, isa, raw(0))
        _, ev = eng._decode_cached(spec, isa, raw(2))
        assert ev == 1
        _, ev = eng._decode_cached(spec, isa, raw(0))
        assert ev == 0
        assert t_be.decode_cache_info()["size"] == 2
    finally:
        t_be.set_decode_cache_cap(old)
