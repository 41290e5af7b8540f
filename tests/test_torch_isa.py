"""The port's host ISA layer against the reference, bit for bit.

Seeded random specs, instructions and uop lists go through the JAX
package's (``repro``) and the port's (``repro_torch``) hwspec, isa,
microop, layout and quantize modules.  Tolerance: 0 — every encoding,
blocked layout, packed byte and quantized value is compared for equality.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import hwspec as r_hw, isa as r_isa, layout as r_layout
from repro.core import microop as r_uop, quantize as r_q
from repro_torch.core import hwspec as t_hw, isa as t_isa
from repro_torch.core import layout as t_layout, microop as t_uop
from repro_torch.core import quantize as t_q

SPEC_NAMES = ["pynq", "pynq_batch2", "tpu_like", "lowbit4", "calibrated"]


def _spec(mod, name):
    if name == "lowbit4":
        return mod.lowbit(4)
    if name == "calibrated":
        return mod.calibrated()
    return getattr(mod, name)()


def _random_specs(n, seed):
    """Seeded random template instances that both packages accept."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        f = dict(batch=int(rng.choice([1, 2, 4])),
                 block_in=int(rng.choice([8, 16, 32])),
                 block_out=int(rng.choice([8, 16, 32])),
                 inp_buff_bytes=int(2 ** rng.integers(14, 18)),
                 wgt_buff_bytes=int(2 ** rng.integers(16, 19)),
                 acc_buff_bytes=int(2 ** rng.integers(16, 19)))
        r = r_hw.pynq().replace(**f)
        if r_hw.spec_feasible(r) is None:
            out.append(f)
    return out


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_named_specs_and_feasibility_match(name):
    r, t = _spec(r_hw, name), _spec(t_hw, name)
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    assert r_hw.spec_feasible(r) == t_hw.spec_feasible(t)
    assert r.wgt_elem_bytes == t.wgt_elem_bytes
    assert r.acc_depth == t.acc_depth
    assert r_hw.HOST_FIT == t_hw.HOST_FIT


def _random_insns(rng, spec_fields, n):
    """n random instructions as (kind, field dict) within field widths."""
    out = []
    for _ in range(n):
        kind = rng.choice(["load", "store", "gemm", "alu", "finish"])
        dep = [bool(b) for b in rng.integers(0, 2, 4)]
        if kind in ("load", "store"):
            mem = (int(rng.integers(0, 5)) if kind == "load"
                   else int(r_isa.MemId.OUT))
            f = dict(opcode=int(r_isa.Opcode.LOAD if kind == "load"
                                else r_isa.Opcode.STORE),
                     memory_type=mem, sram_base=int(rng.integers(0, 256)),
                     dram_base=int(rng.integers(0, 1 << 20)),
                     y_size=int(rng.integers(0, 64)),
                     x_size=int(rng.integers(0, 64)),
                     x_stride=int(rng.integers(0, 1024)),
                     y_pad_0=int(rng.integers(0, 4)),
                     y_pad_1=int(rng.integers(0, 4)),
                     x_pad_0=int(rng.integers(0, 4)),
                     x_pad_1=int(rng.integers(0, 4)))
        elif kind in ("gemm", "alu"):
            f = dict(reset=bool(rng.integers(0, 2)),
                     uop_bgn=int(rng.integers(0, 64)),
                     uop_end=int(rng.integers(64, 128)),
                     iter_out=int(rng.integers(0, 32)),
                     iter_in=int(rng.integers(0, 32)),
                     dst_factor_out=int(rng.integers(0, 64)),
                     dst_factor_in=int(rng.integers(0, 64)),
                     src_factor_out=int(rng.integers(0, 64)),
                     src_factor_in=int(rng.integers(0, 64)))
            if kind == "gemm":
                f.update(wgt_factor_out=int(rng.integers(0, 16)),
                         wgt_factor_in=int(rng.integers(0, 16)))
            else:
                f.update(alu_opcode=int(rng.integers(0, 5)),
                         use_imm=bool(rng.integers(0, 2)),
                         imm=int(rng.integers(-(1 << 15), 1 << 15)))
        else:
            f = {}
        out.append((kind, dep, f))
    return out


def _build(mod, kind, dep, f):
    d = mod.DepFlags(*dep)
    if kind in ("load", "store"):
        g = dict(f, opcode=mod.Opcode(f["opcode"]),
                 memory_type=mod.MemId(f["memory_type"]))
        return mod.LoadStoreInsn(dep=d, **g)
    if kind == "gemm":
        return mod.GemmInsn(dep=d, **f)
    if kind == "alu":
        return mod.AluInsn(dep=d, **dict(f, alu_opcode=mod.AluOp(
            f["alu_opcode"])))
    return mod.FinishInsn(dep=d)


@pytest.mark.parametrize("seed", range(4))
def test_instruction_encodings_bit_identical(seed):
    rng = np.random.default_rng(seed)
    fields = _random_specs(1, seed)[0]
    r_spec = r_hw.pynq().replace(**fields)
    t_spec = t_hw.pynq().replace(**fields)
    r_lay, t_lay = r_isa.IsaLayout(r_spec), t_isa.IsaLayout(t_spec)
    assert (r_lay.insn_bits, r_lay.factor_bits) == \
        (t_lay.insn_bits, t_lay.factor_bits)
    specs = _random_insns(rng, fields, 200)
    r_ins = [_build(r_isa, *x) for x in specs]
    t_ins = [_build(t_isa, *x) for x in specs]
    r_words = r_lay.encode_stream(r_ins)
    t_words = t_lay.encode_stream(t_ins)
    assert r_words.dtype == t_words.dtype
    assert r_words.tobytes() == t_words.tobytes()
    # decode of the same words agrees field for field
    for a, b in zip(r_lay.decode_stream(r_words),
                    t_lay.decode_stream(t_words)):
        assert type(a).__name__ == type(b).__name__
        assert {k: int(v) if isinstance(v, (int, np.integer)) else v
                for k, v in vars(a).items() if k != "dep"} == \
            {k: int(v) if isinstance(v, (int, np.integer)) else v
             for k, v in vars(b).items() if k != "dep"}
        assert dataclasses.astuple(a.dep) == dataclasses.astuple(b.dep)


@pytest.mark.parametrize("seed", range(3))
def test_uop_encodings_bit_identical(seed):
    rng = np.random.default_rng(100 + seed)
    name = ["pynq", "pynq_batch2", "tpu_like"][seed]
    r_lay = r_uop.UopLayout(_spec(r_hw, name))
    t_lay = t_uop.UopLayout(_spec(t_hw, name))
    n = 300
    dst = rng.integers(0, 1 << min(r_lay.dst_bits, 20), n)
    src = rng.integers(0, 1 << min(r_lay.src_bits, 20), n)
    wgt = rng.integers(0, 1 << min(r_lay.wgt_bits, 20), n)
    r_u = [r_uop.UOp(int(a), int(b), int(c)) for a, b, c in zip(dst, src, wgt)]
    t_u = [t_uop.UOp(int(a), int(b), int(c)) for a, b, c in zip(dst, src, wgt)]
    rw, tw = r_lay.encode_kernel(r_u), t_lay.encode_kernel(t_u)
    assert rw.tobytes() == tw.tobytes()
    assert [(u.dst, u.src, u.wgt) for u in t_lay.decode_kernel(tw)] == \
        [(u.dst, u.src, u.wgt) for u in r_u]


@pytest.mark.parametrize("name", ["pynq", "pynq_batch2"])
def test_layout_blocking_bit_identical(name):
    rng = np.random.default_rng(7)
    r_spec, t_spec = _spec(r_hw, name), _spec(t_hw, name)
    a = rng.integers(-128, 128, size=(37, 53), dtype=np.int8)
    w = rng.integers(-128, 128, size=(29, 53), dtype=np.int8)
    c = rng.integers(-2 ** 31, 2 ** 31, size=(37, 29), dtype=np.int32)
    x = rng.integers(-128, 128, size=(3, 21, 9, 7), dtype=np.int8)
    k = rng.integers(-128, 128, size=(19, 21, 3, 3), dtype=np.int8)
    for fn, arg in (("pack_inp", a), ("pack_wgt", w), ("pack_acc", c),
                    ("pack_conv_inp", x), ("pack_conv_wgt", k)):
        got = getattr(t_layout, fn)(arg, t_spec)
        want = getattr(r_layout, fn)(arg, r_spec)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), fn
    blocked = r_layout.block2d(a, 4, 16)
    assert t_layout.block2d(a, 4, 16).tobytes() == blocked.tobytes()
    np.testing.assert_array_equal(t_layout.unblock2d(blocked, 37, 53), a)
    nb = r_layout.block_nchw(x, 2, 8)
    assert t_layout.block_nchw(x, 2, 8).tobytes() == nb.tobytes()
    np.testing.assert_array_equal(t_layout.unblock_nchw(nb, 3, 21), x)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_pack_bits_and_wgt_elems_bit_identical(bits):
    rng = np.random.default_rng(bits)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
    a = rng.integers(lo, hi, size=(5, 77), dtype=np.int8)
    r_p, t_p = r_layout.pack_bits(a, bits), t_layout.pack_bits(a, bits)
    assert r_p.tobytes() == t_p.tobytes()
    assert t_layout.unpack_bits(t_p, bits, 77).tobytes() == \
        r_layout.unpack_bits(r_p, bits, 77).tobytes()
    blocked = rng.integers(lo, hi, size=(3, 2, 16, 16), dtype=np.int8)
    r_w = r_layout.pack_wgt_elems(blocked, bits)
    t_w = t_layout.pack_wgt_elems(blocked, bits)
    assert r_w.tobytes() == t_w.tobytes()
    assert t_layout.unpack_wgt_elems(t_w, bits, 16, 16).tobytes() == \
        r_layout.unpack_wgt_elems(r_w, bits, 16, 16).tobytes()


@pytest.mark.parametrize("seed", range(3))
def test_quantize_outputs_identical(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, 33)) * 3
    for pct in (100.0, 99.0):
        assert dataclasses.astuple(r_q.calibrate(x, percentile=pct)) == \
            dataclasses.astuple(t_q.calibrate(x, percentile=pct))
    qp_r, qp_t = r_q.calibrate(x), t_q.calibrate(x)
    assert r_q.quantize(x, qp_r).tobytes() == t_q.quantize(x, qp_t).tobytes()
    q8 = r_q.quantize(x, qp_r)
    assert r_q.dequantize(q8, qp_r).tobytes() == \
        t_q.dequantize(q8, qp_t).tobytes()
    for bits in (8, 4):
        sr = r_q.per_channel_scales(x, axis=0, bits=bits)
        st = t_q.per_channel_scales(x, axis=0, bits=bits)
        assert sr.tobytes() == st.tobytes()
        assert r_q.quantize_per_channel(2.5 * x, sr, bits=bits).tobytes() == \
            t_q.quantize_per_channel(2.5 * x, st, bits=bits).tobytes()
    g, b, m, v = (rng.normal(size=8) for _ in range(4))
    v = np.abs(v)
    for ra, ta in zip(r_q.fold_batchnorm(g, b, m, v),
                      t_q.fold_batchnorm(g, b, m, v)):
        assert ra.tobytes() == ta.tobytes()
    assert r_q.choose_requant_shift(0.02, 0.01, 0.1) == \
        t_q.choose_requant_shift(0.02, 0.01, 0.1)


def test_quantize_regressions_identical():
    """The three quantize-layer regressions fixed in the reference hold
    in the port with identical outputs: per-channel bits= clipping,
    bias clipping in the float domain, and empty-input calibration."""
    rng = np.random.default_rng(11)
    w = rng.normal(size=(8, 32)).astype(np.float32)
    sr = r_q.per_channel_scales(w, axis=0, bits=4)
    st = t_q.per_channel_scales(w, axis=0, bits=4)
    q4 = t_q.quantize_per_channel(3.0 * w, st, axis=0, bits=4)
    assert q4.min() >= -8 and q4.max() <= 7
    assert q4.tobytes() == \
        r_q.quantize_per_channel(3.0 * w, sr, axis=0, bits=4).tobytes()
    bias = np.array([1.0, -1.0, 0.5, 2.0, -3.0])
    with np.errstate(invalid="ignore"):
        for sx, sw in ((1e-20, 1e-20), (0.5, 0.5)):
            got = t_q.quantize_bias(bias, sx=sx, sw=sw)
            assert got.tobytes() == \
                r_q.quantize_bias(bias, sx=sx, sw=sw).tobytes()
    assert t_q.quantize_bias(bias, 1e-20, 1e-20)[0] == (1 << 31) - 1
    empty = np.zeros((0, 4), np.float32)
    for pct in (100.0, 99.0):
        assert dataclasses.astuple(t_q.calibrate(empty, percentile=pct)) \
            == dataclasses.astuple(r_q.calibrate(empty, percentile=pct))
