"""Sub-byte weights in the port against the reference package.

The same numpy-seeded inputs go through the reference (its Pallas kernels
in interpret mode, its engines) and the port on CPU tensors (the kernel
ops' plain versions, both port engines):

  * the device-side WGT unpack is byte-equal to ``layout.unpack_wgt_elems``
    at bits 1, 2 and 4, padding tails included;
  * ``lut_gemm``'s plain versions (the dense oracle the ops take on the
    CPU, and the table algorithm the CUDA kernel runs) equal the
    reference's ``lut_gemm(use_pallas=True)`` and the port's ``vta_gemm``
    plain version at the reference test's shapes, bits 1/2/4, group
    2/4/8, both epilogues;
  * packed programs give the reference's outputs on both port engines,
    with ``RunStats.lut_launches`` equal to the reference ``PallasBackend``
    under auto, ``use_lut=False``, ``use_lut=True`` and an int8 spec;
  * ``VtaLinear(bits=4/2)`` equals the reference ``VtaLinear``; at
    bits=1 both refuse (int1 has no positive level to calibrate on).

Tolerance: 0 everywhere (integer paths).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.backend as r_be
import repro.core.hwspec as r_hw
import repro.core.layout as r_layout
import repro.core.program as r_prog
import repro.core.scheduler as r_sched
import repro_torch.core.backend as t_be
import repro_torch.core.hwspec as t_hw
import repro_torch.core.layout as t_layout
import repro_torch.core.program as t_prog
import repro_torch.core.scheduler as t_sched
from repro.kernels.lut_gemm import lut_gemm as r_lut_gemm
from repro.models.quantized import VtaLinear as RVtaLinear
from repro_torch.kernels.lut_gemm import (lut_gemm, lut_gemm_ref,
                                          lut_gemm_table_ref)
from repro_torch.kernels.vta_gemm import vta_gemm_ref
from repro_torch.models.quantized import VtaLinear as TVtaLinear

CPU = dict(torch_device="cpu", dram_size=1 << 21)


# ----------------------------------------------------------------------
# device-side unpack
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("block", [(16, 16), (3, 5), (1, 7)])
def test_unpack_wgt_elems_torch_byte_equal(bits, block):
    bo, bi = block
    rng = np.random.default_rng(bits * 100 + bo * 10 + bi)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    vals = rng.integers(lo, hi + 1, size=(6, bo, bi), dtype=np.int8)
    vals[0] = lo                       # the extremes of the range
    vals[1] = hi
    packed = r_layout.pack_wgt_elems(vals, bits)
    assert packed.shape[-1] * 8 >= bo * bi * bits  # a padding tail when odd
    got = t_layout.unpack_wgt_elems_torch(torch.from_numpy(packed), bits,
                                          bo, bi)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), r_layout.unpack_wgt_elems(
        packed, bits, bo, bi))
    np.testing.assert_array_equal(got.numpy(), vals)
    # a strided view (one DMA's 2D footprint) unpacks the same
    wide = np.zeros((6, packed.shape[-1] * 2), np.uint8)
    wide[:, :packed.shape[-1]] = packed
    view = torch.from_numpy(wide)[:, :packed.shape[-1]]
    np.testing.assert_array_equal(
        t_layout.unpack_wgt_elems_torch(view, bits, bo, bi).numpy(), vals)


# ----------------------------------------------------------------------
# lut_gemm plain versions against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("group", [2, 4, 8])
def test_lut_gemm_plain_matches_reference(bits, group):
    rng = np.random.default_rng(bits * 10 + group)
    qmin, qmax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    for (M, K, N) in [(1, 32, 16), (4, 144, 130), (18, 96, 64)]:
        a = rng.integers(-128, 128, size=(M, K)).astype(np.int8)
        w = rng.integers(qmin, qmax + 1, size=(K, N)).astype(np.int8)
        at, wt = torch.from_numpy(a), torch.from_numpy(w)
        for ep, sh in [("none", 0), ("requant", 5)]:
            want = np.asarray(r_lut_gemm(
                jnp.asarray(a), jnp.asarray(w), bits=bits, group=group,
                epilogue=ep, shift=sh, use_pallas=True))
            tag = f"bits={bits} group={group} shape={(M, K, N)} ep={ep}"
            for got in (lut_gemm(at, wt, bits=bits, group=group,
                                 epilogue=ep, shift=sh),
                        lut_gemm_table_ref(at, wt, bits=bits, group=group,
                                           epilogue=ep, shift=sh),
                        vta_gemm_ref(at, wt, epilogue=ep, shift=sh)):
                assert got.dtype == {"none": torch.int32,
                                     "requant": torch.int8}[ep]
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=tag)


def test_lut_gemm_tile_axis_and_edges():
    """The leading tile axis, a transposed weight view read in place, and
    shifts of 32 or more (sign fill) all match the dense oracle."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-128, 128, (3, 5, 37), dtype=np.int8))
    w_nk = torch.from_numpy(rng.integers(-8, 8, (3, 11, 37), dtype=np.int8))
    w = w_nk.transpose(1, 2)
    for ep, sh in [("none", 0), ("requant", 31), ("requant", 40)]:
        want = lut_gemm_ref(a, w, epilogue=ep, shift=sh)
        assert torch.equal(lut_gemm(a, w, bits=4, epilogue=ep, shift=sh),
                           want)
        assert torch.equal(lut_gemm_table_ref(a, w, bits=4, epilogue=ep,
                                              shift=sh), want)
    with pytest.raises(ValueError, match="bits"):
        lut_gemm(a, w, bits=3)
    with pytest.raises(ValueError, match="epilogue"):
        lut_gemm(a, w, bits=4, epilogue="dequant")
    with pytest.raises(TypeError):
        lut_gemm(a.to(torch.int32), w, bits=4)



@pytest.mark.parametrize("parts", [1, 3, 7])
@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("group,M", [(2, 16), (4, 16), (4, 1), (8, 5)])
def test_lut_table_ref_exact_at_the_extremes(group, M, bits, parts):
    """The kernel's packed 16-bit row pairs at their largest sums: every
    activation -128 and every weight at the b-bit minimum make each lane
    product +128 * 2^(b-1), so one 16-lane vector sums to 16384 in each
    half (the bound the kernel's note gives); K 8192 in 1, 3 and 7 parts.
    Equal to the dense GEMM, and to it again with the signs mixed."""
    K, N = 8192, 3
    a = torch.full((M, K), -128, dtype=torch.int8)
    w = torch.full((K, N), -(1 << (bits - 1)), dtype=torch.int8)
    for ep, sh in [("none", 0), ("requant", 12)]:
        want = vta_gemm_ref(a, w, epilogue=ep, shift=sh)
        got = lut_gemm_table_ref(a, w, bits=bits, group=group, epilogue=ep,
                                 shift=sh, parts=parts)
        assert torch.equal(got, want), (ep, sh)
    mixed = a.clone()
    mixed[::2] = 127
    assert torch.equal(lut_gemm_table_ref(mixed, w, bits=bits, group=group,
                                          parts=parts),
                       vta_gemm_ref(mixed, w))


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("group", [2, 4, 8])
def test_lut_table_ref_split_matches_reference(group, parts):
    """Seeded numpy inputs, K of three chunks with a ragged end, rows
    that take two passes: the table model, split or not, equals the
    reference's lut_gemm (Pallas, interpret mode)."""
    rng = np.random.default_rng(group * 10 + parts)
    for bits, (M, K, N) in [(4, (2, 1100, 24)), (2, (18, 600, 10)),
                            (1, (1, 1040, 33))]:
        lo = -(1 << (bits - 1))
        a = rng.integers(-128, 128, size=(M, K)).astype(np.int8)
        w = rng.integers(lo, -lo, size=(K, N)).astype(np.int8)
        want = np.asarray(r_lut_gemm(jnp.asarray(a), jnp.asarray(w),
                                     bits=bits, group=group,
                                     use_pallas=True))
        got = lut_gemm_table_ref(torch.from_numpy(a), torch.from_numpy(w),
                                 bits=bits, group=group, parts=parts)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("group", [2, 4, 8])
def test_lut_table_layout_is_a_conflict_free_permutation(group):
    """For every row instance: the kernel's table layout is a permutation
    of the chunk's table words, and the lanes of one shared-memory
    wavefront (LW lanes, each loading UW words of one group and plane)
    land in distinct banks whatever patterns their weights select."""
    from repro_torch.kernels.lut_gemm.kernel import (ROW_INSTANCES,
                                                     table_layout,
                                                     table_word)
    rng = np.random.default_rng(group)
    for mt in ROW_INSTANCES[group]:
        L = table_layout(group, mt)
        v = torch.arange(32)[:, None, None, None]
        gs = torch.arange(L["GPV"])[None, :, None, None]
        wi = torch.arange(L["WPP"])[None, None, :, None]
        p = torch.arange(L["P"])[None, None, None, :]
        words = table_word(group, mt, v, gs, wi, p).reshape(-1)
        assert torch.equal(words.sort().values, torch.arange(L["WORDS"]))
        for _ in range(20):
            for w0 in range(0, 32, L["LW"]):
                lanes = torch.arange(w0, w0 + L["LW"])
                pats = torch.from_numpy(rng.integers(0, L["P"], L["LW"]))
                gsub = int(rng.integers(0, L["GPV"]))
                nu = int(rng.integers(0, L["NU"]))
                banks = torch.stack([table_word(group, mt, lanes, gsub,
                                                nu * L["UW"] + k, pats) % 32
                                     for k in range(L["UW"])]).reshape(-1)
                assert banks.unique().numel() == banks.numel()


def test_lut_plan_rows_vectors_and_split():
    """The row instance is the least >= M (group 8 stops at 4 rows); a
    short K spreads a warp's columns over its lanes (vw vectors a column,
    at least 32 / C); K is split across blocks when the column blocks
    leave SMs idle, and never when the rows take more than one pass."""
    from repro_torch.kernels.lut_gemm.kernel import (columns_per_block,
                                                     lut_plan)
    assert lut_plan(1, 2, 192, 64, 4) == (2, 4, 1, 1)      # the decoder
    assert lut_plan(1, 1, 64, 128, 4)[:3] == (1, 8, 1)
    assert lut_plan(1, 16, 64, 64, 4)[:2] == (16, 8)       # C 4: vw >= 8
    assert lut_plan(1, 5, 50, 70, 8)[:3] == (4, 8, 1)
    assert lut_plan(1, 16, 8192, 3072, 4)[:2] == (16, 32)
    for mt in (1, 2, 4, 8, 16):
        assert columns_per_block(mt) * lut_plan(1, mt, 8, 16, 4)[1] >= 256
    for T, M, N, K in [(1, 1, 192, 4096), (1, 16, 3072, 8192),
                       (1, 1, 8192, 3072)]:
        mt, vw, splits, cps = lut_plan(T, M, N, K, 4)
        assert vw == 32 and splits > 1
        assert (splits - 1) * cps < -(-K // 512) <= splits * cps
    assert lut_plan(1, 18, 192, 4096, 4)[2] == 1           # two row passes
    assert lut_plan(1, 9, 192, 4096, 8)[2] == 1

# ----------------------------------------------------------------------
# packed programs on both port engines
# ----------------------------------------------------------------------
def _programs(spec_fn, w, m):
    """The same one-matmul program compiled in both packages."""
    out = []
    for prog_m, hw_m, sched_m, kw in ((r_prog, r_hw, r_sched, {}),
                                      (t_prog, t_hw, t_sched, CPU)):
        p = prog_m.Program(spec_fn(hw_m))
        x = p.input("x", (m, w.shape[1]))
        p.output(p.matmul(x, p.constant("w", w),
                          epilogue=sched_m.Epilogue(shift=5), name="mm"))
        out.append(p.compile(use_cache=False, **kw))
    return out


def _luts(c):
    return sum(s.lut_launches for s in c.last_stats)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_packed_program_byte_equal_both_engines(bits):
    rng = np.random.default_rng(40 + bits)
    qmin, qmax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    w = rng.integers(qmin, qmax + 1, size=(56, 72)).astype(np.int8)
    x = rng.integers(-128, 128, size=(5, 72)).astype(np.int8)
    rc, tc = _programs(lambda hw: hw.lowbit(bits), w, 5)
    want = rc(backend=r_be.PallasBackend(), x=x)
    ref_luts = _luts(rc)
    assert ref_luts > 0
    assert tc.const_bytes == rc.const_bytes
    for be in (t_be.SimulatorBackend(), t_be.CudaBackend()):
        np.testing.assert_array_equal(tc(backend=be, x=x), want,
                                      err_msg=f"bits={bits} {be.name}")
    assert _luts(tc) == ref_luts
    np.testing.assert_array_equal(
        tc.device.dram.read(0, tc.device.dram._next),
        rc.device.dram.read(0, rc.device.dram._next))


@pytest.mark.parametrize("mode", ["auto", "dense", "forced", "int8"])
def test_lut_launches_equal_reference(mode):
    """Per-shape kernel selection takes the reference's decisions: the
    lut_launches counter is equal on the same stream, at a decode shape
    (2 rows) and past LUT_MAX_ROWS (24 rows)."""
    rng = np.random.default_rng(50)
    w = rng.integers(-8, 8, size=(128, 128)).astype(np.int8)
    use_lut = {"auto": None, "dense": False, "forced": True,
               "int8": None}[mode]
    spec_fn = (lambda hw: hw.pynq()) if mode == "int8" \
        else (lambda hw: hw.lowbit(4))
    for m in (2, 24):
        x = rng.integers(-128, 128, size=(m, 128)).astype(np.int8)
        want = np.clip((x.astype(np.int64) @ w.T.astype(np.int64)) >> 5,
                       -128, 127).astype(np.int8)
        rc, tc = _programs(spec_fn, w, m)
        np.testing.assert_array_equal(
            rc(backend=r_be.PallasBackend(use_lut=use_lut), x=x), want)
        np.testing.assert_array_equal(
            tc(backend=t_be.CudaBackend(use_lut=use_lut), x=x), want)
        assert _luts(tc) == _luts(rc), (mode, m)
        if mode in ("dense", "int8"):
            assert _luts(tc) == 0


# ----------------------------------------------------------------------
# VtaLinear(bits=)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bits", [4, 2, 1])
def test_vta_linear_bits_matches_reference(bits):
    rng = np.random.default_rng(7)
    w = rng.normal(size=(96, 80)).astype(np.float32) * 0.1
    x = rng.normal(size=(2, 96)).astype(np.float32)
    if bits == 1:
        # int1 two's complement has no positive level, so per-tensor
        # calibration has no scale: the reference divides by zero, the
        # port refuses with a typed error
        with pytest.raises(ZeroDivisionError):
            RVtaLinear(w, bits=1)
        with pytest.raises(ValueError, match="1-bit"):
            TVtaLinear(w, bits=1, **CPU)
        return
    r = RVtaLinear(w, bits=bits)
    t = TVtaLinear(w, bits=bits, **CPU)
    assert t.spec.wgt_bits == bits == r.spec.wgt_bits
    np.testing.assert_array_equal(t.w_q, r.w_q)
    want = r(x)
    np.testing.assert_array_equal(t(x, backend="simulator"), want)
    np.testing.assert_array_equal(t(x), want)
    compiled = next(iter(t._programs.values()))
    assert f"wgt int{bits} packed" in compiled.describe()
    assert _luts(compiled) > 0
    # from PTQ params (numpy), as the LM substrate will hand them over
    p = {"w_q": np.clip(np.rint(w / 0.01), -127, 127).astype(np.int8),
         "w_scale": np.full(80, 0.01, np.float32)}
    np.testing.assert_array_equal(
        TVtaLinear.from_params(p, bits=bits, **CPU)(x),
        RVtaLinear.from_params(p, bits=bits)(x))
