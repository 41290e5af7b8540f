"""The slice as a whole: Program -> stream -> engine, port against reference.

A small ``resnet18_offload.heterogeneous_chain``-shaped graph (channels
16-32, maps 16x16 -> 8x8): a cpu_only 7x7 stem, a 3x3 conv with bias and
relu, a 1x1 conv with shift only, and a host residual add (int8
saturating, as the reference decoder's residual).  Weights are graph
constants made with ``repro_torch.convert`` from the reference's objects.
Both packages compile it and serve three calls with new inputs.
Tolerance: 0 — outputs byte-equal, describe() strings equal, and the
port's repeat calls allocate no DRAM.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.conv as r_conv
import repro.core.hwspec as r_hw
import repro.core.program as r_prog
import repro.core.scheduler as r_sched
import repro_torch.core.conv as t_conv
import repro_torch.core.program as t_prog
from repro_torch import convert
from repro_torch.core.backend import assert_fast_path

STEM = dict(n=1, h=16, w=16, ic=3, oc=16, kh=7, kw=7, stride=2, pad=3)
BODY = dict(n=1, h=8, w=8, ic=16, oc=32, kh=3, kw=3, stride=1, pad=1)
POINT = dict(n=1, h=8, w=8, ic=32, oc=32, kh=1, kw=1, stride=1, pad=0)


def residual_add(a, b):
    """int8 residual add with the tensor ALU's saturation."""
    return np.clip(a.astype(np.int32) + b.astype(np.int32),
                   -128, 127).astype(np.int8)


def _weights():
    rng = np.random.default_rng(2024)
    return dict(
        k1=rng.integers(-8, 8, size=(16, 3, 7, 7), dtype=np.int8),
        k2=rng.integers(-8, 8, size=(32, 16, 3, 3), dtype=np.int8),
        k3=rng.integers(-8, 8, size=(32, 32, 1, 1), dtype=np.int8),
        bias=rng.integers(-300, 300, size=32, dtype=np.int32))


def _ref_epilogues(w):
    spec = r_hw.pynq()
    bb = np.repeat(w["bias"].reshape(-1, 1, spec.block_out), spec.batch,
                   axis=1)
    return dict(stem=r_sched.Epilogue(shift=5, relu=True),
                body=r_sched.Epilogue(bias_blocked=bb, shift=6, relu=True),
                point=r_sched.Epilogue(shift=4))


def _build(pkg, w, eps_ref):
    """The chain in package `pkg` ("ref" or "port"); the port's spec and
    epilogues are converted from the reference's objects."""
    if pkg == "ref":
        p = r_prog.Program(r_hw.pynq())
        C, eps = r_conv.ConvShape, eps_ref
    else:
        spec = convert.spec_from_fields(dataclasses.asdict(r_hw.pynq()))
        p = t_prog.Program(spec)
        C = t_conv.ConvShape
        eps = {k: convert.epilogue_from_fields(dataclasses.asdict(e))
               for k, e in eps_ref.items()}
    x = p.input("x", (1, 3, 16, 16))
    t = p.conv2d(x, p.constant("k1", w["k1"]), C(**STEM),
                 epilogue=eps["stem"], cpu_only=True, name="stem")
    t = p.conv2d(t, p.constant("k2", w["k2"]), C(**BODY),
                 epilogue=eps["body"], name="body")
    u = p.conv2d(t, p.constant("k3", w["k3"]), C(**POINT),
                 epilogue=eps["point"], name="point")
    p.output(p.host(residual_add, u, t, shape=(1, 32, 8, 8),
                    name="residual", key="residual_add"))
    return p


def test_convert_round_trip():
    spec = r_hw.pynq()
    assert dataclasses.asdict(convert.spec_from_fields(
        dataclasses.asdict(spec))) == dataclasses.asdict(spec)
    ep = r_sched.Epilogue(bias_blocked=np.arange(32, dtype=np.int32)
                          .reshape(2, 1, 16), shift=3, relu=True)
    got = convert.epilogue_from_fields(dataclasses.asdict(ep))
    assert got.bias_blocked.tobytes() == ep.bias_blocked.tobytes()
    assert (got.shift, got.relu, got.clip_lo, got.clip_hi,
            got.n_alu_passes) == (ep.shift, ep.relu, ep.clip_lo, ep.clip_hi,
                                  ep.n_alu_passes)
    consts = convert.constants_from_numpy({"w": np.arange(6, dtype=np.int8)},
                                          torch_device="cpu")
    assert consts["w"].numpy().tobytes() == np.arange(6, dtype=np.int8) \
        .tobytes()


@pytest.mark.parametrize("engines", [("pallas", "cuda"),
                                     ("simulator", "simulator")],
                         ids=["fast", "oracle"])
def test_heterogeneous_chain_byte_equal_over_three_calls(engines):
    w = _weights()
    eps = _ref_epilogues(w)
    rc = _build("ref", w, eps).compile(use_cache=False)
    tc = _build("port", w, eps).compile(use_cache=False, torch_device="cpu",
                                        dram_size=1 << 22)
    assert tc.describe() == rc.describe()
    assert [type(s).__name__ for s in tc.steps] == \
        [type(s).__name__ for s in rc.steps]
    dram = tc.device.dram
    image_end, n_allocs = dram._next, len(dram._allocs)
    rng = np.random.default_rng(7)
    for call in range(3):
        x = rng.integers(-64, 64, size=(1, 3, 16, 16), dtype=np.int8)
        want = rc(backend=engines[0], x=x)
        got = tc(backend=engines[1], x=x)
        assert got.dtype == want.dtype == np.int8
        assert got.tobytes() == want.tobytes(), f"call {call}"
        # repeat calls rebind inputs in place: no DRAM allocation
        assert (dram._next, len(dram._allocs)) == (image_end, n_allocs)
        assert tc.last_staging_bytes == rc.last_staging_bytes
        for rs, ts in zip(rc.last_stats, tc.last_stats):
            for k in ("coalesced_gemm_insns", "eager_gemm_insns",
                      "tile_batches", "tiles_resolved", "gemm_macs"):
                assert getattr(ts, k) == getattr(rs, k), k
    if engines[1] == "cuda":
        assert_fast_path(tc.last_stats)
        assert all(s.backend == "cuda" for s in tc.last_stats)
