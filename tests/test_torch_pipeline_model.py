"""The port's roofline placement (Fig. 15) against the reference's.

``conv_roofline_point`` and ``matmul_roofline_point`` schedule one layer
on a Runtime, run it on the numpy simulator against a CPU DRAM image and
replay the stream on the TimingModel: every field (cycles, utilization,
intensity, GOPS, the roofline) must equal the reference's exactly, at
virtual threads 1 and 2.
"""
import dataclasses

import pytest

from repro.core import hwspec as rhw
from repro.core import pipeline_model as RP
from repro.core.conv import ConvShape as RConvShape
from repro_torch.core import hwspec
from repro_torch.core import pipeline_model as TP
from repro_torch.core.conv import ConvShape

CPU = dict(torch_device="cpu")
CONVS = {
    "1x1_28x28x64": dict(n=1, h=28, w=28, ic=64, oc=64, kh=1, kw=1,
                         stride=1, pad=0),
    "3x3_14x14x32": dict(n=1, h=14, w=14, ic=32, oc=32, kh=3, kw=3,
                         stride=1, pad=1),
}


@pytest.mark.parametrize("vt", [1, 2])
@pytest.mark.parametrize("conv", sorted(CONVS))
def test_conv_roofline_point_equals_the_reference(conv, vt):
    want = RP.conv_roofline_point(rhw.pynq(), RConvShape(**CONVS[conv]),
                                  conv, vt)
    got = TP.conv_roofline_point(hwspec.pynq(), ConvShape(**CONVS[conv]),
                                 conv, vt, **CPU)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.roofline_fraction == want.roofline_fraction
    assert got.gops <= got.roofline_gops * 1.001


@pytest.mark.parametrize("vt", [1, 2])
@pytest.mark.parametrize("mnk", [(64, 128, 64), (128, 256, 128)])
def test_matmul_roofline_point_equals_the_reference(mnk, vt):
    M, N, K = mnk
    want = RP.matmul_roofline_point(rhw.pynq(), M, N, K, "mm", vt)
    got = TP.matmul_roofline_point(hwspec.pynq(), M, N, K, "mm", vt, **CPU)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert 0.0 <= got.utilization <= 1.0


def test_hardware_roofline_and_peak_utilization():
    for ai in (0.5, 4.0, 64.0, 1e4):
        assert TP.hardware_roofline(hwspec.pynq(), ai) \
            == RP.hardware_roofline(rhw.pynq(), ai)
    pts = [TP.matmul_roofline_point(hwspec.pynq(), 64, 64, 64, "mm", vt,
                                    **CPU) for vt in (1, 2)]
    assert TP.peak_compute_utilization(pts) == max(p.utilization
                                                   for p in pts)
    assert TP.peak_compute_utilization([]) == 0.0
