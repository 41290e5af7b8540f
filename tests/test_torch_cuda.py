"""Kernel against plain version on the card (marker ``cuda``).

These tests need an NVIDIA card and nvcc; where there is none they skip
and say so.  On the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  The file imports neither JAX nor the
reference package, so it runs where only PyTorch is installed.
Tolerance: 0 — the kernels' int32, int8 and float32 results are compared
with ``torch.equal`` (the float32 dequant product is one int-to-float
rounding and one multiply on both sides).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import hwspec
from repro_torch.core.backend import CrossBackendChecker, assert_fast_path
from repro_torch.core.conv import ConvShape, conv2d_reference
from repro_torch.core.program import Program
from repro_torch.core.runtime import Runtime
from repro_torch.core.scheduler import Epilogue, schedule_matmul
from repro_torch.kernels import _build
from repro_torch.kernels.tensor_alu import tensor_alu, tensor_alu_ref
from repro_torch.kernels.vta_gemm import vta_gemm, vta_gemm_ref
from torch_cases import EPILOGUES, SHAPES, alu_cases, gemm_inputs


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    _build.build_all()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("epilogue,shift", EPILOGUES)
@pytest.mark.parametrize("M,K,N", SHAPES + [(1, 5, 3), (300, 4608, 64)])
def test_vta_gemm_kernel_matches_plain(cuda_dev, M, K, N, epilogue, shift,
                                       use_bias):
    a, w, bias, scale = (torch.from_numpy(x).to(cuda_dev)
                         for x in gemm_inputs(M, K, N, seed=M + N))
    b = bias if use_bias else None
    before = vta_gemm.launches
    got = vta_gemm(a, w, b, scale, epilogue=epilogue, shift=shift)
    want = vta_gemm_ref(a, w, b, scale, epilogue=epilogue, shift=shift)
    torch.cuda.synchronize()
    assert vta_gemm.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_vta_gemm_tile_axis_kernel_matches_plain(cuda_dev):
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.integers(-128, 128, (5, 130, 200),
                                      dtype=np.int8)).to(cuda_dev)
    w_nk = torch.from_numpy(rng.integers(-128, 128, (5, 70, 200),
                                         dtype=np.int8)).to(cuda_dev)
    got = vta_gemm(a, w_nk.transpose(1, 2), epilogue="requant", shift=9)
    want = vta_gemm_ref(a, w_nk.transpose(1, 2), epilogue="requant",
                        shift=9)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", alu_cases(), ids=lambda c: c[0])
def test_tensor_alu_kernel_matches_plain(cuda_dev, case):
    _, dst, src, chain = case
    d = torch.from_numpy(dst).to(cuda_dev)
    s = None if src is None else torch.from_numpy(src).to(cuda_dev)
    got = tensor_alu(d, s, chain=chain)
    torch.cuda.synchronize()
    assert torch.equal(got, tensor_alu_ref(d, s, chain=chain))


@pytest.mark.cuda
def test_engines_agree_on_the_card(cuda_dev):
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, size=(64, 64), dtype=np.int8)
    w = rng.integers(-128, 128, size=(64, 64), dtype=np.int8)
    rt = Runtime(hwspec.pynq(), dram_size=1 << 22)
    schedule_matmul(rt, a, w, epilogue=Epilogue(shift=5), virtual_threads=2)
    report = CrossBackendChecker(("simulator", "cuda")).check_runtime(rt)
    assert report.matches


@pytest.mark.cuda
def test_conv_program_on_the_card(cuda_dev):
    s = ConvShape(n=1, h=14, w=14, ic=32, oc=32, kh=3, kw=3, stride=1,
                  pad=1)
    rng = np.random.default_rng(1)
    x = rng.integers(-64, 64, size=(1, 32, 14, 14), dtype=np.int8)
    k = rng.integers(-8, 8, size=(32, 32, 3, 3), dtype=np.int8)
    ep = Epilogue(shift=5, relu=True)
    p = Program(hwspec.pynq())
    p.conv2d(p.input("x", x.shape), p.constant("k", k), s, epilogue=ep)
    c = p.compile(use_cache=False)
    before = vta_gemm.launches
    got = c(x=x)
    assert vta_gemm.launches > before
    assert_fast_path(c.last_stats)
    np.testing.assert_array_equal(got, conv2d_reference(x, k, s, epilogue=ep))
