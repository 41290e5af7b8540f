"""Kernel against plain version on the card (marker ``cuda``).

These tests need an NVIDIA card and nvcc; where there is none they skip
and say so.  On the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  The file imports neither JAX nor the
reference package, so it runs where only PyTorch is installed.
Tolerance: 0 for the integer kernels — their int32, int8 and float32
results are compared with ``torch.equal`` (the float32 dequant product is
one int-to-float rounding and one multiply on both sides).
``decode_attention`` is float math summed in another order than its plain
version (lane groups, then splits): float32 within 1e-5 absolute on
unit-scale inputs; bfloat16, compared in float32, within 2^-6 * max|want|
(four bf16 ulps at 2^-8 * max|want| each), a limit that follows the
output's scale; two calls on the same inputs are bitwise equal (no
float atomics; the split length is fixed by S, so a host and a device
kv_len split alike).  The same holds for a bfloat16 query over
float32 caches, for G = 9 query heads per kv head (starcoder2-7b) and
for kimi-k2's G = 8 at its decode step.
``flash_attention`` against its plain version: float32 within 1e-5
absolute on unit-normal inputs (the 3xTF32 kernel: sums in another
order, a running softmax over 32- or 64-key tiles), bfloat16 within 2^-6
* max|want| as above; bitwise equal over two calls.  The float32 kernel
against float64 attention: its error at most 4x the plain version's, or
1e-6 of max|out| where that is larger.
``tensor_alu_scatter`` (the tensor_alu kernel's scatter instance) byte
for byte against its plain version on random block maps.
``gla_chunk`` against its plain version: within 3e-4 absolute plus 3e-4
relative (the reference's own limit for its kernel against its oracle:
float32 sums in another order, and tiles of at most 64 rows against the
plain version's chunk); bitwise equal over two calls.  Both against the
step recurrence in float64: the kernel's error at most 4x the plain
version's, or 1e-6 of max|y| (max|h| for h) where that is larger.  At
N 256 k is scaled by 1/sqrt(N), as the mLSTM scales it
(src/repro/models/xlstm.py): unit-normal k there gives scores of 16
and a plain float32 version whose own error against float64 exceeds the
3e-4 limit.
The ``flash_attention`` backward kernel (``flash_bwd.cu``) against the
plain backward (``attention_bwd_ref``, float32 math) on the same inputs:
bfloat16 within 2^-6 * max|want| for each of dq, dk and dv (as the
forward: the kernel rounds P and dS once to bf16 as operands, and both
sides round the result once), and row by row against the plain backward
in float64 on the upcast inputs: each query row of dq and key row of dk
and dv within 4x that row's error of the plain backward with P and dS
rounded to bf16 (``operands=torch.bfloat16``), plus 2^-10 of the median
norm of the rows that are not zero (late causal rows are an order smaller than the first, so a
limit from max|want| alone would miss them); float32 held to the plain
backward in
float64, its error at most 4x the float32 plain backward's, or 1e-6 of
max|want| where that is larger; two calls bitwise equal (no atomics).
The backward takes the forward kernel's log-sum-exp L
(``flash_attention_fwd``): writing it leaves the forward's output bitwise
as it was, and it is held to the plain L (``attention_lse_ref``) within
1e-5 absolute in float32 and 2e-5 in bfloat16 (both kernels compute the
scores in float32; the bf16 kernel's exponentials are exp2 of log2 e
scaled scores).  The backward takes every D the forward takes (D 80).
Every head dim, forward and backward, under the same limits: D is
zero-padded by the op where the kernels do not take it as it is, D above
128 runs on the wide kernels (``flash_wide.cu``: wgmma in bfloat16,
3xTF32 in float32, the output in slices; D 136 to 512 here, two calls
bitwise equal; ``tools/time_kernels.py --ops flash_wide`` times them).
The ``gla_chunk`` backward kernel (``gla_bwd.cu``, its float32 outputs)
against the plain backward in float64 on the same inputs: each of dq,
dk, dv, dla and dh0 within 4x the float32 plain backward's error, or
1e-6 of its max|want| where that is larger; the op's bfloat16 dq and dk
those outputs rounded; two calls bitwise equal (no atomics), also where
P is cut into 64-column chunks whose partials the kernel sums (P 65 and
the mLSTM's 1025).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import autotune, hwspec
from repro_torch.core.backend import (CrossBackendChecker, assert_fast_path,
                                      block_map_info)
from repro_torch.core.conv import ConvShape, conv2d_reference
from repro_torch.core.program import Program
from repro_torch.core.runtime import Runtime
from repro_torch.core.scheduler import Epilogue, schedule_matmul
from repro_torch.core.serve import DevicePool
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref_4d)
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_lse_ref,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd,
                                                 flash_attention_plain)
from repro_torch.kernels.gla_chunk import (gla_chunk, gla_chunk_bwd,
                                           gla_chunk_bwd_plain,
                                           gla_chunk_plain, gla_recurrence)
from repro_torch.kernels.gla_chunk.kernel import gla_chunk_bwd_cuda
from repro_torch.kernels.lut_gemm import lut_gemm, lut_gemm_ref
from repro_torch.kernels.tensor_alu import (BlockMap, tensor_alu,
                                            tensor_alu_ref,
                                            tensor_alu_scatter,
                                            tensor_alu_scatter_ref)
from repro_torch.kernels.vta_gemm import (quantized_linear,
                                          quantized_linear_ref, vta_gemm,
                                          vta_gemm_ref)
import repro_torch.kernels.vta_gemm.kernel as vta_kernel
from repro_torch.kernels.vta_gemm.kernel import GemmPlan, gemm_plan
from repro_torch.models.vta_decoder import DecoderConfig, QuantDecoder
from torch_cases import (ENGINE_SHAPES, EPILOGUES, QLINEAR_CASES,
                         SCATTER_CHAINS, SHAPES, SKINNY_SHAPES, alu_cases,
                         gemm_inputs, qlinear_w, qlinear_x, scatter_case)


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
@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("epilogue,shift", EPILOGUES)
@pytest.mark.parametrize("M,K,N", SKINNY_SHAPES)
def test_vta_gemm_skinny_instance_matches_plain(cuda_dev, M, K, N, epilogue,
                                                shift, use_bias):
    """The instance for at most 16 rows (split K, atomic int32 partials),
    and M 17 just past the cut, bitwise; twice, so the scratch sums and
    tickets are seen to be left zeroed."""
    a, w, bias, scale = (torch.from_numpy(x).to(cuda_dev)
                         for x in gemm_inputs(M, K, N, seed=M + N + K))
    w = w.t().contiguous().t()              # (K, N) over (N, K) storage
    b = bias if use_bias else None
    want = vta_gemm_ref(a, w, b, scale, epilogue=epilogue, shift=shift)
    for _ in range(2):
        got = vta_gemm(a, w, b, scale, epilogue=epilogue, shift=shift)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_vta_gemm_skinny_tile_axis_matches_plain(cuda_dev):
    rng = np.random.default_rng(10)
    a = torch.from_numpy(rng.integers(-128, 128, (3, 4, 1152),
                                      dtype=np.int8)).to(cuda_dev)
    w_nk = torch.from_numpy(rng.integers(-128, 128, (3, 200, 1152),
                                         dtype=np.int8)).to(cuda_dev)
    assert gemm_plan(3, 4, 200, 1152).route == "skinny"
    got = vta_gemm(a, w_nk.transpose(1, 2), epilogue="requant", shift=9)
    want = vta_gemm_ref(a, w_nk.transpose(1, 2), epilogue="requant",
                        shift=9)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _vta_operands(dev, T, M, N, K, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-128, 128, (T, M, K),
                                      dtype=np.int8)).to(dev)
    w_nk = torch.from_numpy(rng.integers(-128, 128, (T, N, K),
                                         dtype=np.int8)).to(dev)
    a[:, 0] = -128                          # the operands' extremes
    w_nk[:, :, 0] = -128
    bias = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, N,
                                         dtype=np.int32)).to(dev)
    scale = torch.from_numpy(rng.random(N, dtype=np.float32) * 1e-3) \
        .to(dev)
    return a, w_nk.transpose(1, 2), bias, scale


def _vta_twice(a, w, bias, scale, epilogue, shift):
    """Two calls, each bitwise equal to the plain version (so the split's
    scratch sums and tickets are seen to be left zeroed)."""
    want = vta_gemm_ref(a, w, bias, scale, epilogue=epilogue, shift=shift)
    before = vta_gemm.launches
    for _ in range(2):
        got = vta_gemm(a, w, bias, scale, epilogue=epilogue, shift=shift)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert vta_gemm.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("T,M,N,K,epilogue,shift", ENGINE_SHAPES)
def test_vta_gemm_wgmma_engine_shapes_match_plain(cuda_dev, T, M, N, K,
                                                  epilogue, shift,
                                                  use_bias):
    """Every shape the task-ISA engine launches above 16 rows, on the plan's
    tile and split."""
    assert gemm_plan(T, M, N, K).route == "wgmma"
    a, w, bias, scale = _vta_operands(cuda_dev, T, M, N, K, M + N + K)
    _vta_twice(a, w, bias if use_bias else None, scale, epilogue, shift)


WGMMA_EPILOGUES = [("none", 0), ("requant", 0), ("requant", 9),
                   ("requant", 31), ("requant", 40), ("dequant", 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("epilogue,shift", WGMMA_EPILOGUES)
@pytest.mark.parametrize("slices", [1, 8], ids=["one_slice", "8_slices"])
@pytest.mark.parametrize("bm,bn", vta_kernel.WGMMA_TILES)
def test_vta_gemm_wgmma_every_tile_and_split(cuda_dev, monkeypatch, bm, bn,
                                             slices, epilogue, shift,
                                             use_bias):
    """Each (rows, channels) tile of the instance, at one K slice and at
    eight, on T 3 peer tiles ragged in M, N and K (K padded to 16 by the
    wrapper), every epilogue, with and without bias."""
    T, M, N, K = 3, 130, 203, 1000
    steps = -(-vta_kernel.padded_k(K) // vta_kernel.WGMMA_KSTEP)
    per = -(-steps // slices)
    plan = GemmPlan("wgmma", -(-steps // per), per * vta_kernel.WGMMA_KSTEP,
                    bm, bn)
    monkeypatch.setattr(vta_kernel, "_wgmma_plan", lambda *_: plan)
    a, w, bias, scale = _vta_operands(cuda_dev, T, M, N, K, bm + bn)
    _vta_twice(a, w, bias if use_bias else None, scale, epilogue, shift)


@pytest.mark.cuda
def test_vta_gemm_wgmma_reads_misaligned_views(cuda_dev):
    """Operands whose bases are not 16-byte aligned (views one byte into
    their storage) are copied by the wrapper; K a multiple of 16."""
    T, M, N, K = 2, 70, 96, 256
    rng = np.random.default_rng(3)
    sa = torch.from_numpy(rng.integers(-128, 128, T * M * K + 1,
                                       dtype=np.int8)).to(cuda_dev)
    sw = torch.from_numpy(rng.integers(-128, 128, T * N * K + 1,
                                       dtype=np.int8)).to(cuda_dev)
    a = sa[1:].view(T, M, K)
    w = sw[1:].view(T, N, K).transpose(1, 2)
    assert a.data_ptr() % 16 and w.data_ptr() % 16
    _vta_twice(a, w, None, None, "requant", 9)


QLINEAR_SHAPES = [(1, 1000, 203), (4, 3072, 1024), (4, 8192, 3072),
                  (4, 2048, 8384), (16, 3072, 3072), (17, 1000, 203),
                  (64, 2048, 520),
                  # xlstm-1.3b's mLSTM gates (w_if: N = 2H = 8, K 4096) at a
                  # decode step and a 512-token prefill
                  (4, 4096, 8), (512, 4096, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", QLINEAR_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", QLINEAR_SHAPES)
def test_quantized_linear_fused_bitwise(cuda_dev, M, K, N, dtype, case):
    """The fused route (amax, quantization, GEMM and dequantization in the
    kernels) against the plain chain on the card: the same bits, in x's
    dtype; one vta_gemm launch a call."""
    x = torch.from_numpy(qlinear_x(M, K, case, M + K)).to(cuda_dev) \
        .to(dtype)
    w_nk, sc = qlinear_w(K, N, N)
    w_q = torch.from_numpy(w_nk).to(cuda_dev).t()
    w_scale = torch.from_numpy(sc).to(cuda_dev)
    want = quantized_linear_ref(x, w_q, w_scale)
    before = vta_gemm.launches
    for _ in range(2):
        got = quantized_linear(x, w_q, w_scale)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (M, N)
        assert torch.equal(got, want)
    assert vta_gemm.launches == before + 2
    assert quantized_linear.shapes[(M, N, K, str(dtype)[6:])] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [4, 40])
def test_quantized_linear_given_scale_clips(cuda_dev, M, dtype):
    """A given x_scale with x at +-127.5 and -128.5 of it: round half to
    even, then the clip, on both routes."""
    K, N = 512, 136
    xs = torch.tensor(0.25, device=cuda_dev)
    x = torch.full((M, K), 0.5, device=cuda_dev)
    x[:, 0], x[:, 1], x[:, 2], x[:, 3] = 127.5 * 0.25, -127.5 * 0.25, \
        -128.5 * 0.25, 1000.0
    x = x.to(dtype)
    w_nk, sc = qlinear_w(K, N, 3)
    w_q = torch.from_numpy(w_nk).to(cuda_dev).t()
    w_scale = torch.from_numpy(sc).to(cuda_dev)
    got = quantized_linear(x, w_q, w_scale, xs)
    want = quantized_linear_ref(x, w_q, w_scale, xs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("given", [False, True], ids=["amax", "x_scale"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [17, 130, 512, 4096])
def test_quantized_linear_wgmma_bitwise(cuda_dev, M, dtype, given):
    """Above 16 rows: x quantized once into x_q, then the wgmma instance;
    bitwise equal to the plain chain twice, at K and N not multiples of
    16, with the amax or a given x_scale."""
    K, N = 1000, 520
    x = torch.from_numpy(qlinear_x(M, K, "outlier", M)).to(cuda_dev) \
        .to(dtype)
    xs = torch.tensor(0.03125, device=cuda_dev) if given else None
    w_nk, sc = qlinear_w(K, N, M + 1)
    w_q = torch.from_numpy(w_nk).to(cuda_dev).t()
    w_scale = torch.from_numpy(sc).to(cuda_dev)
    assert gemm_plan(1, M, N, K).route == "wgmma"
    want = quantized_linear_ref(x, w_q, w_scale, xs)
    for _ in range(2):
        got = quantized_linear(x, w_q, w_scale, xs)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quantized_linear_wgmma_misaligned_x(cuda_dev, dtype):
    """x a view one element into its storage (not 16-byte aligned): the
    quantize launch reads it element by element."""
    M, K, N = 40, 512, 136
    rng = np.random.default_rng(6)
    buf = torch.from_numpy(rng.normal(size=M * K + 1).astype(np.float32)) \
        .to(cuda_dev).to(dtype)
    x = buf[1:].view(M, K)
    assert x.data_ptr() % 16
    w_nk, sc = qlinear_w(K, N, 9)
    w_q = torch.from_numpy(w_nk).to(cuda_dev).t()
    w_scale = torch.from_numpy(sc).to(cuda_dev)
    got = quantized_linear(x, w_q, w_scale)
    torch.cuda.synchronize()
    assert torch.equal(got, quantized_linear_ref(x, w_q, w_scale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quantized_linear_leading_dims(cuda_dev, dtype):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 3, 384)).astype(np.float32)) \
        .to(cuda_dev).to(dtype)
    w_nk, sc = qlinear_w(384, 72, 5)
    w_q = torch.from_numpy(w_nk).to(cuda_dev).t()
    w_scale = torch.from_numpy(sc).to(cuda_dev)
    got = quantized_linear(x, w_q, w_scale)
    assert got.shape == (2, 3, 72)
    assert torch.equal(got, quantized_linear_ref(x, w_q, w_scale))


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
@pytest.mark.parametrize("spec_name,src_int8", [
    ("pynq", False), ("pynq_batch2", False), ("pynq", True)],
    ids=["pynq", "batch2", "int8"])
@pytest.mark.parametrize("chain_name", list(SCATTER_CHAINS))
@pytest.mark.parametrize("T", [1, 2, 3, 4])
def test_tensor_alu_scatter_kernel_matches_plain(cuda_dev, T, chain_name,
                                                 spec_name, src_int8):
    """Random block maps (overlapping parts and groups summed with int32
    wraparound, uncovered blocks), T 1-4, with and without a chain and a
    tensor operand, every op and the shr edge amounts: byte-equal to the
    plain version, one launch."""
    spec = getattr(hwspec, spec_name)()
    nb, bo = spec.batch, spec.block_out
    grid, groups, mats, bias, chain = scatter_case(
        T * 100 + len(chain_name) + 7 * src_int8, T, chain_name, nb, bo,
        src_int8)
    bmap = BlockMap(grid, groups, nb, bo)
    m = [[torch.from_numpy(x).to(cuda_dev) for x in tile] for tile in mats]
    b = None if bias is None else list(torch.from_numpy(bias).to(cuda_dev))
    before = tensor_alu_scatter.launches
    got = tensor_alu_scatter(m, bmap, b, chain=chain)
    torch.cuda.synchronize()
    assert tensor_alu_scatter.launches == before + 1
    assert torch.equal(got, tensor_alu_scatter_ref(m, bmap, b, chain=chain))


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


@pytest.mark.cuda
def test_conv_scatter_maps_uploaded_once(cuda_dev):
    """A 3x3 conv with bias, shift and relu on the card: its tile batches
    go through the scatter instance, equal to conv2d_reference, and a
    second request builds and uploads no block map."""
    s = ConvShape(n=1, h=14, w=14, ic=32, oc=48, kh=3, kw=3, stride=1,
                  pad=1)
    spec = hwspec.pynq()
    rng = np.random.default_rng(3)
    k = rng.integers(-8, 8, size=(48, 32, 3, 3), dtype=np.int8)
    bias = rng.integers(-512, 512, size=48, dtype=np.int32)
    ep = Epilogue(bias_blocked=np.repeat(bias.reshape(-1, 1, spec.block_out),
                                         spec.batch, axis=1),
                  shift=8, relu=True)
    p = Program(spec)
    p.conv2d(p.input("x", (1, 32, 14, 14)), p.constant("k", k), s,
             epilogue=ep)
    c = p.compile(use_cache=False)
    infos = []
    for r in range(2):
        x = rng.integers(-64, 64, size=(1, 32, 14, 14), dtype=np.int8)
        before = tensor_alu_scatter.launches
        np.testing.assert_array_equal(
            c(x=x), conv2d_reference(x, k, s, epilogue=ep))
        assert tensor_alu_scatter.launches > before
        infos.append(block_map_info())
    assert infos[1]["builds"] == infos[0]["builds"]
    assert infos[1]["uploads"] == infos[0]["uploads"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("T,M,K,N", [(1, 1, 64, 32), (2, 5, 70, 50),
                                     (1, 16, 3072, 512), (3, 18, 144, 130)])
def test_lut_gemm_kernel_matches_plain(cuda_dev, T, M, K, N, bits, group):
    rng = np.random.default_rng(T + M + K + N + bits + group)
    lo = -(1 << (bits - 1))
    a = torch.from_numpy(rng.integers(-128, 128, (T, M, K),
                                      dtype=np.int8)).to(cuda_dev)
    w = torch.from_numpy(rng.integers(lo, -lo, (T, N, K), dtype=np.int8)) \
        .to(cuda_dev).transpose(1, 2)
    for ep, sh in (("none", 0), ("requant", 5), ("requant", 40)):
        before = lut_gemm.launches
        got = lut_gemm(a, w, bits=bits, group=group, epilogue=ep, shift=sh)
        want = lut_gemm_ref(a, w, epilogue=ep, shift=sh)
        torch.cuda.synchronize()
        assert lut_gemm.launches == before + 1
        assert torch.equal(got, want), (bits, group, ep, sh)



def _lut_check(dev, T, M, K, N, bits, group, cases, seed):
    rng = np.random.default_rng(seed)
    lo = -(1 << (bits - 1))
    a = torch.from_numpy(rng.integers(-128, 128, (T, M, K),
                                      dtype=np.int8)).to(dev)
    w = torch.from_numpy(rng.integers(lo, -lo, (T, N, K), dtype=np.int8)) \
        .to(dev).transpose(1, 2)
    for ep, sh in cases:
        before = lut_gemm.launches
        got = lut_gemm(a, w, bits=bits, group=group, epilogue=ep, shift=sh)
        again = lut_gemm(a, w, bits=bits, group=group, epilogue=ep, shift=sh)
        want = lut_gemm_ref(a, w, epilogue=ep, shift=sh)
        torch.cuda.synchronize()
        assert lut_gemm.launches == before + 2
        assert torch.equal(got, want), (T, M, K, N, bits, group, ep, sh)
        assert torch.equal(again, want)


LUT_EPILOGUES = [("none", 0), ("requant", 0), ("requant", 5),
                 ("requant", 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1040, 100])
@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("M", [1, 2, 5, 16])
def test_lut_gemm_row_instances_match_plain(cuda_dev, M, bits, group, K):
    """Every row instance (1, 2, 8 and 16 rows; 4 in passes for group 8)
    byte-equal to the dense plain version, with every epilogue, on a
    ragged N, with K of three chunks with a ragged end and a short K whose
    columns are spread over a warp's lanes."""
    _lut_check(cuda_dev, 1, M, K, 200, bits, group, LUT_EPILOGUES,
               M * 100 + bits * 10 + group + K)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("T,M,K,N", [(1, 1, 4096, 192), (1, 2, 4096, 192),
                                     (1, 16, 4096, 192), (1, 1, 8192, 3072),
                                     (1, 16, 8192, 3072), (2, 4, 4096, 192)])
def test_lut_gemm_split_k_matches_plain(cuda_dev, T, M, K, N, bits):
    """Shapes whose column blocks leave SMs idle take the split of K (the
    decoder's N 192, Llama's N 3072): partials in scratch, the last block
    of each column block adds them and runs the epilogue."""
    from repro_torch.kernels.lut_gemm.kernel import lut_plan
    sms = torch.cuda.get_device_properties(cuda_dev).multi_processor_count
    assert lut_plan(T, M, N, K, 4, sms)[2] > 1
    _lut_check(cuda_dev, T, M, K, N, bits, 4, LUT_EPILOGUES, K + N + M)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_lut_gemm_decoder_shape_matches_plain(cuda_dev, bits):
    """The int4 decoder's launch: T1 M2 N192 K64, requant and none."""
    _lut_check(cuda_dev, 1, 2, 64, 192, bits, 4, LUT_EPILOGUES, 64 + bits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2.0 ** -6)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,HQ,KH,D", [(1, 96, 2, 2, 32),
                                         (1, 4096, 24, 8, 128),
                                         (2, 300, 6, 2, 64)])
def test_decode_attention_kernel_matches_plain(cuda_dev, B, S, HQ, KH, D,
                                               dtype, atol):
    rng = np.random.default_rng(S + HQ)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(cuda_dev).to(dtype)
    q, k, v = t(B, 1, HQ, D), t(B, S, KH, D), t(B, S, KH, D)
    for kv_len in (0, 1, S - 37, S):
        before = decode_attention.launches
        got = decode_attention(q, k, v, kv_len)
        again = decode_attention(
            q, k, v, torch.tensor([kv_len], dtype=torch.int32,
                                  device=cuda_dev))
        want = decode_attention_ref_4d(q, k, v, kv_len)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 2
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got, again)          # bitwise reproducible
        err = (got.float() - want.float()).abs().max().item()
        limit = atol if dtype == torch.float32 else \
            atol * want.float().abs().max().item()
        assert err <= limit, (kv_len, err, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)], ids=["f32", "bf16", "bf16q-f32kv"])
@pytest.mark.parametrize("B,S,HQ,KH,D", [(1, 96, 2, 2, 32),
                                         (1, 4096, 24, 8, 128),
                                         (2, 300, 36, 4, 128),
                                         (4, 256, 64, 8, 128),
                                         (4, 64, 20, 20, 64),
                                         (4, 640, 32, 32, 96)],
                         ids=["decoder", "llama", "starcoder2-G9",
                              "kimi-k2-G8", "whisper-step",
                              "phi3-vision-D96"])
def test_decode_attention_any_group_and_mixed_dtype(cuda_dev, B, S, HQ, KH,
                                                    D, q_dtype, kv_dtype):
    """The repaired kernel: G = 9 and a query of another dtype than the
    caches (the LM serve path's bfloat16 model over float32 caches)."""
    rng = np.random.default_rng(S + HQ + 1)

    def t(dtype, *shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(cuda_dev).to(dtype)
    q = t(q_dtype, B, 1, HQ, D)
    k, v = t(kv_dtype, B, S, KH, D), t(kv_dtype, B, S, KH, D)
    for kv_len in (0, 1, S - 37, S):
        got = decode_attention(q, k, v, kv_len)
        again = decode_attention(q, k, v, kv_len)
        want = decode_attention_ref_4d(q, k, v, kv_len)
        torch.cuda.synchronize()
        assert got.dtype == q_dtype and got.shape == want.shape
        assert torch.equal(got, again)
        err = (got.float() - want.float()).abs().max().item()
        limit = 1e-5 if q_dtype == torch.float32 else \
            2.0 ** -6 * want.float().abs().max().item()
        assert err <= limit, (kv_len, err, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)], ids=["f32", "bf16", "bf16q-f32kv"])
@pytest.mark.parametrize("B,S,HQ,KH,D", [(4, 256, 24, 8, 128),
                                         (4, 1024, 32, 32, 64),
                                         (1, 96, 2, 2, 32)],
                         ids=["llama-step", "zamba2-step", "decoder"])
def test_decode_attention_split_plan_matches_plain(cuda_dev, B, S, HQ, KH, D,
                                                   q_dtype, kv_dtype):
    """The served decode shapes at every kind of kv_len the plan meets:
    none, one row, the served 32, one split boundary either side, S; a host
    int and a device tensor give the same bits; one launch a call."""
    rng = np.random.default_rng(S + HQ + 2)

    def t(dtype, *shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(cuda_dev).to(dtype)
    q = t(q_dtype, B, 1, HQ, D)
    k, v = t(kv_dtype, B, S, KH, D), t(kv_dtype, B, S, KH, D)
    for kv_len in (0, 1, 31, 32, 33, 65, S - 1, S):
        before = decode_attention.launches
        got = decode_attention(q, k, v, kv_len)
        again = decode_attention(q, k, v, torch.tensor(
            [kv_len], dtype=torch.int32, device=cuda_dev))
        want = decode_attention_ref_4d(q, k, v, kv_len)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 2
        assert torch.equal(got, again), kv_len
        err = (got.float() - want.float()).abs().max().item()
        limit = 1e-5 if q_dtype == torch.float32 else \
            2.0 ** -6 * want.float().abs().max().item()
        assert err <= limit, (kv_len, err, limit)
        if kv_len == 0:
            assert not got.float().abs().any()


FLASH_CASES = [
    # (B, S, Sk, HQ, KH, D, causal)
    (1, 16, 16, 24, 8, 128, True),       # the Llama-3.2-3B prompt
    (2, 300, 300, 8, 2, 64, True),       # ragged tiles
    (1, 200, 333, 4, 1, 128, False),     # non-causal, Sk != S, MQA
    (1, 40, 130, 4, 2, 32, True),        # a cache prefix: Sk > S
    (1, 100, 36, 2, 2, 16, True),        # Sk < S: rows that see no key
    (1, 1024, 1024, 4, 4, 128, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_flash_attention_kernel_matches_plain(cuda_dev, case, dtype):
    B, S, Sk, HQ, KH, D, causal = case
    rng = np.random.default_rng(S + Sk + HQ)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(cuda_dev).to(dtype)
    q, k, v = t(B, S, HQ, D), t(B, Sk, KH, D), t(B, Sk, KH, D)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    limit = 1e-5 if dtype == torch.float32 else \
        2.0 ** -6 * want.float().abs().max().item()
    assert err <= limit, (err, limit)


#: float32-only cases of the 3xTF32 kernel: D = 4 mod 8 (padded with a
#: zero column block in shared memory), D 100, 128-row blocks (whisper's
#: cross-attention shape), GQA with rows that see no key
FLASH_F32_CASES = [
    (1, 50, 70, 4, 2, 36, True),
    (2, 130, 130, 3, 3, 100, False),
    (2, 1000, 1500, 20, 20, 64, False),
    (1, 300, 200, 8, 2, 36, True),
]


def _f64_attention(q, k, v, causal):
    B, S, HQ, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    g = HQ // KH
    qh = q.double().transpose(1, 2)
    kh = k.double().transpose(1, 2).repeat_interleave(g, dim=1)
    vh = v.double().transpose(1, 2).repeat_interleave(g, dim=1)
    s = qh @ kh.transpose(-1, -2) / D ** 0.5
    if causal:
        vis = torch.arange(Sk, device=q.device)[None] <= \
            torch.arange(S, device=q.device)[:, None] + (Sk - S)
        s = s.masked_fill(~vis, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return (p @ vh).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES + FLASH_F32_CASES,
                         ids=lambda c: "-".join(str(x) for x in c))
def test_flash_f32_kernel_against_float64(cuda_dev, case):
    """The 3xTF32 kernel within 1e-5 of its plain version, bitwise equal
    over two calls, and its error against float64 attention at most 4x
    the plain float32 version's (or 1e-6 of max|out|)."""
    B, S, Sk, HQ, KH, D, causal = case
    rng = np.random.default_rng(S * 3 + Sk + D)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(cuda_dev)
    q, k, v = t(B, S, HQ, D), t(B, Sk, KH, D), t(B, Sk, KH, D)
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    plain = flash_attention_plain(q, k, v, causal=causal)
    want = _f64_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got - plain).abs().max().item() <= 1e-5
    err = (got.double() - want).abs().max().item()
    plain_err = (plain.double() - want).abs().max().item()
    assert err <= max(4 * plain_err, 1e-6 * want.abs().max().item()), \
        (err, plain_err)
    if causal and S > Sk:
        assert not got[:, :S - Sk].abs().any()


#: whisper's and phi-3-vision's served flash shapes: cross-attention at a
#: decode step (S 1) and at prefill (S 16) over whisper's 1500 frames, its
#: encoder (S = Sk = 1500, 23.4 key tiles of 64: the masked last tile),
#: and phi-3-vision's prompt at D 96 (576 patches and 16 tokens)
ENCDEC_FLASH_CASES = [
    (4, 1, 1500, 20, 20, 64, False),
    (4, 16, 1500, 20, 20, 64, False),
    (2, 1500, 1500, 20, 20, 64, False),
    (2, 592, 592, 32, 32, 96, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ENCDEC_FLASH_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_flash_attention_encdec_shapes_match_plain(cuda_dev, case, dtype):
    """Within 1e-5 (float32) or 2^-6 * max|want| (bfloat16) of the plain
    version, bitwise equal over two calls, one launch a call."""
    test_flash_attention_kernel_matches_plain(cuda_dev, case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ENCDEC_FLASH_CASES[:2] + [
    (1, 200, 333, 4, 1, 128, False), (1, 40, 130, 4, 2, 32, True)],
    ids=lambda c: "-".join(str(x) for x in c))
def test_flash_attention_bf16_query_over_f32_kv(cuda_dev, case):
    """The mixed-dtype rule (whisper's decode step on a bfloat16 model over
    float32 caches): one launch of the 3xTF32 kernel on the query upcast
    to float32, the result in bfloat16, counted under its own shapes key;
    bitwise equal to the float32 call on the upcast query cast back, and
    within 2^-6 * max|want| of the plain version, which promotes."""
    B, S, Sk, HQ, KH, D, causal = case
    rng = np.random.default_rng(S + Sk + 5)

    def t(dtype, *shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(cuda_dev).to(dtype)
    q = t(torch.bfloat16, B, S, HQ, D)
    k, v = t(torch.float32, B, Sk, KH, D), t(torch.float32, B, Sk, KH, D)
    key = (B, S, Sk, HQ, KH, D, causal, "bfloat16/float32")
    before = flash_attention.launches
    seen = flash_attention.shapes.get(key, 0)
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert flash_attention.shapes[key] == seen + 2
    upcast = flash_attention(q.float(), k, v, causal=causal) \
        .to(torch.bfloat16)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, again) and torch.equal(got, upcast)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -6 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("Sk", [1500, 8192])
def test_flash_f32_kernel_long_sums_stay_float32(cuda_dev, Sk):
    """Values with a common offset (v = 1 + N(0, 1)), so every output is
    a one-signed sum of about 1 over Sk keys: the 3xTF32 kernel's error
    against float64 at most 4x the plain float32 version's, as above.
    The tensor cores' float32 accumulation truncates; summed through
    every key tile, it left whisper's encoder (Sk 1500) 6x the plain
    version's error, growing with Sk: the kernel sums each tile apart."""
    rng = np.random.default_rng(Sk)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(cuda_dev)
    q, k = t(2, 256, 4, 64), t(2, Sk, 4, 64)
    v = t(2, Sk, 4, 64) + 1.0
    got = flash_attention(q, k, v, causal=False)
    plain = flash_attention_plain(q, k, v, causal=False)
    want = _f64_attention(q, k, v, False)
    torch.cuda.synchronize()
    err = (got.double() - want).abs().max().item()
    plain_err = (plain.double() - want).abs().max().item()
    assert err <= 4 * plain_err, (err, plain_err)


@pytest.mark.cuda
def test_flash_attention_reads_strided_views(cuda_dev):
    """q, k, v as views of one packed (B, S, HQ + 2 KH, D) projection: the
    kernel reads them through their strides."""
    rng = np.random.default_rng(21)
    B, S, HQ, KH, D = 2, 70, 6, 2, 64
    qkv = torch.from_numpy(rng.normal(size=(B, S, HQ + 2 * KH, D))
                           .astype(np.float32)).to(cuda_dev)
    q, k, v = qkv[:, :, :HQ], qkv[:, :, HQ:HQ + KH], qkv[:, :, HQ + KH:]
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5



WGMMA_CASES = [
    # (B, S, Sk, HQ, KH, D, causal): the bf16 route, the wgmma kernel
    (1, 16, 16, 24, 8, 128, True),       # Llama's 16-token prompt, G 3
    (1, 40, 40, 4, 4, 64, True),         # S < 64, G 1
    (1, 40, 40, 4, 4, 64, False),
    (2, 33, 33, 6, 2, 128, False),
    (1, 77, 130, 8, 2, 128, True),       # ragged, Sk > S
    (1, 77, 130, 8, 8, 64, False),
    (1, 1000, 1500, 9, 1, 64, True),     # ragged tiles, G 9
    (2, 1000, 1500, 9, 1, 128, False),
    (1, 512, 512, 32, 32, 64, True),     # zamba2-1.2b's 512-token prompt
    (1, 300, 300, 6, 2, 96, True),       # D 96, padded to 128
    (1, 100, 36, 3, 1, 32, True),        # Sk < S: rows that see no key
]


def _bf16_flash_check(q, k, v, causal):
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert got.is_contiguous()
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    limit = 2.0 ** -6 * want.float().abs().max().item()
    assert err <= limit, (err, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_flash_wgmma_kernel_matches_plain(cuda_dev, case):
    B, S, Sk, HQ, KH, D, causal = case
    rng = np.random.default_rng(S * 7 + Sk + HQ + D)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(cuda_dev).to(torch.bfloat16)
    _bf16_flash_check(t(B, S, HQ, D), t(B, Sk, KH, D), t(B, Sk, KH, D),
                      causal)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_wgmma_reads_strided_views(cuda_dev, D):
    """bf16 q, k, v as views of one fused (B, S, HQ + 2 KH, D) projection
    and a (B, H, S, D) transposed view: the tensor maps read them in
    place."""
    rng = np.random.default_rng(D)
    B, S, HQ, KH = 2, 150, 6, 2
    qkv = torch.from_numpy(rng.normal(size=(B, S, HQ + 2 * KH, D))
                           .astype(np.float32)).to(cuda_dev) \
        .to(torch.bfloat16)
    q, k, v = qkv[:, :, :HQ], qkv[:, :, HQ:HQ + KH], qkv[:, :, HQ + KH:]
    _bf16_flash_check(q, k, v, True)
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)  # (B, KH, S, D)
    _bf16_flash_check(q, kt, v, False)


@pytest.mark.cuda
def test_flash_wgmma_refuses_misaligned_operands(cuda_dev):
    """A bf16 operand TMA cannot read in place raises ValueError: no
    fallback to another kernel or a copy."""
    B, S, H, D = 1, 64, 2, 64
    buf = torch.zeros(B * S * (H * D + 4) + 8, dtype=torch.bfloat16,
                      device=cuda_dev)
    good = torch.zeros((B, S, H, D), dtype=torch.bfloat16, device=cuda_dev)
    odd_stride = torch.as_strided(buf, (B, S, H, D),
                                  (S * (H * D + 4), H * D + 4, D, 1))
    odd_base = torch.as_strided(buf, (B, S, H, D),
                                (S * H * D, H * D, D, 1), 1)
    before = flash_attention.launches
    for bad in (odd_stride, odd_base):
        with pytest.raises(ValueError):
            flash_attention(bad, good, good)
        with pytest.raises(ValueError):
            flash_attention(good, good, bad)
    assert flash_attention.launches == before
    # the wide kernels take every D above 128: a misaligned view there is
    # copied by the wrapper (its tensor maps are made for contiguous
    # operands), and launched
    wbuf = torch.zeros(S * H * 264 + 8, dtype=torch.bfloat16,
                       device=cuda_dev)
    wide = torch.as_strided(wbuf, (B, S, H, 264), (S * H * 264, H * 264,
                                                   264, 1), 1)
    flash_attention(wide, wide, wide)
    assert flash_attention.launches == before + 1


GLA_CASES = [
    # (B, S, H, N, P, chunk)
    (1, 16, 64, 64, 64, 64),      # zamba2-1.2b, a 16-token prompt: Q = 16
    (1, 512, 64, 64, 64, 64),     # zamba2-1.2b, 8 chunks
    (4, 128, 64, 64, 64, 64),     # zamba2-1.2b, 4 sequences
    (2, 256, 3, 32, 32, 64),      # the reference's kernel-test shapes
    (1, 512, 2, 64, 64, 128),     # chunk 128 walked as 64-row tiles
    (2, 128, 4, 16, 48, 32),      # N != P
    (1, 96, 2, 64, 40, 96),       # chunk 96: tiles of 64 and 32 rows
    (1, 256, 3, 72, 40, 64),      # N 72: not a multiple of 16
    (2, 128, 2, 1, 16, 32),       # N 1: q and k padded to 4 columns
]
#: (B, S, H, N, P, chunk, q/k dtype): xlstm-1.3b's mLSTM scan (N 256, P
#: 1025 with the denominator channel, chunk 512), k scaled by 1/sqrt(N)
GLA_WIDE_CASES = [
    (1, 512, 4, 256, 1025, 512, torch.float32),
    (1, 512, 4, 256, 1025, 512, torch.bfloat16),
    (1, 4096, 4, 256, 1025, 512, torch.bfloat16),
]


def _gla_inputs(dev, B, S, H, N, P, seed, qk_dtype=torch.float32,
                broadcast=False, k_scale=1.0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32)).to(dev)
    if broadcast:
        q = t(B, S, N).to(qk_dtype)[:, :, None].expand(B, S, H, N)
        k = t(B, S, N, scale=k_scale).to(qk_dtype)[:, :, None] \
            .expand(B, S, H, N)
    else:
        q = t(B, S, H, N).to(qk_dtype)
        k = t(B, S, H, N, scale=k_scale).to(qk_dtype)
    v = t(B, S, H, P)
    la = -t(B, S, H).abs() * 0.3
    return q, k, v, la, t(B, H, N, P, scale=0.1)


def _gla_check(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs()
        assert bool((err <= 3e-4 + 3e-4 * w.float().abs()).all()), \
            err.max().item()


def _gla_f64_check(got, want, q, k, v, la, h0):
    """The kernel's error against the step recurrence in float64 at most
    4x the plain version's, or 1e-6 of the output's largest magnitude."""
    B, S, H, N = q.shape
    P = v.shape[-1]

    def to_bh(x):
        return x.transpose(1, 2).reshape(B * H, 1, S, -1)
    hi = torch.zeros((B * H, N, P), device=q.device) if h0 is None \
        else h0.reshape(B * H, N, P)
    y64, h64 = gla_recurrence(to_bh(q), to_bh(k), to_bh(v),
                              to_bh(la[..., None])[..., 0], hi,
                              dtype=torch.float64)
    exact = (y64.reshape(B, H, S, P).transpose(1, 2), h64.reshape(B, H, N, P))
    for g, w, e in zip(got, want, exact):
        err = float((g.double() - e).abs().max())
        plain = float((w.double() - e).abs().max())
        assert err <= max(4 * plain, 1e-6 * float(e.abs().max())), \
            (err, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("h0", [False, True], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("case", GLA_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_gla_chunk_kernel_matches_plain(cuda_dev, case, h0):
    B, S, H, N, P, chunk = case
    q, k, v, la, h = _gla_inputs(cuda_dev, B, S, H, N, P, S + H + N + P)
    h = h if h0 else None
    before = gla_chunk.launches
    got = gla_chunk(q, k, v, la, h, chunk=chunk)
    again = gla_chunk(q, k, v, la, h, chunk=chunk)
    want = gla_chunk_plain(q, k, v, la, h, chunk=chunk)
    torch.cuda.synchronize()
    assert gla_chunk.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _gla_check(got, want)
    _gla_f64_check(got, want, q, k, v, la, h)


@pytest.mark.cuda
@pytest.mark.parametrize("h0", [False, True], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("case", GLA_WIDE_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_gla_chunk_kernel_at_xlstm_width(cuda_dev, case, h0):
    """N 256, P 1025 (33 slices of P, the last one column wide), chunk
    512 walked in tiles; y in float32 as chunked_gla asks."""
    B, S, H, N, P, chunk, dt = case
    q, k, v, la, h = _gla_inputs(cuda_dev, B, S, H, N, P, S + N, dt,
                                 k_scale=N ** -0.5)
    h = h if h0 else None
    kw = dict(chunk=chunk, y_dtype=torch.float32)
    before = gla_chunk.launches
    got = gla_chunk(q, k, v, la, h, **kw)
    again = gla_chunk(q, k, v, la, h, **kw)
    want = gla_chunk_plain(q, k, v, la, h, **kw)
    torch.cuda.synchronize()
    assert gla_chunk.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _gla_check(got, want)
    _gla_f64_check(got, want, q, k, v, la, h)


@pytest.mark.cuda
@pytest.mark.parametrize("y_dtype", [None, torch.float32],
                         ids=["y_bf16", "y_f32"])
@pytest.mark.parametrize("broadcast", [False, True],
                         ids=["heads", "stride0_heads"])
def test_gla_chunk_bf16_q_k_and_broadcast_heads(cuda_dev, broadcast,
                                                y_dtype):
    """Mamba2's operands: C and B broadcast over heads (stride 0, read in
    place), in bfloat16 over bfloat16 caches; y in float32 for
    chunked_gla, in q's dtype through the op's own contract."""
    q, k, v, la, h = _gla_inputs(cuda_dev, 2, 192, 64, 64, 64, 5,
                                 torch.bfloat16, broadcast)
    assert (q.stride(2) == 0) == broadcast
    got = gla_chunk(q, k, v, la, h, chunk=64, y_dtype=y_dtype)
    again = gla_chunk(q, k, v, la, h, chunk=64, y_dtype=y_dtype)
    want = gla_chunk_plain(q, k, v, la, h, chunk=64, y_dtype=y_dtype)
    torch.cuda.synchronize()
    assert got[0].dtype == (y_dtype or torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if y_dtype is None:       # both round one float32 value to bfloat16
        err = (got[0].float() - want[0].float()).abs()
        assert bool((err <= 3e-4 + 2.0 ** -7 * want[0].float().abs()).all())
        _gla_check(got[1:], want[1:])
    else:
        _gla_check(got, want)


#: (B, S, H, N, P, chunk, q/k dtype, q/k heads, h0 and dh given): per
#: head, one row for every head (Mamba2) and a stride-0 view over the
#: heads; a ragged last 64-row tile (S 96); N 256 (the mLSTM's) and N 1;
#: P cut into 64-column chunks with a ragged last one (P 65, and the
#: mLSTM's P 1025 with its one-column chunk)
GLA_BWD_CASES = [
    (2, 128, 3, 16, 17, 32, torch.float32, "heads", False),
    (1, 96, 4, 64, 65, 32, torch.float32, "one", True),
    (2, 192, 8, 64, 64, 64, torch.bfloat16, "one", False),
    (1, 128, 2, 256, 33, 128, torch.bfloat16, "heads", True),
    (1, 64, 2, 1, 5, 64, torch.float32, "stride0", True),
    (1, 256, 2, 256, 1025, 128, torch.bfloat16, "heads", True),
    (1, 160, 2, 96, 1025, 32, torch.float32, "one", True),
]


def _gla_bwd_inputs(dev, B, S, H, N, P, dt, heads, state, seed):
    """q, k, v, la, h0, dy, dh (unit normal; la -0.3 |normal|; k scaled by
    1/sqrt(N) above N 64, as the mLSTM scales it)."""
    q, k, v, la, h0 = _gla_inputs(dev, B, S, H, N, P, seed, dt,
                                  heads != "heads",
                                  N ** -0.5 if N > 64 else 1.0)
    if heads == "one":
        q, k = q[:, :, :1], k[:, :, :1]
    g = torch.Generator(device=dev).manual_seed(seed)
    dy = torch.randn((B, S, H, P), generator=g, device=dev)
    dh = torch.randn((B, H, N, P), generator=g, device=dev) * 0.5
    return (q, k, v, la, h0 if state else None, dy, dh if state else None)


def _gla_bwd_check(got, args, chunk):
    """The kernel's float32 gradients against the plain backward's."""
    want32 = gla_chunk_bwd_plain(*args, chunk=chunk, dtype=torch.float32)
    want64 = gla_chunk_bwd_plain(*args, chunk=chunk, dtype=torch.float64)
    for name, g, w, e in zip(("dq", "dk", "dv", "dla", "dh0"), got, want32,
                             want64):
        assert g.shape == e.shape and g.dtype == torch.float32, name
        err = float((g.double() - e.double()).abs().max())
        plain = float((w.double() - e.double()).abs().max())
        assert err <= max(4 * plain, 1e-6 * float(e.abs().max())), \
            (name, err, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GLA_BWD_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_gla_chunk_bwd_kernel_matches_plain(cuda_dev, case):
    B, S, H, N, P, chunk, dt, heads, state = case
    args = _gla_bwd_inputs(cuda_dev, B, S, H, N, P, dt, heads, state,
                           S + N + P)
    before = gla_chunk.bwd_launches
    got = gla_chunk_bwd(*args, chunk=chunk)
    again = gla_chunk_bwd(*args, chunk=chunk)
    raw = gla_chunk_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert gla_chunk.bwd_launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert got[0].dtype == dt and got[0].shape == args[0].shape
    assert all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, raw))
    _gla_bwd_check(raw, args, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", ["one", "heads"])
def test_gla_chunk_carries_its_gradient_on_the_card(cuda_dev, heads):
    """gla_chunk on CUDA tensors that require grad: one forward launch and
    one backward launch, and the gradients are gla_chunk_bwd's bitwise."""
    args = _gla_bwd_inputs(cuda_dev, 2, 128, 4, 16, 24, torch.float32,
                           heads, True, 8)
    ops = [t.clone().requires_grad_() for t in args[:5]]
    dy, dh = args[5], args[6]
    f0, b0 = gla_chunk.launches, gla_chunk.bwd_launches
    y, h = gla_chunk(*ops, chunk=32)
    loss = (y * dy).sum() + (h * dh).sum()
    got = torch.autograd.grad(loss, ops)
    torch.cuda.synchronize()
    assert (gla_chunk.launches, gla_chunk.bwd_launches) == (f0 + 1, b0 + 1)
    want = gla_chunk_bwd(*args, chunk=32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_gla_chunk_bwd_refuses_what_it_has_no_instance_for(cuda_dev):
    args = _gla_bwd_inputs(cuda_dev, 1, 64, 2, 264, 16, torch.float32,
                           "heads", True, 6)
    with pytest.raises(ValueError, match="N from 1 to 256"):
        gla_chunk_bwd_cuda(*args)
    args = _gla_bwd_inputs(cuda_dev, 1, 64, 2, 16, 16, torch.float32,
                           "heads", True, 7)
    with pytest.raises(ValueError, match="float32 v"):
        gla_chunk_bwd_cuda(args[0], args[1], args[2].bfloat16(), *args[3:])


@pytest.mark.cuda
def test_gla_chunk_carries_the_state_over_a_long_slow_decay(cuda_dev):
    """32768 steps of la about -1e-3 and v = 1 + N(0, 1): a state sum
    chained across the tiles on the tensor cores would truncate
    one-signed and grow with S; each tile's update is added on the CUDA
    cores, so y and h stay within 4x the plain version's float64 error."""
    q, k, v, la, h = _gla_inputs(cuda_dev, 1, 32768, 2, 64, 64, 12)
    g = torch.Generator(device=cuda_dev).manual_seed(12)
    la = -1e-3 * (1 + 0.1 * torch.randn(la.shape, generator=g,
                                        device=cuda_dev).abs())
    v = v + 1.0
    got = gla_chunk(q, k, v, la, h, chunk=64)
    want = gla_chunk_plain(q, k, v, la, h, chunk=64)
    torch.cuda.synchronize()
    _gla_f64_check(got, want, q, k, v, la, h)


@pytest.mark.cuda
def test_gla_chunk_refuses_what_it_has_no_instance_for(cuda_dev):
    q, k, v, la, h = _gla_inputs(cuda_dev, 1, 64, 2, 264, 16, 6)
    with pytest.raises(ValueError, match="N from 1 to 256"):
        gla_chunk(q, k, v, la, h)
    q, k, v, la, h = _gla_inputs(cuda_dev, 1, 64, 2, 16, 16, 7)
    with pytest.raises(TypeError, match="float32 v"):
        gla_chunk(q, k, v.bfloat16(), la, h)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        gla_chunk(q, k, v, la, h, chunk=48)


@pytest.mark.cuda
def test_pooled_int4_decode_on_the_card(cuda_dev):
    """8 greedy steps of the int4 decoder with kernel attention through a
    2-slot pool: every dialogue equals the eager reference on the card,
    and both new kernels ran."""
    dec = QuantDecoder(DecoderConfig(s_max=16), spec=hwspec.lowbit(4),
                       attention="kernel", dram_size=1 << 22)
    c = dec.compile(use_cache=False)
    prompts = [3, 10, 17]
    want = []
    for p in prompts:
        ref, tok, out = dec.reference(), p, []
        for _ in range(8):
            tok = int(np.argmax(ref.step(dec.token(tok))))
            out.append(tok)
        want.append(out)
    lut0, att0 = lut_gemm.launches, decode_attention.launches
    with DevicePool(c, size=2) as pool:
        sess = [pool.session() for _ in prompts]
        toks, got = list(prompts), [[] for _ in prompts]
        for _ in range(8):
            futs = [s.submit(x=dec.token(t)) for s, t in zip(sess, toks)]
            for i, f in enumerate(futs):
                toks[i] = int(np.argmax(f.wait(timeout=120)))
                got[i].append(toks[i])
    assert got == want
    assert lut_gemm.launches > lut0 and decode_attention.launches > att0


#: tile geometries of the autotuner's grid (core/autotune.py:
#: enumerate_candidates around pynq) that pynq and pynq_batch2 do not
#: have; (1, 8, 8) is not in it (no scratchpad split makes it feasible)
AUTOTUNE_TILES = [(2, 8, 8), (1, 8, 32), (1, 32, 8), (1, 32, 32),
                  (2, 8, 16), (2, 32, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["conv", "matmul"])
@pytest.mark.parametrize("tile", AUTOTUNE_TILES,
                         ids=lambda t: "x".join(map(str, t)))
def test_engine_byte_equal_to_simulator_at_autotuner_tiles(cuda_dev, tile,
                                                           kind):
    """block_in and block_out of 8 and 32 (vta_gemm's K a multiple of 8
    and not of 16; the scatter's block maps on new tile grids), each at
    the first scratchpad split of the grid that takes the tile: every
    accelerator segment's DRAM image byte-equal to the simulator's, the
    output equal to the numpy reference (autotune.validate_candidate),
    and the CUDA engine's kernels launched."""
    spec = next(c.spec for c in autotune.enumerate_candidates(
        hwspec.pynq()) if (c.spec.batch, c.spec.block_in,
                           c.spec.block_out) == tile)
    wl = autotune.conv_workload(ConvShape(n=1, h=14, w=14, ic=32, oc=32,
                                          kh=3, kw=3, stride=1, pad=1)) \
        if kind == "conv" else autotune.matmul_workload(64, 128, 128)
    prog, feeds, refs = wl.build(spec, 2, None)
    c = prog.compile(use_cache=False, dram_size=1 << 24)
    before = vta_gemm.launches
    autotune.validate_candidate(c, feeds, refs)
    assert vta_gemm.launches > before
    np.testing.assert_array_equal(c(backend="cuda", **feeds), refs["y"])


def _served_logits(tcfg, params, toks, dev):
    """Prefill 12 tokens then 3 decode steps, teacher-forced on `toks`
    (B, 15): each call's logits, on the CPU."""
    from repro_torch.models import transformer as TT
    caches = TT.init_caches(tcfg, toks.shape[0], 32, torch.float32, dev)
    t = torch.from_numpy(toks).to(dev)
    out = []
    with torch.inference_mode():
        lg, caches = TT.prefill(params, tcfg, {"tokens": t[:, :12]}, caches)
        out.append(lg.cpu())
        for i in range(3):
            lg, caches = TT.decode_step(params, tcfg, caches,
                                        t[:, 12 + i:13 + i], 12 + i)
            out.append(lg.cpu())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("quant,tol", [(False, 1e-4), (True, 5e-3)],
                         ids=["float", "int8"])
def test_reduced_xlstm_served_on_the_card(cuda_dev, quant, tol):
    """Reduced xlstm (4 layers, mLSTM and sLSTM) on the card against its
    CPU plain run: gla_chunk (N 64, P 33, chunk 512) and, on int8
    weights, quantized_linear launch; the logits of a prefill and three
    decode steps agree within `tol` of max|logit| (float: the scan's
    3xTF32 sums; int8: an activation at a rounding tie may quantize to
    the next step, tests/test_torch_xlstm.py); the served tokens on
    float weights equal the CPU engine's."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.serve import ServeEngine, make_requests
    from repro_torch.models import transformer as TT
    from repro_torch.models.quantized import quantize_params
    tcfg = reduced(get_arch("xlstm-1.3b").model)
    cpu = TT.init_params(tcfg, 0, torch_device="cpu")
    if quant:
        cpu = quantize_params(cpu)
    card = TT.LMParams({k: v for k, v in cpu.tree().items()}).to(cuda_dev)
    toks = np.random.default_rng(40).integers(0, tcfg.vocab_size, (2, 15))
    gla0, gemm0 = gla_chunk.launches, vta_gemm.launches
    got = _served_logits(tcfg, card, toks, cuda_dev)
    assert gla_chunk.launches == gla0 + 2          # two mLSTM layers
    assert (vta_gemm.launches > gemm0) == quant
    want = _served_logits(tcfg, cpu, toks, "cpu")
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) <= tol
    if quant:
        return
    outs = []
    for params, dev in ((card, cuda_dev), (cpu, "cpu")):
        eng = ServeEngine(tcfg, params, batch_slots=4, max_len=64,
                          torch_device=dev)
        outs.append({r.rid: r.out_tokens
                     for r in eng.run(make_requests(tcfg, 6, 16))})
    assert outs[0] == outs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("quant,tol", [(False, 1e-4), (True, 5e-3)],
                         ids=["float", "int8"])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"])
def test_reduced_moe_served_on_the_card(cuda_dev, arch, quant, tol):
    """Reduced phi3.5-moe and kimi-k2 (2 layers, 4 experts, top-2; kimi-k2
    with a shared expert) on the card against the same model on the CPU:
    flash_attention in every prefill layer, decode_attention in every
    decode layer and, on int8 weights, quantized_linear (4 a layer, 7 on
    kimi-k2) launch; the logits of a prefill and three decode steps agree
    within `tol` of max|logit| (float: the 3xTF32 flash kernel's sums;
    int8: an activation at a rounding tie may quantize to the next step);
    the served tokens on float weights equal the CPU engine's."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.serve import ServeEngine, make_requests
    from repro_torch.models import transformer as TT
    from repro_torch.models.quantized import quantize_params
    tcfg = reduced(get_arch(arch).model)
    cpu = TT.init_params(tcfg, 0, torch_device="cpu")
    if quant:
        cpu = quantize_params(cpu)
    card = TT.LMParams({k: v for k, v in cpu.tree().items()}).to(cuda_dev)
    toks = np.random.default_rng(41).integers(0, tcfg.vocab_size, (2, 15))
    fa0, da0, gemm0 = (flash_attention.launches, decode_attention.launches,
                       vta_gemm.launches)
    got = _served_logits(tcfg, card, toks, cuda_dev)
    assert flash_attention.launches == fa0 + 2       # two layers, a prefill
    assert decode_attention.launches == da0 + 3 * 2
    per_layer = 4 + 3 * tcfg.n_shared_experts
    assert vta_gemm.launches - gemm0 == (4 * 2 * per_layer if quant else 0)
    want = _served_logits(tcfg, cpu, toks, "cpu")
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) <= tol
    if quant:
        return
    outs = []
    for params, dev in ((card, cuda_dev), (cpu, "cpu")):
        eng = ServeEngine(tcfg, params, batch_slots=4, max_len=64,
                          torch_device=dev)
        outs.append({r.rid: r.out_tokens
                     for r in eng.run(make_requests(tcfg, 6, 16))})
    assert outs[0] == outs[1]


#: (B, S, Sk, HQ, KH, D, causal): the backward kernel's cases, small
#: shapes of every served kind (GQA, ragged tiles, Sk != S both ways,
#: rows that see no key) at each instantiated D
FLASH_BWD_CASES = [
    (1, 64, 64, 6, 2, 128, True),        # llama-like GQA
    (2, 77, 77, 4, 2, 128, True),        # ragged tiles
    (1, 100, 150, 4, 4, 64, False),      # whisper's cross-attention kind
    (2, 90, 90, 4, 4, 96, True),         # phi-3-vision's D 96
    (1, 40, 130, 4, 1, 64, True),        # Sk > S
    (1, 100, 36, 4, 2, 128, True),       # Sk < S: rows that see no key
    (1, 2048, 2048, 4, 2, 128, True),    # long causal rows, held by row
    (1, 96, 96, 4, 2, 80, True),         # D 80: padded as the forward pads
]


def _row_norms(x):
    return x.double().reshape(-1, x.shape[-1]).norm(dim=-1)


def _bwd_operands(dev, dtype, B, S, Sk, HQ, KH, D, seed):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(dev).to(dtype)
    q, k, v = t(B, S, HQ, D), t(B, Sk, KH, D), t(B, Sk, KH, D)
    do = t(B, S, HQ, D)
    return q, k, v, do


def _check_bwd(q, k, v, do, causal):
    """The kernel's (dq, dk, dv), from the forward kernel's L, against the
    plain backward: returns the errors; asserts the limits of the module
    docstring."""
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    before = flash_attention.bwd_launches
    got = flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    again = flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    torch.cuda.synchronize()
    assert flash_attention.bwd_launches == before + 2
    group = q.shape[2] // k.shape[2]
    want = attention_bwd_ref(q, k, v, o, do, group=group, causal=causal)
    if q.dtype == torch.float32:
        want64 = attention_bwd_ref(q, k, v, o, do, group=group,
                                   causal=causal, dtype=torch.float64)
    else:
        oracle = attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                                   group=group, causal=causal,
                                   dtype=torch.float64)
        floor = attention_bwd_ref(q, k, v, o, do, group=group, causal=causal,
                                  dtype=torch.float64,
                                  operands=torch.bfloat16)
    errs = []
    for i, (a, a2, w, name) in enumerate(zip(got, again, want,
                                             ("dq", "dk", "dv"))):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(a, a2), name
        err = (a.float() - w.float()).abs().max().item()
        if q.dtype == torch.bfloat16:
            limit = 2.0 ** -6 * w.float().abs().max().item()
            assert err <= limit, (name, err, limit)
            w64 = oracle[i]
            e_k = _row_norms(a.double() - w64)
            norms = _row_norms(w64)
            lim = 4 * _row_norms(floor[i].double() - w64) \
                + 2.0 ** -10 * norms[norms > 0].median()
            r = int(torch.argmax(e_k / lim))
            assert (e_k <= lim).all(), (name, r, e_k[r].item(), lim[r].item())
        else:
            w64 = want64[i].double()
            e64 = (a.double() - w64).abs().max().item()
            base = (w.double() - w64).abs().max().item()
            limit = max(4 * base, 1e-6 * w64.abs().max().item())
            assert e64 <= limit, (name, e64, base, limit)
        errs.append(err)
    return errs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_flash_bwd_kernel_matches_plain(cuda_dev, case, dtype):
    B, S, Sk, HQ, KH, D, causal = case
    q, k, v, do = _bwd_operands(cuda_dev, dtype, B, S, Sk, HQ, KH, D,
                                S + Sk + D)
    _check_bwd(q, k, v, do, causal)
    if S > Sk and causal:
        # the rows that see no key have zero gradient
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        dq = flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)[0]
        assert not dq[:, :S - Sk].float().abs().any()


#: head dims the tensor-core kernels do not take as they are: D 20, 80
#: and 100 zero-padded by the op (to 32, 80 and 112 in bfloat16; 20, 80 and
#: 100 need none in float32), D 136 (padded to 144 in bfloat16), 160, 200
#: and 256 on the wide kernels (flash_wide.cu), D 320, 512 and 576 on them
#: with the output in slices (above 512 the bf16 forward streams Q too),
#: causal with Sk < S (rows that see no key), GQA groups 1, 2 and 4,
#: ragged tiles
FLASH_ANY_D_CASES = [
    (1, 64, 64, 4, 2, 20, True),
    (1, 96, 96, 4, 2, 80, False),
    (2, 70, 50, 4, 1, 100, True),
    (1, 77, 77, 8, 4, 136, False),
    (2, 70, 40, 8, 2, 136, True),
    (1, 96, 96, 4, 2, 160, True),
    (1, 150, 100, 8, 2, 256, True),
    (2, 70, 90, 4, 4, 200, False),
    (1, 130, 130, 8, 2, 256, True),
    (2, 70, 50, 4, 2, 320, True),
    (1, 96, 96, 4, 4, 320, False),
    (1, 130, 130, 4, 2, 512, True),
    (2, 40, 60, 4, 1, 512, False),
    (1, 70, 70, 4, 2, 576, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_ANY_D_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_flash_any_head_dim_matches_plain(cuda_dev, case, dtype):
    """Forward and backward at head dims the tensor-core kernels do not
    take as they are against the plain versions, under the limits of the
    kernels they route to."""
    B, S, Sk, HQ, KH, D, causal = case
    q, k, v, do = _bwd_operands(cuda_dev, dtype, B, S, Sk, HQ, KH, D,
                                S + Sk + D)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert got.shape == want.shape and torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    limit = 1e-5 if dtype == torch.float32 else \
        2.0 ** -6 * want.float().abs().max().item()
    assert err <= limit, (err, limit)
    _check_bwd(q, k, v, do, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_flash_forward_writes_its_lse(cuda_dev, case, dtype):
    """The forward kernel's output is bitwise the same with and without L,
    and its L is the plain L (+inf on the rows that see no key)."""
    B, S, Sk, HQ, KH, D, causal = case
    q, k, v, _ = _bwd_operands(cuda_dev, dtype, B, S, Sk, HQ, KH, D,
                               S + Sk + D + 1)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    out_l, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert torch.equal(out, out_l)
    assert lse.shape == (B, HQ, S) and lse.dtype == torch.float32
    want = attention_lse_ref(q, k, group=HQ // KH, causal=causal)
    inf = torch.isinf(want)
    assert torch.equal(inf, torch.isinf(lse)) and bool((lse[inf] > 0).all())
    tol = 1e-5 if dtype == torch.float32 else 2e-5
    err = (lse[~inf] - want[~inf]).abs().max().item() if (~inf).any() else 0
    assert err <= tol * max(1.0, want[~inf].abs().max().item()), err


@pytest.mark.cuda
def test_flash_bwd_f32_long_sums_stay_float32(cuda_dev):
    """v = 1 + N(0, 1) over 8192 keys: a one-signed error from sums chained
    on the tensor cores would grow with the keys."""
    q, k, v, do = _bwd_operands(cuda_dev, torch.float32, 1, 16, 8192, 4, 4,
                                64, 5)
    v = v + 1.0
    _check_bwd(q, k, v, do, False)


@pytest.mark.cuda
def test_flash_bwd_needs_the_forward_lse(cuda_dev):
    """On the card the backward takes L from the forward: without it, it
    raises before any launch."""
    q, k, v, do = _bwd_operands(cuda_dev, torch.bfloat16, 1, 64, 64, 4, 2,
                                64, 6)
    o = flash_attention(q, k, v, causal=True)
    before = flash_attention.bwd_launches
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_bwd(q, k, v, o, do, causal=True)
    assert flash_attention.bwd_launches == before


@pytest.mark.cuda
def test_flash_bwd_through_autograd(cuda_dev):
    """A loss through the op on CUDA tensors passes the kernel's gradient
    to q, k and v: the Function launches the backward once."""
    q, k, v, do = _bwd_operands(cuda_dev, torch.bfloat16, 2, 128, 128, 8, 2,
                                128, 11)
    for t in (q, k, v):
        t.requires_grad_(True)
    before = (flash_attention.launches, flash_attention.bwd_launches)
    out = flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert (flash_attention.launches, flash_attention.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    _, lse = flash_attention_fwd(q.detach(), k.detach(), v.detach(),
                                 causal=True)
    want = flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                               out.detach(), do, causal=True, lse=lse)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("S, Sk", [(0, 16), (16, 0)], ids=["S0", "Sk0"])
def test_flash_empty_operands_count_no_launch(cuda_dev, S, Sk):
    """An empty operand launches no kernel and counts none: the forward's
    output is empty at S 0, the backward's gradients are zeros at S or Sk
    0 (the forward kernel refuses Sk 0, so o is given there)."""
    q, _, _, do = _bwd_operands(cuda_dev, torch.bfloat16, 1, S, S, 4, 2,
                                64, 13)
    _, k, v, _ = _bwd_operands(cuda_dev, torch.bfloat16, 1, Sk, Sk, 4, 2,
                               64, 14)
    before = (flash_attention.launches, flash_attention.bwd_launches)
    o = flash_attention(q, k, v, causal=False) if S == 0 \
        else torch.zeros_like(q)
    lse = torch.zeros((1, 4, S), device=cuda_dev)
    grads = flash_attention_bwd(q, k, v, o, do, causal=False, lse=lse)
    torch.cuda.synchronize()
    assert not any(g.float().abs().any() for g in grads)
    assert flash_attention.bwd_launches == before[1]
    if S == 0:
        assert flash_attention.launches == before[0]


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["D0", "lse", "mixed", "f16"])
def test_flash_bwd_out_of_range_raises(cuda_dev, what):
    """A D the forward does not take (D 0: every D from 1 runs,
    zero-padded and on the tensor-core or the wide kernels), an L of
    another shape, mixed dtypes and float16 raise before any launch."""
    D = 0 if what == "D0" else 64
    dt = torch.float16 if what == "f16" else torch.bfloat16
    q, k, v, do = _bwd_operands(cuda_dev, torch.float32, 1, 16, 16, 2, 2, D,
                                3)
    q, do = q.to(dt), do.to(dt)
    if what != "mixed":
        k, v = k.to(dt), v.to(dt)
    lse = torch.zeros((1, 2, 15 if what == "lse" else 16), device=cuda_dev)
    before = flash_attention.bwd_launches
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, do, do, causal=True, lse=lse)
    assert flash_attention.bwd_launches == before


def _grad_refusal_cases(dev):
    """(op name, a call whose float operand requires grad) for every op
    whose kernel has no backward."""
    f = dict(device=dev, requires_grad=True)
    i8 = dict(dtype=torch.int8, device=dev)
    a = torch.ones((4, 32), **i8)
    w = torch.ones((16, 32), **i8).t()      # (K, N), as the LM stores it
    scale = torch.ones(16, **f)
    x = torch.randn((4, 32), **f)
    q = torch.randn((1, 1, 2, 64), **f)
    kv = torch.randn((1, 8, 2, 64), device=dev)
    fdst = torch.randn((8, 8), **f)
    return {
        "vta_gemm": lambda: vta_gemm(a, w, None, scale, epilogue="dequant"),
        "quantized_linear": lambda: quantized_linear(x, w, scale),
        # integer operands cannot require grad: a float one is refused
        "lut_gemm": lambda: lut_gemm(fdst, w, bits=4),
        "tensor_alu": lambda: tensor_alu(fdst, chain=(("add", 1),)),
        "decode_attention": lambda: decode_attention(q, kv, kv, 8),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["vta_gemm", "quantized_linear", "lut_gemm",
                                "tensor_alu", "decode_attention"])
def test_kernel_without_backward_refuses_grad(cuda_dev, op):
    """On the card, an op whose kernel has no backward raises where an
    operand requires grad (it never returns a result that drops the
    gradient), launches nothing, and runs as before under no_grad."""
    call = _grad_refusal_cases(cuda_dev)[op]
    fn = {"vta_gemm": vta_gemm, "quantized_linear": quantized_linear,
          "lut_gemm": lut_gemm, "tensor_alu": tensor_alu,
          "decode_attention": decode_attention}[op]
    before = getattr(fn, "launches", 0)
    with pytest.raises(ValueError, match="no backward kernel"):
        call()
    assert getattr(fn, "launches", 0) == before
    if op not in ("lut_gemm", "tensor_alu"):
        with torch.no_grad():
            call()
