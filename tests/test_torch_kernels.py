"""The port's kernels against the reference's Pallas kernels.

On this machine the port's ops run their plain PyTorch versions (the
tensors lie on the CPU); the reference runs its Pallas kernels in
interpret mode and its jnp oracle.  Same seeded numpy inputs go to both.

Tolerance: 0 everywhere.  The int32 and int8 results are compared byte for
byte.  The "dequant" float32 results are compared byte for byte too: both
sides convert the exact int32 accumulator to float32 (one round to
nearest) and multiply by the same float32 scale (one more), so equal
inputs give equal bits.

The same cases run kernel against plain version on the card in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.tensor_alu.kernel import tensor_alu_pallas
from repro.kernels.tensor_alu.ref import tensor_alu_ref as r_alu_ref
from repro.kernels.vta_gemm import vta_gemm as r_vta_gemm
from repro.kernels.vta_gemm import vta_gemm_ref as r_gemm_ref
from repro_torch.kernels.tensor_alu import tensor_alu
from repro_torch.kernels.vta_gemm import vta_gemm
from torch_cases import EPILOGUES, SHAPES, alu_cases, gemm_inputs

@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("epilogue,shift", EPILOGUES)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_vta_gemm_plain_matches_pallas(M, K, N, epilogue, shift, use_bias):
    a, w, bias, scale = gemm_inputs(M, K, N, seed=M * 7 + N)
    b = bias if use_bias else None
    kw = dict(epilogue=epilogue, shift=shift)
    got = vta_gemm(torch.from_numpy(a), torch.from_numpy(w),
                   None if b is None else torch.from_numpy(b),
                   torch.from_numpy(scale), **kw).numpy()
    jb = None if b is None else jnp.asarray(b)
    pallas = np.asarray(r_vta_gemm(jnp.asarray(a), jnp.asarray(w), jb,
                                   jnp.asarray(scale), use_pallas=True,
                                   interpret=True, **kw))
    oracle = np.asarray(r_gemm_ref(jnp.asarray(a), jnp.asarray(w), jb,
                                   jnp.asarray(scale), **kw))
    assert got.dtype == pallas.dtype == oracle.dtype
    assert got.shape == pallas.shape == (M, N)
    assert got.tobytes() == pallas.tobytes()
    assert got.tobytes() == oracle.tobytes()


def test_vta_gemm_tile_axis_equals_per_tile_calls():
    """A leading tile axis is T independent GEMMs (the engine's batched
    launch); a transposed (N, K) weight view is read in place."""
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, size=(3, 20, 48), dtype=np.int8)
    w_nk = rng.integers(-128, 128, size=(3, 24, 48), dtype=np.int8)
    at, wt = torch.from_numpy(a), torch.from_numpy(w_nk).transpose(1, 2)
    got = vta_gemm(at, wt, epilogue="requant", shift=6)
    for t in range(3):
        want = np.asarray(r_gemm_ref(jnp.asarray(a[t]),
                                     jnp.asarray(w_nk[t].T),
                                     epilogue="requant", shift=6))
        assert got[t].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("case", alu_cases(), ids=lambda c: c[0])
def test_tensor_alu_plain_matches_pallas(case):
    _, dst, src, chain = case
    got = tensor_alu(torch.from_numpy(dst),
                     None if src is None else torch.from_numpy(src),
                     chain=chain).numpy()
    js = None if src is None else jnp.asarray(src)
    pallas = np.asarray(tensor_alu_pallas(jnp.asarray(dst), js, chain=chain,
                                          bm=dst.shape[0], interpret=True))
    oracle = np.asarray(r_alu_ref(jnp.asarray(dst), js, chain=chain))
    assert got.dtype == np.int32
    assert got.tobytes() == pallas.tobytes()
    assert got.tobytes() == oracle.tobytes()


def test_ops_dispatch_by_device():
    """A CPU tensor takes the plain version; a device that has no kernel
    raises; building needs nvcc, which this machine lacks."""
    a = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 4), dtype=torch.int8)
    assert vta_gemm(a, w).dtype == torch.int32
    with pytest.raises(ValueError):
        vta_gemm(a.to("meta"), w.to("meta"))
    with pytest.raises(ValueError):
        tensor_alu(torch.zeros(3, dtype=torch.int32).to("meta"),
                   chain=(("add", 1),))
    with pytest.raises(TypeError):
        vta_gemm(a.to(torch.int32), w)
