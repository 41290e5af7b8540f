"""The port's gla_chunk op (its plain version, on the CPU) against the
reference's Pallas kernel (interpret mode), the reference's jnp oracle and
the step-by-step recurrence.

Inputs are made with numpy from a seed, as in the reference's own kernel
tests (``tests/test_kernels.py``).  Tolerance: 3e-4 absolute and relative,
the reference's own limit for its kernel against its oracle (float32 sums
in another order; the two agree to about 1e-6 of max|y| here).  A
bfloat16 q and k are upcast exactly, so they give the float32 result of
the upcast values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gla_chunk import gla_chunk as r_gla_chunk
from repro.kernels.gla_chunk import gla_chunk_pallas, gla_chunk_ref as r_ref
from repro.models.ssm import gla_step as r_gla_step
from repro_torch.kernels.gla_chunk import (gla_chunk, gla_chunk_plain,
                                           gla_chunk_ref, gla_recurrence)
from repro_torch.kernels.gla_chunk.kernel import gla_chunk_cuda

TOL = dict(atol=3e-4, rtol=3e-4)

# (B, S, H, N, P, chunk): the reference's kernel-test shapes, then Q < 64
# (a 16-token prompt: Q = min(64, 16) = 16) and zamba2's N = P = 64
SHAPES = [(2, 256, 3, 32, 32, 64), (1, 512, 2, 64, 64, 128),
          (2, 128, 4, 16, 48, 32), (1, 16, 2, 64, 64, 64)]


def inputs(B, S, H, N, P, seed=11, h0=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, N)).astype(np.float32)
    k = rng.normal(size=(B, S, H, N)).astype(np.float32)
    v = rng.normal(size=(B, S, H, P)).astype(np.float32)
    la = (-np.abs(rng.normal(size=(B, S, H))) * 0.3).astype(np.float32)
    h = (rng.normal(size=(B, H, N, P)) * 0.1).astype(np.float32) if h0 \
        else None
    return q, k, v, la, h


def torch_args(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def jax_args(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_op_matches_pallas_and_the_jnp_oracle(shape):
    B, S, H, N, P, chunk = shape
    x = inputs(B, S, H, N, P)
    y, h = gla_chunk(*torch_args(*x), chunk=chunk)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert y.shape == (B, S, H, P) and h.shape == (B, H, N, P)
    for use_pallas in (True, False):
        yw, hw = r_gla_chunk(*jax_args(*x), chunk=chunk,
                             use_pallas=use_pallas, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(yw), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(hw), **TOL)


@pytest.mark.parametrize("shape", [(6, 4, 16, 32, 48), (2, 1, 64, 64, 64)],
                         ids=lambda s: "-".join(map(str, s)))
def test_kernel_layout_ref_matches_gla_chunk_pallas(shape):
    """gla_chunk_ref takes gla_chunk_pallas's own layout and signature."""
    BH, nc, Q, N, P = shape
    rng = np.random.default_rng(13)
    q, k = (rng.normal(size=(BH, nc, Q, N)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(BH, nc, Q, P)).astype(np.float32)
    la = (-np.abs(rng.normal(size=(BH, nc, Q))) * 0.3).astype(np.float32)
    h0 = (rng.normal(size=(BH, N, P)) * 0.1).astype(np.float32)
    y, h = gla_chunk_ref(*torch_args(q, k, v, la, h0))
    for fn, kw in ((gla_chunk_pallas, {"interpret": True}), (r_ref, {})):
        yw, hw = fn(*jax_args(q, k, v, la, h0), **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(yw), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(hw), **TOL)


@pytest.mark.parametrize("h0", [False, True], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("chunk", [16, 64])
def test_op_matches_the_step_recurrence(chunk, h0):
    """Against the port's step recurrence and the reference's gla_step
    loop: oracles independent of the chunking."""
    B, S, H, N, P = 1, 64, 2, 8, 16
    x = inputs(B, S, H, N, P, seed=12, h0=h0)
    q, k, v, la, hh = torch_args(*x)
    y, h = gla_chunk(q, k, v, la, hh, chunk=chunk)
    to_bh = lambda t: t.transpose(1, 2).reshape(B * H, 1, S, -1)  # noqa
    h_init = torch.zeros(B * H, N, P) if hh is None else \
        hh.reshape(B * H, N, P)
    yr, hr = gla_recurrence(to_bh(q), to_bh(k), to_bh(v),
                            la.transpose(1, 2).reshape(B * H, 1, S), h_init)
    np.testing.assert_allclose(
        y.numpy(), yr.reshape(B, H, S, P).transpose(1, 2).numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), hr.reshape(B, H, N, P).numpy(),
                               **TOL)
    jq, jk, jv, jla = jax_args(*x[:4])
    hj = jnp.zeros((B, H, N, P)) if hh is None else jnp.asarray(x[4])
    ys = []
    for t in range(S):
        hj, yt = r_gla_step(hj, jq[:, t], jk[:, t], jv[:, t],
                            jnp.exp(jla[:, t]))
        ys.append(yt)
    np.testing.assert_allclose(y.numpy(), np.asarray(jnp.stack(ys, 1)), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **TOL)


def test_bfloat16_q_and_k_and_the_output_dtype():
    """q and k in bfloat16 are upcast exactly: y equals the float32 result
    on the upcast values; y comes back in q's dtype unless asked."""
    q, k, v, la, h0 = torch_args(*inputs(1, 128, 2, 32, 32, seed=14))
    qb, kb = q.bfloat16(), k.bfloat16()
    y32, h32 = gla_chunk(qb.float(), kb.float(), v, la, h0, chunk=64)
    y, h = gla_chunk(qb, kb, v, la, h0, chunk=64)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert torch.equal(y, y32.bfloat16()) and torch.equal(h, h32)
    yf, _ = gla_chunk(qb, kb, v, la, h0, chunk=64, y_dtype=torch.float32)
    assert yf.dtype == torch.float32 and torch.equal(yf, y32)


def test_heads_broadcast_by_stride_zero():
    """Mamba2 broadcasts one q and k row over heads: a stride-0 view gives
    the result of the materialized copy."""
    B, S, H, N, P = 2, 64, 4, 16, 16
    rng = np.random.default_rng(15)
    c = torch.from_numpy(rng.normal(size=(B, S, N)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(B, S, N)).astype(np.float32))
    _, _, v, la, h0 = torch_args(*inputs(B, S, H, N, P, seed=16))
    q = c[:, :, None].expand(B, S, H, N)
    k = b[:, :, None].expand(B, S, H, N)
    assert q.stride(2) == 0
    y, h = gla_chunk(q, k, v, la, h0, chunk=32)
    y2, h2 = gla_chunk(q.contiguous(), k.contiguous(), v, la, h0, chunk=32)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.parametrize("S,chunk", [(40, 32), (100, 64), (0, 64)])
def test_the_chunk_rule_raises_where_the_reference_does(S, chunk):
    x = inputs(1, S, 2, 8, 8, h0=False)
    with pytest.raises((AssertionError, ZeroDivisionError)):
        r_gla_chunk(*jax_args(*x), chunk=chunk)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        gla_chunk(*torch_args(*x), chunk=chunk)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        gla_chunk_plain(*torch_args(*x), chunk=chunk)


def test_a_chunk_longer_than_the_sequence_is_the_sequence():
    x = torch_args(*inputs(1, 48, 2, 8, 8, seed=17))
    y, h = gla_chunk(*x, chunk=64)          # Q = min(64, 48) = 48
    y2, h2 = gla_chunk(*x, chunk=48)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_shapes_and_devices_are_checked():
    q, k, v, la, h0 = torch_args(*inputs(1, 16, 2, 8, 8))
    with pytest.raises(ValueError, match="shapes"):
        gla_chunk(q, k[:, :, :1], v, la)
    with pytest.raises(ValueError, match="shapes"):
        gla_chunk(q, k, v, la, h0[:, :1])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        gla_chunk(*(t.to("meta") for t in (q, k, v, la)))
    with pytest.raises(ValueError, match="different devices"):
        gla_chunk(q, k, v.to("meta"), la)


@pytest.mark.parametrize("bad", ["N", "v_dtype", "q_dtype", "tile",
                                 "stride"])
def test_the_kernel_wrapper_refuses_what_it_has_no_instance_for(bad):
    """The wrapper's checks run before anything is built or launched, so
    they are held here on CPU tensors: each raises, never falls back."""
    N = 72 if bad == "N" else 16
    q, k, v, la, h0 = torch_args(*inputs(1, 16, 2, N, 8))
    tile = 16
    if bad == "v_dtype":
        v = v.bfloat16()
    elif bad == "q_dtype":
        q, k = q.half(), k.half()
    elif bad == "tile":
        tile = 128
    elif bad == "stride":
        q = torch.from_numpy(np.zeros((1, 16, 2, 18), np.float32))[..., 1:17]
    with pytest.raises((TypeError, ValueError)):
        gla_chunk_cuda(q, k, v, la, h0, tile, torch.float32)
