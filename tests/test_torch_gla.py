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
from repro_torch.kernels.gla_chunk.kernel import (MAX_N, SMEM_MAX,
                                                 gla_chunk_cuda, gla_plan)

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
    # meta tensors (the dry run): the card's output shapes, no launch
    before = gla_chunk.launches
    y, h = gla_chunk(*(t.to("meta") for t in (q, k, v, la)))
    assert y.is_meta and y.shape == v.shape and h.shape == h0.shape
    assert gla_chunk.launches == before
    with pytest.raises(ValueError, match="different devices"):
        gla_chunk(q, k, v.to("meta"), la)


@pytest.mark.parametrize("bad", ["N", "v_dtype", "q_dtype", "tile",
                                 "stride"])
def test_the_kernel_wrapper_refuses_what_it_has_no_instance_for(bad):
    """The wrapper's checks run before anything is built or launched, so
    they are held here on CPU tensors: each raises, never falls back."""
    N = 264 if bad == "N" else 16
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


def bf16_rounded(x):
    """x rounded to bfloat16 and back, as numpy float32."""
    return torch.from_numpy(x).bfloat16().float().numpy()


# (B, S, H, N, P, chunk): xlstm-1.3b's mLSTM scan (N 256, P 1025 with the
# denominator channel, chunk 512) and state widths that are not a
# multiple of 4 or of 8
WIDE_SHAPES = [(1, 1024, 2, 256, 1025, 512), (1, 128, 2, 72, 40, 64),
               (2, 64, 3, 1, 8, 32)]


@pytest.mark.parametrize("qk", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", WIDE_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_op_at_the_widths_the_kernel_now_takes(shape, qk):
    """The plain op against the reference's Pallas kernel (interpret) and
    its jnp oracle at N up to 256 and N not a multiple of 4, nonzero h0,
    k scaled by 1/sqrt(N) as the mLSTM does (src/repro/models/xlstm.py);
    bfloat16 q and k are upcast exactly, so the reference gets the upcast
    values and y is asked for in float32."""
    B, S, H, N, P, chunk = shape
    q, k, v, la, h0 = inputs(B, S, H, N, P, seed=21)
    k = (k / np.sqrt(N)).astype(np.float32)   # as the mLSTM scales k
    if qk == "bfloat16":
        q, k = bf16_rounded(q), bf16_rounded(k)
    tq, tk, tv, tla, th = torch_args(q, k, v, la, h0)
    y, h = gla_chunk(tq.to(getattr(torch, qk)), tk.to(getattr(torch, qk)),
                     tv, tla, th, chunk=chunk, y_dtype=torch.float32)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, N, P)
    for use_pallas in (True, False):
        yw, hw = r_gla_chunk(*jax_args(q, k, v, la, h0), chunk=chunk,
                             use_pallas=use_pallas, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(yw), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(hw), **TOL)


@pytest.mark.parametrize("P", [1, 32, 64, 1025])
@pytest.mark.parametrize("qk", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_the_plan_fits_every_width(qk, P):
    """gla_plan over N 1..256 and chunks of 16 to 512 rows: shared memory
    within the card's 227 KB, N padded to a multiple of 8, slices of P
    that cover P with the last one ragged, tiles the kernel takes."""
    for N in range(1, MAX_N + 1):
        for Q in (1, 16, 64, 512):
            pl = gla_plan(1, 4, N, P, min(Q, 64), qk)
            assert pl.smem_bytes <= SMEM_MAX, (N, P, Q, pl)
            assert pl.n_pad % 8 == 0 and N <= pl.n_pad < N + 8
            assert pl.p_block in (16, 32, 64) and pl.stages in (1, 2, 3)
            assert (pl.p_slices - 1) * pl.p_block < P <= \
                pl.p_slices * pl.p_block
            assert pl.tile in (16, 32, 64) and pl.tile < 2 * max(Q, 16)
            assert pl.grid == (4, pl.p_slices)
    with pytest.raises(ValueError, match="N from 1 to 256"):
        gla_plan(1, 4, MAX_N + 1, P, 64, qk)
    with pytest.raises(ValueError, match="N from 1 to 256"):
        gla_plan(1, 4, 0, P, 64, qk)


def test_the_plan_fills_the_card_at_the_served_shapes():
    """zamba2's prefill (64 heads, P 64) in slices of 32 columns: 128
    blocks, a ring of three stages; xlstm's 4 heads of P 1025 in 33 slices
    of 32: 132 blocks, one per SM, two stages; both in 64-row tiles."""
    z = gla_plan(1, 64, 64, 64, 64, torch.float32)
    assert (z.tile, z.p_block, z.stages, z.grid) == (64, 32, 3, (64, 2))
    x = gla_plan(1, 4, 256, 1025, 64, torch.bfloat16)
    assert (x.tile, x.p_block, x.stages, x.grid) == (64, 32, 2, (4, 33))
    assert gla_plan(1, 64, 64, 64, 16, torch.float32).tile == 16


def _tf32(x):
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, to nearest
    with ties away from zero."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_cut(x):
    """float32 as the tensor cores read it for a TF32 operand: the low 13
    mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(a, b, exact_a, exact_b, passes):
    """a @ b as the kernel's tensor cores form it: 3xTF32, hi = x rounded
    to TF32 and lo = x - hi (which the tensor cores truncate), hi_a hi_b
    plus lo_a hi_b + hi_a lo_b, each product summed in float32 on its own
    and the two small ones added to the big one at the end (a bfloat16
    operand is exact in TF32 and has no lo half); or, with passes=1, one
    TF32 product."""
    ah = a if exact_a else _tf32(a)
    bh = b if exact_b else _tf32(b)
    if passes == 1:
        return ah @ bh
    s1 = _tf32_cut(a - ah) @ bh if not exact_a else torch.zeros(())
    s2 = ah @ _tf32_cut(b - bh) if not exact_b else torch.zeros(())
    return ah @ bh + (s1 + s2)


def kernel_model(q, k, v, la, h0, tile, exact_qk, passes=3):
    """A CPU model of the kernel's arithmetic over (BH, S, .) float32
    tensors: the scan in tiles of `tile` rows (zero-filled past S), per
    tile the cumsum of la in float32, the masked score tile, y = exp(L)
    (q h) + W v and h <- exp(L_tot) h + (k exp(L_tot - L))ᵀ v, each product
    through _mm."""
    BH, S, N = q.shape
    P = v.shape[-1]
    h = h0.clone()
    causal = torch.ones((tile, tile), dtype=torch.bool).tril()
    ys = []
    for s0 in range(0, S, tile):
        n = min(tile, S - s0)

        def part(x):
            out = x.new_zeros((BH, tile) + x.shape[2:])
            out[:, :n] = x[:, s0:s0 + n]
            return out
        qt, kt, vt, lt = part(q), part(k), part(v), part(la)
        L = torch.cumsum(lt, dim=1)
        Lt = L[:, -1:]
        d = L[:, :, None] - L[:, None, :]
        W = torch.where(causal, _mm(qt, kt.transpose(1, 2), exact_qk,
                                    exact_qk, passes)
                        * torch.exp(torch.where(causal, d, 0.0)), 0.0)
        y = torch.exp(L)[..., None] * _mm(qt, h, exact_qk, False, passes) \
            + _mm(W, vt, False, False, passes)
        ks = kt * torch.exp(Lt - L)[..., None]
        h = torch.exp(Lt)[..., None] * h \
            + _mm(ks.transpose(1, 2), vt, False, False, passes)
        ys.append(y[:, :n])
    return torch.cat(ys, dim=1), h


def _model_case(B, S, H, N, P, chunk, qk):
    """Inputs in the op's layout, the op's plain output, and the kernel
    model's and the float64 recurrence's in the (BH, S, .) layout."""
    q, k, v, la, h0 = torch_args(*inputs(B, S, H, N, P, seed=22))
    dt = getattr(torch, qk)
    q, k = q.to(dt).float(), k.to(dt).float()
    y, h = gla_chunk(q, k, v, la, h0, chunk=chunk)
    to_bh = lambda t: t.transpose(1, 2).reshape(B * H, S, -1)  # noqa
    args = (to_bh(q), to_bh(k), to_bh(v), to_bh(la[..., None])[..., 0],
            h0.reshape(B * H, N, P))
    y64, h64 = gla_recurrence(*(a[:, None] if a.dim() < 3 or i < 4 else a
                                for i, a in enumerate(args)),
                              dtype=torch.float64)
    plain = (to_bh(y), h.reshape(B * H, N, P))
    tile = gla_plan(B, H, N, P, min(chunk, S, 64), dt).tile
    return args, tile, plain, (y64[:, 0], h64)


def _err(got, want):
    return max(float((g.double() - w).abs().max()) for g, w in
               zip(got, want))


# zamba2-1.2b's scan (N = P = 64, chunk 64) and xlstm-1.3b's (N 256,
# chunk 512; P cut from 1025 to 129 for time)
MODEL_SHAPES = [(1, 512, 2, 64, 64, 64), (1, 1024, 1, 256, 129, 512)]


@pytest.mark.parametrize("qk", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_the_kernels_3xtf32_arithmetic_is_as_accurate_as_float32(shape,
                                                                  qk):
    """The kernel model against the float64 recurrence: within 4x the
    plain float32 version's own error, and within the kernel's limit of
    3e-4 + 3e-4 |plain| of the plain version."""
    args, tile, plain, exact = _model_case(*shape, qk)
    got = kernel_model(*args, tile, qk == "bfloat16")
    e_plain = _err(plain, exact)
    assert _err(got, exact) <= 4 * e_plain, (_err(got, exact), e_plain)
    for g, w in zip(got, plain):
        assert bool(((g - w).abs() <= 3e-4 + 3e-4 * w.abs()).all())


def test_one_tf32_pass_would_fail_that_check():
    """The same check refuses one TF32 product per operand pair: the float64
    check can tell the precision the kernel needs from what it must not
    use."""
    args, tile, plain, exact = _model_case(*MODEL_SHAPES[0], "float32")
    got = kernel_model(*args, tile, False, passes=1)
    assert _err(got, exact) > 4 * _err(plain, exact)
