"""The gradient of the port's flash_attention against the reference.

On CPU tensors the op's backward is the plain ``attention_bwd_ref``
(FlashAttention-2's formulas in float32, written out; the CUDA kernel is
held against it on the card, ``tests/test_torch_cuda.py``).  Here:

  * ``attention_bwd_ref`` against ``torch.autograd`` of the port's plain
    forward (``flash_attention_plain``), in float64: within 1e-5 of
    max|grad| (the plain forward computes in float32, so autograd through
    it carries float32 roundings); its chunked form (keys in blocks)
    against the whole one: within 1e-5 of max|grad|;
  * ``attention_bwd_ref`` against ``jax.grad`` of the reference's
    ``flash_attention(use_pallas=False)`` on the same float32 inputs:
    within 2e-5 of max|grad| (sums in another order); bfloat16 inputs:
    within 2^-7 of max|grad| (both sides compute in float32 and round
    the result once to bfloat16: one ulp at the top of the range either
    way).  Rows that see no key are left out of this comparison: the
    reference's materialized oracle gives them the mean of v (softmax
    over a row of -1e30) where the port's forward gives zeros, and so
    the gradients differ there by design;
  * a row that sees no key has zero gradient in the port;
  * ``operands=torch.bfloat16`` (the bf16 kernel's rounding of P and dS,
    the floor of the card's row-by-row check) moves each gradient by no
    more than the bound that rounding gives: 2^-8 of the sum of the
    magnitudes of its terms (rounding to nearest, 2^-9, with room for
    the float64 sums), and the default leaves the result as it was;
  * the op inside ``torch.autograd`` on CPU tensors (the Function) gives
    attention_bwd_ref's gradients bitwise, and its forward the plain
    version's; no kernel launch is counted on the CPU;
  * the forward's log-sum-exp L (what the kernels save for the backward,
    ``flash_attention_fwd``; on the CPU ``attention_lse_ref``) against
    ``jax.nn.logsumexp`` of the reference's scaled scores with its
    bottom-right mask: within 1e-6 of max|L| in float32 (sums in another
    order); +inf on rows that see no key, where the reference gives
    -inf; the Function saves it, and the plain backward given it is the
    one that recomputes it, bitwise;
  * the backward's instance check (``kernel.flash_bwd_plan``) takes
    exactly the D the forward takes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as r_flash
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_lse_ref,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention.kernel import (flash_bwd_plan,
                                                        flash_f32_plan,
                                                        wgmma_plan)

CASES = [
    # (B, S, Sk, HQ, KH, D, causal)
    (2, 24, 24, 4, 4, 16, True),        # MHA
    (2, 24, 24, 8, 2, 64, True),        # GQA 4:1
    (1, 20, 20, 4, 1, 96, False),       # MQA, D 96, non-causal
    (1, 12, 30, 6, 2, 16, True),        # Sk > S (a cache prefix)
    (1, 30, 12, 4, 2, 64, True),        # Sk < S: rows that see no key
    (2, 9, 17, 4, 2, 16, False),        # cross-attention kind
]


def _inputs(seed, B, S, Sk, HQ, KH, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, HQ, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KH, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KH, D)).astype(np.float32),
            rng.normal(size=(B, S, HQ, D)).astype(np.float32))


def _ids(c):
    return "-".join(str(x) for x in c)


def _seen_rows(S, Sk, causal):
    """Rows that see at least one key."""
    return slice(max(0, S - Sk) if causal else 0, S)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_bwd_ref_matches_autograd_of_plain_forward(case):
    B, S, Sk, HQ, KH, D, causal = case
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in _inputs(1, B, S, Sk, HQ, KH, D))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = flash_attention_plain(qg, kg, vg, causal=causal)
    want = torch.autograd.grad(o, (qg, kg, vg), do)
    got = attention_bwd_ref(q, k, v, o.detach(), do, group=HQ // KH,
                            causal=causal, dtype=torch.float64)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    # the chunked form (blocks of 5 keys, the last one shorter)
    chunked = attention_bwd_ref(q, k, v, o.detach(), do, group=HQ // KH,
                                causal=causal, bk=5, dtype=torch.float64)
    for a, b in zip(chunked, got):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("lse", ["recomputed", "given"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_bwd_ref_matches_reference_grad(case, dtype, lse):
    """The plain backward, recomputing L or given the forward's L (as the
    Function gives it), against jax.grad of the reference."""
    B, S, Sk, HQ, KH, D, causal = case
    qn, kn, vn, don = _inputs(2, B, S, Sk, HQ, KH, D)
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (qn, kn, vn, don))

    def loss(q, k, v):
        o = r_flash(q, k, v, causal=causal, use_pallas=False)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    want = [np.asarray(w.astype(jnp.float32)) for w in want]

    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in (qn, kn, vn, don))
    o, L = flash_attention_fwd(q, k, v, causal=causal)
    kw = dict(group=HQ // KH, causal=causal,
              lse=L if lse == "given" else None)
    got = attention_bwd_ref(q, k, v, o, do, **kw)
    rows = _seen_rows(S, Sk, causal)
    tol = 2e-5 if dtype == "float32" else 2.0 ** -7
    dq, dk, dv = (g.float().numpy() for g in got)
    if rows.start:
        # the reference's rows that see no key (the mean of v) would enter
        # its dk and dv: both sides take do = 0 on those rows, and dq is
        # compared on the rows that see keys
        don = don.copy()
        don[:, :rows.start] = 0.0
        jdo = jnp.asarray(don).astype(jdt)
        want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
        want = [np.asarray(w.astype(jnp.float32)) for w in want]
        do = torch.from_numpy(don).to(tdt)
        dq, dk, dv = (g.float().numpy() for g in attention_bwd_ref(
            q, k, v, o, do, **kw))
    for name, a, b in (("dq", dq[:, rows], want[0][:, rows]),
                       ("dk", dk, want[1]), ("dv", dv, want[2])):
        err = float(np.abs(a - b).max())
        assert err <= tol * float(np.abs(b).max()), (name, err)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_operand_rounding_is_bounded(case):
    B, S, Sk, HQ, KH, D, causal = case
    G = HQ // KH
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _inputs(7, B, S, Sk, HQ, KH, D))
    o = flash_attention_plain(q, k, v, causal=causal)
    exact = attention_bwd_ref(q, k, v, o, do, group=G, causal=causal,
                              dtype=torch.float64)
    assert all(torch.equal(a, b) for a, b in zip(exact, attention_bwd_ref(
        q, k, v, o, do, group=G, causal=causal, dtype=torch.float64,
        operands=None)))
    # unrounded float64 results, and P and dS materialized for the bound
    q64, k64, v64, o64, do64 = (t.double() for t in (q, k, v, o, do))
    want = attention_bwd_ref(q64, k64, v64, o64, do64, group=G,
                             causal=causal, dtype=torch.float64)
    got = attention_bwd_ref(q64, k64, v64, o64, do64, group=G,
                            causal=causal, dtype=torch.float64,
                            operands=torch.bfloat16)
    kr, vr = (t.repeat_interleave(G, dim=2) for t in (k64, v64))
    s = torch.einsum("bqhd,bkhd->bhqk", q64, kr) / D ** 0.5
    if causal:
        seen = torch.ones(S, Sk, dtype=torch.bool).tril(Sk - S)
        s = s.masked_fill(~seen, -torch.inf)
    p = torch.nan_to_num(torch.softmax(s, dim=-1))
    delta = (do64 * o64).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do64, vr) - delta)
    scale, u = D ** -0.5, 2.0 ** -8
    dq_b = u * scale * torch.einsum("bhqk,bkhd->bqhd", ds.abs(), kr.abs())
    dk_b = u * scale * torch.einsum("bhqk,bqhd->bkhd", ds.abs(), q64.abs())
    dv_b = u * torch.einsum("bhqk,bqhd->bkhd", p, do64.abs())
    group_sum = (lambda x: x.reshape(B, Sk, KH, G, D).sum(3))
    for name, a, w, bound in (("dq", got[0], want[0], dq_b),
                              ("dk", got[1], want[1], group_sum(dk_b)),
                              ("dv", got[2], want[2], group_sum(dv_b))):
        assert ((a - w).abs() <= bound + 1e-12).all(), name
    assert not all(torch.equal(a, w) for a, w in zip(got, want))


def test_rows_that_see_no_key_have_zero_gradient():
    B, S, Sk, HQ, KH, D = 1, 30, 12, 4, 2, 16
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(3, B, S, Sk, HQ, KH, D))
    o = flash_attention_plain(q, k, v, causal=True)
    dq, dk, dv = attention_bwd_ref(q, k, v, o, do, group=2, causal=True)
    assert not dq[:, :S - Sk].abs().any()
    # and a do on those rows alone moves nothing
    do0 = torch.zeros_like(do)
    do0[:, :S - Sk] = do[:, :S - Sk]
    for g in attention_bwd_ref(q, k, v, o, do0, group=2, causal=True):
        assert not g.abs().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_autograd_function_on_cpu(case, dtype):
    B, S, Sk, HQ, KH, D, causal = case
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(4, B, S, Sk, HQ, KH, D))
    launches = (flash_attention.launches, flash_attention.bwd_launches)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = flash_attention(qg, kg, vg, causal=causal)
    assert o.requires_grad and o.dtype == dtype
    assert torch.equal(o.detach(), flash_attention_plain(q, k, v,
                                                         causal=causal))
    # it saves q, k, v, the output and L
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5 and torch.equal(
        saved[4], attention_lse_ref(q, k, group=HQ // KH, causal=causal))
    got = torch.autograd.grad(o, (qg, kg, vg), do)
    want = attention_bwd_ref(q, k, v, o.detach(), do, group=HQ // KH,
                             causal=causal)
    same = flash_attention_bwd(q, k, v, o.detach(), do, causal=causal)
    for a, b, c in zip(got, want, same):
        assert a.dtype == dtype and torch.equal(a, b) and torch.equal(b, c)
    # only k requiring grad: q's gradient is not asked for
    kg2 = k.clone().requires_grad_(True)
    (dk,) = torch.autograd.grad(flash_attention(q, kg2, v, causal=causal),
                                (kg2,), do)
    assert torch.equal(dk, want[1])
    assert (flash_attention.launches, flash_attention.bwd_launches) == \
        launches


def test_no_grad_mode_skips_the_function():
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(True)
                  for a in _inputs(5, 1, 8, 8, 2, 2, 16))
    with torch.no_grad():
        o = flash_attention(q, k, v)
    assert not o.requires_grad and o.grad_fn is None
    o = flash_attention(q.detach(), k.detach(), v.detach())
    assert o.grad_fn is None


def test_backward_checks_its_operands():
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(6, 1, 8, 8, 4, 2, 16))
    o = flash_attention_plain(q, k, v)
    with pytest.raises(ValueError, match="must match"):
        flash_attention_bwd(q, k, v, o[:, :4], do)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention_bwd(q, k[:, :, :1].expand(1, 8, 3, 16), v, o, do)
    # a meta tensor (the dry run) takes the card's route: it needs L
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_bwd(*(t.to("meta") for t in (q, k, v, o, do)))


LSE_CASES = [
    # (B, S, Sk, HQ, KH, D, causal)
    (2, 24, 24, 4, 2, 16, True),
    (1, 12, 30, 6, 2, 16, True),        # Sk > S
    (1, 30, 12, 4, 2, 64, True),        # Sk < S: rows that see no key
    (2, 9, 17, 4, 2, 16, False),
    (1, 20, 7, 4, 4, 32, False),
]


@pytest.mark.parametrize("case", LSE_CASES, ids=_ids)
def test_forward_lse_matches_reference_logsumexp(case):
    B, S, Sk, HQ, KH, D, causal = case
    qn, kn, vn, _ = _inputs(8, B, S, Sk, HQ, KH, D)
    # the reference's scores, its mask aligned bottom-right
    kr = np.repeat(kn, HQ // KH, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(qn),
                   jnp.asarray(kr)) / (D ** 0.5)
    if causal:
        mask = jnp.tril(jnp.ones((S, Sk), bool), k=Sk - S)
        s = jnp.where(mask, s, -jnp.inf)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))        # (B, HQ, S)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    launches = flash_attention.launches
    out, got = flash_attention_fwd(q, k, v, causal=causal)
    assert flash_attention.launches == launches
    assert torch.equal(out, flash_attention_plain(q, k, v, causal=causal))
    assert got.shape == (B, HQ, S) and got.dtype == torch.float32
    got = got.numpy()
    none = np.isneginf(want)
    assert bool(none.any()) == (causal and Sk < S)
    assert np.all(np.isposinf(got[none]))
    top = float(np.abs(want[~none]).max())
    assert float(np.abs(got[~none] - want[~none]).max()) <= 1e-6 * top
    assert torch.equal(torch.from_numpy(got), attention_lse_ref(
        q, k, group=HQ // KH, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_backward_given_lse_is_bitwise_the_recomputed(case, dtype):
    B, S, Sk, HQ, KH, D, causal = case
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(9, B, S, Sk, HQ, KH, D))
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    given = flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    recomputed = flash_attention_bwd(q, k, v, o, do, causal=causal)
    for a, b in zip(given, recomputed):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse[:, :1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_takes_the_forward_head_dims(dtype):
    """flash_bwd_plan accepts a D exactly where the forward's plan does
    (wgmma_plan for bfloat16, flash_f32_plan for float32): D 80 in both,
    D 130 in neither (ValueError); bfloat16 D pads to 64 or 128, float32
    to a multiple of 32."""
    for D in range(1, 140):
        q = torch.zeros((1, 16, 2, D), dtype=dtype)
        try:
            if dtype == torch.bfloat16:
                wgmma_plan(q, q, q)
            else:
                flash_f32_plan(1, 16, 16, 2, 2, D, True)
            fwd = True
        except ValueError:
            fwd = False
        try:
            plan = flash_bwd_plan(D, dtype)
        except ValueError:
            plan = None
        assert (plan is not None) == fwd, D
        if plan is not None:
            assert plan.dp >= D and plan.dp in (
                (64, 128) if dtype == torch.bfloat16 else (32, 64, 96, 128))
    assert flash_bwd_plan(80, dtype).dp == (128 if dtype == torch.bfloat16
                                            else 96)
    with pytest.raises(ValueError):
        flash_bwd_plan(130, dtype)
