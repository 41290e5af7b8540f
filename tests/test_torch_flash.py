"""flash_attention in the port against the reference package.

On CPU tensors the port's op runs its plain versions (the CUDA kernel is
held against them on the card, in ``tests/test_torch_cuda.py``).  Here:

  * the port's ``flash_attention`` equals the reference's Pallas kernel
    (``flash_attention_pallas`` in interpret mode, blocks of 64 so the
    causal skip and the diagonal mask are exercised) and the reference's
    ``attention_ref`` at the MHA / GQA / MQA shapes of
    ``tests/test_kernels.py`` cut to S = 256, causal and not.  Tolerance:
    float32 2e-5 (absolute and relative; sums in another order),
    bfloat16 2e-2 (both sides round the float32 result to bfloat16 once);
  * ``attention_ref_chunked`` equals the reference's chunked oracle
    (2e-5), and the op switches to it above ``_CHUNKED_THRESHOLD`` score
    elements per head as the reference op does;
  * causal with Sk != S: the port aligns the diagonal bottom-right, as
    the reference's oracles do.  The reference's Pallas kernel masks
    q_pos >= k_pos from 0 on both axes and so differs from its own oracle
    there (S = 16, Sk = 32: by more than 1.0); the test shows both;
  * a row that sees no key (causal, Sk < S) gives zeros in the port,
    where the reference's materialized oracle gives the mean of v;
  * the float32 CUDA kernel's tiles (``flash_f32_plan``) and its 3xTF32
    arithmetic (``attention_tf32x3_model``): within 1e-5 of a float64
    oracle, about as close as the plain float32 version, at phase 7's
    float32 shapes cut down.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as r_flash
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import (
    attention_ref as r_attention_ref,
    attention_ref_chunked as r_attention_ref_chunked)
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 attention_ref_chunked,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention import ops as t_ops

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CASES = [
    # (B, S, HQ, KH, D): test_kernels.py's shapes at S = 256
    (1, 256, 4, 4, 64),     # MHA
    (2, 256, 8, 2, 64),     # GQA 4:1
    (1, 256, 4, 1, 128),    # MQA
]


def _inputs(seed, B, S, Sk, HQ, KH, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, HQ, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KH, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KH, D)).astype(np.float32))


def _heads(x):
    B, S, H, D = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, D)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", CASES, ids=["mha", "gqa", "mqa"])
def test_flash_matches_pallas_kernel_and_oracle(case, causal, dtype):
    B, S, HQ, KH, D = case
    q, k, v = _inputs(5, B, S, S, HQ, KH, D)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    got = flash_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                          causal=causal)
    assert got.dtype == td and got.shape == (B, S, HQ, D)
    pallas = r_flash(jq, jk, jv, causal=causal, use_pallas=True,
                     interpret=True, bq=64, bk=64)
    oracle = r_flash(jq, jk, jv, causal=causal, use_pallas=False)
    tol = TOL[dtype]
    for want in (pallas, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("S,Sk,bk", [(64, 64, 16), (48, 96, 32),
                                     (128, 128, 128)])
def test_chunked_matches_reference_chunked(S, Sk, bk, causal):
    q, k, v = _inputs(6, 2, S, Sk, 4, 2, 32)
    got = attention_ref_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                                group=2, causal=causal, bk=bk)
    want = r_attention_ref_chunked(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), group=2, causal=causal,
                                   bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    # the materialized and chunked forms agree with each other too
    flat = attention_ref(*(torch.from_numpy(_heads(a)) for a in (q, k, v)),
                         group=2, causal=causal)
    np.testing.assert_allclose(
        got.numpy(), flat.numpy().reshape(2, 4, S, 32).transpose(0, 2, 1, 3),
        atol=2e-5, rtol=2e-5)


def test_plain_version_switches_to_chunked_above_threshold(monkeypatch):
    """S * Sk above the threshold takes the chunked loop, as the reference
    op does; both give the reference op's result."""
    calls = []
    real = t_ops.attention_ref_chunked
    monkeypatch.setattr(t_ops, "attention_ref_chunked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    S = 2056                        # 2056^2 > 2048^2
    q, k, v = _inputs(7, 1, S, S, 2, 1, 16)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert calls == [1]
    want = r_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    small = flash_attention_plain(*(torch.from_numpy(a[:, :64])
                                    for a in (q, k, v)))
    assert calls == [1] and small.shape == (1, 64, 2, 16)


def test_causal_with_a_longer_key_range_aligns_bottom_right():
    """S = 16 queries over Sk = 32 keys (a cache prefix of 16): the port
    follows the reference's oracle; the reference's Pallas kernel masks
    from 0 on both axes and differs from that oracle by more than 1."""
    q, k, v = _inputs(11, 1, 16, 32, 2, 2, 64)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True)
    oracle = r_attention_ref(*(jnp.asarray(_heads(a)) for a in (q, k, v)),
                             group=1, causal=True)
    oracle = np.asarray(oracle).reshape(1, 2, 16, 64).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), oracle, atol=2e-5, rtol=2e-5)
    pallas = flash_attention_pallas(
        *(jnp.asarray(_heads(a)) for a in (q, k, v)), group=1, causal=True,
        bq=16, bk=16, interpret=True)
    pallas = np.asarray(pallas).reshape(1, 2, 16, 64).transpose(0, 2, 1, 3)
    assert np.abs(pallas - oracle).max() > 1.0
    # at S == Sk the kernel and the oracle agree
    np.testing.assert_allclose(
        flash_attention(*(torch.from_numpy(a[:, :16]) for a in (q, k, v)),
                        causal=True).numpy(),
        np.asarray(r_flash(*(jnp.asarray(a[:, :16]) for a in (q, k, v)),
                           causal=True, use_pallas=True, interpret=True,
                           bq=16, bk=16)), atol=2e-5, rtol=2e-5)


def test_rows_that_see_no_key_give_zeros():
    """Causal with Sk < S: the first S - Sk rows see no key.  The port
    gives zeros there (weights of masked keys are zero, l is clamped at
    1e-30); the reference's materialized oracle gives the mean of v (a
    softmax over a row of -1e30).  Every other row agrees."""
    q, k, v = _inputs(12, 1, 24, 16, 2, 1, 32)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True).numpy()
    oracle = r_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                     use_pallas=False)
    oracle = np.asarray(oracle)
    assert np.all(got[:, :8] == 0)
    np.testing.assert_allclose(oracle[:, :8],
                               np.broadcast_to(v.mean(axis=1)[:, None],
                                               (1, 8, 2, 32)),
                               atol=1e-5)
    np.testing.assert_allclose(got[:, 8:], oracle[:, 8:], atol=2e-5,
                               rtol=2e-5)


def test_meta_tensors_have_no_kernel():
    """A meta tensor (the dry run) takes the card's route with no kernel
    launched: the output's shape and dtype, nothing computed; shapes are
    checked as on any device."""
    q = torch.empty((1, 4, 2, 16), device="meta")
    before = flash_attention.launches
    out = flash_attention(q, q, q)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert flash_attention.launches == before
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, q[:, :, :1, :8], q[:, :, :1, :8])


# ----------------------------------------------------------------------
# the CUDA route and the bf16 kernel's tensor maps (plain Python)
# ----------------------------------------------------------------------
def test_route_by_dtype_has_no_fallback():
    from repro_torch.kernels.flash_attention.kernel import route
    assert route(torch.bfloat16) == "wgmma"
    assert route(torch.float32) == "tf32x3"
    with pytest.raises(TypeError):
        route(torch.float16)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_wgmma_plan_contiguous_and_gqa_9():
    """Dims innermost first (D, S, H, B) and byte strides of S, H, B; a kv
    head axis of extent 1 (G = 9 over one kv head) gets a stride TMA
    accepts, since it is never stepped."""
    from repro_torch.kernels.flash_attention.kernel import wgmma_plan
    B, S, HQ, D = 2, 100, 9, 128
    q, k = _bf16(B, S, HQ, D), _bf16(B, 300, 1, D)
    dims, strides = wgmma_plan(q, k, k)
    assert dims == [D, S, HQ, B] + [D, 300, 1, B] * 2
    assert strides[:3] == [HQ * D * 2, D * 2, S * HQ * D * 2]
    kb = D * 2                       # k's S stride: one head of D
    assert strides[3] == kb and strides[5] == 300 * D * 2
    assert strides[4] % 16 == 0 and strides[4] >= 300 * kb
    assert strides[3:6] == strides[6:9]


def test_wgmma_plan_reads_fused_qkv_in_place():
    """q, k, v as views of one (B, S, HQ + 2 KH, D) projection: the maps
    take the views' own strides, no copy."""
    from repro_torch.kernels.flash_attention.kernel import wgmma_plan
    B, S, HQ, KH, D = 2, 70, 6, 2, 64
    qkv = _bf16(B, S, HQ + 2 * KH, D)
    q, k, v = qkv[:, :, :HQ], qkv[:, :, HQ:HQ + KH], qkv[:, :, HQ + KH:]
    dims, strides = wgmma_plan(q, k, v)
    row = (HQ + 2 * KH) * D * 2
    assert dims == [D, S, HQ, B, D, S, KH, B, D, S, KH, B]
    assert strides == [row, D * 2, S * row] * 3
    assert (k.data_ptr() - q.data_ptr()) % 16 == 0


def test_wgmma_plan_refuses_what_tma_cannot_read():
    from repro_torch.kernels.flash_attention.kernel import wgmma_plan
    B, S, H, D = 1, 64, 2, 64
    buf = _bf16(B * S * (H * D + 4) + 8)
    good = _bf16(B, S, H, D)
    odd_stride = torch.as_strided(buf, (B, S, H, D),
                                  (S * (H * D + 4), H * D + 4, D, 1))
    odd_base = torch.as_strided(buf, (B, S, H, D), (S * H * D, H * D, D, 1),
                                1)
    for bad in (odd_stride, odd_base, good.transpose(2, 3)):
        with pytest.raises(ValueError):
            wgmma_plan(good, bad, good)
    with pytest.raises(ValueError, match="multiple of 16"):
        wgmma_plan(*(_bf16(B, S, H, 40),) * 3)
    with pytest.raises(ValueError, match="multiple of 16"):
        wgmma_plan(*(_bf16(B, S, H, 144),) * 3)


# ----------------------------------------------------------------------
# the float32 kernel's tiles and arithmetic (plain Python / PyTorch)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("D", [4, 8, 12, 36, 60, 64, 68, 96, 100, 128])
@pytest.mark.parametrize("B,S,Sk,HQ,KH,causal", [
    (1, 16, 16, 32, 32, True),        # zamba2-1.2b's served prompt
    (2, 1000, 1500, 20, 20, False),   # whisper's cross-attention
    (1, 4096, 4096, 24, 8, True),     # Llama-3.2-3B's prefill
    (1, 100, 36, 2, 2, True)])
def test_flash_f32_plan(B, S, Sk, HQ, KH, causal, D):
    """D padded to a multiple of 8; a 64-key tile up to DP 64 and 32
    above; 128-row blocks with a 3-stage ring where their grid gives each
    SM a block, else 64 rows and 2 stages; the shared memory the C layout
    takes (row strides padded for conflict-free fragment loads), at most
    227 KB, and two 64-row blocks an SM."""
    from repro_torch.kernels.flash_attention.kernel import (
        SMEM_MAX, SMS, flash_f32_plan)
    p = flash_f32_plan(B, S, Sk, HQ, KH, D, causal)
    assert p.dp == 8 * math.ceil(D / 8) and p.dp - D in (0, 4)
    assert p.bk == (64 if p.dp <= 64 else 32)
    assert p.bq == (128 if S > 64 and math.ceil(S / 128) * B * HQ >= SMS
                    else 64)
    assert p.stages == (3 if p.bq == 128 else 2)
    qs = p.dp + (8 if p.dp % 16 == 0 else 0)
    vs = p.dp + 4
    assert qs % 16 == 8 and vs % 8 == 4
    assert p.smem == 4 * (p.bq * qs + p.stages * p.bk * (qs + vs))
    assert p.smem <= SMEM_MAX == 232448
    if p.bq == 64:
        assert 2 * (p.smem + 1024) <= 233472     # two blocks an SM


def test_flash_f32_plan_refuses_d():
    from repro_torch.kernels.flash_attention.kernel import flash_f32_plan
    for D in (2, 6, 130, 132):
        with pytest.raises(ValueError, match="multiple of 4"):
            flash_f32_plan(1, 16, 16, 2, 2, D, True)


def _f64_attention(q, k, v, causal):
    B, S, HQ, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    g = HQ // KH
    qh = q.double().transpose(1, 2)
    kh = k.double().transpose(1, 2).repeat_interleave(g, dim=1)
    vh = v.double().transpose(1, 2).repeat_interleave(g, dim=1)
    s = qh @ kh.transpose(-1, -2) / math.sqrt(D)
    if causal:
        vis = torch.arange(Sk)[None] <= torch.arange(S)[:, None] + (Sk - S)
        s = s.masked_fill(~vis, -math.inf)
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return (p @ vh).transpose(1, 2)


@pytest.mark.parametrize("B,S,Sk,HQ,KH,D,causal", [
    (2, 100, 150, 4, 4, 64, False),   # whisper's cross-attention, cut
    (1, 256, 256, 6, 2, 128, True),   # Llama-3.2-3B's prefill, cut
    (1, 16, 16, 8, 8, 64, True),      # zamba2-1.2b's served prompt, cut
    (1, 50, 40, 4, 2, 36, True),      # D = 4 mod 8; rows that see no key
])
def test_tf32x3_model_within_float64(B, S, Sk, HQ, KH, D, causal):
    """The model of the float32 kernel's arithmetic (both products in
    3xTF32: hi rounded to nearest, lo truncated by the tensor cores) is
    within 1e-5 of float64 attention on unit-normal inputs, and within 4x
    the plain float32 version's own error (plus 1e-7)."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_tf32x3_model, tf32_split)
    q, k, v = (torch.from_numpy(x) for x in
               _inputs(S + Sk + D, B, S, Sk, HQ, KH, D))
    want = _f64_attention(q, k, v, causal)
    got = attention_tf32x3_model(q, k, v, causal=causal)
    plain = flash_attention_plain(q, k, v, causal=causal)
    err = (got.double() - want).abs().max().item()
    plain_err = (plain.double() - want).abs().max().item()
    assert err <= 1e-5 and err <= 4 * plain_err + 1e-7, (err, plain_err)
    hi, lo = tf32_split(q)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(hi, dtype=torch.int32))
    assert (hi + lo - q).abs().max().item() <= \
        2.0 ** -21 * q.abs().max().item()
    if S > Sk and causal:
        assert not got[:, :S - Sk].abs().any()
