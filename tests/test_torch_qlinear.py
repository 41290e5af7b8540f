"""The redesigned vta_gemm and decode_attention, modelled on the CPU.

The kernels run only on the card; what their results rest on is held here
against the plain versions and the JAX reference:

* the fused quantization prologue of quantized_linear, modelled float by
  float in the kernel's order (amax over the bit patterns of |x|, the
  clamp at 1e-6 in x's dtype, an IEEE division by 127 rounded to x's
  dtype, an IEEE division of each element, round half to even, clip),
  and its epilogue (float(acc) * (w_scale[n] * x_scale), one rounding
  each): the int8 activations are byte-equal to the plain chain's and to
  the reference's (jnp oracle, and the Pallas kernel in interpret mode);
  the outputs are bitwise equal to the port's;
* the skinny instance's split of K (kernel.py:gemm_plan): every K index
  in exactly one slice, and uint32-wrapped partials over the slices equal
  to vta_gemm_ref;
* decode_attention's split (kernel.py:decode_plan): every position below
  kv_len read exactly once, the grid filled at the LM step shape, and a
  split-and-merge model in the plan's order within attn tolerance of the
  plain version and within 1e-5 of the reference's oracle in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.vta_gemm.ops as r_vta_ops
import repro_torch.kernels.vta_gemm.ops as t_vta_ops
from repro.kernels.decode_attention.ref import \
    decode_attention_ref_4d as r_decode_ref_4d
from repro_torch.kernels.decode_attention import decode_attention_ref_4d
from repro_torch.kernels.decode_attention.kernel import (MIN_SPLIT,
                                                         decode_plan,
                                                         head_blocks,
                                                         split_ranges)
from repro_torch.kernels.vta_gemm import (quantize_activations,
                                          quantized_linear,
                                          quantized_linear_ref, vta_gemm_ref)
from repro_torch.kernels.vta_gemm.kernel import (SKINNY_BN, SKINNY_KC,
                                                 SKINNY_KMAX, SKINNY_MAX_M,
                                                 amax_blocks, clamp_floor,
                                                 gemm_plan, grid_resident,
                                                 k_slices)
from torch_cases import (QLINEAR_CASES, SKINNY_SHAPES, gemm_inputs,
                         qlinear_w, qlinear_x)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
#: (M, N, K) of every quantized linear the LM paths serve: Llama-3.2-3B
#: (q, k/v, o, MLP in, MLP out) and zamba2-1.2b (in_proj, out_proj, the
#: shared block's), at the decode step's 4 rows and the prefill's 16
LM_SHAPES = [(m, n, k) for m in (4, 16) for n, k in (
    (3072, 3072), (1024, 3072), (8192, 3072), (3072, 8192), (8384, 2048),
    (2048, 4096), (2048, 2048), (8192, 2048), (2048, 8192))]


# ----------------------------------------------------------------------
# quantized_linear: the fused prologue and epilogue, float by float
# ----------------------------------------------------------------------
def prologue_model(x2: torch.Tensor, x_scale=None):
    """The kernel's steps on plain torch float32 scalars, in its order:
    (x_q int8, x_scale float32)."""
    xf = x2.to(torch.float32)                    # exact widening
    if x_scale is None:
        bits = xf.abs().view(torch.int32)        # |x| >= 0 orders as bits
        amax = bits.max().view(torch.float32) if xf.numel() else \
            torch.zeros((), dtype=torch.float32)
        lo = torch.tensor(clamp_floor(x2.dtype), dtype=torch.float32)
        a = torch.maximum(amax, lo)
        s = torch.div(a, torch.tensor(127.0, dtype=torch.float32))
        x_scale = s.to(x2.dtype).to(torch.float32)  # nearest even in dtype
    else:
        x_scale = torch.as_tensor(x_scale, dtype=torch.float32)
    q = torch.div(xf, x_scale)                   # IEEE, element by element
    q = torch.round(q)                           # rint: half to even
    q = torch.clamp(q, -128.0, 127.0)
    return q.to(torch.int8), x_scale


def epilogue_model(x_q, w_q, w_scale, x_scale, dtype):
    """float(acc) * (w_scale[n] * x_scale), each product rounded once to
    float32, then rounded to x's dtype."""
    acc = torch.matmul(x_q.to(torch.int64), w_q.to(torch.int64)) \
        .to(torch.int32)
    s = w_scale.to(torch.float32) * x_scale
    return (acc.to(torch.float32) * s).to(dtype)


def _spy(monkeypatch, module):
    seen = []
    real = module.vta_gemm

    def spy(a, *args, **kw):
        seen.append(np.asarray(a))
        return real(a, *args, **kw)
    monkeypatch.setattr(module, "vta_gemm", spy)
    return seen


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("case", QLINEAR_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_prologue_model_bytes_equal(monkeypatch, dtype, case,
                                          use_pallas):
    tdt, jdt = DTYPES[dtype]
    M, K, N = 6, 96, 40
    x = torch.from_numpy(qlinear_x(M, K, case, 7)).to(tdt)
    w_nk, sc = qlinear_w(K, N, 8)
    w_q = torch.from_numpy(w_nk).t()
    w_scale = torch.from_numpy(sc)
    model_q, model_s = prologue_model(x)
    chain_q, chain_s = quantize_activations(x)
    assert torch.equal(model_q, chain_q)
    assert torch.equal(model_s.reshape(()), chain_s.reshape(()))
    r_seen = _spy(monkeypatch, r_vta_ops)
    t_seen = _spy(monkeypatch, t_vta_ops)
    want = r_vta_ops.quantized_linear(
        jnp.asarray(x.float().numpy(), jdt), jnp.asarray(w_nk.T),
        jnp.asarray(sc), use_pallas=use_pallas)
    got = quantized_linear(x, w_q, w_scale)
    assert len(r_seen) == len(t_seen) == 1
    np.testing.assert_array_equal(model_q.numpy(), r_seen[0])
    np.testing.assert_array_equal(model_q.numpy(), t_seen[0])
    model_y = epilogue_model(model_q, w_q, w_scale, model_s, tdt)
    assert torch.equal(got, model_y)
    assert torch.equal(got, quantized_linear_ref(x, w_q, w_scale))
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_given_scale_rounds_half_even_then_clips(monkeypatch, dtype):
    """x at +-127.5, -128.5 and far past a given x_scale of 0.25."""
    tdt, jdt = DTYPES[dtype]
    x = torch.tensor([[127.5, -127.5, -128.5, 1000.0, 0.5, 2.5, -2.5,
                       1.5]]) * 0.25
    x = x.to(tdt)
    model_q, _ = prologue_model(x, 0.25)
    assert model_q.tolist() == [[127, -128, -128, 127, 0, 2, -2, 2]]
    w_nk, sc = qlinear_w(8, 16, 2)
    r_seen = _spy(monkeypatch, r_vta_ops)
    t_seen = _spy(monkeypatch, t_vta_ops)
    r_vta_ops.quantized_linear(jnp.asarray(x.float().numpy(), jdt),
                               jnp.asarray(w_nk.T), jnp.asarray(sc),
                               jnp.float32(0.25))
    quantized_linear(x, torch.from_numpy(w_nk).t(), torch.from_numpy(sc),
                     torch.tensor(0.25))
    np.testing.assert_array_equal(model_q.numpy(), r_seen[0])
    np.testing.assert_array_equal(model_q.numpy(), t_seen[0])


def test_scale_divides_where_a_reciprocal_would_differ():
    """float32 amax / 127 by IEEE division, not amax * (1 / 127) (what
    PyTorch's kernels do for a Python-scalar divisor on the card): at
    these amaxes the two differ in the last bit, and the plain chain takes
    the division, as the reference does."""
    inv = torch.tensor(1.0, dtype=torch.float32) / 127.0
    amax = torch.linspace(1.0, 2.0, 4001, dtype=torch.float32)
    div = amax / torch.tensor(127.0)
    differ = amax[div != amax * inv]
    assert differ.numel() > 0
    for a in differ[:5].tolist():
        x = torch.tensor([[a, -0.5, 0.25]], dtype=torch.float32)
        _, s = quantize_activations(x)
        want = np.float32(a) / np.float32(127.0)
        assert s.item() == want
        assert s.item() != (torch.tensor(a) * inv).item()


# ----------------------------------------------------------------------
# vta_gemm: the skinny instance's plan and split of K
# ----------------------------------------------------------------------
def split_model(a, w, bias, scale, plan, epilogue, shift):
    """The skinny kernel's sums: per slice an exact partial, each wrapped
    to uint32, added mod 2^32 (the atomics' order does not matter), then
    vta_gemm_ref's epilogue on the int32 result."""
    K = a.shape[-1]
    total = torch.zeros(a.shape[:-1] + w.shape[-1:], dtype=torch.int64)
    for k0, k1 in k_slices(plan, K):
        part = torch.matmul(a[..., k0:k1].to(torch.int64),
                            w[..., k0:k1, :].to(torch.int64))
        total = (total + (part & 0xFFFFFFFF)) & 0xFFFFFFFF
    acc = torch.where(total >= 1 << 31, total - (1 << 32), total) \
        .to(torch.int32)
    if bias is not None:
        acc = (acc.to(torch.int64) + bias.to(torch.int64)).to(torch.int32)
    if epilogue == "none":
        return acc
    if epilogue == "requant":
        return (acc >> min(shift, 31)).clamp(-128, 127).to(torch.int8)
    return acc.to(torch.float32) * scale


@pytest.mark.parametrize("M,N,K", LM_SHAPES + [
    (m, n, k) for m, k, n in SKINNY_SHAPES])
def test_skinny_plan_partitions_k(M, N, K):
    plan = gemm_plan(1, M, N, K)
    if M > SKINNY_MAX_M:
        assert plan.route == "tile"
        return
    assert plan.route == "skinny"
    assert plan.kslice % SKINNY_KC == 0 and plan.kslice <= SKINNY_KMAX
    covered = np.zeros(K, np.int64)
    for k0, k1 in k_slices(plan, K):
        assert k0 < k1
        covered[k0:k1] += 1
    assert (covered == 1).all()
    blocks = plan.splits * -(-N // SKINNY_BN)
    assert blocks <= 2 * 132
    assert grid_resident(plan, 1, N)
    if (M, N, K) in LM_SHAPES:
        # every LM decode linear fills the card: at least one block a SM
        assert blocks >= 132, (M, N, K, plan)


@pytest.mark.parametrize("epilogue,shift", [("none", 0), ("requant", 9),
                                            ("dequant", 0)])
@pytest.mark.parametrize("M,N,K", [(4, 200, 1000), (1, 203, 1000),
                                   (16, 136, 4100), (3, 8, 64),
                                   (4, 130, 7000)])
def test_skinny_split_model_equals_plain(M, N, K, epilogue, shift):
    """At reduced N and K the plan splits K into many slices (down to one
    64-byte step each); the wrapped partials add up to the plain GEMM,
    with bias and every epilogue, also at the operands' extremes."""
    a, w, bias, scale = (torch.from_numpy(x) for x in
                         gemm_inputs(M, K, N, seed=M + N + K))
    a[0] = -128
    w[:, 0] = -128
    plan = gemm_plan(1, M, N, K)
    assert plan.splits == -(-K // SKINNY_KC)    # one 64-byte step a slice
    for b in (None, bias):
        got = split_model(a, w, b, scale, plan, epilogue, shift)
        want = vta_gemm_ref(a, w, b, scale, epilogue=epilogue, shift=shift)
        assert torch.equal(got, want)


def test_plan_routes_and_amax_blocks():
    assert gemm_plan(1, 17, 64, 64).route == "tile"
    assert gemm_plan(2, 112, 64, 576).route == "tile"
    # the task-ISA engine's rows stay on the tile instance
    assert gemm_plan(1, 112, 128, 1152) == gemm_plan(1, 112, 128, 1152,
                                                     sms=66)
    # a tile axis multiplies the column blocks; only T = 1 shares an amax
    p1, p3 = gemm_plan(1, 4, 3000, 1152), gemm_plan(8, 4, 3000, 1152)
    assert p3.splits < p1.splits
    assert grid_resident(p1, 1, 3000) and not grid_resident(p3, 8, 3000)
    assert amax_blocks(1) == 1 and amax_blocks(512 * 2048) == 264
    assert clamp_floor(torch.bfloat16) != 1e-6
    assert clamp_floor(torch.bfloat16) == float(
        torch.tensor(1e-6).to(torch.bfloat16))


# ----------------------------------------------------------------------
# decode_attention: the plan and the split-and-merge model
# ----------------------------------------------------------------------
DECODE_SHAPES = [(4, 8, 3, 256), (4, 32, 1, 1024), (1, 2, 1, 96),
                 (8, 8, 3, 32768), (1, 4, 9, 4096), (2, 2, 3, 300)]


@pytest.mark.parametrize("B,KH,G,S", DECODE_SHAPES)
def test_decode_plan_covers_every_position_once(B, KH, G, S):
    _, split_len = decode_plan(B, KH, G, S, None)
    for kv_len in (0, 1, S - 1, S):
        for host in (True, False):
            splits, sl = decode_plan(B, KH, G, S, kv_len if host else None)
            assert sl == split_len       # a host and a device kv_len alike
            assert sl >= MIN_SPLIT or sl >= S
            seen = np.zeros(S, np.int64)
            for s0, s1 in split_ranges(splits, sl, kv_len):
                seen[s0:s1] += 1
            assert (seen[:kv_len] == 1).all() and not seen[kv_len:].any()
            if host:
                assert splits == max(1, -(-kv_len // sl))


def test_decode_plan_fills_the_card_at_the_llama_step():
    splits, _ = decode_plan(4, 8, 3, 256, 256)
    assert 4 * 8 * head_blocks(3) * splits >= 132
    assert decode_plan(4, 8, 3, 256, None)[0] == splits
    # the served kv_len 32 of a 256-row cache: one split
    assert decode_plan(4, 8, 3, 256, 32) == (1, 32)
    assert head_blocks(9) == 2 and head_blocks(8) == 1


def split_merge_model(q, k, v, kv_len, splits, split_len):
    """The kernel's arithmetic in float32: q scaled by 1/sqrt(D) first;
    per split a max, a sum of exponentials and a weighted sum of V; the
    splits merged in split order; the sum clamped at 1e-30."""
    B, _, HQ, D = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, KH, HQ // KH, D).float() * (1.0 / D ** 0.5)
    M = torch.full((B, KH, HQ // KH, 1), -1e30)
    parts = []
    for s0, s1 in split_ranges(splits, split_len, kv_len):
        if s0 >= s1:
            continue
        s = torch.einsum("bhgd,bshd->bhgs", qg, k[:, s0:s1].float())
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bhgs,bshd->bhgd", p, v[:, s0:s1].float())))
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros(qg.shape)
    for m, l, acc in parts:
        w = torch.exp(m - M)
        L = L + l * w
        A = A + acc * w
    out = A / L.clamp_min(1e-30)
    return out.reshape(B, 1, HQ, D).to(q.dtype)


@pytest.mark.parametrize("B,S,HQ,KH,D", [(4, 256, 24, 8, 128),
                                         (2, 300, 6, 2, 64),
                                         (1, 96, 2, 2, 32),
                                         (1, 130, 36, 4, 16)])
def test_split_merge_model_matches_plain_and_reference(B, S, HQ, KH, D):
    rng = np.random.default_rng(S + HQ)
    q, k, v = (rng.normal(size=sh).astype(np.float32) for sh in
               ((B, 1, HQ, D), (B, S, KH, D), (B, S, KH, D)))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    for kv_len in (1, 33, S - 1, S):
        for host in (True, False):
            splits, sl = decode_plan(B, KH, HQ // KH, S,
                                     kv_len if host else None)
            got = split_merge_model(tq, tk, tv, kv_len, splits, sl)
            want = decode_attention_ref_4d(tq, tk, tv, kv_len)
            assert (got - want).abs().max().item() <= 1e-5
            ref = np.asarray(r_decode_ref_4d(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v),
                                             jnp.int32(kv_len)))
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    got = split_merge_model(tq, tk, tv, 0, *decode_plan(B, KH, HQ // KH, S,
                                                        None))
    assert not got.abs().any()
    # bfloat16 caches and query: within 2^-6 of max|want| (phase 7's limit)
    bq, bk, bv = (t.to(torch.bfloat16) for t in (tq, tk, tv))
    splits, sl = decode_plan(B, KH, HQ // KH, S, S)
    got = split_merge_model(bq, bk, bv, S, splits, sl)
    want = decode_attention_ref_4d(bq, bk, bv, S)
    assert (got.float() - want.float()).abs().max().item() <= \
        2.0 ** -6 * want.float().abs().max().item()
