"""flash_attention at every head dim.

The tensor-core kernels take D up to 128 (a multiple of 16 in bfloat16,
of 4 in float32) and the wide kernels (``csrc/flash_wide.cu``) every D
above; the op zero-pads D to a multiple of 16 (bfloat16) or 4 (float32)
for either, forward and backward (``kernel.head_dim_plan``), and the
wide forward takes one or two launches (``kernel.wide_fwd_launches``).
Here, on the CPU:

  * the plain version (what a CPU tensor runs) against the reference's
    oracle (``flash_attention(use_pallas=False)``) at D 80, 160, 200,
    256, 264, 320 and 512, causal and not: float32 within 1e-5 of
    max|out|, bfloat16 within 2^-7 (both compute in float32 and round
    once to bfloat16); its backward against ``jax.grad`` of that oracle:
    float32 within 2e-5 of max|grad| (sums in another order), bfloat16
    within 2^-7;
  * ``head_dim_plan``: which kernels and what padding each D gets (D
    136, 160, 200, 256, 264, 320 and 512 named); D 0 raises;
    ``wide_fwd_launches``: the wide forward's launches (and so its
    scratch L);
  * the card's dispatch (``ops._cuda_forward``, ``ops._cuda_backward``)
    with the kernels replaced by float64 stand-ins that record what they
    are given: a padded D reaches the kernels padded, with the scale of
    the unpadded D, and the output, L and gradients sliced back equal
    the stand-ins' on the unpadded operands (within 1e-12: zero columns
    add nothing), on the tensor-core and the wide kernels alike.  The
    kernels themselves are held to the plain versions on the card
    (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 7).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as r_flash
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.kernels.flash_attention.kernel import (MAX_D, WIDE_SLICE,
                                                        head_dim_plan,
                                                        wide_fwd_launches)

DS = [80, 160, 200, 256, 264, 320, 512]


def _inputs(B, S, HQ, KH, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, S, HQ, D), (B, S, KH, D), (B, S, KH, D),
                          (B, S, HQ, D))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", DS)
def test_plain_version_matches_reference_oracle(D, causal, dtype):
    B, S, HQ, KH = 1, 48, 4, 2
    q, k, v, do = _inputs(B, S, HQ, KH, D, D + causal)
    jd = getattr(jnp, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(getattr(torch, dtype))
                       for a in (q, k, v, do))
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jd) for a in (q, k, v, do))

    def ref(a, b, c):
        return r_flash(a, b, c, causal=causal, use_pallas=False)
    want = np.asarray(ref(jq, jk, jv).astype(jnp.float32))
    got = flash_attention(tq, tk, tv, causal=causal).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    assert np.abs(got - want).max() <= tol * np.abs(want).max()

    _, vjp = jax.vjp(ref, jq, jk, jv)
    want_g = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
    o, lse = flash_attention_fwd(tq, tk, tv, causal=causal)
    got_g = flash_attention_bwd(tq, tk, tv, o, tdo, causal=causal, lse=lse)
    tol = 2e-5 if dtype == "float32" else 2.0 ** -7
    for name, a, w in zip(("dq", "dk", "dv"), got_g, want_g):
        err = np.abs(a.float().numpy() - w).max()
        assert err <= tol * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_head_dim_plan(dtype):
    step = 16 if dtype == torch.bfloat16 else 4
    for D in range(1, MAX_D + 1):
        plan = head_dim_plan(D, dtype)
        assert plan.kernels == "tensor"
        assert plan.dp % step == 0 and D <= plan.dp < D + step
    for D in list(range(MAX_D + 1, WIDE_SLICE + 1)) + [264, 320, 512, 600]:
        plan = head_dim_plan(D, dtype)
        assert plan.kernels == "wide"
        assert plan.dp % step == 0 and D <= plan.dp < D + step
    named = {136: 144, 160: 160, 200: 208, 256: 256, 264: 272, 320: 320,
             512: 512} if dtype == torch.bfloat16 else \
        {D: D for D in (136, 160, 200, 256, 264, 320, 512)}
    for D, dp in named.items():
        assert head_dim_plan(D, dtype) == ("wide", dp)
    for D in (0, -1):
        with pytest.raises(ValueError):
            head_dim_plan(D, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wide_fwd_launches(dtype):
    """bfloat16 up to 256: one online-softmax launch (no scratch L); above,
    and every float32 call: L, then the output's slices from it."""
    bf16 = dtype == torch.bfloat16
    for D in ((144, 160, 208, 256, 272, 320, 512) if bf16
              else (136, 160, 200, 256, 264, 320, 512)):
        assert wide_fwd_launches(D, dtype) == (1 if bf16 and D <= WIDE_SLICE
                                               else 2)
    for D in (128, 64, 200 + (1 if bf16 else 2)):
        with pytest.raises(ValueError):      # not above 128, or unpadded
            wide_fwd_launches(D, dtype)


def _attention64(q, k, v, causal, scale):
    """(out, L) of GQA attention in float64, with an explicit scale."""
    B, S, HQ, D = q.shape
    g = HQ // k.shape[2]
    qh = q.double().transpose(1, 2)
    kh = k.double().transpose(1, 2).repeat_interleave(g, dim=1)
    vh = v.double().transpose(1, 2).repeat_interleave(g, dim=1)
    s = qh @ kh.transpose(-1, -2) * scale
    if causal:
        Sk = k.shape[1]
        vis = torch.arange(Sk)[None] <= torch.arange(S)[:, None] + (Sk - S)
        s = s.masked_fill(~vis, float("-inf"))
    return (torch.softmax(s, -1) @ vh).transpose(1, 2), \
        torch.logsumexp(s, -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [20, 80, 100, 160, 200, 264, 320])
def test_card_dispatch_pads_and_slices(monkeypatch, D, dtype):
    calls = []

    def fwd(q, k, v, causal, with_lse=False, scale=None):
        calls.append(("fwd", q.shape[-1], scale))
        scale = 1 / math.sqrt(q.shape[-1]) if scale is None else scale
        out, lse = _attention64(q, k, v, causal, scale)
        out = out.to(q.dtype)
        return (out, lse.float()) if with_lse else out

    def bwd(q, k, v, o, do, lse, causal, scale=None):
        calls.append(("bwd", q.shape[-1], scale))
        scale = 1 / math.sqrt(q.shape[-1]) if scale is None else scale
        ts = [t.double().requires_grad_(True) for t in (q, k, v)]
        out, _ = _attention64(*ts, causal, scale)
        return [g.to(q.dtype) for g in torch.autograd.grad(
            out, ts, do.double())]

    for name in ("flash_attention_cuda", "flash_wide_cuda"):
        monkeypatch.setattr(t_ops, name, fwd)
    for name in ("flash_attention_bwd_cuda", "flash_wide_bwd_cuda"):
        monkeypatch.setattr(t_ops, name, bwd)
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(2, 24, 4, 2, D, D))
    out, lse = t_ops._cuda_forward(q, k, v, True, True)
    grads = t_ops._cuda_backward(q, k, v, out, do, lse, True)
    plan = head_dim_plan(D, dtype)
    scale = None if plan.dp == D else 1 / math.sqrt(D)
    assert calls == [("fwd", plan.dp, scale), ("bwd", plan.dp, scale)]
    want_out, want_lse = fwd(q, k, v, True, True)
    want_g = bwd(q, k, v, want_out, do, want_lse, True)
    assert out.shape == q.shape and out.dtype == dtype
    # tolerance: 1e-12 in float64 (zero columns add nothing), then one
    # rounding to q's dtype on both sides
    assert torch.allclose(out.double(), want_out.double(), atol=1e-12,
                          rtol=0)
    assert torch.allclose(lse, want_lse, atol=1e-6, rtol=0)
    for a, w in zip(grads, want_g):
        assert a.shape == w.shape
        assert plan.dp == D or a.is_contiguous()     # sliced back whole
        assert torch.allclose(a.double(), w.double(), atol=1e-12, rtol=0)
