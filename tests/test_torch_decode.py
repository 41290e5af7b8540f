"""Decode attention and the quantized decoder in the port against the
reference package.

  * ``decode_attention``'s plain versions equal the reference's
    ``decode_attention_pallas`` (interpret mode) and
    ``decode_attention_ref_4d`` for G in {1, 3} and kv_len in
    {0, 1, S-3, S}, float32.  Tolerance: 1e-5 absolute on unit-scale
    inputs — the sums are taken in another order (einsum against the
    kernel's block dot) and the reference normalizes per block.  At
    kv_len = 0 the reference's jnp oracle gives NaN (-inf minus -inf), so
    there only the Pallas kernel's zeros are the reference.
  * the decoder in ``attention="numpy"`` mode, on ``pynq`` and
    ``lowbit(4)``: 8 steps byte-equal to the reference ``DecoderReference``,
    compiled and eager;
  * in ``attention="kernel"`` mode every attention output is within one
    int8 step of the reference's (float sums in another order can move a
    value across a rounding boundary), and the compiled port equals the
    port's own ``DecoderReference`` bit for bit (they share the op);
  * ``convert.quant_decoder`` carries a reference decoder and a session's
    persistent image across.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.hwspec as r_hw
import repro_torch.core.hwspec as t_hw
from repro.kernels.decode_attention import (decode_attention as
                                            r_decode_attention)
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as r_ref3, decode_attention_ref_4d as r_ref4)
from repro.models.vta_decoder import (DecoderConfig as RConfig,
                                      QuantDecoder as RDecoder)
from repro.models.vta_decoder import _attn_step as r_attn_step
from repro_torch import convert
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref,
                                                  decode_attention_ref_4d)
from repro_torch.models.vta_decoder import (DecoderConfig as TConfig,
                                            QuantDecoder as TDecoder)
from repro_torch.models.vta_decoder import _attn_step as t_attn_step

ATOL = 1e-5
CPU = dict(torch_device="cpu", dram_size=1 << 22)
SMALL = dict(d_model=64, n_blocks=2, n_heads=2, d_ff=128, vocab=32,
             s_max=16)


# ----------------------------------------------------------------------
# decode_attention
# ----------------------------------------------------------------------
@pytest.mark.parametrize("G", [1, 3])
def test_decode_attention_plain_matches_reference(G):
    B, S, KH, D = 2, 64, 2, 32
    HQ = KH * G
    rng = np.random.default_rng(8 + G)
    q = rng.normal(size=(B, 1, HQ, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for kv_len in (0, 1, S - 3, S):
        pallas = np.asarray(r_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.int32(kv_len), use_pallas=True, interpret=True, bk=32))
        for kl in (kv_len, torch.tensor([kv_len], dtype=torch.int32)):
            got = decode_attention(tq, tk, tv, kl)
            assert got.shape == (B, 1, HQ, D) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL,
                                       rtol=0, err_msg=f"kv_len={kv_len}")
        if kv_len == 0:
            assert not got.numpy().any()
            continue
        np.testing.assert_allclose(
            got.numpy(), np.asarray(r_ref4(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v),
                                           jnp.int32(kv_len))),
            atol=ATOL, rtol=0)
        # the kernel layout oracle: (B*KH, G, D) against (B*KH, S, D)
        qh = q.reshape(B * KH, G, D)
        kh = k.transpose(0, 2, 1, 3).reshape(B * KH, S, D)
        vh = v.transpose(0, 2, 1, 3).reshape(B * KH, S, D)
        np.testing.assert_allclose(
            decode_attention_ref(torch.from_numpy(qh), torch.from_numpy(kh),
                                 torch.from_numpy(vh), kv_len).numpy(),
            np.asarray(r_ref3(jnp.asarray(qh), jnp.asarray(kh),
                              jnp.asarray(vh), jnp.int32(kv_len))),
            atol=ATOL, rtol=0)


def test_decode_attention_bf16_and_validation():
    """bfloat16 in, bfloat16 out, float32 math: within one bf16 rounding
    of the float32 result; bad shapes raise."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(1, 1, 6, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 40, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 40, 2, 16)).astype(np.float32))
    want = decode_attention_ref_4d(q, k, v, 37)
    got = decode_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), 37)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=1.6e-2, rtol=0)
    with pytest.raises(ValueError, match="shapes"):
        decode_attention(q, k[:, :, :1].repeat(1, 1, 4, 1), v, 3)


# ----------------------------------------------------------------------
# the decoder
# ----------------------------------------------------------------------
def _pair(spec_name, attention):
    spec_r = getattr(r_hw, spec_name)() if spec_name == "pynq" \
        else r_hw.lowbit(4)
    spec_t = getattr(t_hw, spec_name)() if spec_name == "pynq" \
        else t_hw.lowbit(4)
    rd = RDecoder(RConfig(attention=attention, **SMALL), spec=spec_r)
    td = TDecoder(TConfig(**SMALL), spec=spec_t, attention=attention, **CPU)
    return rd, td


@pytest.mark.parametrize("spec_name", ["pynq", "lowbit4"])
def test_decoder_numpy_mode_byte_equal_reference(spec_name):
    rd, td = _pair(spec_name, "numpy")
    for a, b in zip(rd.weights, td.weights):
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])
    rref, tref = rd.reference(), td.reference()
    c = td.compile(use_cache=False)
    for t in range(8):
        want = rref.step(rd.token(t))
        np.testing.assert_array_equal(tref.step(td.token(t)), want)
        np.testing.assert_array_equal(c(x=td.token(t)), want)
        assert all(s.backend == "cuda" for s in c.last_stats)
    luts = sum(s.lut_launches for s in c.last_stats)
    assert luts == (9 if spec_name == "lowbit4" else 0)
    np.testing.assert_array_equal(c.read_persistent("k0"), rref.K[0])


def test_decoder_kernel_mode_within_one_step():
    """Each attention output of the kernel mode is within one int8 step of
    the reference's (fed the same caches), and the compiled port equals
    the port's eager reference bit for bit."""
    cfg_r = RConfig(attention="kernel", **SMALL)
    cfg_t = TConfig(attention="kernel", **SMALL)
    rng = np.random.default_rng(12)
    d, S = cfg_r.d_model, cfg_r.s_max
    K = np.zeros((S, d), np.int8)
    V = np.zeros((S, d), np.int8)
    pos = np.zeros(1, np.int32)
    worst = 0
    for _ in range(S):
        qkv = rng.integers(-128, 128, size=(1, 3 * d), dtype=np.int8)
        ra, rK, rV, rpos = r_attn_step(cfg_r, qkv, K, V, pos)
        ta, tK, tV, tpos = t_attn_step(cfg_t, qkv, K, V, pos, "cpu")
        np.testing.assert_array_equal(tK, rK)
        np.testing.assert_array_equal(tpos, rpos)
        worst = max(worst, int(np.abs(ta.astype(np.int32)
                                      - ra.astype(np.int32)).max()))
        K, V, pos = rK, rV, rpos
    assert worst <= 1
    _, td = _pair("lowbit4", "kernel")
    tref, c = td.reference(), td.compile(use_cache=False)
    for t in range(6):
        np.testing.assert_array_equal(c(x=td.token(t)),
                                      tref.step(td.token(t)))


def test_convert_quant_decoder_carries_weights_and_session_state():
    rd = RDecoder(RConfig(seed=5, **SMALL), spec=r_hw.lowbit(4))
    td = convert.quant_decoder(rd, **CPU)
    assert td.cfg == TConfig(seed=5, **SMALL)
    assert td.spec == t_hw.lowbit(4)
    rc, tc = rd.compile(), td.compile(use_cache=False)
    # three reference steps, then the session's raw bytes cross over
    for t in range(3):
        rc(x=rd.token(t))
    image = rc.persistent_image()
    tc.load_persistent_image(image)
    for name in tc.persistent_names:
        np.testing.assert_array_equal(tc.read_persistent(name),
                                      rc.read_persistent(name))
    for t in range(3, 6):
        np.testing.assert_array_equal(tc(x=td.token(t)), rc(x=rd.token(t)))
    assert {k: v.tobytes() for k, v in tc.persistent_image().items()} \
        == {k: v.tobytes() for k, v in rc.persistent_image().items()}
