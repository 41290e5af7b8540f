"""The whisper encoder, cross-attention and the modality prefixes
(phi-3-vision's patches, whisper's frames) in the port against the
reference package.

The reference's weights (``init_params`` from a PRNG key, and
``quantize_params``) cross into the port as numpy trees
(``convert.lm_params_from_numpy``); inputs are made with numpy from a
seed.  The JAX side runs through both of its routes: ``use_pallas=True``
(the Pallas kernels in interpret mode) and ``use_pallas=False`` (its jnp
oracles); eagerly, but jitted for the float models' prefill and decode
and for its serving engine, as it ships.

Tolerances:
  * layers and logits in float32: 1e-5 relative to the largest magnitude
    (sums in another order; the models agree to about 1e-6);
  * the embedded inputs (token rows, the patch prefix): bitwise equal;
  * on int8 weights every ``quantized_linear`` call's int8 activations
    equal the reference's but at a .5 rounding tie
    (``torch_cases.assert_int8_activations_match``), and the logits are
    held to 5e-3, the limit of the other int8 model tests in the port,
    where a tie flip moves them;
  * a bfloat16 query over float32 K/V (the decode step's cross-attention
    on a bfloat16 model over float32 caches): bitwise equal to the plain
    version on the query upcast to float32, then cast back, which is the
    rule the CUDA route follows; within one bfloat16 step (2^-7 of the
    largest magnitude) of the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.vta_gemm.ops as r_vta_ops
import repro_torch.kernels.vta_gemm.ops as t_vta_ops
from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_arch as r_get_arch
from repro.configs import input_specs as r_input_specs
from repro.configs import reduced as r_reduced
from repro.kernels.flash_attention import flash_attention as r_flash
from repro.launch import serve as R
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.quantized import quantize_params as r_quantize_params
from repro_torch import convert
from repro_torch.configs import SHAPES, get_arch, input_specs, list_archs
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.launch import serve as S
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.quantized import quantize_params
from torch_cases import (assert_int8_activations_match,
                         record_int8_activations)

WHISPER, VISION = "whisper-large-v3", "phi-3-vision-4.2b"
ROUTES = pytest.mark.parametrize("use_pallas", [False, True],
                                 ids=["jnp", "pallas"])


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def rel_err(got, want):
    got = got.to(torch.float32).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def configs(arch, **kw):
    rcfg = r_reduced(r_get_arch(arch).model).replace(**kw)
    return rcfg, convert.model_config_from_fields(dataclasses.asdict(rcfg))


def params(rcfg, quant=False, seed=0):
    rp = RT.init_params(jax.random.PRNGKey(seed), rcfg)
    if quant:
        rp = r_quantize_params(rp)
    return rp, convert.lm_params_from_numpy(to_numpy(rp), "cpu")


def t(a, dtype=None):
    x = torch.from_numpy(np.asarray(a))
    return x if dtype is None else x.to(dtype)


# ----------------------------------------------------------------------
# input specs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_equal_the_reference(arch, shape):
    """The same keys, shapes and dtypes as the reference's
    ShapeDtypeStructs, as tensors on the meta device."""
    want = r_input_specs(r_get_arch(arch).model, R_SHAPES[shape])
    got = input_specs(get_arch(arch).model, SHAPES[shape])
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.device.type == "meta", k
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def _attn_params(rcfg, seed):
    rp = to_numpy(RA.attn_init(jax.random.PRNGKey(seed), rcfg))
    tp = convert.lm_params_from_numpy(rp, "cpu").tree()
    return jax.tree.map(jnp.asarray, rp), tp


@ROUTES
@pytest.mark.parametrize("causal", [False, True],
                         ids=["noncausal", "causal"])
def test_attn_train(causal, use_pallas):
    rcfg, tcfg = configs(WHISPER, use_pallas=use_pallas)
    rp, tp = _attn_params(rcfg, 1)
    x = np.random.default_rng(1).normal(size=(2, 16, 64)).astype(np.float32)
    with jax.disable_jit():
        want = RA.attn_train(rp, rcfg, jnp.asarray(x), causal=causal)
    got = TA.attn_train(tp, tcfg, t(x), causal=causal)
    assert rel_err(got, want) <= 1e-5


@ROUTES
@pytest.mark.parametrize("S", [1, 5, 16])
def test_encode_cross_kv_and_cross_attn_apply(S, use_pallas):
    """K/V (B, T, KH, hd) of the encoder output, and S query rows over
    them (S 1 is the decode step's shape, 16 the prefill's)."""
    rcfg, tcfg = configs(WHISPER, use_pallas=use_pallas)
    rp, tp = _attn_params(rcfg, 2)
    rng = np.random.default_rng(2)
    enc = rng.normal(size=(2, 16, 64)).astype(np.float32)
    x = rng.normal(size=(2, S, 64)).astype(np.float32)
    with jax.disable_jit():
        want_kv = RA.encode_cross_kv(rp, rcfg, jnp.asarray(enc))
        want = RA.cross_attn_apply(rp, rcfg, jnp.asarray(x), want_kv)
    got_kv = TA.encode_cross_kv(tp, tcfg, t(enc))
    for k in ("k", "v"):
        assert got_kv[k].shape == (2, 16, tcfg.n_kv_heads, tcfg.hd)
        assert rel_err(got_kv[k], want_kv[k]) <= 1e-5
    got = TA.cross_attn_apply(tp, tcfg, t(x), got_kv)
    assert got.shape == (2, S, 64)
    assert rel_err(got, want) <= 1e-5


@ROUTES
@pytest.mark.parametrize("S,Sk", [(1, 16), (16, 16), (16, 40)])
def test_flash_bf16_query_over_f32_kv(S, Sk, use_pallas):
    """The mixed-dtype rule: the plain version on a bfloat16 query over
    float32 K/V equals, bitwise, the plain version on the query upcast to
    float32, cast back to bfloat16 (what the CUDA route launches); both
    agree with the reference's op on the same operands."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, S, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, Sk, 2, 16)).astype(np.float32)
            for _ in range(2))
    qb = t(q, torch.bfloat16)
    got = flash_attention(qb, t(k), t(v), causal=False)
    assert got.dtype == torch.bfloat16
    upcast = flash_attention_plain(qb.float(), t(k), t(v), causal=False)
    assert torch.equal(got, upcast.to(torch.bfloat16))
    with jax.disable_jit():
        want = r_flash(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k),
                       jnp.asarray(v), causal=False, use_pallas=use_pallas)
    assert want.dtype == jnp.bfloat16
    assert rel_err(got, want) <= 2 ** -7


# ----------------------------------------------------------------------
# the encoder and the prefixes
# ----------------------------------------------------------------------
@ROUTES
def test_encode(use_pallas):
    rcfg, tcfg = configs(WHISPER, use_pallas=use_pallas)
    rp, tp = params(rcfg)
    frames = np.random.default_rng(4).normal(size=(2, 16, 64)) \
        .astype(np.float32)
    with jax.disable_jit():
        want = RT._encode(rp, rcfg, jnp.asarray(frames))
    got = TT._encode(tp.tree(), tcfg, t(frames))
    assert got.shape == (2, 16, 64)
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_embed_inputs_prefixes(arch, dtype):
    """The patch prefix ahead of the text and the token rows are bitwise
    the reference's (float32 patches cast to the model's dtype); the
    frames go through the encoder (enc_out), the text alone into x."""
    rcfg, tcfg = configs(arch, dtype=dtype)
    rp, tp = params(rcfg)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, rcfg.vocab_size, (2, 6))
             .astype(np.int32)}
    if arch == VISION:
        batch["patch_emb"] = rng.normal(size=(2, rcfg.n_patches, 64)) \
            .astype(np.float32)
    else:
        batch["frames"] = rng.normal(size=(2, rcfg.encoder_seq, 64)) \
            .astype(np.float32)
    with jax.disable_jit():
        want_x, want_enc = RT.embed_inputs(
            rp, rcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got_x, got_enc = TT.embed_inputs(tp.tree(), tcfg,
                                     {k: t(v) for k, v in batch.items()})
    assert got_x.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got_x.float().numpy(),
                                  np.asarray(want_x, np.float32))
    if arch == VISION:
        assert got_x.shape == (2, rcfg.n_patches + 6, 64) and got_enc is None
        return
    assert got_x.shape == (2, 6, 64)
    assert got_enc.dtype == got_x.dtype
    assert rel_err(got_enc, want_enc) <= (1e-5 if dtype == "float32"
                                          else 2 ** -6)


# ----------------------------------------------------------------------
# the models
# ----------------------------------------------------------------------
def _batch(rcfg, rng, B=2, text=12):
    b = {"tokens": rng.integers(0, rcfg.vocab_size, (B, text))
         .astype(np.int32)}
    if rcfg.frontend == "vision_stub":
        b["patch_emb"] = rng.normal(size=(B, rcfg.n_patches, rcfg.d_model)) \
            .astype(np.float32)
    if rcfg.encoder_layers:
        b["frames"] = rng.normal(size=(B, rcfg.encoder_seq, rcfg.d_model)) \
            .astype(np.float32)
    return b


def _prefill_decode(rcfg, tcfg, rp, tp, batch, cache_dtype="float32",
                    steps=2, max_len=40, eager=True):
    """Logits of prefill then `steps` greedy decode steps, both packages
    (the reference eager, or jitted); returns ([(port, reference)
    logits], port caches, reference caches)."""
    rc = RT.init_caches(rcfg, 2, max_len, jnp.dtype(cache_dtype))
    tc = TT.init_caches(tcfg, 2, max_len, getattr(torch, cache_dtype),
                        torch_device="cpu")
    r_prefill = lambda p, b, c: RT.prefill(p, rcfg, b, c)  # noqa: E731
    r_decode = lambda p, c, tk, i: RT.decode_step(  # noqa: E731
        p, rcfg, c, tk, i)
    if not eager:
        r_prefill, r_decode = jax.jit(r_prefill), jax.jit(r_decode)
    with jax.disable_jit(eager):
        want, rc = r_prefill(rp, {k: jnp.asarray(v)
                                  for k, v in batch.items()}, rc)
    with torch.inference_mode():
        got, tc = TT.prefill(tp, tcfg, {k: t(v) for k, v in batch.items()},
                             tc)
    out = [(got, want)]
    pos = batch["tokens"].shape[1] + (rcfg.n_patches if "patch_emb" in batch
                                      else 0)
    tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    assert np.array_equal(torch.argmax(got, -1).numpy(), tok)
    for i in range(steps):
        with jax.disable_jit(eager):
            want, rc = r_decode(rp, rc, jnp.asarray(tok), jnp.int32(pos + i))
        with torch.inference_mode():
            got, tc = TT.decode_step(tp, tcfg, tc, t(tok), pos + i)
        out.append((got, want))
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        assert np.array_equal(torch.argmax(got, -1).numpy(), tok)
    return out, tc, rc


@ROUTES
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_prefill_and_decode_logits(monkeypatch, arch, quant, use_pallas):
    """A prefill (12 text tokens behind phi-3-vision's 8 patches, or over
    whisper's 16 frames) and two greedy decode steps; phi-3-vision's
    first step is at position 8 + 12, its rope counting the patches.  The
    reference runs eagerly on int8 weights (jitted, XLA rewrites the
    activation quantization) and jitted on float ones."""
    rcfg, tcfg = configs(arch, use_pallas=use_pallas)
    rp, tp = params(rcfg, quant)
    want_q = record_int8_activations(monkeypatch, RL, r_vta_ops)
    got_q = record_int8_activations(monkeypatch, TL, t_vta_ops)
    out, _, _ = _prefill_decode(rcfg, tcfg, rp, tp,
                                _batch(rcfg, np.random.default_rng(6)),
                                eager=quant)
    errs = [rel_err(g, w) for g, w in out]
    assert max(errs) <= (5e-3 if quant else 1e-5), errs
    if arch == WHISPER:     # encoder 6, decoder 10 at prefill, 8 a step
        per_run = rcfg.encoder_layers * 6 + rcfg.n_layers * (10 + 2 * 8)
    else:
        per_run = rcfg.n_layers * 7 * 3
    assert len(got_q) == (per_run if quant else 0)
    assert_int8_activations_match(got_q, want_q)


@ROUTES
def test_bf16_caches_under_a_float32_model(use_pallas):
    """The prefill/decode dtype split: prefill's cross-attention attends
    over the float32 K/V it has just computed (its logits within 1e-5: a
    port that read the bfloat16 cache back would be about 1e-3 off) and
    writes a bfloat16 copy into cross_kv; a decode step reads that copy.
    The copies round float32 values that differ by about 1e-7 between
    the packages, so a value at a bfloat16 rounding boundary lands one
    step apart (seen: 1-3 of 4096-10240 per cache, in both caches): the
    caches are held to equality but for such one-step flips, and the
    decode logits to 1e-4 (seen 1.3e-5)."""
    rcfg, tcfg = configs(WHISPER, use_pallas=use_pallas)
    rp, tp = params(rcfg, seed=3)
    out, tc, rc = _prefill_decode(rcfg, tcfg, rp, tp,
                                  _batch(rcfg, np.random.default_rng(7)),
                                  cache_dtype="bfloat16")
    errs = [rel_err(g, w) for g, w in out]
    assert errs[0] <= 1e-5 and max(errs) <= 1e-4, errs
    for name in ("cross_kv", "kv"):
        for k in ("k", "v"):
            got = tc["layers"]["attn"][name][k]
            want = np.asarray(jnp.asarray(rc["layers"]["attn"][name][k],
                                          jnp.float32))
            assert got.dtype == torch.bfloat16 and got.shape == want.shape
            got = got.float().numpy()
            off = got != want
            assert off.mean() < 1e-3, (name, k, int(off.sum()))
            assert (np.abs(got - want)[off]
                    <= 2 ** -7 * np.abs(want)[off]).all(), (name, k)


@pytest.mark.parametrize("frames", [8, 20, None],
                         ids=["short", "long", "missing"])
def test_frames_of_another_length_raise(frames):
    """cross_kv holds encoder_seq rows and is written in place: frames of
    another length are refused, never truncated or padded."""
    _, tcfg = configs(WHISPER)
    tp = TT.init_params(tcfg, 0, torch_device="cpu")
    caches = TT.init_caches(tcfg, 1, 32, torch.float32, "cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
    if frames is not None:
        batch["frames"] = torch.zeros((1, frames, tcfg.d_model))
    with pytest.raises(ValueError, match="frames"):
        TT.prefill(tp, tcfg, batch, caches)
    assert not caches["layers"]["attn"]["cross_kv"]["k"].any()


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_own_init_has_the_reference_tree(arch):
    """init_params draws the reference's tree (the encoder and each
    decoder layer's lnx and cross for whisper), shapes and dtypes equal;
    PTQ quantizes the encoder's and the cross-attention's linears
    byte-equal to the reference's."""
    rcfg, tcfg = configs(arch)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    want = {".".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(rp)}
    own = TT.init_params(tcfg, 0, torch_device="cpu").state_dict()
    assert set(own) == set(want)
    for k, v in own.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
    rq = to_numpy(r_quantize_params(rp))
    tq = quantize_params(convert.lm_params_from_numpy(to_numpy(rp), "cpu"))
    tq = tq.state_dict()
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(rq):
        key = ".".join(str(k.key) for k in path)
        if key.endswith("w_q") or key.endswith("w_scale"):
            np.testing.assert_array_equal(tq[key].numpy(), leaf)
            n += 1
    # whisper: the encoder's 6 linears and the decoder's 10 (4 self, 4
    # cross, 2 mlp); phi-3-vision: 4 attention and 3 swiglu linears
    assert n == 2 * (16 if arch == WHISPER else 7)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_serve_engine_phi3_vision_on_tokens_alone(quant):
    """The reference CLI's traffic (6 x 16-token prompts, 16 new tokens,
    4 slots), tokens alone as the reference serves phi-3-vision: the
    port's tokens equal the reference's."""
    rcfg, tcfg = configs(VISION)
    rp, tp = params(rcfg, quant)

    def reqs(module):
        rng = np.random.default_rng(0)
        return [module.Request(rid=i, prompt=rng.integers(
            0, rcfg.vocab_size, size=16).astype(np.int32), max_new=16)
            for i in range(6)]
    want = R.ServeEngine(rcfg, rp, batch_slots=4, max_len=64).run(reqs(R))
    got = S.ServeEngine(tcfg, tp, batch_slots=4, max_len=64,
                        torch_device="cpu").run(reqs(S))
    assert {r.rid: r.out_tokens for r in got} \
        == {r.rid: r.out_tokens for r in want}
    assert all(len(r.out_tokens) == 16 for r in got)


def test_serve_engine_refuses_whisper():
    """Its prefill needs frames, which token requests do not carry (the
    reference's engine fails there with an AttributeError)."""
    _, tcfg = configs(WHISPER)
    tp = TT.init_params(tcfg, 0, torch_device="cpu")
    with pytest.raises(ValueError, match="frames"):
        S.ServeEngine(tcfg, tp, torch_device="cpu")


def test_cli_serves_phi3_vision_on_the_cpu(capsys):
    S.main(["--arch", VISION, "--reduced", "--device", "cpu", "--quantized",
            "--requests", "3", "--max-new", "4", "--slots", "2"])
    out = capsys.readouterr().out
    assert "int8 PTQ" in out and "served 3 requests, 12 tokens" in out
