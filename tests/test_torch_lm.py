"""The LM substrate in the port against the reference package.

The reference's weights (``init_params`` from a PRNG key, and
``quantize_params``) cross into the port as numpy trees
(``convert.lm_params_from_numpy``); inputs are made with numpy from a
seed.  The JAX side runs with ``use_pallas=True`` (the Pallas kernels in
interpret mode) and ``use_pallas=False`` (its jnp oracles).

Tolerances:
  * layers and logits in float32: 1e-5 relative to the largest magnitude
    (sums in another order; the models agree to about 6e-7);
  * bfloat16 layers: one bfloat16 rounding step, 2^-7 relative to the
    largest magnitude (the two frameworks round intermediate bfloat16
    results at other places);
  * the int8 activations of ``quantized_linear`` and the int8 weights of
    ``quantize_params``: byte-equal, scales equal;
  * prefill(S) then one decode step against prefill(S + 1), on the port:
    2e-3 in float, the reference's own limit in
    ``tests/test_arch_smoke.py``; 2e-2 on int8 weights, where the
    activations' per-tensor scale differs between a 16-token prefill and
    a 1-token step (seen: 8.8e-3 at max|logit| 0.49).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.vta_gemm.ops as r_vta_ops
import repro_torch.kernels.vta_gemm.ops as t_vta_ops
from repro.configs import get_arch as r_get_arch, reduced as r_reduced
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.config import ModelConfig as RConfig
from repro.models.quantized import quantize_params as r_quantize_params
from repro_torch import convert
from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.quantized import quantize_params

ARCHS = ["llama3.2-3b", "olmo-1b", "starcoder2-7b"]


def to_numpy(tree):
    """A JAX weight tree as nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def rel_err(got, want):
    got = got.to(torch.float32).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def configs(arch, **kw):
    rcfg = r_reduced(r_get_arch(arch).model).replace(**kw)
    return rcfg, convert.model_config_from_fields(dataclasses.asdict(rcfg))


def cpu_params(rp):
    return convert.lm_params_from_numpy(to_numpy(rp), torch_device="cpu")


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------
def test_configs_equal_the_reference():
    for a in list_archs():
        r, t = r_get_arch(a), get_arch(a)
        assert dataclasses.asdict(t.model) == dataclasses.asdict(r.model)
        assert dataclasses.asdict(reduced(t.model)) \
            == dataclasses.asdict(r_reduced(r.model))
        assert (t.optimizer, t.fsdp, t.shapes, t.dp_over_model) \
            == (r.optimizer, r.fsdp, r.shapes, r.dp_over_model)
        cfg = convert.model_config_from_fields(dataclasses.asdict(r.model))
        assert cfg == t.model and cfg.hd == r.model.hd
        assert cfg.block_pattern() == r.model.block_pattern()
        assert cfg.param_counts() == r.model.param_counts()


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparametric"])
def test_norms(norm, dtype):
    rcfg, tcfg = configs("llama3.2-3b", norm=norm)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    p = {k: rng.normal(size=64).astype(np.float32)
         for k in RL.norm_init(rcfg, 64)}
    want = RL.norm_apply(rcfg, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x, getattr(jnp, dtype)))
    got = TL.norm_apply(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert rel_err(got, want) <= (1e-5 if dtype == "float32" else 2 ** -7)
    assert set(TL.norm_init(tcfg, 64, torch.device("cpu"))) == set(p)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope(theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 7))
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    assert rel_err(got, want) <= 1e-5
    np.testing.assert_allclose(TL.rope_frequencies(128, theta).numpy(),
                               np.asarray(RL.rope_frequencies(128, theta)),
                               rtol=1e-6)


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_mlp_gelu_is_the_tanh_approximation(mlp):
    rcfg, tcfg = configs("starcoder2-7b", mlp=mlp)
    rng = np.random.default_rng(3)
    p = to_numpy(RL.mlp_init(jax.random.PRNGKey(1), rcfg, 64, 128))
    x = rng.normal(size=(2, 4, 64)).astype(np.float32) * 2
    want = RL.mlp_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), rcfg)
    tp = {k: {"w": torch.from_numpy(np.array(v["w"]))} for k, v in p.items()}
    got = TL.mlp_apply(tp, torch.from_numpy(x), tcfg)
    assert rel_err(got, want) <= 1e-5
    if mlp == "gelu":
        h = x @ p["wi"]["w"]
        exact = torch.nn.functional.gelu(torch.from_numpy(h)) \
            @ torch.from_numpy(np.array(p["wo"]["w"]))
        assert rel_err(exact, want) > 1e-4     # exact gelu would differ


@pytest.mark.parametrize("pos", ["rope", "learned", "sinusoidal"])
def test_embeddings(pos):
    rcfg, tcfg = configs("llama3.2-3b", pos=pos)
    p = to_numpy(RL.embed_init(jax.random.PRNGKey(2), rcfg))
    toks = np.random.default_rng(4).integers(0, rcfg.vocab_size, (2, 9))
    want = RL.embed_apply(jax.tree.map(jnp.asarray, p), rcfg,
                          jnp.asarray(toks, jnp.int32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got = TL.embed_apply(tp, tcfg, torch.from_numpy(toks))
    assert rel_err(got, want) <= 1e-5
    positions = np.full((2, 1), 37)
    want = RL.embed_apply(jax.tree.map(jnp.asarray, p), rcfg,
                          jnp.asarray(toks[:, :1], jnp.int32),
                          positions=jnp.asarray(positions))
    got = TL.embed_apply(tp, tcfg, torch.from_numpy(toks[:, :1]),
                         positions=torch.from_numpy(positions))
    assert rel_err(got, want) <= 1e-5
    np.testing.assert_allclose(TL.sinusoidal_embedding(64, 32).numpy(),
                               np.asarray(RL.sinusoidal_embedding(64, 32)),
                               atol=1e-6)


def _capture(monkeypatch, module):
    seen = []
    real = module.vta_gemm

    def spy(a, *args, **kw):
        seen.append(np.asarray(a))
        return real(a, *args, **kw)
    monkeypatch.setattr(module, "vta_gemm", spy)
    return seen


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_linear_int8_activations_equal(monkeypatch, dtype,
                                                 use_pallas):
    """The activation quantization takes the reference's dtype steps: the
    int8 operands of the GEMM are byte-equal, in float32 and bfloat16."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 5, 96)) * 4).astype(np.float32)
    x[0, 0, :4] = [0.0, 2.5, -1e-7, 7.25]
    w = rng.normal(size=(96, 40)).astype(np.float32) * 0.2
    rq = RL.quantize_linear_params({"w": jnp.asarray(w)})
    tq = TL.quantize_linear_params({"w": torch.from_numpy(w)})
    r_seen = _capture(monkeypatch, r_vta_ops)
    t_seen = _capture(monkeypatch, t_vta_ops)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = RL.linear_apply(rq, jx, RConfig(
        name="t", family="dense", n_layers=1, d_model=96, n_heads=1,
        n_kv_heads=1, d_ff=1, vocab_size=1, use_pallas=use_pallas))
    got = TL.linear_apply(tq, tx)
    assert len(r_seen) == len(t_seen) == 1
    assert r_seen[0].dtype == np.int8 and t_seen[0].dtype == np.int8
    np.testing.assert_array_equal(t_seen[0], r_seen[0])
    assert got.dtype == tx.dtype and got.shape == (3, 5, 40)
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    assert rel_err(got, want) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_bytes_equal(dtype):
    rcfg, tcfg = configs("llama3.2-3b", dtype=dtype)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rq = to_numpy(r_quantize_params(rp))
    tq = quantize_params(cpu_params(rp)).tree()
    tq_from_ref = convert.lm_params_from_numpy(rq, "cpu").tree()
    for tree in (tq, tq_from_ref):
        for name in ("wq", "wk", "wv", "wo"):
            want = rq["layers"]["attn"]["attn"][name]
            got = tree["layers"]["attn"]["attn"][name]
            assert got["w_q"].dtype == torch.int8
            assert got["w_q"].transpose(-1, -2).is_contiguous()
            np.testing.assert_array_equal(got["w_q"].numpy(), want["w_q"])
            np.testing.assert_array_equal(got["w_scale"].numpy(),
                                          want["w_scale"])
        for name in ("wi", "wg", "wo"):
            np.testing.assert_array_equal(
                tree["layers"]["attn"]["mlp"][name]["w_q"].numpy(),
                rq["layers"]["attn"]["mlp"][name]["w_q"])
        assert tree["embed"]["tokens"].dtype == getattr(torch, dtype)


def test_state_dict_keys_are_the_reference_tree_paths():
    rcfg, tcfg = configs("starcoder2-7b")
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    paths = {".".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(rp)}
    ported = cpu_params(rp)
    assert set(ported.state_dict()) == paths
    own = TT.init_params(tcfg, 0, torch_device="cpu")
    assert set(own.state_dict()) == paths
    for k, v in own.state_dict().items():
        assert tuple(v.shape) == ported.state_dict()[k].shape, k
    assert "layers.attn.attn.wq.w" in paths
    q = quantize_params(own)
    assert "layers.attn.attn.wq.w_q" in q.state_dict()
    assert q.tree()["embed"]["tokens"] is own.tree()["embed"]["tokens"]


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def _attn_setup(kv_quant, dtype="float32", seed=0):
    rcfg, tcfg = configs("llama3.2-3b", kv_cache_quant=kv_quant,
                         dtype=dtype)
    rp = to_numpy(RA.attn_init(jax.random.PRNGKey(seed), rcfg))
    tp = {k: {"w": convert.lm_params_from_numpy({"w": v["w"]}, "cpu")
              .tree()["w"]} for k, v in rp.items()}
    return rcfg, tcfg, jax.tree.map(jnp.asarray, rp), tp


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32kv", "int8kv"])
def test_attn_prefill_and_decode(kv_quant, use_pallas):
    rcfg, tcfg, rp, tp = _attn_setup(kv_quant)
    rcfg = rcfg.replace(use_pallas=use_pallas)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    rc = RA.init_kv_cache(rcfg, 2, 32, jnp.float32)
    tc = TA.init_kv_cache(tcfg, 2, 32, torch.float32, torch.device("cpu"))
    want, rc = RA.attn_prefill(rp, rcfg, jnp.asarray(x), rc)
    got, tc = TA.attn_prefill(tp, tcfg, torch.from_numpy(x), tc)
    assert rel_err(got, want) <= 1e-5
    for name in rc:
        if rc[name].dtype == jnp.int8:
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(rc[name]))
        else:
            assert rel_err(tc[name], rc[name]) <= 1e-5
    for step, pos in enumerate((12, 13, 14)):
        xd = rng.normal(size=(2, 1, 64)).astype(np.float32)
        want, rc = RA.attn_decode(rp, rcfg, jnp.asarray(xd), rc,
                                  jnp.int32(pos))
        got, tc = TA.attn_decode(tp, tcfg, torch.from_numpy(xd), tc, pos)
        assert rel_err(got, want) <= 1e-5, step


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
def test_attn_decode_bf16_model_over_f32_cache(use_pallas):
    """The serve engine's case: a bfloat16 model over float32 caches.  The
    reference's Pallas kernel upcasts the query; so does the port."""
    rcfg, tcfg, rp, tp = _attn_setup(False, dtype="bfloat16", seed=3)
    rcfg = rcfg.replace(use_pallas=use_pallas)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    rc = RA.init_kv_cache(rcfg, 2, 32, jnp.float32)
    tc = TA.init_kv_cache(tcfg, 2, 32, torch.float32, torch.device("cpu"))
    _, rc = RA.attn_prefill(rp, rcfg, jnp.asarray(x, jnp.bfloat16), rc)
    _, tc = TA.attn_prefill(tp, tcfg, torch.from_numpy(x).bfloat16(), tc)
    assert tc["k"].dtype == torch.float32
    xd = rng.normal(size=(2, 1, 64)).astype(np.float32)
    want, _ = RA.attn_decode(rp, rcfg, jnp.asarray(xd, jnp.bfloat16), rc,
                             jnp.int32(8))
    got, _ = TA.attn_decode(tp, tcfg, torch.from_numpy(xd).bfloat16(), tc, 8)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) <= 2 ** -6


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
def _prefill_decode(arch, quant, use_pallas, steps=2):
    rcfg, tcfg = configs(arch, use_pallas=use_pallas)
    r_prefill = jax.jit(lambda p, b, c: RT.prefill(p, rcfg, b, c))
    r_decode = jax.jit(lambda p, c, t, pos: RT.decode_step(p, rcfg, c, t,
                                                           pos))
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    if quant:
        rp = r_quantize_params(rp)
    tp = cpu_params(rp)
    toks = np.random.default_rng(8).integers(0, rcfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    rc = RT.init_caches(rcfg, 2, 32, jnp.float32)
    tc = TT.init_caches(tcfg, 2, 32, torch.float32, torch_device="cpu")
    want, rc = r_prefill(rp, {"tokens": jnp.asarray(toks)}, rc)
    with torch.inference_mode():
        got, tc = TT.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, tc)
    errs = [rel_err(got, want)]
    tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    assert np.array_equal(torch.argmax(got, -1).numpy(), tok)
    for i in range(steps):
        want, rc = r_decode(rp, rc, jnp.asarray(tok), jnp.int32(12 + i))
        with torch.inference_mode():
            got, tc = TT.decode_step(tp, tcfg, tc, torch.from_numpy(tok),
                                     12 + i)
        errs.append(rel_err(got, want))
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        assert np.array_equal(torch.argmax(got, -1).numpy(), tok)
    return errs


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits(arch, quant, use_pallas):
    errs = _prefill_decode(arch, quant, use_pallas)
    assert max(errs) <= 1e-5, errs


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_decode_continues_prefill(quant):
    """Prefill(S) then decode == prefill(S+1) last logits, on the port
    (the reference's check in tests/test_arch_smoke.py)."""
    _, tcfg = configs("olmo-1b")
    params = TT.init_params(tcfg, 3, torch_device="cpu")
    if quant:
        params = quantize_params(params)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (1, 16)))
    with torch.inference_mode():
        caches = TT.init_caches(tcfg, 1, 32, torch.float32, "cpu")
        _, caches = TT.prefill(params, tcfg, {"tokens": toks[:, :15]}, caches)
        dec, _ = TT.decode_step(params, tcfg, caches, toks[:, 15:16], 15)
        full, _ = TT.prefill(params, tcfg, {"tokens": toks},
                             TT.init_caches(tcfg, 1, 32, torch.float32,
                                            "cpu"))
    tol = 2e-3 if not quant else 2e-2
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=tol,
                               rtol=tol)


def test_logit_softcap_and_untied_head():
    rcfg, tcfg = configs("llama3.2-3b", logit_softcap=3.0,
                         tie_embeddings=False)
    rp = RT.init_params(jax.random.PRNGKey(4), rcfg)
    h = np.random.default_rng(10).normal(size=(2, 3, 64)).astype(np.float32)
    want = RT.logits_fn(rp, rcfg, jnp.asarray(h))
    got = TT.logits_fn(cpu_params(rp).tree(), tcfg, torch.from_numpy(h))
    assert rel_err(got, want) <= 1e-5
    assert float(got.abs().max()) < 3.0
