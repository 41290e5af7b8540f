"""The port's xLSTM blocks and xlstm-1.3b served, against the reference.

Reduced xlstm (4 layers: mLSTM, sLSTM, mLSTM, sLSTM; d 64, 4 heads, so
q/k width N = 64 and v width P = 32 + 1 with the denominator channel)
in float32.  The reference's weights (``mlstm_init``, ``slstm_init``,
``init_params`` from a PRNG key, and ``quantize_params``) cross into the
port as numpy trees (``convert.lm_params_from_numpy``); inputs are made
with numpy from a seed.  The reference model runs eagerly; its serving
engine is compared as it is (jitted).

Tolerances, relative to the largest magnitude: 1e-5 for the blocks, the
caches and the float-weight logits (sums in another order; seen about
1e-6).  Int8-weight logits: 5e-3.  The two packages' norms differ by an
ulp or two before the first linear already, and an activation whose
x / scale sits that close to a rounding tie quantizes to the next int8
step in one package only: one such flip in the last layer's ``down``
moved the logits by 1.7e-3 of max|logit| (seed 32, decode step 1; every
other call within 2.2e-7).  So the int8 run also holds every
quantized_linear call's int8 activations to the reference's, a
difference allowed only at such a tie
(``torch_cases.assert_int8_activations_match``).  Prefill(15) then one decode step against
prefill(16): 2e-3 on float weights (the reference's own limit,
``tests/test_arch_smoke.py``), and on int8 weights the reference's own
gap (the activations' per-tensor scale spans 16 tokens in one case and
1 in the other) held within 1e-5 of max|logit|.  Greedy tokens of the
two serving engines are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.vta_gemm.ops as r_vta_ops
import repro.models.layers as RL
import repro_torch.kernels.vta_gemm.ops as t_vta_ops
import repro_torch.models.layers as TL

from repro.configs import get_arch as r_get_arch, reduced as r_reduced
from repro.launch import serve as R
from repro.models import transformer as RT
from repro.models import xlstm as RX
from repro.models.quantized import quantize_params as r_quantize_params
from repro_torch import convert
from repro_torch.launch import serve as S
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.models.quantized import quantize_params
from torch_cases import (assert_int8_activations_match,
                         record_int8_activations)

ARCH = "xlstm-1.3b"
CPU = torch.device("cpu")


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def rel_err(got, want):
    got = got.to(torch.float32).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def configs(**kw):
    rcfg = r_reduced(r_get_arch(ARCH).model).replace(**kw)
    return rcfg, convert.model_config_from_fields(dataclasses.asdict(rcfg))


def cross(tree):
    """A reference tree (JAX) as the port's nested dict of CPU tensors."""
    return convert.lm_params_from_numpy(to_numpy(tree), CPU).tree()


def _params(rcfg, quant):
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    if quant:
        rp = r_quantize_params(rp)
    return rp, convert.lm_params_from_numpy(to_numpy(rp), CPU)


# ----------------------------------------------------------------------
# the blocks
# ----------------------------------------------------------------------
BLOCKS = {
    "mlstm": (RX.mlstm_init, RX.init_mlstm_cache, RX.mlstm_prefill,
              RX.mlstm_decode, TX.init_mlstm_cache, TX.mlstm_prefill,
              TX.mlstm_decode),
    "slstm": (RX.slstm_init, RX.init_slstm_cache, RX.slstm_prefill,
              RX.slstm_decode, TX.init_slstm_cache, TX.slstm_prefill,
              TX.slstm_decode),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_prefill_then_decode_with_caches(block):
    """Prefill 12 steps from a fresh cache, then 3 decode steps: the
    outputs and every cache entry within 1e-5; the caches float32."""
    r_init, r_cache, r_pre, r_dec, t_cache, t_pre, t_dec = BLOCKS[block]
    rcfg, tcfg = configs()
    rp = r_init(jax.random.PRNGKey(1), rcfg)
    tp = cross(rp)
    rc = r_cache(rcfg, 2)
    tc = t_cache(tcfg, 2, CPU)
    assert set(tc) == set(rc)
    rng = np.random.default_rng(30)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    with jax.disable_jit():
        want, rc = r_pre(rp, rcfg, jnp.asarray(x), rc)
    got, tc = t_pre(tp, tcfg, torch.from_numpy(x), tc)
    assert rel_err(got, want) <= 1e-5
    for k in rc:
        assert tc[k].dtype == torch.float32
        assert rel_err(tc[k], rc[k]) <= 1e-5, k
    for step in range(3):
        xd = rng.normal(size=(2, 1, 64)).astype(np.float32)
        with jax.disable_jit():
            want, rc = r_dec(rp, rcfg, jnp.asarray(xd), rc)
        got, tc = t_dec(tp, tcfg, torch.from_numpy(xd), tc)
        assert rel_err(got, want) <= 1e-5, step
        for k in rc:
            assert rel_err(tc[k], rc[k]) <= 1e-5, (step, k)


def test_mlstm_qk_width_and_the_denominator_channel():
    """xlstm-1.3b: N = max(64, 1024 / 4) = 256, P = 1024 + 1; reduced:
    N 64, P 33.  A bfloat16 v times the float32 gate is float32, and the
    last channel is the gate rounded to bfloat16."""
    full = convert.model_config_from_fields(
        dataclasses.asdict(r_get_arch(ARCH).model))
    assert TX._qk_dim(full) == RX._qk_dim(r_get_arch(ARCH).model) == 256
    rcfg, tcfg = configs()
    assert TX._qk_dim(tcfg) == RX._qk_dim(rcfg) == 64
    c = TX.init_mlstm_cache(tcfg, 3, CPU)["h"]
    assert tuple(c.shape) == (3, 4, 64, 33) and c.dtype == torch.float32
    rng = np.random.default_rng(31)
    v = torch.from_numpy(rng.normal(size=(1, 2, 4, 8)).astype(np.float32))
    i = torch.from_numpy(rng.random(size=(1, 2, 4)).astype(np.float32))
    vi = TX._with_denominator(v.bfloat16(), i)
    assert vi.dtype == torch.float32
    want = jnp.concatenate(
        [jnp.asarray(v.numpy(), jnp.bfloat16) * jnp.asarray(i.numpy())[
            ..., None],
         jnp.asarray(i.numpy())[..., None].astype(jnp.bfloat16)], axis=-1)
    assert want.dtype == jnp.float32
    np.testing.assert_array_equal(vi.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
@pytest.mark.parametrize("quant,tol", [(False, 1e-5), (True, 5e-3)],
                         ids=["float", "int8"])
def test_prefill_and_decode_logits(monkeypatch, quant, tol):
    rcfg, tcfg = configs()
    rp, tp = _params(rcfg, quant)
    want_q = record_int8_activations(monkeypatch, RL, r_vta_ops)
    got_q = record_int8_activations(monkeypatch, TL, t_vta_ops)
    toks = np.random.default_rng(32).integers(0, rcfg.vocab_size,
                                              (2, 12)).astype(np.int32)
    rc = RT.init_caches(rcfg, 2, 32, jnp.float32)
    tc = TT.init_caches(tcfg, 2, 32, torch.float32, "cpu")
    with jax.disable_jit():
        want, rc = RT.prefill(rp, rcfg, {"tokens": jnp.asarray(toks)}, rc)
    with torch.inference_mode():
        got, tc = TT.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                             tc)
    errs = [rel_err(got, want)]
    tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    for i in range(3):
        with jax.disable_jit():
            want, rc = RT.decode_step(rp, rcfg, rc, jnp.asarray(tok),
                                      jnp.int32(12 + i))
        with torch.inference_mode():
            got, tc = TT.decode_step(tp, tcfg, tc, torch.from_numpy(tok),
                                     12 + i)
        errs.append(rel_err(got, want))
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    assert max(errs) <= tol, errs
    # 7 quantized linears an mLSTM layer, 2 an sLSTM layer; 4 calls
    assert len(got_q) == (4 * (7 * 2 + 2 * 2) if quant else 0)
    assert_int8_activations_match(got_q, want_q)


def _continue(prefill, decode, init, params, cfg, toks):
    """(logits of prefill(S) then one decode step, of prefill(S + 1))."""
    S_ = toks.shape[1] - 1
    _, caches = prefill(params, cfg, {"tokens": toks[:, :S_]}, init())
    dec, _ = decode(params, cfg, caches, toks[:, S_:], S_)
    full, _ = prefill(params, cfg, {"tokens": toks}, init())
    return dec, full


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_decode_continues_prefill(quant):
    """Prefill(15) then decode == prefill(16) last logits (the reference's
    check in tests/test_arch_smoke.py), within 2e-3 on float weights; on
    int8 weights the port's gap is held to the reference's own."""
    rcfg, tcfg = configs()
    rp, tp = _params(rcfg, quant)
    toks = np.random.default_rng(33).integers(0, tcfg.vocab_size, (1, 16))
    with torch.inference_mode():
        dec, full = _continue(
            TT.prefill, TT.decode_step,
            lambda: TT.init_caches(tcfg, 1, 32, torch.float32, "cpu"), tp,
            tcfg, torch.from_numpy(toks))
    if not quant:
        np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-3,
                                   rtol=2e-3)
        return
    with jax.disable_jit():
        r_dec, r_full = _continue(
            RT.prefill, lambda p, c, cc, t, pos: RT.decode_step(
                p, c, cc, t, jnp.int32(pos)),
            lambda: RT.init_caches(rcfg, 1, 32, jnp.float32), rp, rcfg,
            jnp.asarray(toks, jnp.int32))
    gap = np.asarray(r_dec) - np.asarray(r_full)
    assert rel_err(dec - full, gap) * np.abs(gap).max() \
        <= 1e-5 * float(full.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_bytes_equal_and_the_tree_crosses_whole(dtype):
    """Every int8 weight and scale of the xlstm tree (the mLSTM's seven
    linears, w_if with N = 2H among them, and the sLSTM's w_in and down)
    is byte-equal to the reference's; the sLSTM's recurrent r stays
    float32 and equal; the converter carries every leaf across."""
    rcfg, tcfg = configs(dtype=dtype)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rq = to_numpy(r_quantize_params(rp))
    own = quantize_params(convert.lm_params_from_numpy(to_numpy(rp), CPU))
    crossed = convert.lm_params_from_numpy(rq, CPU)
    want = {".".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(rq)}
    for name in ("layers.mlstm.mlstm.wq.w_q", "layers.mlstm.mlstm.w_if.w_q",
                 "layers.slstm.slstm.w_in.w_q", "layers.slstm.slstm.r"):
        assert name in want
    for params in (own, crossed):
        got = params.state_dict()
        assert set(got) == set(want)
        for name, leaf in want.items():
            t = got[name]
            assert tuple(t.shape) == leaf.shape, name
            assert str(t.dtype).split(".")[-1] == str(leaf.dtype), name
            np.testing.assert_array_equal(t.float().numpy(),
                                          leaf.astype(np.float32),
                                          err_msg=name)
        assert got["layers.slstm.slstm.r"].dtype == torch.float32
        w_q = params.tree()["layers"]["mlstm"]["mlstm"]["w_if"]["w_q"]
        assert w_q.shape[-1] == 2 * tcfg.n_heads
        assert w_q.transpose(-1, -2).is_contiguous()


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_own_init_and_caches_have_the_reference_tree():
    """The port's own init has the reference's tree paths and shapes (so
    the converter carries weights by name); its caches too, float32 for
    a bfloat16 cache dtype, the sLSTM n ones."""
    rcfg, tcfg = configs()
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    own = TT.init_params(tcfg, 0, torch_device="cpu")
    shapes = {k: tuple(v.shape) for k, v in own.state_dict().items()}
    want = {".".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(rp)}
    assert shapes == want
    assert own.state_dict()["layers.slstm.slstm.r"].dtype == torch.float32
    caches = TT.init_caches(tcfg, 2, 16, torch.bfloat16, "cpu")
    r_caches = RT.init_caches(rcfg, 2, 16, jnp.bfloat16)
    got = {".".join(p): (tuple(t.shape), str(t.dtype).split(".")[-1])
           for p, t in _leaves(caches)}
    want = {".".join(str(k.key) for k in path): (leaf.shape,
                                                 str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(r_caches)}
    assert got == want
    assert bool((caches["layers"]["slstm"]["n"] == 1).all())


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def _requests(module, cfg, max_new, prompt_len=16):
    rng = np.random.default_rng(0)
    return [module.Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, size=prompt_len).astype(np.int32), max_new=m)
        for i, m in enumerate(max_new)]


@pytest.mark.parametrize("traffic", ["cli", "staggered"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_serve_engine_tokens_equal_the_reference(quant, traffic):
    """The reference CLI's traffic (6 x 16-token prompts, 16 new tokens,
    4 slots) and staggered admission (2 slots, 4, 12 and 8 new tokens):
    the mLSTM and sLSTM states are spliced per slot."""
    rcfg, tcfg = configs()
    rp, tp = _params(rcfg, quant)
    max_new, slots = ([16] * 6, 4) if traffic == "cli" else ([4, 12, 8], 2)
    want = R.ServeEngine(rcfg, rp, batch_slots=slots, max_len=64).run(
        _requests(R, rcfg, max_new))
    got = S.ServeEngine(tcfg, tp, batch_slots=slots, max_len=64,
                        torch_device="cpu").run(_requests(S, tcfg, max_new))
    want = {r.rid: r.out_tokens for r in want}
    got = {r.rid: r.out_tokens for r in got}
    assert got == want
    assert [len(got[i]) for i in sorted(got)] == max_new


def test_a_prompt_the_chunk_does_not_divide_raises():
    """The mLSTM's chunk 512: a 600-token prompt is rejected as the
    reference's chunked_gla rejects it (an assert there, ValueError
    here); 512 and 40 tokens are served."""
    rcfg, tcfg = configs()
    rp, tp = _params(rcfg, False)
    with pytest.raises(AssertionError):
        R.ServeEngine(rcfg, rp, batch_slots=1, max_len=64).add_request(
            _requests(R, rcfg, [2], prompt_len=600)[0])
    eng = S.ServeEngine(tcfg, tp, batch_slots=2, max_len=64,
                        torch_device="cpu")
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        eng.add_request(_requests(S, tcfg, [2], prompt_len=600)[0])
    assert eng.add_request(_requests(S, tcfg, [2], prompt_len=512)[0])
    assert eng.add_request(_requests(S, tcfg, [2], prompt_len=40)[0])


def test_a_spliced_slot_starts_from_the_fresh_slstm_state():
    """The batch caches start with the sLSTM n at ones; a request spliced
    into slot 1 carries the state a one-row prefill from n = 1 gives, and
    the free slots keep n = 1, c = h = 0."""
    rcfg, tcfg = configs()
    _, tp = _params(rcfg, False)
    eng = S.ServeEngine(tcfg, tp, batch_slots=3, max_len=64,
                        torch_device="cpu")
    sl = eng.caches["layers"]["slstm"]
    assert bool((sl["n"] == 1).all()) and not sl["c"].any()
    eng.slot_req[0] = object()          # slot 0 busy: the request takes 1
    req = _requests(S, tcfg, [2])[0]
    assert eng.add_request(req)
    one = TT.init_caches(tcfg, 1, 64, torch.float32, "cpu")
    with torch.inference_mode():
        TT.prefill(tp, tcfg, {"tokens": torch.from_numpy(req.prompt[None])},
                   one)
    for k in ("c", "n", "h"):
        torch.testing.assert_close(sl[k][:, 1:2], one["layers"]["slstm"][k],
                                   rtol=0, atol=0)
    assert bool((sl["n"][:, 0::2] == 1).all())
    assert not sl["c"][:, 0::2].any() and not sl["h"][:, 0::2].any()


def test_cli_serves_xlstm_on_the_cpu(capsys):
    S.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--quantized",
            "--requests", "3", "--max-new", "4", "--slots", "2"])
    out = capsys.readouterr().out
    assert "int8 PTQ" in out and "served 3 requests, 12 tokens" in out
