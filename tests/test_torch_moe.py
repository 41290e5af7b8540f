"""The port's moe block and the moe models served, against the reference.

Reduced phi3.5-moe-42b-a6.6b and kimi-k2-1t-a32b (``configs.reduced``: 2
layers, d 64, 4 experts, top-2, expert width 64; kimi-k2 with one shared
expert, rmsnorm) in float32.  The reference's weights (``moe_init``,
``init_params`` from a PRNG key, and ``quantize_params``) cross into the
port as numpy trees (``convert.lm_params_from_numpy``); inputs are made
with numpy from a seed.  The reference runs eagerly; its serving engine
is compared as it is (jitted).

Tolerances, relative to the largest magnitude: the routing's gates and
aux loss 1e-6, ``moe_apply`` and the float-weight logits 1e-5 (sums in
another order).  The dispatch plan (sort order, slot, kept pairs), the
top-k ids and the capacity are equal.  At k = 8 over 16 experts in
bfloat16 the dispatch and combine are bitwise equal to the reference's:
each token's k contributions are added in the order of the sorted
pairs, and that order shows (adding them in top-k order differs).
Int8-weight logits: 5e-3, with every quantized_linear call's int8
activations equal to the reference's except at a rounding tie
(``torch_cases.assert_int8_activations_match``).  Prefill(15) then one
decode step against prefill(16): 2e-3 on float weights (the reference's
own limit), on int8 weights the reference's own gap held within 1e-5 of
max|logit|.  Greedy tokens of the two serving engines are equal.
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
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.models.quantized import quantize_params as r_quantize_params
from repro_torch import convert
from repro_torch.launch import serve as S
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.quantized import quantize_params
from torch_cases import (assert_int8_activations_match,
                         record_int8_activations)

PHI, KIMI = "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"
ARCHS = [PHI, KIMI]
CPU = torch.device("cpu")


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


def cross(tree):
    """A reference tree (JAX) as the port's nested dict of CPU tensors."""
    return convert.lm_params_from_numpy(to_numpy(tree), CPU).tree()


def _params(rcfg, quant):
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    if quant:
        rp = r_quantize_params(rp)
    return rp, convert.lm_params_from_numpy(to_numpy(rp), CPU)


class _PlanSpy:
    """Stands in for ``jnp`` inside the reference's moe module and records
    its dispatch plan: the stable argsort's order and the slots the
    combine reads (``dest``, the second ``jnp.take``)."""

    def __init__(self):
        self.orders, self.takes = [], []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argsort(self, *args, **kw):
        out = jnp.argsort(*args, **kw)
        self.orders.append(np.asarray(out))
        return out

    def take(self, a, idx, **kw):
        self.takes.append(np.asarray(idx))
        return jnp.take(a, idx, **kw)


# ----------------------------------------------------------------------
# capacity and routing
# ----------------------------------------------------------------------
@pytest.mark.parametrize("k,E", [(1, 4), (2, 4), (2, 16), (8, 384)])
def test_capacity_equals_the_reference(k, E):
    for T in (1, 3, 4, 15, 16, 17, 64, 512, 4096):
        for cf in (0.25, 1.0, 1.25, 2.0):
            assert TM._capacity(T, k, E, cf) == RM._capacity(T, k, E, cf)
    assert TM._capacity(4, 2, 16, 1.25) == 8          # a phi decode step
    assert TM._capacity(512, 2, 16, 1.25) == 80       # phi's long prompt


@pytest.mark.parametrize("arch", ARCHS)
def test_route_equals_the_reference(arch):
    """Top-k ids equal; gates and the aux loss within 1e-6."""
    rcfg, tcfg = configs(arch)
    rp = RM.moe_init(jax.random.PRNGKey(1), rcfg)
    x = np.random.default_rng(20).normal(size=(24, 64)).astype(np.float32)
    with jax.disable_jit():
        want_i, want_g, want_aux = RM._route(rcfg, jnp.asarray(x),
                                             rp["router"]["w"])
    got_i, got_g, got_aux = TM._route(tcfg, torch.from_numpy(x),
                                      cross(rp)["router"]["w"])
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_g.dtype == torch.float32
    assert rel_err(got_g, want_g) <= 1e-6
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6 * float(want_aux)


def test_route_ties_take_the_lower_expert_first():
    """Equal router columns give equal probabilities: jax.lax.top_k takes
    the lower index first, and so does the port.  All four equal (every
    token routes to 0 and 1), and two equal pairs (columns 1 and 3 above
    0 and 2: 1 before 3)."""
    rcfg, tcfg = configs(PHI)
    x = np.random.default_rng(21).normal(size=(10, 64)).astype(np.float32)
    col = np.random.default_rng(22).normal(size=(64,)).astype(np.float32)
    pair = np.stack([col * 0, col, col * 0, col], axis=1)
    for w, first in ((np.repeat(col[:, None], 4, axis=1), [0, 1]),
                     (pair, None)):
        with jax.disable_jit():
            want_i, want_g, _ = RM._route(rcfg, jnp.asarray(x),
                                          jnp.asarray(w))
        got_i, got_g, _ = TM._route(tcfg, torch.from_numpy(x),
                                    torch.from_numpy(w))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        assert rel_err(got_g, want_g) <= 1e-6
        if first is not None:
            assert (got_i.numpy() == first).all()
    # the tied pair: each token takes 1 and 3 where x . col > 0, else 0, 2
    pos = (x @ col) > 0
    np.testing.assert_array_equal(got_i.numpy()[pos], [[1, 3]] * pos.sum())
    np.testing.assert_array_equal(got_i.numpy()[~pos],
                                  [[0, 2]] * (~pos).sum())


# ----------------------------------------------------------------------
# dispatch, experts, combine
# ----------------------------------------------------------------------
MOE_CASES = {
    # (arch, capacity factor, router skew towards expert 0)
    "no_drops": (PHI, 4.0, 0.0),
    "drops": (PHI, 0.25, 2.0),
    "shared": (KIMI, 1.25, 0.0),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_float32(monkeypatch, case):
    """moe_apply within 1e-5 (aux within 1e-6), and the dispatch plan
    equal to the reference's own: its stable sort order, each pair's slot
    (`dest`, the overflow row for a dropped pair) and so the kept pairs.
    "drops": capacity factor 0.25 and a router skewed to expert 0 send
    more pairs to it than its capacity; "shared": kimi-k2's shared
    expert."""
    arch, cf, skew = MOE_CASES[case]
    rcfg, tcfg = configs(arch, moe_capacity_factor=cf)
    rp = RM.moe_init(jax.random.PRNGKey(2), rcfg)
    if skew:
        w = np.array(rp["router"]["w"])
        w[:, 0] += skew * np.abs(w).max()
        rp["router"]["w"] = jnp.asarray(w)
    x = np.random.default_rng(23).normal(size=(2, 12, 64)) \
        .astype(np.float32)
    spy = _PlanSpy()
    monkeypatch.setattr(RM, "jnp", spy)
    with jax.disable_jit():
        want, want_aux = RM.moe_apply(rp, rcfg, jnp.asarray(x))
    monkeypatch.undo()
    tp = cross(rp)
    got, got_aux = TM.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert rel_err(got, want) <= 1e-5
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6 * float(want_aux)
    top_i, _, _ = TM._route(tcfg, torch.from_numpy(x).reshape(24, 64),
                            tp["router"]["w"])
    E, k = tcfg.moe_experts, tcfg.moe_top_k
    C = TM._capacity(24, k, E, cf)
    order, dest, keep = TM.dispatch_plan(top_i.reshape(-1), E, C)
    np.testing.assert_array_equal(order.numpy(), spy.orders[0])
    np.testing.assert_array_equal(dest.numpy(), spy.takes[1])
    np.testing.assert_array_equal(keep.numpy(), spy.takes[1] < E * C)
    dropped = int((~keep).sum())
    assert (dropped > 0) == (case == "drops"), dropped
    assert ("shared" in tp) == (case == "shared")


def _bf16_case(T=12, d=64, f=64, E=16, k=8, seed=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, d)).astype(np.float32)
    ws = [(rng.uniform(-1, 1, size=shape) / 8).astype(np.float32)
          for shape in ((E, d, f), (E, d, f), (E, f, d))]
    probs = rng.dirichlet(np.ones(E), size=T).astype(np.float32)
    top_i = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    top_g = np.take_along_axis(probs, top_i, -1)
    top_g /= top_g.sum(-1, keepdims=True)
    return x, ws, top_i.reshape(-1), top_g.reshape(-1)


def test_combine_at_k8_in_bf16_is_bitwise_the_references():
    """kimi-k2's k = 8, over 16 experts, in bfloat16, with pairs dropped
    (12 tokens: C = 8 < 12 x 8 / 16 at some experts): the dispatch, the
    experts' FFN and the combine are bitwise equal to the eager
    reference.  The combine's order shows: the same contributions added
    in top-k order differ from the reference."""
    k, E = 8, 16
    x, ws, flat_e, flat_g = _bf16_case(k=k, E=E)
    C = RM._capacity(12, k, E, 1.25)
    with jax.disable_jit():
        want = RM._dispatch_compute_combine(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(flat_e, jnp.int32),
            jnp.asarray(flat_g), k, E, 0, C,
            *[jnp.asarray(w, jnp.bfloat16) for w in ws])
    tx = torch.from_numpy(x).bfloat16()
    tws = [torch.from_numpy(w).bfloat16() for w in ws]
    te = torch.from_numpy(flat_e).long()
    tg = torch.from_numpy(flat_g)
    got = TM._dispatch_compute_combine(tx, te, tg, k, C, *tws)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    _, _, keep = TM.dispatch_plan(te, E, C)
    assert not keep.all()
    # the same contributions summed in each token's top-k order
    order, dest, _ = TM.dispatch_plan(te, E, C)
    buf = torch.zeros((E * C + 1, 64), dtype=torch.bfloat16)
    buf[dest] = tx[order // k]
    out = torch.cat([TM._expert_ffn(buf[:E * C].view(E, C, 64), *tws)
                     .reshape(E * C, 64), torch.zeros((1, 64),
                                                      dtype=torch.bfloat16)])
    slot = torch.empty_like(dest)
    slot[order] = dest
    contrib = out[slot] * tg[:, None].bfloat16()
    topk_sum = torch.zeros((12, 64), dtype=torch.bfloat16)
    for j in range(k):
        topk_sum = topk_sum + contrib.view(12, k, 64)[:, j]
    assert not np.array_equal(topk_sum.float().numpy(),
                              np.asarray(want, np.float32))


def test_moe_apply_at_k8_in_bf16_against_the_reference():
    """The whole layer at k = 8 over 16 experts on a bfloat16 model: the
    float32 routing equal, the output bitwise equal."""
    rcfg, tcfg = configs(KIMI, dtype="bfloat16", moe_experts=16,
                         moe_top_k=8)
    rp = RM.moe_init(jax.random.PRNGKey(3), rcfg)
    x = np.random.default_rng(25).normal(size=(2, 6, 64)).astype(np.float32)
    with jax.disable_jit():
        want, _ = RM.moe_apply(rp, rcfg, jnp.asarray(x, jnp.bfloat16))
    got, _ = TM.moe_apply(cross(rp), tcfg, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ----------------------------------------------------------------------
# the models
# ----------------------------------------------------------------------
@pytest.mark.parametrize("quant,tol", [(False, 1e-5), (True, 5e-3)],
                         ids=["float", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits(monkeypatch, arch, quant, tol):
    """A 12-token prefill and three decode steps; on int8 weights every
    quantized_linear call's int8 activations equal the reference's, but
    at a rounding tie."""
    rcfg, tcfg = configs(arch)
    rp, tp = _params(rcfg, quant)
    want_q = record_int8_activations(monkeypatch, RL, r_vta_ops)
    got_q = record_int8_activations(monkeypatch, TL, t_vta_ops)
    toks = np.random.default_rng(26).integers(0, rcfg.vocab_size,
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
    # 4 attention linears a layer, and 3 of the shared expert on kimi-k2
    per_layer = 4 + 3 * tcfg.n_shared_experts
    assert len(got_q) == (4 * tcfg.n_layers * per_layer if quant else 0)
    assert_int8_activations_match(got_q, want_q)


def _continue(prefill, decode, init, params, cfg, toks):
    """(logits of prefill(S) then one decode step, of prefill(S + 1))."""
    S_ = toks.shape[1] - 1
    _, caches = prefill(params, cfg, {"tokens": toks[:, :S_]}, init())
    dec, _ = decode(params, cfg, caches, toks[:, S_:], S_)
    full, _ = prefill(params, cfg, {"tokens": toks}, init())
    return dec, full


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_prefill(arch, quant):
    """Prefill(15) then decode == prefill(16) last logits within 2e-3 on
    float weights; on int8 weights the port's gap is held to the
    reference's own."""
    rcfg, tcfg = configs(arch)
    rp, tp = _params(rcfg, quant)
    toks = np.random.default_rng(27).integers(0, tcfg.vocab_size, (1, 16))
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


def _paths(tree):
    return {".".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_bytes_equal_and_the_tree_crosses_whole(arch):
    """The attention linears and kimi-k2's shared expert (stacked
    (L, d, f) {"w"} nodes) become int8, byte-equal to the reference's;
    the bare (L, E, d, f) expert arrays and the float32 router stay float
    and equal, in both the port's own PTQ and the crossed reference
    tree."""
    rcfg, tcfg = configs(arch, dtype="bfloat16")
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rq = to_numpy(r_quantize_params(rp))
    own = quantize_params(convert.lm_params_from_numpy(to_numpy(rp), CPU))
    crossed = convert.lm_params_from_numpy(rq, CPU)
    want = _paths(rq)
    int8 = ["layers.moe.attn.wq.w_q", "layers.moe.attn.wo.w_q"]
    if arch == KIMI:
        int8 += ["layers.moe.moe.shared.wi.w_q", "layers.moe.moe.shared.wg.w_q",
                 "layers.moe.moe.shared.wo.w_q"]
    else:
        assert not any(".shared." in name for name in want)
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
        for name in int8:
            assert got[name].dtype == torch.int8, name
            assert got[name].transpose(-1, -2).is_contiguous(), name
        assert got["layers.moe.moe.wi"].shape == (2, 4, 64, 64)
        assert got["layers.moe.moe.wi"].dtype == torch.bfloat16
        assert got["layers.moe.moe.router.w"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_own_init_has_the_reference_tree(monkeypatch, arch):
    """The port's own init on a bfloat16 model has the reference's tree
    paths, shapes and dtypes (the router float32, the experts bare
    bfloat16 stacks); the expert stacks are drawn one (d, f) matrix at a
    time (no float32 temporary of a whole stack); its caches are the
    reference's."""
    rcfg, tcfg = configs(arch, dtype="bfloat16")
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    draws = []
    real_rand = torch.rand

    def rand(*args, **kw):
        out = real_rand(*args, **kw)
        draws.append(tuple(out.shape))
        return out
    monkeypatch.setattr(torch, "rand", rand)
    own = TT.init_params(tcfg, 0, torch_device="cpu")
    monkeypatch.undo()
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in own.state_dict().items()}
    want = {k: (leaf.shape, str(leaf.dtype))
            for k, leaf in _paths(rp).items()}
    assert got == want
    L, E, d, f = tcfg.n_layers, tcfg.moe_experts, tcfg.d_model, \
        tcfg.moe_d_ff
    assert draws.count((d, f)) == 3 * L * E           # wi, wg, wo (f = d)
    assert not [s for s in draws if len(s) > 2 and s[-3] == E]
    caches = TT.init_caches(tcfg, 2, 16, torch.bfloat16, "cpu")
    r_caches = RT.init_caches(rcfg, 2, 16, jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in _paths_torch(caches).items()} \
        == {k: (leaf.shape, str(leaf.dtype))
            for k, leaf in _paths(r_caches).items()}


def _paths_torch(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths_torch(v, prefix + (k,)))
        else:
            out[".".join(prefix + (k,))] = v
    return out


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
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_tokens_equal_the_reference(arch, quant, traffic):
    """The reference CLI's traffic (6 x 16-token prompts, 16 new tokens,
    4 slots) and staggered admission (2 slots, 4, 12 and 8 new tokens):
    every decode step routes all slots, empty ones included, and their
    tokens share the capacity, as in the reference."""
    rcfg, tcfg = configs(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_moe_models_on_the_cpu(capsys, arch):
    S.main(["--arch", arch, "--reduced", "--device", "cpu", "--quantized",
            "--requests", "3", "--max-new", "4", "--slots", "2"])
    out = capsys.readouterr().out
    assert "int8 PTQ" in out and "served 3 requests, 12 tokens" in out
