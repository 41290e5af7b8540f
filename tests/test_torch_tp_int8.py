"""int8 serving under a mesh against the reference's meshless int8 model,
on the CPU.

The reduced llama3.2-3b (the reference's ``init_params`` from
``PRNGKey(0)``, then its ``quantize_params``) serves a 16-token prompt
of 4 rows and three decode steps (the reference's own greedy tokens fed
back) on ``gloo`` ranks (``torch_cases.spawn_ranks``: one group of two
ranks and one of four, each under its own timeout), through the dry
run's mesh serve step (``launch/dryrun.py:_serve_step``: each leaf
gathered as the layers compute it, ``sharding.model_split_leaves``) at
(data, model) meshes:

  * (1, 2): the heads and the MLP split over "model": the layers get
    their slices of the int8 weights, column-parallel ones their columns
    of the replicated ``w_scale``, and a row-parallel layer's activation
    scale is its max over "model";
  * (2, 2): the same, with the batch rows also split over "data";
  * (2, 1): only the batch split, where the activation scale is the max
    over "data".

The reduced kimi-k2 (2 layers, 4 experts of which each rank holds 2,
one shared expert) serves the same way at (1, 2) only, through the
fused expert-parallel layer (``models/moe.py:_moe_fused_ep``): the
shared expert's wg and wi take their columns of the int8 weights and of
``w_scale``, its wo its rows and the max over "model".  Its combine is
set to ``psum`` on both sides (the arch's ``reduce_scatter`` sums in
bfloat16 on a mesh, the meshless layer in float32: a different value,
not a fault); the reference's own fused layer reads the shared experts'
float ``w`` and cannot serve int8 weights on a mesh, so the port is held
to the reference's meshless int8 run here too.

Each ``quantized_linear`` call's int8 activations, gathered whole over
the mesh, equal the reference's (``torch_cases.
assert_int8_activations_match``: but by one step at a .5 tie), and the
logits of the prefill and of each step are within 1e-5 of max|logit| of
the reference's (``tests/test_torch_lm.py``'s int8 limit) with the same
greedy tokens.  The reference runs eagerly (jitted, XLA rewrites the
int8 activation quantization).
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.kernels.vta_gemm.ops as r_vta_ops
from repro.configs import get_arch as r_get_arch, reduced as r_reduced
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.quantized import quantize_params as r_quantize_params

from torch_cases import (assert_int8_activations_match,
                         record_int8_activations, spawn_ranks)

#: arch -> (config overrides, the (data, model) meshes it is served on)
ARCHS = {"llama3.2-3b": ({}, [(1, 2), (2, 2), (2, 1)]),
         "kimi-k2-1t-a32b": ({"moe_combine": "psum"}, [(1, 2)])}
CASES = [(arch, mesh) for arch, (_, meshes) in ARCHS.items()
         for mesh in meshes]
IDS = ["tp2", "dp2-tp2", "dp2", "kimi-tp2"]
B, S, STEPS, MAX_LEN = 4, 16, 3, 32

RANK = """
    import pickle
    import numpy as np
    from repro_torch import convert
    from repro_torch.distributed import meshctx
    from repro_torch.distributed.sharding import (
        batch_specs, model_split_leaves, named_shardings, param_specs)
    from repro_torch.kernels.vta_gemm import ops as t_vta_ops
    from repro_torch.launch.dryrun import _cache_layout, _serve_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import _distribute, _rows, _split_mesh_dims
    from repro_torch.models import layers as TL
    from repro_torch.models import transformer as T
    from repro_torch.tree import map_tree
    out = {{}}
    for arch, shape in {cases!r}:
        if shape[0] * shape[1] != WORLD:
            continue
        with open({path!r} + "." + arch, "rb") as f:
            ref = pickle.load(f)
        cfg = convert.model_config_from_fields(ref["cfg"])
        full = convert.lm_params_from_numpy(ref["params"], "cpu").tree()
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        specs = param_specs(full, cfg, mesh)
        split = model_split_leaves(specs, cfg, mesh)
        params = map_tree(_distribute, full, named_shardings(specs, mesh))
        toks = torch.from_numpy(ref["tokens"])
        b_dims = _split_mesh_dims(mesh, batch_specs({{"tokens": toks}}, cfg,
                                                    mesh)["tokens"])
        b_axes = [mesh.mesh_dim_names[i] for i in b_dims]
        caches = _cache_layout(T.init_caches(cfg, toks.shape[0], {max_len},
                                             torch.float32, "cpu"),
                               cfg, mesh, b_dims)
        calls = []
        real_ql, real_gemm = TL.quantized_linear, t_vta_ops.vta_gemm

        def ql(x, *args, **kw):
            calls.append([x.reshape(-1, x.shape[-1]), None])
            return real_ql(x, *args, **kw)

        def gemm(a, *args, **kw):
            if calls and calls[-1][1] is None:
                calls[-1][1] = a
            return real_gemm(a, *args, **kw)
        TL.quantized_linear, t_vta_ops.vta_gemm = ql, gemm
        model = meshctx.axis_of(mesh, "model")
        data = meshctx.axis_of(mesh, "data")

        def whole(t, rows, cols):
            # this rank's block of a (rows, cols) tensor gathered whole
            if t.shape[1] < cols:
                t = meshctx.all_gather_blocks(t.contiguous(), model, 1)
            if t.shape[0] < rows:
                t = meshctx.all_gather_blocks(t.contiguous(), data, 0)
            return t

        logits = []
        with torch.no_grad():
            for step in range({steps} + 1):
                if step == 0:
                    batch = {{"tokens": _rows(toks, mesh, b_dims)}}
                    kind, pos = "prefill", 0
                else:
                    tok = torch.from_numpy(ref["greedy"][step - 1])
                    batch = {{"token": _rows(tok, mesh, b_dims)}}
                    kind, pos = "decode", toks.shape[1] + step - 1
                lg, caches = _serve_step(cfg, kind, mesh, params, split,
                                         batch, caches, pos, b_axes)
                lg = lg.reshape(-1, lg.shape[-1])
                logits.append(whole(lg, ref["logits"][step].shape[0],
                                    cfg.vocab_size).numpy())
        TL.quantized_linear, t_vta_ops.vta_gemm = real_ql, real_gemm
        assert len(calls) == len(ref["x_q"]), (len(calls), len(ref["x_q"]))
        x_q = [whole(q, *want.shape).numpy()
               for (_, q), want in zip(calls, ref["x_q"])]
        out[(arch, tuple(shape))] = dict(logits=logits, x_q=x_q)
    if RANK == 0:
        with open({path!r} + f".{{WORLD}}", "wb") as f:
            pickle.dump(out, f)
"""


def _reference(arch, path):
    """The reference's meshless int8 run of the reduced `arch`, pickled to
    `path`.<arch>: its config, int8 parameters, tokens, greedy tokens,
    logits and int8 activations.  Returns (activation calls, logits)."""
    rcfg = dataclasses.replace(r_reduced(r_get_arch(arch).model),
                               **ARCHS[arch][0])
    rp = r_quantize_params(RT.init_params(jax.random.PRNGKey(0), rcfg))
    toks = np.random.default_rng(29).integers(
        0, rcfg.vocab_size, (B, S)).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        calls = record_int8_activations(mp, RL, r_vta_ops)
        rc = RT.init_caches(rcfg, B, MAX_LEN, jnp.float32)
        lg, rc = RT.prefill(rp, rcfg, {"tokens": jnp.asarray(toks)}, rc)
        logits, greedy = [np.asarray(lg, np.float32).reshape(B, -1)], []
        for i in range(STEPS):
            tok = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
            greedy.append(tok.reshape(B, 1))
            lg, rc = RT.decode_step(rp, rcfg, rc, jnp.asarray(greedy[-1]),
                                    jnp.int32(S + i))
            logits.append(np.asarray(lg, np.float32).reshape(B, -1))
    ref = dict(cfg=dataclasses.asdict(rcfg),
               params=jax.tree.map(np.asarray, rp), tokens=toks,
               greedy=greedy, logits=logits, x_q=[q for _, q in calls])
    with open(f"{path}.{arch}", "wb") as f:
        pickle.dump(ref, f)
    return calls, logits


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({arch: (the reference's activation calls, its logits)}, {(arch,
    mesh): the ranks' gathered record})."""
    path = str(tmp_path_factory.mktemp("tp_int8") / "ref.pkl")
    refs = {arch: _reference(arch, path) for arch in ARCHS}
    body = RANK.format(path=path, cases=CASES, steps=STEPS,
                       max_len=MAX_LEN)
    got = {}
    for world in (2, 4):
        spawn_ranks(body, world, timeout=180)
        with open(f"{path}.{world}", "rb") as f:
            got.update(pickle.load(f))
    return refs, got


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_int8_activations_match_the_meshless_reference(runs, arch, mesh):
    refs, got = runs
    mine = [[None, q] for q in got[arch, mesh]["x_q"]]
    assert_int8_activations_match(mine, refs[arch][0])


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_int8_logits_match_the_meshless_reference(runs, arch, mesh):
    refs, got = runs
    for step, (g, w) in enumerate(zip(got[arch, mesh]["logits"],
                                      refs[arch][1])):
        assert g.shape == w.shape, (step, g.shape, w.shape)
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 1e-5, (step, err)
        assert np.array_equal(g.argmax(-1), w.argmax(-1)), step
