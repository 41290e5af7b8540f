"""Tensor parallelism over a "model" axis above 1, on ``gloo`` ranks
spawned on the CPU (``torch_cases.spawn_ranks``, each group under its own
timeout; one group of two ranks, one of four).

  (i) ``Trainer(mesh=)``, two steps (``torch_cases.mesh_vs_meshless``),
      against the meshless Trainer from the same seed: reduced
      llama3.2-3b (with remat) on (data, model) meshes (1, 2), (2, 2) and
      (1, 4), olmo-1b (untied embeddings) on (1, 2).  Each rank's losses
      and gradient norms within 1e-5 relative, and every gradient leaf of
      the first step, gathered whole, within 1e-5 of the meshless leaf's
      max|grad| (float32: the only difference is the order of a few
      float32 sums; measured at most 8.5e-7).  The leaves the layers
      compute split over "model" (``sharding.model_split_leaves``) stay
      each rank's slice, and the flash op runs on the rank's heads (HQ/tp,
      KH/tp); where the KV heads do not split (reduced llama's KH 2 at
      tp 4) the attention is gathered whole and runs replicated.  Reduced
      zamba2-1.2b on (2, 2) as the recurrent archs train
      (``dp_over_model``: the config lists "model" among its data and
      FSDP axes): the batch is split over both axes, no leaf is computed
      split, and the gradient is summed over "model" too.
 (ii) The helpers at tp 2 (in the two-rank group): the vocab-parallel
      embedding lookup and loss equal the one-device functions, in value
      and in gradient; the gather and the reduce-scatter along either dim
      equal the concatenation and the sum of the ranks' blocks; and
      ``reduce_from_model``'s backward is the identity, where
      ``torch.distributed.nn.functional.all_reduce``'s sums the replicated
      cotangent again (``tp`` times too large: the hazard the port's
      collective avoids).
"""
import json

import numpy as np
import pytest

from repro_torch.models.config import ShardingConfig
from torch_cases import mesh_cfg, spawn_ranks

#: (mesh shape, arch) of the Trainer runs
CASES = [((1, 2), "llama3.2-3b"), ((1, 2), "olmo-1b"),
         ((2, 2), "llama3.2-3b"), ((2, 2), "zamba2-1.2b"),
         ((1, 4), "llama3.2-3b")]
#: the archs that treat "model" as a data axis (configs/base.py
#: dp_over_model)
DP_OVER_MODEL = {"zamba2-1.2b"}
STEPS = 2


def tp_cfg(arch):
    cfg = mesh_cfg(arch)
    if arch in DP_OVER_MODEL:
        axes = ("data", "model")
        cfg = cfg.replace(sharding=ShardingConfig(data_axes=axes,
                                                  fsdp_axes=axes))
    return cfg


TP_TRAIN = """
    import json
    from torch_cases import mesh_vs_meshless
    from test_torch_tp import DP_OVER_MODEL, tp_cfg
    for shape, arch in {cases!r}:
        rec = mesh_vs_meshless(tp_cfg(arch), shape, {steps},
                               fsdp=arch in DP_OVER_MODEL)
        print("OUT" + json.dumps(dict(rec, arch=arch)))
"""

HELPERS = """
    import torch.distributed.nn.functional as dfn
    from repro_torch.distributed import meshctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from torch_cases import mesh_cfg
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    cfg = mesh_cfg("llama3.2-3b")        # tied embeddings, V 512
    g = torch.Generator().manual_seed(3)
    V, d = cfg.vocab_size, cfg.d_model
    table = torch.randn(V, d, generator=g)
    h = torch.randn(2, 8, d, generator=g)
    targets = torch.randint(0, V, (2, 8), generator=g)
    targets[0, :3] = -1
    tokens = torch.randint(0, V, (2, 8), generator=g)
    res = {}

    def run(tab, use):
        tab = tab.clone().requires_grad_(True)
        hh = h.clone().requires_grad_(True)
        params = {"embed": {"tokens": tab}, "final_norm":
                  {"scale": torch.ones(d)}}
        with meshctx.use_mesh(mesh if use else None):
            loss = T.chunked_cross_entropy(params, cfg, hh, targets)
            x = L.embed_apply(params["embed"], cfg, tokens)
            (loss + (x * h).sum()).backward()
        return loss, x, tab.grad, hh.grad

    whole = run(table, False)
    part = run(table.chunk(2)[RANK], True)
    res["loss"] = [float(whole[0]), float(part[0])]
    res["embed_err"] = float((whole[1] - part[1]).abs().max())
    res["table_grad_err"] = float((whole[2].chunk(2)[RANK]
                                   - part[2]).abs().max())
    res["h_grad_err"] = float((whole[3] - part[3]).abs().max())
    res["grad_scale"] = float(whole[3].abs().max())

    ax = meshctx.axis_of(mesh, "model")
    x = torch.randn(6, 4, generator=torch.Generator().manual_seed(RANK))
    both = [torch.randn(6, 4, generator=torch.Generator().manual_seed(r))
            for r in range(2)]
    res["forms"] = [
        bool(torch.equal(meshctx.all_gather_blocks(x, ax, d),
                         torch.cat(both, dim=d))) for d in (0, 1)] + [
        bool(torch.equal(meshctx.reduce_scatter_blocks(x, ax, 0),
                         (both[0] + both[1]).chunk(2)[RANK]))]
    for name, fn in (("port", lambda t: meshctx.reduce_from_model(t, ax)),
                     ("dist_nn", lambda t: dfn.all_reduce(t, group=ax.group))):
        t = torch.ones(3, requires_grad=True)
        fn(t).sum().backward()
        res[name] = t.grad.tolist()
    print("HELP" + json.dumps(res))
"""

_groups = {}


def _out(o, tag):
    return [json.loads(line[len(tag):]) for line in o.splitlines()
            if line.startswith(tag)]


def _group(world):
    """Each rank's records of one spawned group: the Trainer runs of
    CASES on meshes of `world` ranks, and in the two-rank group the
    helpers."""
    if world not in _groups:
        cases = [c for c in CASES if int(np.prod(c[0])) == world]
        body = TP_TRAIN.format(cases=cases, steps=STEPS)
        if world == 2:
            body += HELPERS
        outs = spawn_ranks(body, world=world, timeout=240)
        _groups[world] = [dict(runs={(tuple(r["shape"]), r["arch"]): r
                                     for r in _out(o, "OUT")},
                               helpers=_out(o, "HELP")) for o in outs]
    return _groups[world]


def _runs(shape, arch):
    return [rk["runs"][(shape, arch)]
            for rk in _group(int(np.prod(shape)))]


def _ids(c):
    return f"{c[0][0]}x{c[0][1]}-{c[1]}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_trainer_tp_matches_meshless(case):
    shape, arch = case
    tp = shape[1]
    ranks = _runs(shape, arch)
    want = ranks[0]["meshless"]
    cfg = tp_cfg(arch)
    for r in ranks:
        # tolerance: 1e-5 relative (float32; sums split over the ranks)
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
        if arch in DP_OVER_MODEL:
            assert r["split"] == []
            assert r["heads"] == [[cfg.n_heads, cfg.n_kv_heads]]
            continue
        heads_split = cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0
        want_heads = [cfg.n_heads // tp, cfg.n_kv_heads // tp] \
            if heads_split else [cfg.n_heads, cfg.n_kv_heads]
        assert r["heads"] == [want_heads]
        # the vocab and the MLP always split here (V 512, f 128)
        assert "embed/tokens" in r["split"]
        assert "layers/attn/mlp/wi/w" in r["split"]
        assert ("layers/attn/attn/wq/w" in r["split"]) == heads_split
        for k in r["split"]:
            assert int(np.prod(r["local"][k])) * tp \
                == int(np.prod(r["whole"][k])), k
    # every rank reports the same (global) losses
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_trainer_tp_grad_leaves_match_meshless(case):
    errs = _runs(*case)[0]["grad_err"]
    assert len(errs) == len(_runs(*case)[0]["whole"])
    # tolerance: 1e-5 of each leaf's max|grad| (float32 sums in another
    # order; a factor of tp on any leaf is far outside it)
    bad = {k: e for k, e in errs.items() if not e <= 1e-5}
    assert not bad, bad


def test_vocab_parallel_helpers_and_collective_forms():
    for rk in _group(2):
        r = rk["helpers"][0]
        # tolerance: float32 rounding of the split log-sum-exp (the sum of
        # exponentials in two halves) and of the head's partial products
        np.testing.assert_allclose(r["loss"][1], r["loss"][0], rtol=1e-6)
        assert r["embed_err"] == 0.0           # zeros plus one owner's row
        assert r["table_grad_err"] <= 1e-6 * max(1.0, r["grad_scale"])
        assert r["h_grad_err"] <= 1e-6 * max(1.0, r["grad_scale"])
        assert r["forms"] == [True, True, True]
        assert r["port"] == [1.0, 1.0, 1.0]
        assert r["dist_nn"] == [2.0, 2.0, 2.0]  # the hazard: tp times
