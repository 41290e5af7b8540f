"""Expert parallelism, the moe layer's data-parallel form and Adafactor's
sharded moments, on ``gloo`` ranks spawned on the CPU
(``torch_cases.spawn_ranks``, each group under its own timeout; one
group of two ranks, one of four).

  (i) ``Trainer(mesh=)``, two steps (``torch_cases.mesh_vs_meshless``),
      against the meshless Trainer from the same seed: reduced
      phi3.5-moe with AdamW, its own ``moe_fused_ep`` and (on (1, 2)) the
      unfused expert-parallel path; reduced kimi-k2 with Adafactor and
      FSDP (its fused path, a shared expert, sequence-parallel hint) with
      the float32 ``psum`` combine, and (on (1, 2)) as configured, the
      bfloat16 ``reduce_scatter`` combine (the ``psum_bf16`` sum with the
      port's replicated residual).  On (data, model) meshes (1, 2), (2, 1)
      and (2, 2): each rank's losses and gradient norms within 1e-5
      relative of the meshless Trainer's, every gradient leaf of the first
      step, gathered whole, within 1e-5 of the meshless leaf's max|grad|
      (float32; measured at most 7.7e-7), and, for Adafactor in float32,
      every parameter after the two steps within 3e-4 of the meshless
      run's largest change of it (measured at most 2.8e-5; AdamW's first
      steps are near sign(g), so a leaf's float32 noise moves its
      parameters too far for such a check); the bfloat16 combine within
      bf16's 8e-3 (leaves at most 1.9e-3).  On (2, 1) no axis splits the
      experts: the data-parallel form routes and drops over the whole
      global batch, as the meshless Trainer (the default capacity, so
      pairs drop).  On (2, 2) the reference's expert-parallel capacity is
      each data shard's (``T // dp``), not the whole batch's, so the
      meshless Trainer is the yardstick only where nothing drops: the
      capacity factor there is E / k (C = T); the drops under the shard's
      capacity are held to the reference in (ii).  With FSDP on (2, 2)
      Adafactor's moments are sharded over both axes.
 (ii) ``moe_apply``'s expert-parallel branches against the reference's
      ``shard_map`` on a (2, 2) XLA host mesh (a subprocess with
      ``--xla_force_host_platform_device_count=4``; the port's side in
      the four-rank group), the same weights and tokens, the default
      capacity (pairs drop on each shard): ``psum``, ``moe_token_gather``,
      ``moe_expert_2d`` and ``_moe_fused_ep`` (with a shared expert)
      within 1e-5 absolute in float32 (max|y| is about 0.27; the expert
      FFN's 64-term float32 products summed in another order: typically
      1e-7 of max|y|, and 4.3e-6 absolute in one run of sixteen, where
      PyTorch's CPU matmul took another code path), the aux loss within
      1e-6; ``psum_bf16``, ``reduce_scatter`` and the fused
      ``reduce_scatter`` within bf16's 8e-3 of max|y|.  The port maps
      ``moe_token_gather`` and ``reduce_scatter`` onto its replicated
      tokens and its bfloat16 sum (``models/moe.py``); these cases hold
      the mapping to the reference's own branches.
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from torch_cases import ROOT, mesh_cfg, spawn_ranks

STEPS = 2
#: name -> (arch, optimizer, fsdp, config changes, rtol)
RUNS = {
    "phi_fused": ("phi3.5-moe-42b-a6.6b", "adamw", False, {}, 1e-5),
    "phi_unfused": ("phi3.5-moe-42b-a6.6b", "adamw", False,
                    {"moe_fused_ep": False}, 1e-5),
    "kimi_psum": ("kimi-k2-1t-a32b", "adafactor", True,
                  {"moe_combine": "psum"}, 1e-5),
    # tolerance: bf16's 8e-3 (the combine rounds the experts' sum to bf16)
    "kimi_reduce_scatter": ("kimi-k2-1t-a32b", "adafactor", True, {},
                            8e-3),
}
#: (mesh shape, run) of the Trainer runs
CASES = [((1, 2), "phi_fused"), ((1, 2), "phi_unfused"),
         ((1, 2), "kimi_psum"), ((1, 2), "kimi_reduce_scatter"),
         ((2, 1), "phi_fused"), ((2, 1), "kimi_psum"),
         ((2, 2), "phi_fused"), ((2, 2), "kimi_psum")]


def _cfg(name, shape):
    arch, _, _, kw, _ = RUNS[name]
    cfg = mesh_cfg(arch).replace(**kw)
    if shape[0] > 1 and shape[1] > 1:
        # no pair drops: C = T (module docstring)
        cfg = cfg.replace(moe_capacity_factor=cfg.moe_experts
                          / cfg.moe_top_k)
    return cfg


EP_TRAIN = """
    import json
    from torch_cases import mesh_vs_meshless
    from test_torch_ep import RUNS, _cfg
    for shape, name in {cases!r}:
        arch, opt, fsdp, kw, rtol = RUNS[name]
        rec = mesh_vs_meshless(_cfg(name, shape), shape, {steps},
                               optimizer=opt, fsdp=fsdp)
        print("OUT" + json.dumps(dict(rec, name=name)))
"""


# ----------------------------------------------------------------------
# (ii) moe_apply's branches against the reference's shard_map
# ----------------------------------------------------------------------
#: branch -> (config changes, (absolute, relative to max|y|) tolerance)
BRANCHES = {
    "psum": ({}, (1e-5, 0.0)),
    "token_gather": ({"moe_token_gather": True}, (1e-5, 0.0)),
    "expert_2d": ({"moe_expert_2d": True}, (1e-5, 0.0)),
    "fused": ({"moe_fused_ep": True, "n_shared_experts": 1}, (1e-5, 0.0)),
    "psum_bf16": ({"moe_combine": "psum_bf16"}, (0.0, 8e-3)),
    "reduce_scatter": ({"moe_combine": "reduce_scatter"}, (0.0, 8e-3)),
    "fused_reduce_scatter": ({"moe_fused_ep": True, "n_shared_experts": 1,
                              "moe_combine": "reduce_scatter"},
                             (0.0, 8e-3)),
}
#: the layer: d 32, 8 experts of width 64, top 2, default capacity factor
#: 1.25; x (4, 16, 32): 64 tokens, 32 a data shard
LAYER = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=4,
             n_kv_heads=4, d_ff=64, vocab_size=64, moe_experts=8,
             moe_top_k=2, moe_d_ff=64, dtype="float32")


def _reference_branches(path, log):
    """Start the reference's side of (ii) in a subprocess writing `path`
    (``path + ".failed"`` where it raises); returns the process."""
    code = textwrap.dedent(f"""
        import os, traceback
        try:
            import jax, jax.numpy as jnp, numpy as np
            from repro.launch.mesh import make_mesh
            from repro.distributed import meshctx
            from repro.models.config import ModelConfig, ShardingConfig
            from repro.models import moe as M
            BRANCHES = {BRANCHES!r}
            base = ModelConfig(**{LAYER!r}, sharding=ShardingConfig(
                enabled=True, data_axes=("data",), model_axis="model"))
            x = np.random.default_rng(1).normal(size=(4, 16, 32)).astype(
                np.float32)
            mesh = make_mesh((2, 2), ("data", "model"))
            out = {{"x": x}}
            p = M.moe_init(jax.random.PRNGKey(0), base.replace(
                n_shared_experts=1))
            for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
                out["p/" + "/".join(str(getattr(e, "key", e)) for e in k)] = \\
                    np.asarray(v)
            for name, (kw, _) in BRANCHES.items():
                cfg = base.replace(**kw)
                q = p if cfg.n_shared_experts else {{
                    k: v for k, v in p.items() if k != "shared"}}
                with meshctx.use_mesh(mesh):
                    y, aux = jax.jit(lambda q, x: M.moe_apply(q, cfg, x))(
                        q, jnp.asarray(x))
                out["y/" + name] = np.asarray(y)
                out["aux/" + name] = np.asarray(aux)
            np.savez({str(path)!r} + ".part.npz", **out)
            os.replace({str(path)!r} + ".part.npz", {str(path)!r})
        except BaseException:
            open({str(path)!r} + ".failed", "w").write(traceback.format_exc())
            raise
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=log, stderr=log)


PORT_BRANCHES = """
    import numpy as np
    from repro_torch.distributed import meshctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.config import ModelConfig
    from test_torch_ep import BRANCHES, LAYER
    import time
    deadline = time.monotonic() + 200
    while not os.path.exists(NPZ):
        if os.path.exists(NPZ + ".failed") or time.monotonic() > deadline:
            raise SystemExit("the reference's branches were not written")
        time.sleep(0.1)
    d = np.load(NPZ)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    di, mi = mesh.get_coordinate()
    x = torch.from_numpy(d["x"]).chunk(2)[di]
    def w(name):
        return torch.from_numpy(d["p/" + name])
    out = {}
    for name, (kw, tol) in BRANCHES.items():
        cfg = ModelConfig(**LAYER).replace(**kw)
        p = {"router": {"w": w("router/w")},
             **{k: w(k).chunk(2)[mi] for k in ("wi", "wg", "wo")}}
        if cfg.n_shared_experts:
            p["shared"] = {"wi": {"w": w("shared/wi/w").chunk(2, 1)[mi]},
                           "wg": {"w": w("shared/wg/w").chunk(2, 1)[mi]},
                           "wo": {"w": w("shared/wo/w").chunk(2, 0)[mi]}}
        with meshctx.use_mesh(mesh):
            y, aux = M.moe_apply(p, cfg, x)
        want = d["y/" + name][2 * di:2 * di + 2]
        out[name] = dict(err=float(np.abs(y.numpy() - want).max()),
                         scale=float(np.abs(want).max()),
                         aux_err=abs(float(aux) - float(d["aux/" + name])))
    print("BRANCH" + json.dumps(out))
"""


_groups = {}


def _out(o, tag):
    return [json.loads(line[len(tag):]) for line in o.splitlines()
            if line.startswith(tag)]


def _group(world):
    """Each rank's records of one spawned group: the Trainer runs of
    CASES on meshes of `world` ranks, and in the four-rank group the
    port's side of (ii) (the reference's side first, in a subprocess)."""
    if world not in _groups:
        cases = [c for c in CASES if int(np.prod(c[0])) == world]
        body = EP_TRAIN.format(cases=cases, steps=STEPS)
        with tempfile.TemporaryDirectory() as tmp, \
                tempfile.TemporaryFile("w+") as log:
            ref = None
            if world == 4:      # the reference runs beside the ranks
                path = os.path.join(tmp, "moe.npz")
                ref = _reference_branches(path, log)
                body += f"\n    NPZ = {path!r}\n" + PORT_BRANCHES
            try:
                outs = spawn_ranks(body, world=world, timeout=240)
            finally:
                if ref is not None:
                    if ref.poll() is None:
                        ref.kill()
                    ref.wait()
                    log.seek(0)
                    assert ref.returncode == 0, log.read()[-3000:]
        _groups[world] = [dict(runs={(tuple(r["shape"]), r["name"]): r
                                     for r in _out(o, "OUT")},
                               branches=_out(o, "BRANCH")) for o in outs]
    return _groups[world]


def _runs(shape, name):
    return [rk["runs"][(shape, name)]
            for rk in _group(int(np.prod(shape)))]


def _ids(c):
    return f"{c[0][0]}x{c[0][1]}-{c[1]}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_trainer_ep_matches_meshless(case):
    shape, name = case
    tp = shape[1]
    rtol = RUNS[name][4]
    cfg = _cfg(name, shape)
    ranks = _runs(shape, name)
    want = ranks[0]["meshless"]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=rtol)
        np.testing.assert_allclose(r["grad_norm"], want["grad_norm"],
                                   rtol=rtol)
        assert ("layers/moe/moe/wi" in r["split"]) == (tp > 1)
        assert r["local"]["layers/moe/moe/wi"][1] == cfg.moe_experts // tp
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_trainer_ep_leaves_match_meshless(case):
    shape, name = case
    _, opt, _, _, rtol = RUNS[name]
    r = _runs(shape, name)[0]
    assert len(r["grad_err"]) == len(r["param_err"]) == len(r["whole"])
    # tolerance: module docstring (1e-5 float32, 8e-3 the bf16 combine)
    bad = {k: e for k, e in r["grad_err"].items() if not e <= rtol}
    assert not bad, bad
    if opt == "adafactor" and rtol == 1e-5:
        bad = {k: e for k, e in r["param_err"].items() if not e <= 3e-4}
        assert not bad, bad


def test_moe_branches_match_reference_shard_map():
    for rk in _group(4):
        r = rk["branches"][0]
        assert set(r) == set(BRANCHES)
        for name, (_, (atol, rtol)) in BRANCHES.items():
            e = r[name]
            assert e["err"] <= atol + rtol * e["scale"], (name, e)
            assert e["aux_err"] <= 1e-6, (name, e)
