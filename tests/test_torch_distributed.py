"""The port's data-parallel mesh layer against the reference, on two
``gloo`` ranks spawned on the CPU (``torch_cases.spawn_ranks``, each
group under its own timeout).

  (i) ``compressed_mean_local`` over two ranks equals the reference's
      ``compressed_mean`` (a 2-device XLA host mesh in a subprocess) on
      the same gradients, bitwise, the error carried over three steps;
      the int8 payload crosses the all-reduce as int32 (every
      ``all_reduce`` call's dtype recorded), and the stacked entry point
      ``compressed_mean`` gives the same bits;
 (ii) reduced llama3.2-3b (with remat) and olmo-1b train 3 steps through
      ``Trainer`` on a (2, 1) ("data", "model") mesh, FSDP off and on:
      each loss within 1e-5 relative of the meshless Trainer's (the mean
      of the two halves' gradients against the whole batch's, float32),
      the gradient norms as well; the parameters live as DTensors,
      sharded on "data" with FSDP, and the moments mirror them;
(iii) a checkpoint saved by the 2-rank FSDP run restores into a meshless
      Trainer and into a 1-rank (1, 1) mesh Trainer with FSDP, every leaf
      bitwise equal to the 2-rank run's gathered leaves, and both train
      on: their losses equal each other bitwise (the mean over one rank
      is the identity) and stay near the 2-rank run's;
 (iv) ``plan_elastic_restart`` equals the reference's over a grid of
      device counts, model widths, batches and pods.

Plus ``make_mesh``'s refusals and ``constrain`` on a DTensor and on a
plain tensor.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.distributed.fault_tolerance import \
    plan_elastic_restart as r_plan
from repro_torch.distributed.fault_tolerance import (ElasticPlan,
                                                     plan_elastic_restart,
                                                     simulate_failure)
from repro_torch.launch.train import Trainer
from torch_cases import ROOT, mask_targets, mesh_cfg, spawn_ranks

STEPS = 3


def _json_lines(out, tag):
    return [json.loads(line[len(tag):]) for line in out.splitlines()
            if line.startswith(tag)]


# ----------------------------------------------------------------------
# (i) int8 compressed mean
# ----------------------------------------------------------------------
def _reference_compressed(path):
    """The reference's compressed_mean on a 2-device host mesh, three
    steps with the error carried; writes means and errors to `path`."""
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.launch.mesh import make_mesh
        from repro.distributed.compression import compressed_mean
        d = np.load({str(path)!r})
        mesh = make_mesh((2,), ("data",))
        e = jnp.zeros_like(jnp.asarray(d["g"][0]))
        means, errs = [], []
        for t in range(d["g"].shape[0]):
            m, e = compressed_mean(jnp.asarray(d["g"][t]), e, mesh,
                                   axis="data")
            means.append(np.asarray(m))
            errs.append(np.asarray(e))
        np.savez({str(path)!r}, g=d["g"], mean=np.stack(means),
                 err=np.stack(errs))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


def test_compressed_mean_bitwise_equals_reference(tmp_path):
    rng = np.random.default_rng(0)
    g = rng.normal(size=(STEPS, 2, 64, 32)).astype(np.float32)
    g[:, 1] *= 3.0                      # the ranks' scales differ
    g[1, 0, :4] = 1e-4                  # below one quant step
    path = tmp_path / "g.npz"
    np.savez(path, g=g)
    _reference_compressed(path)
    ref = np.load(path)
    outs = spawn_ranks(f"""
        import json
        import numpy as np
        from repro_torch.distributed import compression
        from repro_torch.launch.mesh import make_mesh
        calls = []
        real = dist.all_reduce
        def spy(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
            calls.append([str(t.dtype), t.numel(), str(op)])
            return real(t, op=op, group=group, async_op=async_op)
        dist.all_reduce = spy
        g = torch.from_numpy(np.load({str(path)!r})["g"])
        e = torch.zeros_like(g[0, RANK])
        means, errs = [], []
        for t in range(g.shape[0]):
            m, e = compression.compressed_mean_local(g[t, RANK], e)
            means.append(m.numpy().tolist())
            errs.append(e.numpy().tolist())
        mesh = make_mesh((2,), ("data",), device="cpu")
        m0, e0 = compression.compressed_mean(g[0], torch.zeros_like(g[0]),
                                             mesh)
        q, scale = compression.quantize_shard(g[0, RANK])
        print("OUT" + json.dumps(dict(
            mean=means, err=errs, calls=calls, stacked_mean=m0.tolist(),
            stacked_err=e0.tolist(), q_dtype=str(q.dtype),
            q_max=int(q.abs().max()), scale=float(scale))))
    """, world=2)
    got = [_json_lines(o, "OUT")[0] for o in outs]
    for rank, r in enumerate(got):
        mean = np.asarray(r["mean"], np.float32)
        err = np.asarray(r["err"], np.float32)
        # tolerance: none; the same float32 and int32 arithmetic
        np.testing.assert_array_equal(mean, ref["mean"])
        np.testing.assert_array_equal(err, ref["err"][:, rank])
        np.testing.assert_array_equal(
            np.asarray(r["stacked_mean"], np.float32), ref["mean"][0])
        np.testing.assert_array_equal(
            np.asarray(r["stacked_err"], np.float32), ref["err"][0])
        # per step: the scale's MAX on one float32, the payload's SUM on
        # 64 x 32 int32
        assert r["calls"][:2] == [["torch.float32", 1, "RedOpType.MAX"],
                                  ["torch.int32", 64 * 32,
                                   "RedOpType.SUM"]]
        big = [c for c in r["calls"] if c[1] > 1]
        assert big and all(c[0] == "torch.int32" for c in big)
        assert r["q_dtype"] == "torch.int8" and r["q_max"] == 127
    # the mean really is a mean of the two ranks' gradients
    want = g.mean(axis=1)
    rel = np.abs(ref["mean"] - want).max() / np.abs(want).max()
    assert rel < 0.05


# ----------------------------------------------------------------------
# (ii) DP and FSDP training against the meshless Trainer
# ----------------------------------------------------------------------
MESH_TRAIN = """
    import json
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch import tree
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import Trainer
    from torch_cases import mask_targets, mesh_cfg
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    for fsdp, masked in {runs!r}:
        tr = Trainer(mesh_cfg({arch!r}), seq_len=32, global_batch=4,
                     peak_lr=3e-3, seed=0, mesh=mesh, fsdp=fsdp,
                     torch_device="cpu")
        if masked:
            mask_targets(tr)
        params = tree.flatten(tr.params)
        m = tree.flatten(tr.opt_state["m"])
        assert all(isinstance(v, DTensor) for v in params.values())
        sharded = [k for k, v in params.items()
                   if isinstance(v.placements[0], Shard)]
        assert bool(sharded) == fsdp, sharded
        assert all(m[k].placements == v.placements
                   and m[k].to_local().shape == v.to_local().shape
                   for k, v in params.items())
        wq = params["layers/attn/attn/wq/w"]
        before = wq.to_local().data_ptr()
        hist = tr.train({steps}, log_every=1000)
        assert wq.to_local().data_ptr() == before   # updated in place
        print("OUT" + json.dumps(dict(fsdp=fsdp, masked=masked,
                                      loss=hist["loss"],
                                      grad_norm=hist["grad_norm"])))
"""


@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmo-1b"])
def test_mesh_training_matches_meshless(arch):
    """DP and FSDP; on olmo also FSDP with unequal counted targets on the
    two ranks (the loss's weighting by counts)."""
    runs = [(False, False), (True, False)] + (
        [(True, True)] if arch == "olmo-1b" else [])
    outs = spawn_ranks(MESH_TRAIN.format(arch=arch, steps=STEPS, runs=runs),
                       world=2)
    meshless = {}
    for masked in sorted({m for _, m in runs}):
        tr = Trainer(mesh_cfg(arch), seq_len=32, global_batch=4,
                     peak_lr=3e-3, seed=0, torch_device="cpu")
        if masked:
            mask_targets(tr)
        meshless[masked] = tr.train(STEPS, log_every=1000)
    got = [_json_lines(o, "OUT") for o in outs]
    for rank_runs in got:
        assert [(r["fsdp"], r["masked"]) for r in rank_runs] == runs
        for r in rank_runs:
            want = meshless[r["masked"]]
            # tolerance: 1e-5 relative (float32; the mean of two halves'
            # gradients against the whole batch's)
            np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
            np.testing.assert_allclose(r["grad_norm"], want["grad_norm"],
                                       rtol=1e-5)
    # both ranks report the same (global) losses
    assert got[0] == got[1]
    if len(runs) == 3:      # the mask moved the losses
        assert got[0][2]["loss"] != got[0][1]["loss"]


# ----------------------------------------------------------------------
# (iii) a 2-rank FSDP checkpoint restored on one rank
# ----------------------------------------------------------------------
def test_fsdp_checkpoint_restores_on_one_rank(tmp_path):
    ckpt, dump = str(tmp_path / "ckpt"), str(tmp_path / "whole.pt")
    outs = spawn_ranks(f"""
        import json
        from repro_torch import tree
        from repro_torch.configs import get_arch, reduced
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.train import Trainer
        cfg = reduced(get_arch("olmo-1b").model).replace(max_seq=128)
        mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
        tr = Trainer(cfg, seq_len=32, global_batch=4, peak_lr=3e-3, seed=1,
                     mesh=mesh, fsdp=True, torch_device="cpu",
                     ckpt_dir={ckpt!r})
        hist = tr.train({STEPS}, log_every=1000)
        whole = {{k: v.full_tensor() for k, v in tree.flatten(
            {{"params": tr.params, "opt_state": tr.opt_state}}).items()
            if hasattr(v, "full_tensor")}}
        if RANK == 0:
            torch.save(whole, {dump!r})
            print("OUT" + json.dumps(hist["loss"]))
    """, world=2)
    h0 = _json_lines(outs[0], "OUT")[0]
    # each restored trainer saves again as it trains on: a copy each
    for name in ("meshless", "mesh"):
        shutil.copytree(ckpt, f"{ckpt}_{name}")
    outs = spawn_ranks(f"""
        import json
        from repro_torch import tree
        from repro_torch.configs import get_arch, reduced
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.train import Trainer
        cfg = reduced(get_arch("olmo-1b").model).replace(max_seq=128)
        whole = torch.load({dump!r})
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        res = {{}}
        for name, kw in (("meshless", {{}}),
                         ("mesh", dict(mesh=mesh, fsdp=True))):
            tr = Trainer(cfg, seq_len=32, global_batch=4, peak_lr=3e-3,
                         seed=7, torch_device="cpu",
                         ckpt_dir={ckpt!r} + "_" + name, **kw)
            assert tr.maybe_restore() and tr.step == {STEPS}
            flat = tree.flatten({{"params": tr.params,
                                 "opt_state": tr.opt_state}})
            for k, want in whole.items():
                got = flat[k]
                got = got.full_tensor() if hasattr(got, "full_tensor") \\
                    else got
                assert torch.equal(got.detach(), want), (name, k)
            assert int(flat["opt_state/count"]) == {STEPS}
            res[name] = tr.train(2, log_every=1000)["loss"]
        print("OUT" + json.dumps(res))
    """, world=1)
    res = _json_lines(outs[0], "OUT")[0]
    # tolerance: none; a one-rank mean is the identity
    assert res["mesh"] == res["meshless"]
    assert all(np.isfinite(res["mesh"]))
    assert res["mesh"][0] < h0[0] + 0.5          # no blow-up


# ----------------------------------------------------------------------
# (iv) the elastic plan; make_mesh; constrain
# ----------------------------------------------------------------------
def test_elastic_plan_equals_reference():
    n = 0
    for devices in (1, 2, 3, 4, 6, 7, 8, 16, 31, 32, 255, 256, 511, 512):
        for mp in (1, 2, 4, 8, 16):
            for batch in (1, 8, 32, 256, 1000):
                for pods in (1, 2, 3):
                    if devices < mp:
                        with pytest.raises(ValueError):
                            plan_elastic_restart(devices, mp, batch, pods)
                        with pytest.raises(ValueError):
                            r_plan(devices, mp, batch, pods)
                        continue
                    got = plan_elastic_restart(devices, mp, batch, pods)
                    want = r_plan(devices, mp, batch, pods)
                    assert isinstance(got, ElasticPlan)
                    assert vars(got) == vars(want), (devices, mp, batch,
                                                     pods)
                    n += 1
    assert n > 500
    assert simulate_failure(512, 256) == 256
    with pytest.raises(ValueError):
        simulate_failure(4, 4)


def test_make_mesh_and_constrain():
    outs = spawn_ranks("""
        import json
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.distributed import meshctx
        from repro_torch.launch.mesh import data_axes_of, make_mesh
        try:
            make_mesh((4, 1), ("data", "model"), device="cpu")
            raise SystemExit("a 4-rank mesh on 2 ranks was made")
        except ValueError:
            pass
        mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
        assert data_axes_of(mesh) == ("data",)
        assert meshctx.axis_sizes(mesh) == {"data": 2, "model": 1}
        x = torch.arange(24.0).reshape(4, 6)
        d = DTensor.from_local(x, mesh, [Replicate(), Replicate()])
        with meshctx.use_mesh(mesh):
            assert meshctx.constrain(x, "data", None) is x
            s = meshctx.constrain(d, ("pod", "data"), "model")
            odd = meshctx.constrain(DTensor.from_local(
                torch.zeros(3, 2), mesh, [Replicate(), Replicate()]),
                "data", None)
        assert meshctx.get_mesh() is None
        assert s.placements == (Shard(0), Shard(1))
        assert odd.placements == (Replicate(), Replicate())
        assert torch.equal(s.full_tensor(), x)
        print("OUT" + json.dumps(s.to_local().shape[0]))
    """, world=2)
    assert [_json_lines(o, "OUT")[0] for o in outs] == [2, 2]
