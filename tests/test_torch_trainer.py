"""The port's training driver against the reference's.

  * the data pipeline: batches bit-equal to the reference's for the same
    seed, step and shard;
  * ``Trainer``: three steps of reduced llama3.2-3b (float32) from the
    reference's initial weights and state (carried across in a step-0
    checkpoint the reference writes), against the reference's ``Trainer``
    (jitted train step): each loss within 1e-5 relative, and every
    parameter and optimizer-state leaf after the three steps within 1e-5
    of the leaf's largest magnitude (AdamW normalizes each gradient
    element, so a float32 difference in a gradient moves a parameter by
    at most a few lr x 1e-6);
  * checkpoints: a port checkpoint restores into a fresh port trainer, and
    the steps after it are bitwise those of the trainer that went on; a
    checkpoint written by the reference restores into the port's trainer
    with every leaf byte-equal to the reference's (its weights carried
    across through ``convert.lm_params_from_numpy``), bfloat16 leaves
    included, in the reference's file format;
  * the CLI and ``examples/train_lm_torch.py``, two steps on the CPU;
    without a mesh Trainer ignores ``fsdp``;
  * the recurrent models, reduced zamba2-1.2b and xlstm-1.3b (float32):
    three steps against the reference's ``Trainer`` under the same
    limits, a reference checkpoint of xlstm restored into the port byte
    for byte (its float32 sLSTM ``r`` among the leaves), and the CLI.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as r_save_checkpoint
from repro.configs import get_arch as r_get_arch, reduced as r_reduced
from repro.data import DataConfig as RDataConfig
from repro.data import SyntheticLMDataset as RDataset
from repro.launch.train import Trainer as RTrainer
from repro_torch import convert, tree
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_arch, reduced
from repro_torch.data import DataConfig, SyntheticLMDataset, \
    make_train_iterator
from repro_torch.launch.train import Trainer
from repro_torch.optim import cosine_schedule

ROOT = Path(__file__).resolve().parents[1]


def to_numpy(t):
    return jax.tree.map(np.asarray, t)


@pytest.mark.parametrize("shards", [1, 2])
def test_data_batches_bit_equal(shards):
    for shard in range(shards):
        kw = dict(vocab_size=512, seq_len=64, global_batch=4, seed=3,
                  n_shards=shards, shard_id=shard)
        r, t = RDataset(RDataConfig(**kw)), SyntheticLMDataset(
            DataConfig(**kw))
        it = make_train_iterator(DataConfig(**kw), start_step=5)
        for step in (0, 5, 17):
            want, got = r.batch(step), t.batch(step)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(next(it)["tokens"],
                                      r.batch(5)["tokens"])


def _llama():
    rcfg = r_reduced(r_get_arch("llama3.2-3b").model).replace(max_seq=128)
    return rcfg, reduced(get_arch("llama3.2-3b").model).replace(max_seq=128)


def _configs(arch):
    rcfg = r_reduced(r_get_arch(arch).model).replace(max_seq=128)
    return rcfg, reduced(get_arch(arch).model).replace(max_seq=128)


def _port_trainer_from(rt, cfg, ckpt_dir, **kw):
    """A port trainer starting from the reference trainer's weights and
    state, carried across in a step-0 checkpoint the reference writes."""
    r_save_checkpoint(ckpt_dir, 0, {"params": rt.params,
                                    "opt_state": rt.opt_state},
                      extra={"step": 0})
    tt = Trainer(cfg, seq_len=32, global_batch=4, torch_device="cpu",
                 ckpt_dir=ckpt_dir, **kw)
    assert tt.maybe_restore() and tt.step == 0
    return tt


def _close_trees(got, want, rel, atol=0.0):
    g, w = tree.flatten(got), tree.flatten(to_numpy(want))
    assert set(g) == set(w)
    for k in w:
        a = g[k].detach().float().numpy()
        b = np.asarray(w[k], np.float32)
        assert float(np.abs(a - b).max()) <= max(
            rel * max(float(np.abs(b).max()), 1e-30), atol), k


def test_trainer_steps_match_reference(tmp_path):
    _steps_match_reference(tmp_path, "llama3.2-3b")


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_recurrent_trainer_steps_match_reference(tmp_path, arch):
    """As llama's, but a parameter may also differ by 2% of the three
    steps' learning rates added up (the farthest AdamW can move an
    element): AdamW divides each gradient element by its own magnitude
    plus 1e-8, so where an element's gradient is about that small (the
    recurrent stacks have such: the Mamba2 dt_bias, the mLSTM's q and k
    projections) a float32 difference in it moves the update by a share
    of the step (seen: 1.5e-6 against steps of 3e-5 to 9e-5).  The AdamW
    moments within 1e-4 of each leaf's max: the Mamba2 A_log gradient sums
    dla over every position with heavy cancellation, and float32 autograd
    of the port's plain forward already differs from the reference there
    by 2.6e-5 of max|m| (the op's backward: 2.0e-5)."""
    lrs = [float(cosine_schedule(t, 100, 10_000, 3e-3)) for t in range(3)]
    _steps_match_reference(tmp_path, arch, atol=0.02 * sum(lrs),
                           state_rel=1e-4)


def _steps_match_reference(tmp_path, arch, atol=0.0, state_rel=1e-5):
    rcfg, cfg = _configs(arch)
    rt = RTrainer(rcfg, seq_len=32, global_batch=4, peak_lr=3e-3, seed=0)
    tt = _port_trainer_from(rt, cfg, str(tmp_path), peak_lr=3e-3, seed=0)
    r_hist = rt.train(3, log_every=1000)
    t_hist = tt.train(3, log_every=1000)
    np.testing.assert_allclose(t_hist["loss"], r_hist["loss"], rtol=1e-5)
    _close_trees(tt.params, rt.params, 1e-5, atol)
    _close_trees(tt.opt_state["m"], rt.opt_state["m"], state_rel)
    _close_trees(tt.opt_state["v"], rt.opt_state["v"], state_rel)
    assert int(tt.opt_state["count"]) == int(rt.opt_state["count"]) == 3
    assert tt.step == rt.step == 3
    assert len(t_hist["seconds"]) == 3


def test_port_checkpoint_round_trip(tmp_path):
    _, cfg = _llama()
    kw = dict(seq_len=32, global_batch=4, torch_device="cpu", peak_lr=3e-3,
              seed=1, ckpt_dir=str(tmp_path))
    a = Trainer(cfg, **kw)
    a.train(2, log_every=1000)
    assert latest_step(str(tmp_path)) == 2
    b = Trainer(cfg, **kw)
    assert b.maybe_restore() and b.step == 2
    for x, y in zip(tree.leaves(a.params) + tree.leaves(a.opt_state),
                    tree.leaves(b.params) + tree.leaves(b.opt_state)):
        assert torch.equal(x, y)
    ha, hb = a.train(2, log_every=1000), b.train(2, log_every=1000)
    assert ha["loss"] == hb["loss"]
    for x, y in zip(tree.leaves(a.params), tree.leaves(b.params)):
        assert torch.equal(x, y)


def test_reference_checkpoint_restores_into_port(tmp_path):
    _reference_checkpoint_restores(tmp_path, "llama3.2-3b")


def test_reference_xlstm_checkpoint_restores_into_port(tmp_path):
    _reference_checkpoint_restores(tmp_path, "xlstm-1.3b")


def _reference_checkpoint_restores(tmp_path, arch):
    rcfg, cfg = _configs(arch)
    rt = RTrainer(rcfg, seq_len=32, global_batch=4, peak_lr=3e-3, seed=2,
                  ckpt_dir=str(tmp_path))
    rt.train(2, log_every=1000)
    tt = Trainer(cfg, seq_len=32, global_batch=4, torch_device="cpu",
                 peak_lr=3e-3, seed=2, ckpt_dir=str(tmp_path))
    assert tt.maybe_restore() and tt.step == 2
    want = convert.lm_params_from_numpy(to_numpy(rt.params), "cpu").tree()
    for k, v in tree.flatten(want).items():
        assert torch.equal(tree.flatten(tt.params)[k], v), k
    for name in ("m", "v"):
        for k, v in tree.flatten(to_numpy(rt.opt_state[name])).items():
            assert torch.equal(tree.flatten(tt.opt_state[name])[k],
                               torch.from_numpy(np.array(v))), k
    assert int(tt.opt_state["count"]) == 2
    # the next step continues the reference's run
    r_next = rt.train(1, log_every=1000)["loss"]
    t_next = tt.train(1, log_every=1000)["loss"]
    np.testing.assert_allclose(t_next, r_next, rtol=1e-5)


def test_bf16_leaves_in_the_reference_format(tmp_path):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(3, 5)).astype(np.float32)
    rtree = {"a": {"w": jnp.asarray(w).astype(jnp.bfloat16)},
             "n": jnp.int32(7), "s": jnp.asarray(w[0])}
    r_save_checkpoint(str(tmp_path / "ref"), 1, rtree, extra={"step": 1})
    like = {"a": {"w": torch.zeros((3, 5), dtype=torch.bfloat16)},
            "n": torch.zeros((), dtype=torch.int32),
            "s": torch.zeros(5)}
    got, extra = restore_checkpoint(str(tmp_path / "ref"), 1, like)
    assert extra == {"step": 1}
    want = torch.from_numpy(w).to(torch.bfloat16)
    assert torch.equal(got["a"]["w"], want) and int(got["n"]) == 7
    assert got["n"].shape == () and torch.equal(got["s"],
                                                torch.from_numpy(w[0]))
    # the port writes the same bytes, header included
    save_checkpoint(str(tmp_path / "port"), 1, got, extra={"step": 1})
    for name in ("a_w.npy", "n.npy", "s.npy"):
        ref = (tmp_path / "ref" / "step_00000001" / name).read_bytes()
        assert (tmp_path / "port" / "step_00000001" / name).read_bytes() \
            == ref, name
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(str(tmp_path / "ref"), 1,
                           dict(like, s=torch.zeros(5, dtype=torch.float64)))
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path / "ref"), 1,
                           dict(like, extra=torch.zeros(1)))


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_on_the_cpu(tmp_path):
    r = _run("-m", "repro_torch.launch.train", "--arch", "llama3.2-3b",
             "--reduced", "--device", "cpu", "--steps", "2", "--seq-len",
             "32", "--batch", "2", "--ckpt-dir", str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "final loss" in r.stdout and "tokens/s on cpu" in r.stdout
    assert latest_step(str(tmp_path)) == 2


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_cli_trains_the_recurrent_models(tmp_path, arch):
    r = _run("-m", "repro_torch.launch.train", "--arch", arch, "--reduced",
             "--device", "cpu", "--steps", "2", "--seq-len", "32",
             "--batch", "2", "--ckpt-dir", str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "final loss" in r.stdout and "tokens/s on cpu" in r.stdout
    assert latest_step(str(tmp_path)) == 2


@pytest.mark.parametrize("case", ["fsdp"])
def test_trainer_refuses_mesh_and_fsdp(case):
    """fsdp: fsdp=True without a mesh is ignored, as the reference ignores
    it, and trains bit for bit as the meshless Trainer.  (The "mesh" case,
    a refusal of a "model" axis above 1, went with the refusal: tensor
    and expert parallelism train, tests/test_torch_tp.py and
    test_torch_ep.py.)"""
    cfg = reduced(get_arch("llama3.2-3b").model)
    runs = [Trainer(cfg, seq_len=32, global_batch=2, torch_device="cpu",
                    fsdp=fsdp) for fsdp in (False, True)]
    hists = [tr.train(2, log_every=1000) for tr in runs]
    assert hists[0]["loss"] == hists[1]["loss"]
    a, b = (tree.flatten(tr.params) for tr in runs)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_example_on_the_cpu():
    r = _run(str(ROOT / "examples" / "train_lm_torch.py"), "--steps", "2",
             "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "over 2 steps" in r.stdout
