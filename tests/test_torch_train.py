"""The port's training forms against the reference's.

``transformer.forward_train`` (and under it ``forward_hidden``,
``chunked_cross_entropy``, attention's gradient through the flash op's
backward) on the reduced configs in float32: the reference's weights
cross into the port (``convert.lm_params_from_numpy``) and the inputs are
made with numpy from a seed.  The loss and the gradient of every leaf
are held against ``jax.value_and_grad(repro.models.transformer
.forward_train)`` (jitted; ``use_pallas=False``, the reference's training
route).

Tolerances (float32): the loss within 1e-5 relative; each leaf's
gradient within 1e-4 of that leaf's max|grad| (float32 sums in another
order through a dozen layers of products; seen: up to about 1e-5).  The
bfloat16 llama case is held to twice the reference's own gap between its
bfloat16 and float32 runs of the same weights (the two frameworks round
bfloat16 intermediates at other places, so they differ about as much as
bfloat16 differs from float32): the gap is the largest over four batches,
of the loss, and of any leaf's gradient relative to its max|grad| (a
single scalar's gap is as small as luck makes it; seen: loss gaps 8e-5
to 3e-4, gradient gaps 0.010-0.013).

The recurrent block types train too: zamba2-1.2b (Mamba2 and the
globally shared attention block, whose gradients add up over its
applications) and xlstm-1.3b (mLSTM and sLSTM), reduced, are held to the
reference in float32 as above and in bfloat16 as the llama case is
(their scans' gradient is the gla_chunk op's plain backward here, the
sLSTM's autograd's through its loop).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as r_get_arch, reduced as r_reduced
from repro.models import transformer as RT
from repro_torch import convert, tree
from repro_torch.models import transformer as TT

ARCHS = ["llama3.2-3b", "olmo-1b", "phi-3-vision-4.2b", "whisper-large-v3",
         "phi3.5-moe-42b-a6.6b", "zamba2-1.2b", "xlstm-1.3b"]
B, S = 2, 16
#: the batches over which the reference's own bf16-against-float32 gap is
#: taken (its largest)
BF16_SEEDS = (8, 9, 10, 11)


def configs(arch, **kw):
    rcfg = r_reduced(r_get_arch(arch).model).replace(**kw)
    return rcfg, convert.model_config_from_fields(dataclasses.asdict(rcfg))


def make_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    targets[0, :3] = -1                     # ignored positions
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    size=(B, S)).astype(np.int32),
             "targets": targets}
    if cfg.frontend == "vision_stub":
        batch["patch_emb"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def reference(rcfg, rp, batch, eager=False):
    fn = jax.value_and_grad(lambda p, b: RT.forward_train(p, rcfg, b),
                            has_aux=True)
    with jax.disable_jit(eager):
        (total, metrics), grads = (fn if eager else jax.jit(fn))(
            rp, {k: jnp.asarray(v) for k, v in batch.items()})
    return (float(total), {k: float(v) for k, v in metrics.items()},
            tree.flatten(jax.tree.map(
                lambda g: np.asarray(g.astype(jnp.float32)), grads)))


def port(cfg, rp, batch):
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp),
                                          torch_device="cpu").tree()
    tree.requires_grad_(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, metrics = TT.forward_train(params, cfg, tb)
    flat = tree.flatten(params)
    grads = torch.autograd.grad(total, list(flat.values()))
    return (float(total.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            {k: g.float().numpy() for k, g in zip(flat, grads)})


def leaf_errors(got, want):
    """Each leaf's max|difference| over its max|grad|."""
    assert set(got) == set(want)
    return {k: float(np.abs(got[k] - want[k]).max()
                     / max(float(np.abs(want[k]).max()), 1e-30))
            for k in want}


#: remat is checked on one decoder, the encoder and the recurrent stacks
@pytest.mark.parametrize("arch,remat", [(a, False) for a in ARCHS] + [
    ("llama3.2-3b", True), ("whisper-large-v3", True),
    ("zamba2-1.2b", True), ("xlstm-1.3b", True)],
    ids=lambda x: x if isinstance(x, str) else ("remat" if x else "plain"))
def test_forward_train_matches_reference(arch, remat):
    rcfg, cfg = configs(arch, remat=remat)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    batch = make_batch(cfg, 7)
    r_total, r_metrics, r_grads = reference(rcfg, rp, batch)
    t_total, t_metrics, t_grads = port(cfg, rp, batch)
    assert abs(t_total - r_total) <= 1e-5 * abs(r_total)
    assert abs(t_metrics["loss"] - r_metrics["loss"]) \
        <= 1e-5 * abs(r_metrics["loss"])
    assert abs(t_metrics["aux_loss"] - r_metrics["aux_loss"]) \
        <= 1e-5 * max(abs(r_metrics["aux_loss"]), 1.0)
    errs = leaf_errors(t_grads, r_grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


def test_bf16_llama_within_the_reference_own_bf16_gap():
    bf16_within_the_reference_own_gap("llama3.2-3b")


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_bf16_recurrent_within_the_reference_own_bf16_gap(arch):
    """The reference's bf16 run is eager here: jitted, XLA rounds some of
    the recurrent stacks' bfloat16 intermediates elsewhere, and its jitted
    gradients differ from its own eager ones by up to 0.10 of a leaf's
    max|grad| (xlstm's sLSTM r and w_in, which carry a difference far
    back in time); the port follows the eager run's rounding."""
    bf16_within_the_reference_own_gap(arch, eager=True)


def bf16_within_the_reference_own_gap(arch, eager=False):
    rcfg32, _ = configs(arch)
    rcfg16, cfg16 = configs(arch, dtype="bfloat16")
    rp32 = RT.init_params(jax.random.PRNGKey(1), rcfg32)
    # the bf16 model's weights: the float32 ones rounded where the
    # reference's bf16 init makes a leaf bf16 (norm scales, the Mamba2
    # decay and skip, the sLSTM's recurrent r stay float32)
    like = RT.init_params(jax.random.PRNGKey(1), rcfg16)
    rp16 = jax.tree.map(lambda a, b: a.astype(b.dtype), rp32, like)
    # the same (rounded) weights in a float32 model
    rp16_32 = jax.tree.map(lambda a: a.astype(jnp.float32), rp16)
    runs = []
    for seed in BF16_SEEDS:
        batch = make_batch(cfg16, seed)
        runs.append((reference(rcfg32, rp16_32, batch),
                     reference(rcfg16, rp16, batch, eager),
                     port(cfg16, rp16, batch)))
    loss_gap = max(abs(r16[0] - r32[0]) for r32, r16, _ in runs)
    grad_gap = max(max(leaf_errors(r16[2], r32[2]).values())
                   for r32, r16, _ in runs)
    for r32, r16, t16 in runs:
        assert abs(t16[0] - r16[0]) <= 2 * loss_gap, (t16[0], r16[0])
        errs = leaf_errors(t16[2], r16[2])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 2 * grad_gap, (worst, errs[worst], grad_gap)


def test_whisper_needs_frames():
    _, cfg = configs("whisper-large-v3")
    params = TT.init_params(cfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 1).items()
             if k != "frames"}
    with pytest.raises(ValueError, match="frames"):
        TT.forward_train(params, cfg, batch)


def test_chunked_cross_entropy_takes_fewer_chunks_where_s_is_odd():
    """S 15 with 2 chunks: one chunk, as the reference's loop decides."""
    rcfg, cfg = configs("olmo-1b")
    rp = RT.init_params(jax.random.PRNGKey(2), rcfg)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(B, 15, cfg.d_model)).astype(np.float32)
    t = rng.integers(-1, cfg.vocab_size, size=(B, 15)).astype(np.int32)
    want = float(RT.chunked_cross_entropy(rp, rcfg, jnp.asarray(h),
                                          jnp.asarray(t)))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp),
                                          torch_device="cpu")
    got = float(TT.chunked_cross_entropy(params, cfg, torch.from_numpy(h),
                                         torch.from_numpy(t)))
    assert abs(got - want) <= 1e-5 * abs(want)
