"""The port's optimizers and schedules against the reference's.

Trees of leaves made with numpy from a seed (float32, and bfloat16
parameters with float32 state) go through the reference's pure updates
and the port's in-place ones, three steps each.  Tolerances: float32
parameters and states within 2e-6 relative to each leaf's largest
magnitude (the same float32 operations in the same order; the bias
corrections' powers and the square roots may differ by an ulp between
XLA and PyTorch); bfloat16 parameters within one bfloat16 ulp of each
leaf's largest magnitude (2^-7 relative: a float32 difference of an ulp
can flip the final rounding).  Schedules within 1e-7 relative; the global
norm within 1e-6 relative; clipping within 2e-6 relative.  Taking a leaf
a slice of its leading dim at a time (``CHUNK``) changes no bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro_torch import optim as T
from repro_torch import tree
from repro_torch.optim import optimizers as T_opt

SHAPES = {"layers": {"w": (3, 8, 16), "b": (3, 16)}, "embed": (12, 8),
          "scale": (8,), "one": (1, 5)}


def make_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.normal(size=v) * scale).astype(np.float32)
                for k, v in node.items()}
    return walk(SHAPES)


def to_jax(t, dtype="float32"):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(getattr(jnp, dtype)),
                        t)


def to_torch(t, dtype="float32"):
    return tree.map_tree(
        lambda a: torch.from_numpy(np.array(a)).to(getattr(torch, dtype)), t)


def close(got, want, rel):
    """Each leaf within rel x its largest magnitude."""
    g, w = tree.flatten(got), tree.flatten(want)
    assert set(g) == set(w)
    for k in w:
        a = g[k].float().numpy() if isinstance(g[k], torch.Tensor) \
            else np.asarray(g[k], np.float32)
        b = np.asarray(jnp.asarray(w[k]).astype(jnp.float32))
        assert a.shape == b.shape, k
        lim = rel * max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= lim, (k, np.abs(a - b).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.1, 0.0])
def test_adamw_matches_reference(dtype, wd):
    p0 = make_tree(0)
    rp, tp = to_jax(p0, dtype), to_torch(p0, dtype)
    rs, ts = R.adamw_init(rp), T.adamw_init(tp)
    for step in range(3):
        g = make_tree(10 + step, scale=0.1)
        lr = R.cosine_schedule(jnp.int32(step), 1, 10, 3e-3)
        rp, rs = R.adamw_update(to_jax(g, dtype), rs, rp, lr=lr,
                                weight_decay=wd)
        tp, ts = T.adamw_update(to_torch(g, dtype), ts, tp,
                                lr=T.cosine_schedule(step, 1, 10, 3e-3),
                                weight_decay=wd)
    rel = 2e-6 if dtype == "float32" else 2.0 ** -7
    close(tp, rp, rel)
    close(ts["m"], rs["m"], 2e-6)
    close(ts["v"], rs["v"], 2e-6)
    assert int(ts["count"]) == int(rs["count"]) == 3
    assert ts["count"].dtype == torch.int32


def test_adamw_slices_change_no_bit(monkeypatch):
    p0 = make_tree(1)
    g = to_torch(make_tree(2, scale=0.1), "bfloat16")
    whole = to_torch(p0, "bfloat16")
    sliced = to_torch(p0, "bfloat16")
    s_whole, s_sliced = T.adamw_init(whole), T.adamw_init(sliced)
    T.adamw_update(g, s_whole, whole, lr=1e-2)
    monkeypatch.setattr(T_opt, "CHUNK", 40)
    assert len(T_opt._slices(sliced["layers"]["w"])) == 3
    T.adamw_update(g, s_sliced, sliced, lr=1e-2)
    for a, b in zip(tree.leaves(whole) + tree.leaves(s_whole["m"]),
                    tree.leaves(sliced) + tree.leaves(s_sliced["m"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("factored", [True, False],
                         ids=["factored", "unfactored"])
def test_adafactor_matches_reference(factored):
    p0 = make_tree(3)
    if not factored:        # only leaves of one row or 1-d: no factoring
        p0 = {"scale": p0["scale"], "one": p0["one"]}
    rp, tp = to_jax(p0), to_torch(p0)
    rs, ts = R.adafactor_init(rp), T.adafactor_init(tp)
    assert set(tree.flatten(ts["v"])) == set(tree.flatten(rs["v"]))
    for step in range(3):
        g = make_tree(20 + step, scale=0.1)
        if not factored:
            g = {"scale": g["scale"], "one": g["one"]}
        rp, rs = R.adafactor_update(to_jax(g), rs, rp, lr=1e-2,
                                    weight_decay=0.01)
        tp, ts = T.adafactor_update(to_torch(g), ts, tp, lr=1e-2,
                                    weight_decay=0.01)
    close(tp, rp, 2e-6)
    close(ts["v"], rs["v"], 2e-6)
    assert int(ts["count"]) == 3


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_reference(max_norm, dtype):
    g0 = make_tree(4)
    rg, rn = R.clip_by_global_norm(to_jax(g0, dtype), max_norm)
    tg, tn = T.clip_by_global_norm(to_torch(g0, dtype), max_norm)
    assert abs(float(tn) - float(rn)) <= 1e-6 * float(rn)
    close(tg, rg, 2e-6 if dtype == "float32" else 2.0 ** -7)
    assert abs(float(T.global_norm(to_torch(g0))) -
               float(R.optimizers.global_norm(to_jax(g0)))) \
        <= 1e-6 * float(rn)


def test_schedules_match_reference():
    for step in (0, 1, 5, 99, 100, 101, 5000, 9999, 10000, 12000):
        for warm, total in ((100, 10_000), (0, 10), (1, 1)):
            want = float(R.cosine_schedule(jnp.int32(step), warm, total, 3e-4,
                                           min_lr=1e-5))
            got = float(T.cosine_schedule(step, warm, total, 3e-4,
                                          min_lr=1e-5))
            assert abs(got - want) <= 1e-7 * abs(want) + 1e-12, (step, warm)
            assert float(T.linear_warmup(step, warm, 3e-4)) == pytest.approx(
                float(R.linear_warmup(jnp.int32(step), warm, 3e-4)),
                rel=1e-7)


def test_make_optimizer():
    assert T.make_optimizer("adamw") == (T.adamw_init, T.adamw_update)
    assert T.make_optimizer("adafactor") == (T.adafactor_init,
                                             T.adafactor_update)
    with pytest.raises(ValueError):
        T.make_optimizer("sgd")
