"""The gla_chunk backward: the port's plain backward against autograd and
against the reference's gradient, and the op's autograd Function on the
CPU.

``ref.gla_chunk_bwd_ref`` writes the gradient out (no autograd); here it
is held against three things on inputs made with numpy from a seed:
autograd of ``gla_chunk_ref`` (float32: each output within 2e-5 of its
max|want|, float32 sums in another order), autograd of the step
recurrence ``gla_recurrence`` in float64 (the float64 backward within
1e-9 of max|want|: the same function, chunked or not), and ``jax.grad``
of the reference's ``repro.models.ssm.chunked_gla`` carried over as
numpy (within 2e-5 of max|want| in float32; a bfloat16 q or k's
gradient within one bfloat16 rounding of the reference's float32 one,
see ``test_bf16_q_k_match_jax_grad``).  The loss is ⟨y, dy⟩ + ⟨h, dh⟩
for random dy and dh.  Mamba2's q and k are one row broadcast over the heads: the reference
differentiates ``jnp.broadcast_to`` of them, the port returns the head
sum for a one-head q or k.  The card's kernel cuts P into chunks of 64
columns and sums the chunks' partials of dq, dk and dla in chunk order:
the plain backward computed that way (``p_chunked_grads``) is held to
``jax.grad`` as well, at P 17, 65 and 1025 (within 2e-5 of max|want|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import chunked_gla as r_chunked_gla
from repro_torch.kernels.gla_chunk import (gla_chunk, gla_chunk_bwd,
                                           gla_chunk_bwd_plain,
                                           gla_chunk_bwd_ref, gla_chunk_ref,
                                           gla_recurrence)

F32_TOL = 2e-5

# (B, S, H, N, P, chunk): chunk < S throughout, N 16 / 64, P 17 / 65
# (neither a multiple of the backward kernel's 64 columns), and one chunk
# equal to S
SHAPES = [(2, 64, 3, 16, 17, 16), (1, 96, 2, 64, 65, 32),
          (2, 48, 4, 16, 65, 48), (1, 128, 2, 64, 17, 64)]


def inputs(B, S, H, N, P, seed, broadcast=False, state=True):
    """q, k (B, S, H or 1, N), v, la, h0, dy, dh as float32 numpy."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    hq = 1 if broadcast else H
    out = dict(q=t(B, S, hq, N), k=t(B, S, hq, N), v=t(B, S, H, P),
               la=(-np.abs(t(B, S, H)) * 0.3).astype(np.float32),
               dy=t(B, S, H, P))
    out["h0"] = t(B, H, N, P, scale=0.1) if state else None
    out["dh"] = t(B, H, N, P, scale=0.5) if state else None
    return out


def torch_of(x, dtype=None):
    if x is None:
        return None
    t = torch.from_numpy(x)
    return t if dtype is None else t.to(dtype)


def reference_grads(x, chunk, qk_dtype=jnp.float32):
    """jax.grad of ⟨y, dy⟩ + ⟨h, dh⟩ through the reference's chunked_gla,
    as float32 numpy, in the order q, k, v, la, h0 (h0's where given)."""
    B, S, H, P = x["v"].shape
    N = x["q"].shape[-1]
    names = ["q", "k", "v", "la"] + (["h0"] if x["h0"] is not None else [])

    def loss(*args):
        a = dict(zip(names, args))
        q = jnp.broadcast_to(a["q"], (B, S, H, N))
        k = jnp.broadcast_to(a["k"], (B, S, H, N))
        y, h = r_chunked_gla(q, k, a["v"], a["la"], chunk=chunk,
                             h0=a.get("h0"))
        out = jnp.sum(y * x["dy"])
        if x["dh"] is not None:
            out = out + jnp.sum(h * x["dh"])
        return out
    args = [jnp.asarray(x[n]).astype(qk_dtype) if n in ("q", "k")
            else jnp.asarray(x[n]) for n in names]
    grads = jax.grad(loss, argnums=tuple(range(len(names))))(*args)
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def port_grads(x, chunk, qk_dtype=torch.float32):
    """The op's gradient on CPU tensors (gla_chunk_bwd), float32 numpy in
    the same order."""
    q, k = (torch_of(x[n], qk_dtype) for n in ("q", "k"))
    v, la, h0, dy, dh = (torch_of(x[n]) for n in ("v", "la", "h0", "dy",
                                                   "dh"))
    g = gla_chunk_bwd(q, k, v, la, h0, dy, dh, chunk=chunk)
    assert g[0].dtype == qk_dtype and g[0].shape == q.shape
    out = [t.float().numpy() for t in g[:4]]
    return out + ([g[4].numpy()] if h0 is not None else [])


def p_chunked_grads(x, chunk, width=64):
    """The op's plain backward on CPU tensors as the card's kernel cuts
    P: each chunk of `width` columns of v, dy, h0 and dh on its own (every
    column of the scan evolves apart), its dq, dk and dla summed over the
    chunks in chunk order, its dv and dh0 columns placed; float32 numpy in
    reference_grads' order."""
    P = x["v"].shape[-1]
    q, k, la = (torch_of(x[n]) for n in ("q", "k", "la"))
    sums, cols = None, []
    for p0 in range(0, P, width):
        cut = {n: None if x[n] is None else torch_of(x[n])[..., p0:p0 + width]
               for n in ("v", "h0", "dy", "dh")}
        g = gla_chunk_bwd(q, k, cut["v"], la, cut["h0"], cut["dy"],
                          cut["dh"], chunk=chunk)
        part = (g[0], g[1], g[3])
        sums = part if sums is None else tuple(a + b for a, b in
                                               zip(sums, part))
        cols.append((g[2], g[4]))
    dv = torch.cat([c[0] for c in cols], dim=-1)
    out = [sums[0].numpy(), sums[1].numpy(), dv.numpy(), sums[2].numpy()]
    if x["h0"] is not None:
        out.append(torch.cat([c[1] for c in cols], dim=-1).numpy())
    return out


def close(got, want, tol=F32_TOL):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float(np.abs(g - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1e-30), err


@pytest.mark.parametrize("state", [False, True], ids=["no_state", "h0_dh"])
@pytest.mark.parametrize("broadcast", [False, True],
                         ids=["heads", "one_head"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_plain_backward_matches_jax_grad(shape, broadcast, state):
    B, S, H, N, P, chunk = shape
    x = inputs(B, S, H, N, P, seed=S + N + P, broadcast=broadcast,
               state=state)
    close(port_grads(x, chunk), reference_grads(x, chunk))


@pytest.mark.parametrize("state", [False, True], ids=["no_state", "h0_dh"])
@pytest.mark.parametrize("P", [17, 65, 1025])
def test_p_chunked_backward_matches_jax_grad(P, state):
    """The kernel's cut of P, on the plain side: per-64-column partials
    summed in chunk order equal jax.grad of the reference's chunked_gla
    (a ragged last chunk of 17, of 1 at P 65 and 1025)."""
    x = inputs(1, 48, 2, 8, P, seed=P + 2, state=state)
    close(p_chunked_grads(x, 16), reference_grads(x, 16))


@pytest.mark.parametrize("broadcast", [False, True],
                         ids=["heads", "one_head"])
def test_bf16_q_k_match_jax_grad(broadcast):
    """bfloat16 q and k: the port computes in float32 from the rounded
    values and rounds dq and dk once, so it is held to the reference's
    float32 gradient of the same (upcast) values within one bfloat16
    rounding, 2^-8 of each value plus 1e-5 of max|want|.  With one row for
    every head the reference itself rounds each head's gradient to
    bfloat16 before it sums them (in bfloat16), so only per-head q and k
    are also held to the reference run in bfloat16, within 2^-7."""
    x = inputs(2, 64, 4, 64, 17, seed=3, broadcast=broadcast)
    for n in ("q", "k"):
        x[n] = np.asarray(jnp.asarray(x[n]).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    got = port_grads(x, 32, torch.bfloat16)
    wants = [(reference_grads(x, 32), 2.0 ** -8)]
    if not broadcast:
        wants.append((reference_grads(x, 32, jnp.bfloat16), 2.0 ** -7))
    for want, rel in wants:
        for i, (g, w) in enumerate(zip(got, want)):
            top = float(np.abs(w).max())
            if i < 2:       # dq, dk in bfloat16
                assert np.all(np.abs(g - w) <= rel * np.abs(w)
                              + 1e-5 * top)
            else:
                assert float(np.abs(g - w).max()) <= F32_TOL * top


@pytest.mark.parametrize("state", [False, True], ids=["no_state", "h0_dh"])
@pytest.mark.parametrize("shape", [(3, 4, 8, 5, 7), (2, 2, 16, 16, 17)],
                         ids=lambda s: "-".join(map(str, s)))
def test_plain_backward_matches_autograd(shape, state):
    """In the kernel layout: the float32 backward against autograd of
    gla_chunk_ref, the float64 one against autograd of the float64 step
    recurrence."""
    BH, nc, Q, N, P = shape
    rng = np.random.default_rng(BH + nc + Q)

    def t(*s, scale=1.0):
        return torch.from_numpy((rng.normal(size=s) * scale)
                                .astype(np.float32))
    q, k, v = t(BH, nc, Q, N), t(BH, nc, Q, N), t(BH, nc, Q, P)
    la = -t(BH, nc, Q).abs() * 0.3
    h0 = t(BH, N, P, scale=0.1) if state else None
    dy, dh = t(BH, nc, Q, P), (t(BH, N, P) if state else None)
    for dtype in (torch.float32, torch.float64):
        leaves = [x.to(dtype).requires_grad_() for x in (q, k, v, la)]
        h0_ = (h0 if h0 is not None else torch.zeros(BH, N, P)) \
            .to(dtype).requires_grad_()
        if dtype == torch.float32:
            y, h = gla_chunk_ref(*leaves, h0_)
        else:
            y, h = gla_recurrence(*leaves, h0_, dtype=dtype)
        loss = (y * dy.to(dtype)).sum()
        if dh is not None:
            loss = loss + (h * dh.to(dtype)).sum()
        want = torch.autograd.grad(loss, leaves + [h0_])
        got = gla_chunk_bwd_ref(q, k, v, la, h0, dy, dh, dtype=dtype)
        tol = F32_TOL if dtype == torch.float32 else 1e-9
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            err = float((g - w.detach()).abs().max())
            assert err <= tol * float(w.abs().max()), (dtype, err)


@pytest.mark.parametrize("broadcast", [False, True],
                         ids=["heads", "one_head"])
def test_autograd_function_gives_the_backward(broadcast):
    """gla_chunk under grad on CPU tensors: its gradients are those of
    gla_chunk_bwd bitwise (a one-head q's summed over the heads), the
    final state's gradient where the loss reads it, zeros where not."""
    x = inputs(2, 64, 3, 16, 17, seed=9, broadcast=broadcast)
    ops = {n: torch_of(x[n]).requires_grad_() for n in
           ("q", "k", "v", "la", "h0")}
    dy, dh = torch_of(x["dy"]), torch_of(x["dh"])
    for use_dh in (False, True):
        y, h = gla_chunk(ops["q"], ops["k"], ops["v"], ops["la"],
                         ops["h0"], chunk=16)
        loss = (y * dy).sum() + ((h * dh).sum() if use_dh else 0.0)
        got = torch.autograd.grad(loss, list(ops.values()))
        want = gla_chunk_bwd(*(t.detach() for t in ops.values()), dy,
                             dh if use_dh else None, chunk=16)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_plain_layout_is_per_head():
    """gla_chunk_bwd_plain returns each gradient in its operand's shape:
    dq and dk per head for per-head q and k (a one-head q expanded over
    the heads), their head sum for a one-head q and k, as the op does."""
    x = inputs(1, 32, 4, 16, 17, seed=5, broadcast=True)
    args = [torch_of(x[n]) for n in ("q", "k", "v", "la", "h0", "dy", "dh")]
    summed = gla_chunk_bwd_plain(*args, chunk=16)
    assert summed[0].shape == summed[1].shape == (1, 32, 1, 16)
    per_head = gla_chunk_bwd_plain(
        *(t.expand(1, 32, 4, 16) for t in args[:2]), *args[2:], chunk=16)
    assert per_head[0].shape == per_head[1].shape == (1, 32, 4, 16)
    for s, p in zip(summed[:2], per_head[:2]):
        assert torch.equal(s, p.sum(2, keepdim=True))
    for s, p in zip(summed[2:], per_head[2:]):
        assert torch.equal(s, p)
    op = gla_chunk_bwd(*args, chunk=16)
    for s, g in zip(summed, op):
        assert torch.equal(s, g)


def test_backward_refuses_mismatched_gradients():
    x = inputs(1, 32, 2, 16, 17, seed=6)
    args = [torch_of(x[n]) for n in ("q", "k", "v", "la", "h0", "dy", "dh")]
    with pytest.raises(ValueError, match="dy"):
        gla_chunk_bwd(*args[:5], args[5][:, :16], args[6], chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        gla_chunk_bwd(*args, chunk=24)
    with pytest.raises(ValueError, match="device"):
        gla_chunk_bwd(*(t.to("meta") for t in args[:6]), args[6], chunk=16)
