"""The language models' training forward in plain PyTorch.

A frozen copy of the equations that ``repro_torch`` trains (its
``models/transformer.py:forward_train`` and the blocks under it, which
follow the JAX reference): the moe family (pre-norm attention, then the
mixture of experts with top-k routing, a per-expert capacity and dropped
pairs) and the hybrid family (Mamba2 blocks, with one globally shared
attention block applied after every ``attn_every``-th).  Every layer
kind is written out here; nothing of the program is imported or called.

Parameters are a flat dict ``{path: tensor}`` keyed by the program's
tree paths (``layers/moe/attn/wq/w``), the layers of a kind stacked on
dim 0.  :func:`leaf_specs` lists them from a configuration.  The forward
computes in float32 whatever the leaves' dtype; every matrix product
goes through a :class:`Precision`, whose ``"fp8"`` form rounds the
operands (and, in the backward, the incoming gradient) to float8 e4m3:
the control of the comparison that decides ``correct``; its ``"bf16"``
form rounds them to bfloat16, a witness only.

The attention core is :class:`_Attention`: one batch row and one block
of query rows at a time, with a hand-written backward from each row's
log-sum-exp, so that no (S, S) score matrix is ever live whole.  The
scan is :func:`gla`, chunked, differentiated by autograd.  Each layer,
each expert and each loss chunk runs under ``torch.utils.checkpoint``, so
the float32 activations of one at a time are live.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]

#: the largest value of float8 e4m3
FP8_MAX = 448.0


# ----------------------------------------------------------------------
# the configuration
# ----------------------------------------------------------------------
def dims(m: dict) -> dict:
    """The sizes the equations use, from a configuration's model fields."""
    d = m["d_model"]
    hd = m.get("head_dim") or d // m["n_heads"]
    di = m.get("ssm_expand", 2) * d
    return dict(d=d, hd=hd, hq=m["n_heads"], kh=m["n_kv_heads"],
                q_dim=m["n_heads"] * hd, kv_dim=m["n_kv_heads"] * hd,
                ff=m["d_ff"], V=m["vocab_size"], di=di,
                N=m.get("ssm_state", 0), W=m.get("ssm_conv", 4),
                P=m.get("ssm_head_dim", 64),
                H=di // m.get("ssm_head_dim", 64),
                E=m.get("moe_experts", 0), k=m.get("moe_top_k", 0),
                f=m.get("moe_d_ff") or m["d_ff"],
                cf=m.get("moe_capacity_factor", 1.25))


def pattern(m: dict) -> List[str]:
    """Each layer's block kind, in order."""
    n = m["n_layers"]
    if m["family"] == "moe":
        return ["moe"] * n
    if m["family"] == "hybrid":
        k = m.get("attn_every", 0)
        return ["mamba2_sharedattn" if k and (i + 1) % k == 0 else "mamba2"
                for i in range(n)]
    raise ValueError(f"the reference has no family {m['family']!r}")


def leaf_specs(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str, str,
                                           float]]:
    """{path: (shape, dtype, kind, scale)} of every parameter, in sorted
    path order.  dtype is "float32" or the configuration's dtype; kind is
    how the benchmark draws it (``harness/inputs.py``): "uniform" in
    +-scale, "normal" with std scale, "one" 1 + scale N(0, 1), "alog"
    log U(1, 16)."""
    z = dims(m)
    dt, d = m.get("dtype", "bfloat16"), z["d"]
    out: Dict[str, Tuple] = {}

    def lin(path, d_in, d_out, lead=()):
        out[path + "/w"] = (lead + (d_in, d_out), dt, "uniform",
                            1 / math.sqrt(d_in))

    def norm(path, n, lead=()):
        out[path + "/scale"] = (lead + (n,), "float32", "one", 0.1)
        if m.get("norm", "rmsnorm") == "layernorm":
            out[path + "/bias"] = (lead + (n,), "float32", "normal", 0.02)

    def attn(path, lead=()):
        lin(path + "/wq", d, z["q_dim"], lead)
        lin(path + "/wk", d, z["kv_dim"], lead)
        lin(path + "/wv", d, z["kv_dim"], lead)
        lin(path + "/wo", z["q_dim"], d, lead)

    def mlp(path, lead=()):
        lin(path + "/wi", d, z["ff"], lead)
        lin(path + "/wg", d, z["ff"], lead)
        lin(path + "/wo", z["ff"], d, lead)

    out["embed/tokens"] = ((z["V"], d), dt, "normal", 0.02)
    norm("final_norm", d)
    if not m.get("tie_embeddings"):
        lin("lm_head", d, z["V"])
    kinds = pattern(m)
    for b in sorted(set(kinds)):
        lead = (kinds.count(b),)
        p = f"layers/{b}"
        norm(p + "/ln1", d, lead)
        if b == "moe":
            attn(p + "/attn", lead)
            norm(p + "/ln2", d, lead)
            E, f = z["E"], z["f"]
            out[p + "/moe/router/w"] = (lead + (d, E), "float32", "uniform",
                                        1 / math.sqrt(d))
            out[p + "/moe/wi"] = (lead + (E, d, f), dt, "uniform",
                                  1 / math.sqrt(d))
            out[p + "/moe/wg"] = (lead + (E, d, f), dt, "uniform",
                                  1 / math.sqrt(d))
            out[p + "/moe/wo"] = (lead + (E, f, d), dt, "uniform",
                                  1 / math.sqrt(f))
        else:
            q = p + "/mamba"
            di, N, H, W = z["di"], z["N"], z["H"], z["W"]
            lin(q + "/in_proj", d, 2 * di + 2 * N + H, lead)
            lin(q + "/out_proj", di, d, lead)
            out[q + "/conv_w"] = (lead + (W, di + 2 * N), dt, "normal",
                                  1 / math.sqrt(W))
            out[q + "/conv_b"] = (lead + (di + 2 * N,), dt, "normal", 0.02)
            out[q + "/A_log"] = (lead + (H,), "float32", "alog", 0.0)
            out[q + "/D"] = (lead + (H,), "float32", "one", 0.1)
            out[q + "/dt_bias"] = (lead + (H,), "float32", "normal", 0.5)
            norm(q + "/norm", di, lead)
    if "mamba2_sharedattn" in kinds:
        norm("shared_attn/ln1", d)
        attn("shared_attn/attn")
        norm("shared_attn/ln2", d)
        mlp("shared_attn/mlp")
    return dict(sorted(out.items()))


# ----------------------------------------------------------------------
# matrix products in the chosen precision
# ----------------------------------------------------------------------
def q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor (its
    max|x| onto 448), returned in float32."""
    s = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    return (x.float() / s).to(torch.float8_e4m3fn).float() * s


def q16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, returned in float32."""
    return x.to(torch.bfloat16).float()


#: each rounded precision's rounding
ROUND = {"fp8": q8, "bf16": q16}


class _Round(torch.autograd.Function):
    """Forward: the operand rounded; backward: the gradient as it comes
    (the products' own backward rounds their operands)."""

    @staticmethod
    def forward(ctx, x, rnd):
        return rnd(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """Forward: the identity; backward: the incoming gradient rounded
    before the products of the backward take it."""

    @staticmethod
    def forward(ctx, x, rnd):
        ctx.rnd = rnd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd(g), None


class _ScaleGrad(torch.autograd.Function):
    """Forward: the identity; backward: the gradient times a factor (a
    planted fault)."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


class Precision:
    """The precision of every matrix product: "f32" (TF32 off), "fp8"
    (operands and incoming gradients rounded to float8 e4m3: the control)
    or "bf16" (rounded to bfloat16: a witness of what the program's
    bfloat16 does to a reading).  `decay_grad` scales the gradient of the
    scan's log decay (1: the equations; else a planted fault)."""

    def __init__(self, name: str = "f32", decay_grad: float = 1.0):
        if name not in ("f32", *ROUND):
            raise ValueError(f"no precision {name!r}")
        self.name = name
        self.rnd = ROUND.get(name)
        self.decay_grad = decay_grad

    def ein(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        if self.rnd is None:
            return torch.einsum(eq, *ops)
        return _RoundGrad.apply(torch.einsum(
            eq, *(_Round.apply(o, self.rnd) for o in ops)), self.rnd)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.rnd is None:
            return a @ b
        return _RoundGrad.apply(_Round.apply(a, self.rnd)
                                @ _Round.apply(b, self.rnd), self.rnd)

    def raw(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b outside autograd (the attention's own backward)."""
        if self.rnd is None:
            return a @ b
        return self.rnd(a) @ self.rnd(b)

    def decay(self, la: torch.Tensor) -> torch.Tensor:
        """The scan's log decay, its gradient scaled by `decay_grad`."""
        if self.decay_grad == 1.0:
            return la
        return _ScaleGrad.apply(la, self.decay_grad)


# ----------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------
def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def norm(m: dict, p: Params, path: str, x: torch.Tensor,
         eps: float = 1e-5) -> torch.Tensor:
    if m.get("norm", "rmsnorm") == "rmsnorm":
        return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
            * p[path + "/scale"]
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.mean((x - mu) ** 2, -1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p[path + "/scale"] \
        + p[path + "/bias"]


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D), positions 0 .. S-1; the halves rotated."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


#: the most float32 scores of one block of query rows, over every head
SCORES = 1 << 29


def _blocks(S: int, H: int):
    """Query blocks (start, end) of at most SCORES / (H S) rows."""
    n = max(64, min(S, SCORES // (H * S)))
    return [(i, min(S, i + n)) for i in range(0, S, n)]


class _Attention(torch.autograd.Function):
    """Causal GQA attention softmax(q kᵀ / sqrt(D)) v over (B, S, H, D)
    operands, one batch row and one block of query rows at a time (the
    keys up to the block's last row); the backward recomputes each
    block's probabilities from its saved log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, prec):
        B, S, HQ, D = q.shape
        G = HQ // k.shape[2]
        scale = 1.0 / math.sqrt(D)
        out = torch.empty_like(q)
        lse = torch.empty(B, HQ, S, device=q.device, dtype=q.dtype)
        for b in range(B):
            kb = k[b].transpose(0, 1).repeat_interleave(G, 0)
            vb = v[b].transpose(0, 1).repeat_interleave(G, 0)
            for i, j in _blocks(S, HQ):
                qb = q[b, i:j].transpose(0, 1)                   # (H, n, D)
                s = prec.raw(qb, kb[:, :j].transpose(1, 2)) * scale
                s.masked_fill_(_mask(i, j, q.device), -math.inf)
                lse[b, :, i:j] = torch.logsumexp(s, -1)
                pr = torch.exp(s - lse[b, :, i:j, None])
                del s
                out[b, i:j] = prec.raw(pr, vb[:, :j]).transpose(0, 1)
                del pr
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.prec = prec
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        prec = ctx.prec
        B, S, HQ, D = q.shape
        KH = k.shape[2]
        G = HQ // KH
        scale = 1.0 / math.sqrt(D)
        dq = torch.empty_like(q)
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        for b in range(B):
            kb = k[b].transpose(0, 1).repeat_interleave(G, 0)
            vb = v[b].transpose(0, 1).repeat_interleave(G, 0)
            dkb, dvb = torch.zeros_like(kb), torch.zeros_like(vb)
            for i, j in _blocks(S, HQ):
                qb = q[b, i:j].transpose(0, 1)
                dob = dout[b, i:j].transpose(0, 1)
                s = prec.raw(qb, kb[:, :j].transpose(1, 2)) * scale
                s.masked_fill_(_mask(i, j, q.device), -math.inf)
                pr = torch.exp(s - lse[b, :, i:j, None])
                del s
                dvb[:, :j] += prec.raw(pr.transpose(1, 2), dob)
                dp = prec.raw(dob, vb[:, :j].transpose(1, 2))
                delta = (dob * out[b, i:j].transpose(0, 1)).sum(
                    -1, keepdim=True)
                ds = pr * (dp - delta) * scale
                del pr, dp
                dq[b, i:j] = prec.raw(ds, kb[:, :j]).transpose(0, 1)
                dkb[:, :j] += prec.raw(ds.transpose(1, 2), qb)
                del ds
            dk[b] = dkb.view(KH, G, S, D).sum(1).transpose(0, 1)
            dv[b] = dvb.view(KH, G, S, D).sum(1).transpose(0, 1)
        return dq, dk, dv, None


def _mask(i: int, j: int, device) -> torch.Tensor:
    """True where key c lies after query row r, rows i .. j-1, keys
    0 .. j-1."""
    r = torch.arange(i, j, device=device)[:, None]
    return torch.arange(j, device=device)[None, :] > r


def attention(m: dict, p: Params, path: str, x: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    z = dims(m)
    B, S, _ = x.shape
    q = prec.mm(x, p[path + "/wq/w"]).reshape(B, S, z["hq"], z["hd"])
    k = prec.mm(x, p[path + "/wk/w"]).reshape(B, S, z["kh"], z["hd"])
    v = prec.mm(x, p[path + "/wv/w"]).reshape(B, S, z["kh"], z["hd"])
    if m.get("pos", "rope") == "rope":
        theta = m.get("rope_theta", 10000.0)
        q, k = rope(q, theta), rope(k, theta)
    o = _Attention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                         prec)
    return prec.mm(o.reshape(B, S, -1), p[path + "/wo/w"])


def mlp(p: Params, path: str, x: torch.Tensor,
        prec: Precision) -> torch.Tensor:
    h = silu(prec.mm(x, p[path + "/wg/w"])) * prec.mm(x, p[path + "/wi/w"])
    return prec.mm(h, p[path + "/wo/w"])


# ----------------------------------------------------------------------
# Mamba2: the causal conv, then the scan h_t = a_t h_{t-1} + k_t v_tᵀ,
# y_t = q_t · h_t, chunk by chunk
# ----------------------------------------------------------------------
def gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        la: torch.Tensor, chunk: int, prec: Precision) -> torch.Tensor:
    """q, k (B, S, N) shared by every head; v (B, S, H, P); la (B, S, H)
    the log decay.  Returns y (B, S, H, P) from a zero state:
    y_t = sum_{s<=t} exp(L_t - L_s) (q_t · k_s) v_s, L the running sum of
    la."""
    B, S, H, P = v.shape
    N = q.shape[-1]
    c = min(chunk, S)
    n = S // c
    q, k = q.reshape(B, n, c, N), k.reshape(B, n, c, N)
    v, la = v.reshape(B, n, c, H, P), la.reshape(B, n, c, H)
    lc = torch.cumsum(la, dim=2)                              # (B, n, c, H)
    causal = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    diff = lc[:, :, :, None, :] - lc[:, :, None, :, :]       # (B,n,i,j,H)
    decay = torch.exp(diff.masked_fill(~causal[None, None, :, :, None],
                                       -math.inf))
    scores = prec.ein("bnid,bnjd->bnij", q, k)
    y = prec.ein("bnijh,bnjhp->bnihp", scores[..., None] * decay, v)
    # each chunk's own contribution to the state at its end, then the
    # states carried across the chunks
    last = lc[:, :, -1:, :]                                   # (B, n, 1, H)
    contrib = prec.ein("bnjd,bnjhp->bnhdp", k,
                       v * torch.exp(last - lc)[..., None])
    states, h = [], torch.zeros(B, H, N, P, device=q.device)
    for i in range(n):
        states.append(h)
        h = h * torch.exp(last[:, i, 0])[..., None, None] + contrib[:, i]
    y = y + prec.ein("bnid,bnhdp->bnihp", q, torch.stack(states, 1)) \
        * torch.exp(lc)[..., None]
    return y.reshape(B, S, H, P)


def mamba2(m: dict, p: Params, path: str, x: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    z = dims(m)
    di, N, H, P, W = z["di"], z["N"], z["H"], z["P"], z["W"]
    B, S, _ = x.shape
    zx = prec.mm(x, p[path + "/in_proj/w"])
    gate, xbc, dt_raw = zx[..., :di], zx[..., di:2 * di + 2 * N], \
        zx[..., 2 * di + 2 * N:]
    w, bias = p[path + "/conv_w"], p[path + "/conv_b"]
    xp = torch.nn.functional.pad(xbc, (0, 0, W - 1, 0))
    xbc = sum(xp[:, i:i + S] * w[i] for i in range(W)) + bias
    xbc = silu(xbc)
    xs = xbc[..., :di].reshape(B, S, H, P)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    dt = torch.nn.functional.softplus(dt_raw + p[path + "/dt_bias"])
    la = prec.decay(dt * -torch.exp(p[path + "/A_log"]))
    y = gla(Cm, Bm, xs * dt[..., None], la, max(32, N), prec)
    y = y + xs * p[path + "/D"][:, None]
    y = y.reshape(B, S, di) * silu(gate)
    y = norm(m, p, path + "/norm", y)
    return prec.mm(y, p[path + "/out_proj/w"])


# ----------------------------------------------------------------------
# the mixture of experts
# ----------------------------------------------------------------------
def expert(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
           wo: torch.Tensor, prec: Precision) -> torch.Tensor:
    """One expert's swiglu FFN over its slots x (C, d)."""
    return prec.mm(silu(prec.mm(x, wg)) * prec.mm(x, wi), wo)


def capacity(T: int, k: int, E: int, cf: float) -> int:
    """ceil(T k cf / E), at least 8, rounded up to a multiple of 8."""
    c = int(math.ceil(T * k * cf / E))
    return max(8, -(-c // 8) * 8)


def moe(m: dict, p: Params, path: str, x: torch.Tensor,
        prec: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, aux): top-k routing over softmax(x W_r) (ties to the lower
    expert), gates renormalised over the k; the token -> expert pairs
    sorted by expert (stable), the first C of each expert kept; each
    expert's swiglu FFN over its C slots; each token the gated sum of its
    kept pairs.  aux = E sum_e (share of first choices) (mean prob)."""
    z = dims(m)
    E, k = z["E"], z["k"]
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    probs = torch.softmax(prec.mm(xt, p[path + "/router/w"]), -1)
    top_g, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_g, top_i = top_g[:, :k], top_i[:, :k]
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9)
    first = torch.nn.functional.one_hot(top_i[:, 0], E).float().mean(0)
    aux = E * torch.sum(first * probs.mean(0))
    C = capacity(T, k, E, z["cf"])
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sid = flat_e[order]
    idx = torch.arange(T * k, device=x.device)
    start = torch.searchsorted(sid, sid, right=False)
    slot = idx - start
    keep = slot < C
    dest = torch.where(keep, sid * C + slot, E * C)
    buf = torch.zeros(E * C + 1, d, device=x.device)
    buf = buf.index_copy(0, dest, xt[order // k])
    e_in = buf[:E * C].view(E, C, d)
    # one expert at a time, recomputed in the backward: the (C, f)
    # activations of one expert are live, not of all E
    xs = e_in.unbind(0)
    ws = [p[path + w].unbind(0) for w in ("/wi", "/wg", "/wo")]
    e_out = torch.cat([checkpoint(
        expert, xs[e], ws[0][e], ws[1][e], ws[2][e], prec,
        use_reentrant=False) for e in range(E)]
        + [torch.zeros(1, d, device=x.device)])
    gates = top_g.reshape(-1)[order]
    y = torch.zeros(T, d, device=x.device).index_add(
        0, order // k, e_out[dest] * gates[:, None])
    return y.reshape(B, S, d), aux


# ----------------------------------------------------------------------
# the stack and the loss
# ----------------------------------------------------------------------
def unstack(p: Params, prefix: str, n: int) -> List[Params]:
    """The n layers of the stacked leaves under `prefix`, keyed as the
    stack: views by ``unbind``, so that the backward stacks each leaf's n
    gradients once instead of adding n leaf-sized tensors."""
    parts = {k: v.unbind(0) for k, v in p.items()
             if k.startswith(prefix + "/")}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def block(m: dict, kind: str, p: Params, shared: Params, x: torch.Tensor,
          prec: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    base = f"layers/{kind}"
    zero = torch.zeros((), device=x.device)
    h = norm(m, p, base + "/ln1", x)
    if kind == "moe":
        x = x + attention(m, p, base + "/attn", h, prec)
        y, aux = moe(m, p, base + "/moe", norm(m, p, base + "/ln2", x),
                     prec)
        return x + y, aux
    x = x + mamba2(m, p, base + "/mamba", h, prec)
    if kind == "mamba2_sharedattn":
        x = x + attention(m, shared, "shared_attn/attn",
                          norm(m, shared, "shared_attn/ln1", x), prec)
        x = x + mlp(shared, "shared_attn/mlp",
                    norm(m, shared, "shared_attn/ln2", x), prec)
    return x, zero


def _chunk_loss(m: dict, p: Params, h: torch.Tensor, t: torch.Tensor,
                prec: Precision) -> torch.Tensor:
    logits = prec.mm(norm(m, p, "final_norm", h), p["lm_head/w"])
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, t.clamp_min(0)[..., None])[..., 0]
    return torch.sum((lse - gold) * (t >= 0).float())


def forward_loss(m: dict, p: Params, tokens: torch.Tensor,
                 targets: torch.Tensor,
                 prec: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean token loss + 0.01 aux, the mean token loss) of a batch
    (B, S) of int64 tokens and targets (-1 ignored), float32 leaves in p."""
    x = p["embed/tokens"][tokens]
    kinds = pattern(m)
    shared = {k: v for k, v in p.items() if k.startswith("shared_attn/")}
    stacks = {b: unstack(p, f"layers/{b}", kinds.count(b))
              for b in set(kinds)}
    seen = {b: 0 for b in set(kinds)}
    aux = torch.zeros((), device=x.device)
    for kind in kinds:
        lp = stacks[kind][seen[kind]]
        seen[kind] += 1
        x, a = checkpoint(block, m, kind, lp, shared, x, prec,
                          use_reentrant=False)
        aux = aux + a
    B, S = targets.shape
    n = m.get("chunked_loss_chunks", 8)
    while S % n:
        n -= 1
    c = S // n
    tot = torch.zeros((), device=x.device)
    head = {k: p[k] for k in p if k.startswith(("final_norm/", "lm_head/"))}
    for j in range(0, S, c):
        tot = tot + checkpoint(_chunk_loss, m, head, x[:, j:j + c],
                               targets[:, j:j + c], prec,
                               use_reentrant=False)
    loss = tot / (targets >= 0).sum().clamp_min(1)
    return loss + 0.01 * aux, loss
