"""The model FLOPs of a training step, from a configuration's fields.

The matrix products the equations need per token, times 3 for a
training step (the forward, and the backward's two products per forward
product), with nothing recomputed counted: each linear layer 2 d_in
d_out; attention's q kᵀ and P v over the causal half, 2 S D a head on
average; a Mamba2 scan its recurrent form, kᵀ v into the state and q
against it, 4 N P a head; a moe layer its router and its top k experts
(not the capacity buffer's empty slots); the output head.  The embedding
is a lookup and counts nothing; neither do norms, the causal conv and
the other elementwise work.  zamba2's shared attention block counts once
for each of its applications.
"""
from __future__ import annotations

from ..reference.model import dims, pattern


def forward_flops_per_token(model: dict, seq_len: int) -> float:
    z = dims(model)
    d = z["d"]
    attn = (2 * d * (z["q_dim"] + 2 * z["kv_dim"]) + 2 * z["q_dim"] * d
            + 2 * seq_len * z["hd"] * z["hq"])
    mlp = 3 * 2 * d * z["ff"]
    total = 2 * d * z["V"]
    for kind in pattern(model):
        if kind == "moe":
            total += attn + 2 * d * z["E"] + z["k"] * 3 * 2 * d * z["f"]
            continue
        di, N, H, P = z["di"], z["N"], z["H"], z["P"]
        total += (2 * d * (2 * di + 2 * N + H) + 2 * di * d
                  + 4 * N * P * H)
        if kind == "mamba2_sharedattn":
            total += attn + mlp
    return float(total)


def step_flops(model: dict, batch: int, seq_len: int) -> float:
    """Model FLOPs of one training step of `batch` rows of `seq_len`."""
    return 3.0 * forward_flops_per_token(model, seq_len) * batch * seq_len
