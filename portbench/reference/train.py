"""The reference's training steps: the loss of :mod:`.model`, its gradient
by autograd, clipping to a global norm of 1, the cosine schedule with
linear warm-up and AdamW, as the training recipe states them.

The parameters are kept as the configuration states: each leaf in its
dtype (bfloat16 or float32), the update computed in float32 and rounded
to the leaf's dtype; the optimizer's moments in float32.  The forward and
the gradient are float32 (or the control's fp8 products, or the witness's
bfloat16 ones).  What a run
returns is what the comparison reads: each step's loss, each leaf's norm
of the clipped gradient of the first step, and each leaf's norm of the
change of the parameters after the steps.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .model import Precision, forward_loss

#: the most elements of a leaf that the update takes at once
CHUNK = 1 << 25


def lr_at(step: int, recipe: dict) -> float:
    """The cosine schedule with linear warm-up, in float32."""
    f32 = np.float32
    peak, warm = f32(recipe["peak_lr"]), recipe["warmup_steps"]
    total = recipe["total_steps"]
    if step < warm:
        return float(peak * min(f32(step + 1) / f32(max(1, warm)), f32(1)))
    frac = min(max((f32(step) - f32(warm)) / f32(max(1, total - warm)),
                   f32(0)), f32(1))
    return float(f32(0.5) * peak * (f32(1) + f32(math.cos(math.pi * frac))))


def _slices(t: torch.Tensor) -> List[torch.Tensor]:
    if t.dim() == 0 or t.numel() <= CHUNK:
        return [t]
    rows = max(1, CHUNK // (t.numel() // t.shape[0]))
    return list(torch.split(t, rows, dim=0))


def leaf_norm(t: torch.Tensor, minus: Optional[torch.Tensor] = None
              ) -> float:
    """The 2-norm of a leaf (of t - minus), summed in float64 a slice of
    its leading dim at a time."""
    sq = 0.0
    parts = _slices(t) if minus is None else zip(_slices(t), _slices(minus))
    for s in parts:
        d = s.double() if minus is None else s[0].double() - s[1].double()
        sq += float(torch.sum(d ** 2))
    return math.sqrt(sq)


def train_steps(model: dict, weights: Dict[str, torch.Tensor],
                batches: List[Dict[str, torch.Tensor]], recipe: dict,
                precision: str = "f32", rows: int = 0,
                decay_grad: float = 1.0) -> dict:
    """Run len(batches) steps from `weights` (consumed: the caller's dict
    is emptied).  `rows` > 0 keeps the first `rows` rows of each batch
    alone (a fault: a part of the batch left out); `decay_grad` scales the
    scan's log-decay gradient (another fault).  Returns {"loss": [...]
    each step's mean token loss, "grad": {path: norm of the first step's
    clipped gradient}, "change": {path: norm of the change after the
    steps}, "size": {path: elements}}."""
    prec = Precision(precision, decay_grad)
    dtypes = {k: v.dtype for k, v in weights.items()}
    start = {k: v.to("cpu", copy=True) for k, v in weights.items()}
    params = {}
    for k in sorted(weights):
        params[k] = weights.pop(k).to(torch.float32, copy=True) \
            .requires_grad_(True)
    names = list(params)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2 = recipe.get("b1", 0.9), recipe.get("b2", 0.95)
    eps, wd = recipe.get("eps", 1e-8), recipe.get("weight_decay", 0.1)
    out: dict = {"loss": [], "grad": {}, "change": {},
                 "size": {k: v.numel() for k, v in params.items()}}
    for step, batch in enumerate(batches):
        tokens = batch["tokens"].long()
        targets = batch["targets"].long()
        if rows:
            tokens, targets = tokens[:rows], targets[:rows]
        total, loss = forward_loss(model, params, tokens, targets, prec)
        grads = torch.autograd.grad(total, [params[k] for k in names])
        out["loss"].append(float(loss.detach()))
        del total, loss
        with torch.no_grad():
            norm = math.sqrt(sum(leaf_norm(g) ** 2 for g in grads))
            scale = min(1.0, 1.0 / max(norm, 1e-9))
            c = np.float32(step + 1)
            bc1 = float(np.float32(1) - np.float32(b1) ** c)
            bc2 = float(np.float32(1) - np.float32(b2) ** c)
            lr = lr_at(step, recipe)
            for k, g in zip(names, grads):
                g.mul_(scale)
                if step == 0:
                    out["grad"][k] = leaf_norm(g)
                p = params[k]
                for gs, ms, vs, ps in zip(*(_slices(t) for t in (
                        g, m[k], v2[k], p))):
                    ms.mul_(b1).add_((1 - b1) * gs)
                    vs.mul_(b2).add_((1 - b2) * gs * gs)
                    upd = (ms / bc1) / (torch.sqrt(vs / bc2) + eps) + wd * ps
                    ps.copy_((ps - lr * upd).to(dtypes[k]).float())
            del grads
    del m, v2
    with torch.no_grad():
        for k in names:
            p = params.pop(k)
            out["change"][k] = leaf_norm(p, start.pop(k).to(p.device))
    return out
