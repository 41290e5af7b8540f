"""A run's inputs, made from ``--seed`` by the benchmark and handed alike
to the program and to the reference: the initial weights and the token
batches.

Weights: every leaf of ``reference.model.leaf_specs`` drawn on the device
from one ``torch.Generator`` seeded with the seed, in a few large calls
(one ``rand`` and one ``randn`` buffer a dtype, in the dtype the leaves
are kept in), each leaf then scaled in place on its slice.  The same seed
on the same device gives the same weights.

Batches: :class:`TokenStream`, a copy of the synthetic mixture of the
port's ``data/pipeline.py:SyntheticLMDataset`` (Zipfian unigrams with
short repeated motifs, keyed on (seed, step)), drawn on the host with
numpy from the traffic file's parameters.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..reference.model import leaf_specs


def torch_seed(seed: int) -> int:
    """The seed as a torch generator takes it (64 bits)."""
    return int(seed) & ((1 << 64) - 1)


def make_weights(model: dict, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{path: tensor} of the initial weights, each in its leaf's dtype."""
    specs = leaf_specs(model)
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed))
    groups: Dict[tuple, list] = {}
    for path, (shape, dt, kind, _) in specs.items():
        draw = "rand" if kind in ("uniform", "alog") else "randn"
        groups.setdefault((dt, draw), []).append(path)
    out: Dict[str, torch.Tensor] = {}
    for (dt, draw), paths in sorted(groups.items()):
        n = sum(math.prod(specs[p][0]) for p in paths)
        buf = getattr(torch, draw)(n, generator=gen, device=device,
                                   dtype=getattr(torch, dt))
        at = 0
        for p in paths:
            shape, _, kind, scale = specs[p]
            size = math.prod(shape)
            t = buf[at:at + size].view(shape)
            at += size
            if kind == "uniform":
                t.mul_(2 * scale).sub_(scale)
            elif kind == "alog":
                t.mul_(15.0).add_(1.0).log_()
            elif kind == "one":
                t.mul_(scale).add_(1.0)
            else:
                t.mul_(scale)
            out[p] = t
    return dict(sorted(out.items()))


class TokenStream:
    """The batch of each step: {"tokens", "targets"} (B, S) int32 numpy,
    the same for the same (seed, step)."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int, seed: int,
                 motif_len: int = 8, n_motifs: int = 64):
        self.vocab_size, self.seq_len, self.global_batch = (vocab_size,
                                                            seq_len, batch)
        self.seed, self.motif_len = int(seed), motif_len
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.motifs = np.random.default_rng(self.seed).integers(
            0, vocab_size, size=(n_motifs, motif_len))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        S, L = self.seq_len, self.motif_len
        rng = np.random.default_rng((self.seed, step, 0))
        toks = rng.choice(self.vocab_size, size=(self.global_batch, S + 1),
                          p=self.unigram)
        n_plant = (S // L) // 2
        for b in range(self.global_batch):
            ids = rng.integers(0, len(self.motifs), size=n_plant)
            starts = rng.choice(S - L, size=n_plant, replace=False)
            for m, s in zip(ids, starts):
                toks[b, s:s + L] = self.motifs[m]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}
