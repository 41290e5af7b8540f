"""Deterministic synthetic LM data pipeline.

The port's own copy of the reference's ``data/pipeline.py`` (numpy only,
unchanged): the same seed, step and shard give the same batches, bit for
bit.

Host-side, per-process sharded token stream with a seedable generator —
the data-parallel analogue of VTA's "runtime prepares DRAM buffers"
contract.  Determinism is keyed on (seed, step, shard), so elastic
restarts resume the exact stream from a checkpointed step without
replaying the history (a requirement for fault-tolerant training).

The synthetic distribution is a mixture of Zipfian unigrams and short
repeated motifs, giving a learnable signal (loss drops well below
ln(vocab)) while needing no external corpus.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1       # data-parallel host shards
    shard_id: int = 0
    motif_len: int = 8
    n_motifs: int = 64


class SyntheticLMDataset:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Zipfian unigram distribution
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # fixed motif table: short phrases the model can memorize
        self.motifs = root.integers(0, v, size=(cfg.n_motifs, cfg.motif_len))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        if cfg.global_batch % cfg.n_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {cfg.n_shards} shards")
        local = cfg.global_batch // cfg.n_shards
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.shard_id))  # deterministic per (step, shard)
        toks = rng.choice(cfg.vocab_size, size=(local, cfg.seq_len + 1),
                          p=self.unigram)
        # plant motifs: ~50% of positions covered by repeated phrases
        n_plant = (cfg.seq_len // cfg.motif_len) // 2
        for b in range(local):
            ids = rng.integers(0, cfg.n_motifs, size=n_plant)
            starts = rng.choice(cfg.seq_len - cfg.motif_len, size=n_plant,
                                replace=False)
            for m, s in zip(ids, starts):
                toks[b, s:s + cfg.motif_len] = self.motifs[m]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}


def make_train_iterator(cfg: DataConfig, start_step: int = 0
                        ) -> Iterator[Dict[str, np.ndarray]]:
    ds = SyntheticLMDataset(cfg)
    step = start_step
    while True:
        yield ds.batch(step)
        step += 1
