"""Deterministic synthetic LM data with learnable structure.

Mixture of (a) Zipfian unigrams, (b) copy/induction spans (the sequence
repeats a randomly chosen earlier window), so a real model's loss drops
well below the unigram entropy — used by the end-to-end training example
and the loss-decreases integration test.  Fully seeded: restart-safe (the
pipeline can be fast-forwarded to any step for checkpoint/restart).

Numpy only: the port's copy of ``repro.data.synthetic``; the same seed gives
the same batches byte for byte.
"""
from __future__ import annotations

import numpy as np


class SyntheticLMDataset:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, copy_frac: float = 0.5):
        self.V = vocab_size
        self.S = seq_len
        self.B = global_batch
        self.seed = seed
        self.copy_frac = copy_frac
        # Zipf weights over a head of the vocab
        head = min(self.V, 4096)
        w = 1.0 / np.arange(1, head + 1) ** 1.1
        self._p = w / w.sum()
        self._head = head

    def batch(self, step: int) -> dict:
        """Batch for a given step index (stateless -> restartable)."""
        rng = np.random.default_rng((self.seed, step))
        toks = rng.choice(self._head, size=(self.B, self.S + 1), p=self._p)
        # induction spans: copy an earlier window forward
        n_copy = int(self.B * self.copy_frac)
        for b in range(n_copy):
            span = rng.integers(8, max(9, self.S // 4))
            src = rng.integers(0, self.S - 2 * span)
            dst = rng.integers(src + span, self.S - span)
            toks[b, dst:dst + span] = toks[b, src:src + span]
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
