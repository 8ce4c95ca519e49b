"""Synthetic LM token pipeline.

A numpy copy of ``repro/data/lm_data.py`` (that module's package loads
JAX); its batches are equal to the reference's, element for element.

Deterministic, seeded synthetic corpus with learnable structure: tokens
follow a mixture of (a) a first-order Markov chain with a banded transition
kernel and (b) copy-back spans, so a transformer's loss actually decreases
during the example training runs (unlike uniform noise). ``__next__``
returns {tokens, labels} (labels = tokens shifted left) as int32 arrays;
step ``k``'s batch is drawn from ``default_rng((seed, k))``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    markov_band: int = 32
    copy_prob: float = 0.3

    def __post_init__(self):
        self._step = 0

    def _sample_doc(self, rng, length: int) -> np.ndarray:
        v = self.vocab_size
        toks = np.empty(length, dtype=np.int64)
        toks[0] = rng.integers(0, v)
        i = 1
        while i < length:
            if i > 16 and rng.random() < self.copy_prob:
                # copy-back span: repeat an earlier window (induction heads)
                span = int(rng.integers(4, 16))
                start = int(rng.integers(0, i - span)) if i - span > 0 else 0
                span = min(span, length - i)
                toks[i:i + span] = toks[start:start + span]
                i += span
            else:
                # banded Markov step
                step = int(rng.integers(1, self.markov_band))
                toks[i] = (toks[i - 1] * 31 + step) % v
                i += 1
        return toks

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self._step))
        self._step += 1
        batch = np.stack([self._sample_doc(rng, self.seq_len + 1)
                          for _ in range(self.batch_size)])
        return {"tokens": batch[:, :-1].astype(np.int32),
                "labels": batch[:, 1:].astype(np.int32)}


def synthetic_lm_batches(vocab_size: int, seq_len: int, batch_size: int,
                         steps: int, seed: int = 0):
    ds = SyntheticLMDataset(vocab_size, seq_len, batch_size, seed)
    for _ in range(steps):
        yield next(ds)
