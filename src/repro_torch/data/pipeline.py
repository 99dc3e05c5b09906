"""Data pipeline: deterministic synthetic LM corpus + shard-aware batcher.

The corpus is a Zipf-ish Markov stream (so the loss actually goes down when
training — unlike uniform noise, bigram structure is learnable by a tiny
model in a few hundred steps, which the e2e example exploits).  Generation
is pure numpy, seeded, and shard-aware: worker ``(i, n)`` produces the i-th
of n disjoint slices of the same logical stream, so the global batch is
identical regardless of topology (the standard deterministic-input
requirement for multi-pod training).

The port's own copy of ``src/repro/data/pipeline.py`` (numpy only, so the
port imports nothing of the JAX package): its tokens are bitwise the
reference's for every seed, step and shard.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass
class SyntheticLM:
    """Markov-chain corpus with Zipf marginals and local structure."""

    vocab: int
    seed: int = 0
    branching: int = 8         # out-degree per state: smaller = more learnable

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab
        self.successors = rng.integers(0, v, size=(v, self.branching))
        zipf = 1.0 / np.arange(1, self.branching + 1)
        self.probs = zipf / zipf.sum()

    def stream(self, seed: int) -> Iterator[int]:
        rng = np.random.default_rng((self.seed << 20) ^ seed)
        tok = int(rng.integers(0, self.vocab))
        while True:
            yield tok
            tok = int(self.successors[tok, rng.choice(self.branching, p=self.probs)])

    def sample_tokens(self, n: int, seed: int) -> np.ndarray:
        it = self.stream(seed)
        return np.fromiter((next(it) for _ in range(n)), np.int32, count=n)


class TokenBatcher:
    """Yields {tokens, labels} batches of [local_batch, seq+?]. Labels are the
    next-token shift (the model shifts internally; labels kept for parity
    with real loaders)."""

    def __init__(self, corpus: SyntheticLM, global_batch: int, seq: int,
                 shard_index: int = 0, num_shards: int = 1):
        if global_batch % num_shards:
            raise ValueError(f"global_batch {global_batch} % shards {num_shards} != 0")
        self.corpus = corpus
        self.global_batch = global_batch
        self.local_batch = global_batch // num_shards
        self.seq = seq
        self.shard_index = shard_index
        self.num_shards = num_shards
        self._step = 0

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rows = []
        for b in range(self.local_batch):
            gslot = self.shard_index * self.local_batch + b
            # stream id mixes step & global slot -> disjoint, reproducible
            rows.append(self.corpus.sample_tokens(
                self.seq, seed=self._step * self.global_batch + gslot))
        self._step += 1
        toks = np.stack(rows)
        return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def make_train_iterator(vocab: int, global_batch: int, seq: int,
                        shard_index: int = 0, num_shards: int = 1,
                        seed: int = 0) -> TokenBatcher:
    return TokenBatcher(SyntheticLM(vocab=vocab, seed=seed),
                        global_batch, seq, shard_index, num_shards)
