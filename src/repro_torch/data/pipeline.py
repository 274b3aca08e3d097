"""Deterministic synthetic data pipeline.

Offline container: no datasets on disk, so the pipeline synthesizes a
learnable token distribution (order-2 Markov chains with per-stream
transition tables) — losses genuinely decrease, smoke tests and the FL
convergence benchmarks have signal, and everything is reproducible from a
seed. The pipeline is shard-aware: ``worker_slice`` carves the global batch
for a data-parallel worker, and ``federated_partitions`` gives each FL client
a disjoint sub-distribution (non-IID knob included).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    """Infinite deterministic stream of (tokens, labels) batches."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    markov_order_states: int = 64   # distinct hidden transition rows
    skew: float = 1.2               # zipf-ish skew of the transition tables

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.vocab_size
        # Row-stochastic transition table over a hashed state.
        raw = rng.pareto(self.skew, size=(self.markov_order_states, V)) + 1e-3
        self._table_logits = np.log(raw / raw.sum(axis=1, keepdims=True))
        self._step = 0

    def _state(self, prev: np.ndarray, prev2: np.ndarray) -> np.ndarray:
        # Order-1 dominant (bigram-learnable) so tiny models get signal fast.
        return prev % self.markov_order_states

    def batch(self, step: Optional[int] = None) -> dict:
        """Batch for a given step (stateless => resumable/replayable)."""
        if step is None:
            step = self._step
            self._step += 1
        rng = np.random.default_rng((self.seed + 1) * 1_000_003 + step)
        B, S, V = self.batch_size, self.seq_len, self.vocab_size
        toks = np.zeros((B, S + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        toks[:, 1] = rng.integers(0, V, size=B)
        gumbel = rng.gumbel(size=(B, S + 1, 1)).astype(np.float32)
        for t in range(2, S + 1):
            state = self._state(toks[:, t - 1], toks[:, t - 2])
            logits = self._table_logits[state]          # (B, V)
            g = rng.gumbel(size=logits.shape).astype(np.float32)
            toks[:, t] = np.argmax(logits + g, axis=-1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def worker_slice(self, batch: dict, worker: int, num_workers: int) -> dict:
        per = self.batch_size // num_workers
        sl = slice(worker * per, (worker + 1) * per)
        return {k: v[sl] for k, v in batch.items()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def federated_partitions(vocab_size: int, seq_len: int, batch_size: int,
                         num_clients: int, *, seed: int = 0,
                         non_iid: float = 0.0) -> list[TokenPipeline]:
    """One pipeline per FL client. ``non_iid`` in [0,1] skews each client's
    transition tables away from the common distribution (0 = IID shards)."""
    out = []
    for c in range(num_clients):
        p = TokenPipeline(vocab_size, seq_len, batch_size,
                          seed=seed + 7919 * (c + 1))
        if non_iid > 0.0:
            common = TokenPipeline(vocab_size, seq_len, batch_size,
                                   seed=seed)._table_logits
            p._table_logits = ((1 - non_iid) * common
                               + non_iid * p._table_logits)
        else:
            p._table_logits = TokenPipeline(
                vocab_size, seq_len, batch_size, seed=seed)._table_logits
        out.append(p)
    return out


def synthetic_batch(vocab_size: int, seq_len: int, batch_size: int,
                    seed: int = 0) -> dict:
    return TokenPipeline(vocab_size, seq_len, batch_size, seed=seed).batch(0)
