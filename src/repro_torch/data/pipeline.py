"""Batching pipelines: tabular VFL batches and LM token batches (a numpy
copy of ``repro.data.pipeline``: the same seed gives byte-identical
batches).

The LM pipeline synthesizes token streams (no corpus access) with a
power-law unigram distribution plus a deterministic bigram structure so
models can actually reduce loss over a few hundred steps.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

__all__ = ["batch_iterator", "synthesize_tokens", "token_batch_iterator"]


def batch_iterator(n: int, batch_size: int, *, seed: int = 0,
                   shuffle: bool = True, drop_last: bool = False
                   ) -> Iterator[np.ndarray]:
    """Yields index arrays over [0, n)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n) if shuffle else np.arange(n)
    stop = (n // batch_size) * batch_size if drop_last else n
    for start in range(0, stop, batch_size):
        yield order[start:start + batch_size]


def synthesize_tokens(rng: np.random.Generator, batch: int, seq: int,
                      vocab: int) -> np.ndarray:
    """Zipfian unigrams + noisy 'successor' bigram structure."""
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    toks = np.empty((batch, seq), np.int64)
    toks[:, 0] = rng.choice(vocab, size=batch, p=probs)
    succ = (np.arange(vocab) * 31 + 7) % vocab  # fixed successor map
    for t in range(1, seq):
        follow = rng.random(batch) < 0.6
        fresh = rng.choice(vocab, size=batch, p=probs)
        toks[:, t] = np.where(follow, succ[toks[:, t - 1]], fresh)
    return toks.astype(np.int32)


def token_batch_iterator(batch: int, seq: int, vocab: int, *, seed: int = 0,
                         d_model: int = 0, frames: int = 0, patches: int = 0,
                         weights: bool = False
                         ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite LM batches; optionally attaches stub frame/patch embeddings
    and per-sample coreset weights (ones)."""
    rng = np.random.default_rng(seed)
    while True:
        toks = synthesize_tokens(rng, batch, seq, vocab)
        out: Dict[str, np.ndarray] = {"tokens": toks, "labels": toks.copy()}
        if frames:
            out["frames"] = rng.normal(
                0, 1, (batch, frames, d_model)).astype(np.float32)
        if patches:
            out["patches"] = rng.normal(
                0, 1, (batch, patches, d_model)).astype(np.float32)
        if weights:
            out["weights"] = np.ones((batch,), np.float32)
        yield out
