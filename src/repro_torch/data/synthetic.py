"""Synthetic token streams (port of the token half of
``repro.data.synthetic``; the numpy generator is copied unchanged, so the
two packages draw identical batches from one seed).

Zipf-distributed ids with a deterministic next-token structure, so that
a learning model measurably reduces loss.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def token_batches(
    vocab_size: int,
    batch: int,
    seq_len: int,
    seed: int = 0,
    structured: bool = True,
) -> Iterator[dict]:
    """INFINITE iterator of {'tokens', 'labels'} numpy int32 batches.

    ``structured`` plants a learnable pattern: token_{t+1} depends on
    token_t via a fixed random permutation with noise, so cross-entropy
    can drop below the unigram entropy. Bound consumption with
    ``repro_torch.data.take(it, n)``.
    """
    from repro_torch.data.pipeline import InfiniteStream

    return InfiniteStream(
        _token_batches_gen(vocab_size, batch, seq_len, seed, structured)
    )


def _token_batches_gen(
    vocab_size: int,
    batch: int,
    seq_len: int,
    seed: int = 0,
    structured: bool = True,
) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(vocab_size)
    zipf_p = 1.0 / np.arange(1, vocab_size + 1)
    zipf_p /= zipf_p.sum()
    while True:
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.choice(vocab_size, size=batch, p=zipf_p)
        if structured:
            noise = rng.random((batch, seq_len)) < 0.2
            rand_tok = rng.choice(vocab_size, size=(batch, seq_len), p=zipf_p)
            for t in range(seq_len):
                nxt = perm[toks[:, t]]
                toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        else:
            toks[:, 1:] = rng.choice(
                vocab_size, size=(batch, seq_len), p=zipf_p
            )
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
