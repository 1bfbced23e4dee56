"""Synthetic datasets (port of ``repro.data.synthetic``; the numpy
generators are copied unchanged, so the two packages draw identical data
from one seed).

Two kinds:

1. Token streams for the language-model training (Zipf-distributed ids
   with a deterministic next-token structure, so that a learning model
   measurably reduces loss).
2. The paper's logistic-regression datasets (Section 4.1): an
   epsilon-like DENSE dataset and an RCV1-like SPARSE dataset, with a
   planted ground-truth separator + label noise. Beside the numpy loss
   and gradient, ``logreg_loss_torch`` / ``logreg_grad_torch`` compute
   the same on tensors, on whatever device the data lies.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Union

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# logistic regression (paper Section 4)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LogRegData:
    """a_i in R^d, b_i in {-1, +1}; f(x) = mean log(1+exp(-b a^T x)) + l2/2 |x|^2."""

    A: np.ndarray  # (n, d)
    b: np.ndarray  # (n,)
    lam: float  # L2 regularizer (paper: 1/n)
    name: str = ""

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def d(self) -> int:
        return self.A.shape[1]


def make_epsilon_like(
    n: int = 10_000, d: int = 2_000, seed: int = 0, noise: float = 0.1
) -> LogRegData:
    """Dense dataset in the spirit of `epsilon` (d=2000, 100% density)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, d)).astype(np.float64) / np.sqrt(d)
    w_star = rng.standard_normal(d)
    logits = A @ w_star
    b = np.sign(logits + noise * rng.standard_normal(n)).astype(np.float64)
    b[b == 0] = 1.0
    return LogRegData(A=A, b=b, lam=1.0 / n, name="epsilon-like")


def make_rcv1_like(
    n: int = 20_000, d: int = 47_236, density: float = 0.0015, seed: int = 0,
    noise: float = 0.1,
) -> LogRegData:
    """Sparse dataset in the spirit of RCV1-test (density 0.15%).

    Stored dense (numpy) for simplicity; the gradients inherit the sparsity
    pattern, which is what matters for the communication accounting.
    """
    rng = np.random.default_rng(seed)
    A = np.zeros((n, d))
    nnz = max(1, int(density * d))
    for i in range(n):
        idx = rng.choice(d, size=nnz, replace=False)
        A[i, idx] = rng.standard_normal(nnz) / np.sqrt(nnz)
    w_star = rng.standard_normal(d)
    logits = A @ w_star
    b = np.sign(logits + noise * rng.standard_normal(n)).astype(np.float64)
    b[b == 0] = 1.0
    return LogRegData(A=A, b=b, lam=1.0 / n, name="rcv1-like")


def logreg_loss_np(data: LogRegData, x: np.ndarray) -> float:
    z = -data.b * (data.A @ x)
    # stable log(1+exp(z))
    loss = np.mean(np.logaddexp(0.0, z))
    return float(loss + 0.5 * data.lam * np.dot(x, x))


def logreg_grad_np(data: LogRegData, x: np.ndarray, idx) -> np.ndarray:
    """Stochastic gradient over sample indices ``idx``."""
    Ai = data.A[idx]
    bi = data.b[idx]
    z = -bi * (Ai @ x)
    sig = 1.0 / (1.0 + np.exp(-z))  # sigmoid(z)
    g = -(Ai * (bi * sig)[:, None]).mean(axis=0)
    return g + data.lam * x


def logreg_loss_torch(A: torch.Tensor, b: torch.Tensor, lam: float,
                      x: torch.Tensor) -> torch.Tensor:
    """``logreg_loss_np`` on tensors (A (n, d), b (n,), x (d,)): a 0-d
    tensor on their device, computed in their dtype."""
    z = -b * (A @ x)
    loss = torch.mean(torch.logaddexp(torch.zeros_like(z), z))
    return loss + 0.5 * lam * torch.dot(x, x)


def logreg_grad_torch(A: torch.Tensor, b: torch.Tensor, lam: float,
                      x: torch.Tensor,
                      idx: Union[int, slice, torch.Tensor]) -> torch.Tensor:
    """``logreg_grad_np`` on tensors, over sample indices ``idx``; an int
    is one sample (taken as a view of its row: no gather)."""
    if isinstance(idx, int):
        idx = slice(idx, idx + 1)
    Ai = A[idx]
    bi = b[idx]
    z = -bi * (Ai @ x)
    sig = torch.sigmoid(z)
    g = -(Ai * (bi * sig)[:, None]).mean(dim=0)
    return g + lam * x
