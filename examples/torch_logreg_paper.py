"""Paper Section 4 on the PyTorch port: logistic regression with Mem-SGD —
the twin of ``examples/logreg_paper.py``, on ``memsgd_flat`` and the
port's theory module.

Reproduces the experimental protocol of Fig. 2 (theoretical stepsizes
eta_t = gamma/(lambda(t+a)), weighted average w_t = (t+a)^2) on an
epsilon-like dense dataset and an RCV1-like sparse dataset, comparing:

  * vanilla SGD (dense communication; ``memsgd_flat`` with ``identity``)
  * Mem-SGD top-k / rand-k (k sparse coordinates per step)
  * the 'without delay' ablation (a=1) that the paper shows hurts

Every run takes single-sample steps at sample indices drawn on the host
before the loop, as the reference's runners draw them. The data is
float32 on the device; f* comes from full gradient descent on it.

Run:  PYTHONPATH=src python examples/torch_logreg_paper.py [--full]
          [--platform cpu] [--steps T]
"""
import argparse
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import encoding
from repro_torch.core.compression import Compressor, identity, rand_k, top_k
from repro_torch.core.memsgd import memsgd_flat
from repro_torch.core.theory import WeightedAverage, paper_stepsize
from repro_torch.data import (
    LogRegData,
    logreg_grad_torch,
    logreg_loss_torch,
    make_epsilon_like,
    make_rcv1_like,
)
from repro_torch.optim import apply_updates
from repro_torch.utils.platform import resolve_device


def to_device(data: LogRegData, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dataset's (A, b) as float32 tensors on ``device``."""
    return (torch.from_numpy(data.A.astype(np.float32)).to(device),
            torch.from_numpy(data.b.astype(np.float32)).to(device))


def sample_indices(n: int, T: int, seed: int = 0) -> list:
    """T sample indices, drawn as ``benchmarks/logreg_runners.run_memsgd``
    draws them for top-k (one ``integers(n)`` per step)."""
    rng = np.random.default_rng(seed)
    return [int(rng.integers(n)) for _ in range(T)]


def run_memsgd_flat(A: torch.Tensor, b: torch.Tensor, lam: float,
                    compressor: Compressor, a: float, idx: Sequence[int],
                    gamma: float = 2.0, evals: Iterable[int] = (),
                    seed: int = 0) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """Paper Algorithm 1 on logistic regression: one single-sample step
    per index of ``idx`` at eta_t = gamma / (lam (t + a)), from x = 0.
    Returns the weighted average x_bar (w_t = (t + a)^2) and its loss
    after each step count in ``evals``, as device tensors (nothing is
    read back inside the loop)."""
    d = A.shape[1]
    x = torch.zeros(d, dtype=torch.float32, device=A.device)
    tx = memsgd_flat(compressor, paper_stepsize(gamma, lam, a), d, seed=seed)
    state = tx.init(x)
    avg = WeightedAverage(a)
    avg_state = avg.init(x)
    evals = set(evals)
    losses = {}
    for t, i in enumerate(idx):
        g = logreg_grad_torch(A, b, lam, x, i)
        upd, state = tx.update(g, state)
        x = apply_updates(x, upd)
        avg_state = avg.update(avg_state, x, t)
        if t + 1 in evals:
            losses[t + 1] = logreg_loss_torch(A, b, lam, avg.value(avg_state))
    return avg.value(avg_state), losses


def optimum(A: torch.Tensor, b: torch.Tensor, lam: float,
            iters: int = 2000) -> float:
    """f* via full gradient descent (L-smooth => eta = 1/L works), in
    float64 on A's device."""
    A, b = A.double(), b.double()
    L = 0.25 * float((A ** 2).sum(dim=1).max()) + lam
    x = torch.zeros(A.shape[1], dtype=torch.float64, device=A.device)
    for _ in range(iters):
        sig = torch.sigmoid(-b * (A @ x))
        x = x - (1.0 / L) * (-(A.T @ (b * sig)) / A.shape[0] + lam * x)
    return float(logreg_loss_torch(A, b, lam, x))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="paper-scale sizes")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=None,
                    help="steps per run (default 2n)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)

    if args.full:
        datasets = [
            ("epsilon", make_epsilon_like(n=400_000, d=2_000), (1, 2, 3), 1.0),
            ("rcv1", make_rcv1_like(n=20_000, d=47_236), (10, 20, 30), 10.0),
        ]
    else:
        datasets = [
            ("epsilon-small", make_epsilon_like(n=4_000, d=200), (1, 2), 1.0),
            ("rcv1-small", make_rcv1_like(n=2_000, d=2_000, density=0.01),
             (10, 20), 10.0),
        ]

    results = {}
    for name, data, ks, shift_factor in datasets:
        T = args.steps or 2 * data.n
        A, b = to_device(data, dev)
        fstar = optimum(A, b, data.lam)
        idx = sample_indices(data.n, T)
        print(f"\n=== {name}: n={data.n} d={data.d} lam=1/n  f*={fstar:.5f} "
              f"T={T} on {dev} ===")

        def subopt(comp, a):
            xbar, _ = run_memsgd_flat(A, b, data.lam, comp, a, idx)
            return float(logreg_loss_torch(A, b, data.lam, xbar)) - fstar

        r = subopt(identity(), 1.0)
        results[(name, "sgd")] = r
        print(f"  {'sgd (dense)':26s} subopt={r:.3e}  "
              f"bits/step={encoding.dense_bits(data.d):,.0f}")
        for k in ks:
            a = shift_factor * data.d / k  # paper Table 2
            for comp, op in (("top", top_k(k)), ("rand", rand_k(k))):
                r = subopt(op, a)
                results[(name, f"{comp}-{k}")] = r
                red = encoding.reduction_factor(data.d, k)
                print(f"  {f'memsgd {comp}-{k} (a={a:.0f})':26s} "
                      f"subopt={r:.3e}  "
                      f"bits/step={encoding.sparse_bits(data.d, k):,.0f}  "
                      f"({red:.0f}x less)")
        # delay ablation
        k = ks[0]
        r = subopt(top_k(k), 1.0)
        print(f"  {f'memsgd top-{k} WITHOUT delay':26s} "
              f"subopt={r:.3e}   <- a=1 hurts (Fig. 2)")
    return results


if __name__ == "__main__":
    main()
