"""The paper's logistic regression on the CPU at the card's step sizes: how
far its losses move under float32 rounding alone.

``chip_smoke.py`` trains ``memsgd_flat`` on ``make_epsilon_like(n=400000,
d=2000)`` and ``make_rcv1_like(n=20000, d=47236)`` at eta_t = 2 / (lam (t
+ a)), lam = 1/n, and holds the card's loss against the CPU's after a
short run. This tool runs the same protocol (the port's
``examples/torch_logreg_paper.run_memsgd_flat``) on fewer rows with the
full sets' lam, so that the steps have the card's sizes, twice: once as
the port computes the gradient, once with its dot product summed in
another order, a difference of float32 rounding only (as the card's
matrix-vector product differs from the CPU's). Prints, per run, the
weighted average's loss after each step count and the two runs'
relative gap there: where the gap is far below 1e-3, a card-against-CPU
check at rtol 1e-3 can only fail on a fault.

    PYTHONPATH=src python tools/logreg_rounding_cpu.py [--steps-eps 80000]
        [--steps-rcv1 20000]

At the defaults (50000 epsilon rows, 5000 rcv1 rows) it holds ~4 GiB and
takes ~6 minutes on 8 cores.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))


def _example():
    path = os.path.join(ROOT, "examples", "torch_logreg_paper.py")
    spec = importlib.util.spec_from_file_location("torch_logreg_paper", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _grad_reordered(A, b, lam, x, i):
    """logreg_grad_torch for one sample, the dot product summed in
    groups of four columns first."""
    a, bi = A[i], b[i]
    z = -bi * torch.sum(a.reshape(-1, 4) * x.reshape(-1, 4), dim=0).sum()
    return -(bi * torch.sigmoid(z)) * a + lam * x


def main(argv=None):
    from repro_torch.core.compression import identity, top_k
    from repro_torch.data import make_epsilon_like, make_rcv1_like

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps-eps", type=int, default=80_000)
    ap.add_argument("--steps-rcv1", type=int, default=20_000)
    args = ap.parse_args(argv)
    ex = _example()
    port_grad = ex.logreg_grad_torch
    sets = [
        ("epsilon", make_epsilon_like(n=50_000, d=2_000), 1 / 400_000,
         (1, 3), 1.0, args.steps_eps),
        ("rcv1", make_rcv1_like(n=5_000, d=47_236), 1 / 20_000, (10, 30),
         10.0, args.steps_rcv1),
    ]
    for name, data, lam, ks, factor, T in sets:
        A, b = ex.to_device(data, "cpu")
        d = data.d
        del data
        idx = ex.sample_indices(A.shape[0], T)
        evals = sorted({500, 1000, 2000, T // 10, T})
        runs = [("sgd", identity(), 1.0)] + [
            (f"top-{k}", top_k(k), factor * d / k) for k in ks]
        for label, comp, a in runs:
            out = []
            for grad in (port_grad, _grad_reordered):
                ex.logreg_grad_torch = grad  # the name run_memsgd_flat calls
                _, losses = ex.run_memsgd_flat(A, b, lam, comp, a, idx,
                                               evals=evals)
                out.append({t: float(v) for t, v in losses.items()})
            ex.logreg_grad_torch = port_grad
            line = ", ".join(
                f"{t}: {out[0][t]:.6f} (gap {abs(out[0][t] - out[1][t]) / abs(out[0][t]):.2e})"
                for t in evals)
            print(f"{name} ({A.shape[0]} rows, lam {lam:.3g}) {label} "
                  f"(a={a:.1f}): {line}", flush=True)
        del A, b


if __name__ == "__main__":
    main()
